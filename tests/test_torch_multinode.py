"""Multi-node GPU jobs on the CPU: the port's job spec (``api/gpu.py``), its
per-node launcher (``runtime/launch.py``) and the multislice layout.

- (a) ``gpu_job`` through the unchanged operator (the memory backend, gang
  scheduling on): one pod a node with ``nvidia.com/gpu`` and the H100
  selector, one gang a node for a JAXJob (``minResources`` its node's
  GPUs), one for a PyTorchJob; the launcher turns each pod's env into an
  N·G world whose mesh is ``{"slice": N, "fsdp": G}`` (``{"dp": N, ...}``
  over c10d), the same Topology in the JAX package's parse; the llama2-7b
  rendering passes the operator's validation; the env ``chip_smoke.py``
  and ``scripts/multicard_smoke.py`` write out is the operator's.
- (b) the launcher: the env of both contracts, the heartbeat on local
  rank 0 only, the refusals, and with tiny ``python -c`` children a
  failing child's code, its siblings' termination and SIGTERM forwarded.
- (c) llama-tiny (fp32) over ``{"slice": 2, "fsdp": 2}`` (two launchers of
  2 CPU ranks under the JAXJob env of a 2-node job) and ``{"dp": 2,
  "fsdp": 2}`` (two launchers under a PyTorchJob's c10d env): the losses
  of one process at rtol 1e-5 (and that one process, from the JAX
  init's weights, the JAX package's step on the same token file at rtol
  1e-4), the global norm counting the replicate dim, the placements, and
  a DCP save at step 2 restored by a fresh 4-process world giving steps
  2-3.
- (d) a ``numSlices: 2`` JAXJob of two launcher pods, 2 CPU ranks each,
  runs to Succeeded on the process backend: the counterpart of
  ``tests/test_e2e_process.py`` ``TestMultisliceTraining``.

Every subprocess runs one OpenMP thread. The file takes about 40 s alone.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from tf_operator_tpu.api import KINDS, parse_job
from tf_operator_tpu.cli import OperatorManager, OperatorOptions
from tf_operator_tpu.cluster.memory import InMemoryCluster
from tf_operator_tpu.cluster.process import LocalProcessCluster
from tf_operator_tpu.controllers.jax import JAXController
from tf_operator_tpu.controllers.pytorch import PyTorchController
from tf_operator_tpu.core.job_controller import EngineOptions
from tf_operator_tpu.metrics import Metrics
from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu.parallel.mesh import standard_mesh as jax_standard_mesh
from tf_operator_tpu.runtime.tpu_init import topology_from_env as jax_topology_from_env
from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu.train.data import TokenFileDataset as JaxTokenFileDataset
from tf_operator_tpu_torch.api import gpu
from tf_operator_tpu_torch.models import convert, llama
from tf_operator_tpu_torch.runtime import gpu_init, heartbeat, launch
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train
from tf_operator_tpu_torch.train.train_step import global_norm

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
TRAIN = ["python", "-m", "tf_operator_tpu_torch.train.llama_train", "--model=llama-tiny"]
HOST_KEYS = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS")


def pod_env(pod):
    return {e.name: e.value for e in pod.spec.containers[0].env}


def reconcile(controller_cls, manifest):
    cluster = InMemoryCluster()
    ctrl = controller_cls(cluster, options=EngineOptions(enable_gang_scheduling=True))
    cluster.create_job(manifest)
    ctrl.run_until_idle()
    pods = sorted(cluster.list_pods("default"), key=lambda p: p.metadata.name)
    groups = sorted(cluster.list_pod_groups("default"), key=lambda g: g["metadata"]["name"])
    return pods, groups


# ----------------------------------------------- (a) the job through the operator
def test_jaxjob_pods_gangs_and_the_launched_world():
    pods, groups = reconcile(JAXController, gpu.gpu_job("ms", "JAXJob", 2, TRAIN))
    assert [p.metadata.name for p in pods] == ["ms-worker-0", "ms-worker-1"]
    for node, pod in enumerate(pods):
        container = pod.spec.containers[0]
        assert container.resources == {"limits": {"nvidia.com/gpu": "8"},
                                       "requests": {"nvidia.com/gpu": "8"}}
        assert pod.spec.node_selector == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert list(container.command) == ["python", "-m", "tf_operator_tpu_torch.runtime.launch",
                                           "--nproc-per-node", "8", "--", *TRAIN]
        env = pod_env(pod)
        assert (env["JAX_NUM_PROCESSES"], env["JAX_PROCESS_ID"]) == ("2", str(node))
        assert (env["JAX_NUM_SLICES"], env["JAX_SLICE_INDEX"]) == ("2", str(node))
        assert json.loads(env["JAX_MESH_SPEC"]) == {"slice": 2, "fsdp": 8}
    # One gang a node: each of its pods is a whole node's GPUs.
    assert [g["metadata"]["name"] for g in groups] == ["ms-slice-0", "ms-slice-1"]
    for g in groups:
        assert g["spec"]["minMember"] == 1
        assert g["spec"]["minResources"]["nvidia.com/gpu"] == "8"
    # The launcher's children: 16 ranks, node p's ranks 8p..8p+7, slice p.
    seen = []
    for node, pod in enumerate(pods):
        for local in range(8):
            env = launch.rank_env(pod_env(pod), local, 8)
            topo = gpu_init.topology_from_env(env)
            assert dataclasses.asdict(topo) == dataclasses.asdict(jax_topology_from_env(env))
            assert (topo.num_processes, topo.slice_index, topo.num_slices) == (16, node, 2)
            assert gpu_init.mesh_axes_for(topo, 16, "cuda") == {"slice": 2, "fsdp": 8}
            assert gpu_init.local_device_index(topo, env) == local
            seen.append(topo.process_id)
    assert seen == list(range(16))


def test_pytorchjob_pods_one_gang_and_the_c10d_world():
    pods, groups = reconcile(PyTorchController,
                             gpu.gpu_job("pt", "PyTorchJob", 3, TRAIN, gpus_per_node=4))
    assert [p.metadata.name for p in pods] == ["pt-master-0", "pt-worker-0", "pt-worker-1"]
    seen = []
    for node, pod in enumerate(pods):
        assert pod.spec.containers[0].resources["limits"] == {"nvidia.com/gpu": "4"}
        assert pod.spec.node_selector == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        env = pod_env(pod)
        assert (env["WORLD_SIZE"], env["RANK"]) == ("3", str(node))
        for local in range(4):
            topo = gpu_init.c10d_topology_from_env(launch.rank_env(env, local, 4))
            assert topo.num_processes == 12
            assert gpu_init.mesh_axes_for(topo, 12, "cuda") == {"dp": 3, "fsdp": 4}
            seen.append(topo.process_id)
    assert seen == list(range(12))
    # A PyTorchJob is one gang: every node's pod and GPUs.
    assert [(g["spec"]["minMember"], g["spec"]["minResources"]) for g in groups] == [
        (3, {"nvidia.com/gpu": "12"})]


def test_the_user_template_wins_and_what_is_refused():
    template = {"spec": {"nodeSelector": {"cloud.google.com/gke-accelerator": "mine"},
                         "containers": [{"name": "jax", "image": "img",
                                         "env": [{"name": "X", "value": "1"}]}]}}
    job = gpu.gpu_job("j", "JAXJob", 1, TRAIN, gpus_per_node=2, template=template)
    pod = job["spec"]["jaxReplicaSpecs"]["Worker"]["template"]
    assert pod["spec"]["nodeSelector"] == {"cloud.google.com/gke-accelerator": "mine"}
    assert pod["spec"]["containers"][0]["image"] == "img"
    assert job["spec"]["mesh"] == {"fsdp": 2} and job["spec"]["numSlices"] == 1
    assert template["spec"]["containers"][0].get("command") is None  # not mutated
    gfd = gpu.gpu_job("j", "PyTorchJob", 1, TRAIN, selector="gfd")
    pod = gfd["spec"]["pytorchReplicaSpecs"]["Master"]["template"]
    assert pod["spec"]["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert pod["spec"]["containers"][0]["env"] == [{"name": "JAX_MESH_SPEC",
                                                    "value": '{"fsdp":8}'}]
    assert "Worker" not in gfd["spec"]["pytorchReplicaSpecs"]
    for kwargs, match in (
            ({"gpus_per_node": 9}, "8 GPUs a node; asked for 9"),
            ({"mesh": {"slice": 2, "fsdp": 4}}, "has 8 devices; the job has 2 nodes x 8"),
            ({"mesh": {"slice": 4, "fsdp": 4}}, "the slice axis is the node count"),
            ({"mesh": {"fsdp": 16}}, "has 32 devices"),  # the workload adds slice=2
            ({"node_type": "a100"}, "unknown GPU node type"),
            ({"selector": "aws"}, "selector 'aws'"),
            ({"template": {"spec": {"containers": [{"name": "jax", "resources": {
                "limits": {"nvidia.com/gpu": "4"}}}]}}}, "limits nvidia.com/gpu=4")):
        with pytest.raises(ValueError, match=match):
            gpu.gpu_job("j", "JAXJob", 2, TRAIN, **kwargs)
    with pytest.raises(ValueError, match="kind 'TFJob'"):
        gpu.gpu_job("j", "TFJob", 1, TRAIN)
    with pytest.raises(ValueError, match="needs a command"):
        gpu.gpu_job("j", "JAXJob", 1, [])


def test_llama2_7b_multislice_passes_the_operators_validation():
    manifest = gpu.llama2_7b_multislice()
    job = parse_job(manifest)
    _, set_defaults, validate = KINDS[job.kind]
    set_defaults(job)
    validate(job.spec)
    assert job.spec.num_slices == 2 and job.spec.mesh == {"slice": 2, "fsdp": 8}
    assert job.spec.jax_replica_specs["Worker"].replicas == 2
    # The TPU manifest's run: the same model, global batch and sequence.
    tpu = yaml.safe_load((ROOT / "examples/jax/llama/jaxjob_llama2_7b_multislice.yaml")
                         .read_text())
    tpu_args = tpu["spec"]["jaxReplicaSpecs"]["Worker"]["template"]["spec"]["containers"][0][
        "command"][2:]
    command = manifest["spec"]["jaxReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]["command"]
    assert command[command.index("--") + 4:] == tpu_args
    assert tpu["spec"]["numSlices"] == 2 and tpu["spec"]["mesh"]["slice"] == 2


@pytest.mark.parametrize("nodes", [1, 2])
def test_the_smoke_scripts_write_out_the_operators_env(nodes):
    """``chip_smoke.node_env`` is the env the operator gives a ``gpu_job``
    pod, its service hosts on the loopback."""
    job = gpu.gpu_job("smoke", "JAXJob", nodes, TRAIN, gpus_per_node=2)
    pods, _ = reconcile(JAXController, job)
    for node, pod in enumerate(pods):
        want = pod_env(pod)
        got = chip_smoke.node_env(nodes, node, 2, port=1234)
        assert sorted(got) == sorted(want)
        assert {k: v for k, v in got.items() if k not in HOST_KEYS} == {
            k: v for k, v in want.items() if k not in HOST_KEYS}
        assert got["JAX_COORDINATOR_ADDRESS"] == "127.0.0.1:1234"


# --------------------------------------------------------------- (b) the launcher
JAX_POD = {"JAX_COORDINATOR_ADDRESS": "j-worker-0.ns.svc:1234", "JAX_NUM_PROCESSES": "3",
           "JAX_PROCESS_ID": "2", "JAX_NUM_SLICES": "3", "JAX_SLICE_INDEX": "2",
           "JAX_MESH_SPEC": '{"slice":3,"fsdp":4}', "PATH": "/bin",
           heartbeat.ENV_HEARTBEAT_LEASE: "j-worker-2-hb", heartbeat.ENV_HEARTBEAT_FILE: "/hb",
           heartbeat.ENV_HEARTBEAT_NAMESPACE: "ns", heartbeat.ENV_HEARTBEAT_INTERVAL: "5"}
C10D_POD = {"MASTER_ADDR": "pt-master-0", "MASTER_PORT": "23456", "WORLD_SIZE": "2",
            "RANK": "1", "JAX_MESH_SPEC": '{"dp":2,"fsdp":4}'}


def test_rank_env_of_both_contracts():
    for local in range(4):
        env = launch.rank_env(JAX_POD, local, 4)
        changed = {k: v for k, v in env.items() if JAX_POD.get(k) != v}
        want = {"JAX_NUM_PROCESSES": "12", "JAX_PROCESS_ID": str(8 + local),
                "LOCAL_RANK": str(local), "LOCAL_WORLD_SIZE": "4"}
        assert changed == want
        # The heartbeat stays with local rank 0: one Lease, one beat file.
        gone = set(JAX_POD) - set(env)
        assert gone == (set() if local == 0 else set(launch.HEARTBEAT_ENV))
    env = launch.rank_env(C10D_POD, 3, 4)
    assert (env["WORLD_SIZE"], env["RANK"], env["MASTER_ADDR"]) == ("8", "7", "pt-master-0")
    assert "JAX_NUM_PROCESSES" not in env and "JAX_COORDINATOR_ADDRESS" not in env
    # Both contracts at once: both mapped.
    both = launch.rank_env({**JAX_POD, **C10D_POD}, 1, 4)
    assert (both["JAX_PROCESS_ID"], both["RANK"]) == ("9", "5")
    # One card a node: the pod's rank, as it was.
    assert {k: v for k, v in launch.rank_env(C10D_POD, 0, 1).items()
            if C10D_POD.get(k) != v} == {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    assert gpu_init.launch_note(gpu_init.topology_from_env(launch.rank_env(JAX_POD, 3, 4)),
                                launch.rank_env(JAX_POD, 3, 4)) == (
        "process 11/12 node 2 local rank 3/4 slice 2/3")


def test_what_the_launcher_refuses(monkeypatch, capsys):
    # A slice-local world over 2 cards a node is no longer refused: the
    # slice's world is its hosts times the local ranks (gpu_init).
    local = {**JAX_POD, "JAX_SLICE_LOCAL_WORLD": "true", "TPU_WORKER_HOSTNAMES": "h"}
    for nproc in (1, 2):
        for rank in range(nproc):
            topo = gpu_init.topology_from_env(launch.rank_env(local, rank, nproc))
            assert (topo.slice_world, topo.num_processes, topo.process_id) == (True, nproc, rank)
    assert launch.rank_env(local, 0, 1)["JAX_PROCESS_ID"] == "2"  # one card a node: as it was
    with pytest.raises(ValueError, match="neither the JAXJob contract"):
        launch.rank_env({"PATH": "/bin", "MASTER_ADDR": "m", "RANK": "0"}, 0, 1)
    with pytest.raises(ValueError, match="needs --nproc-per-node"):
        launch.processes_per_node(None, ["x", "--device", "cpu"])
    assert launch.processes_per_node(3, ["x", "--device=cpu"]) == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no card is visible"):
        launch.processes_per_node(None, ["x"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert launch.processes_per_node(None, ["x"]) == 2
    with pytest.raises(ValueError, match="--nproc-per-node 4 with 2 cards visible"):
        launch.processes_per_node(4, ["x"])
    proc = subprocess.run([sys.executable, "-m", "tf_operator_tpu_torch.runtime.launch",
                           "--", "python", "-c", "pass"], cwd=ROOT,
                          env={**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "no card is visible" in proc.stderr
    monkeypatch.setattr(os, "environ", {"PATH": "/bin"})
    assert launch.main(["--nproc-per-node", "2", "--", "python", "-c", "pass", "--device",
                        "cpu"]) == 2
    assert "neither the JAXJob contract" in capsys.readouterr().err


CHILD = r"""
import os, signal, sys, time
rank, out, mode = int(os.environ["LOCAL_RANK"]), sys.argv[1], sys.argv[2]
def term(*_):
    open(f"{out}.{rank}", "w").write("term")
    sys.exit(143)
signal.signal(signal.SIGTERM, signal.SIG_IGN if mode == "ignore" and rank == 2 else term)
open(f"{out}.ready.{rank}", "w").write(os.environ["JAX_PROCESS_ID"])
if mode in ("fail", "ignore", "kill"):  # the others' handlers are in place first
    while not all(os.path.exists(f"{out}.ready.{r}") for r in range(3)):
        time.sleep(0.01)
if mode in ("fail", "ignore") and rank == 1:
    sys.exit(3)
if mode == "kill" and rank == 0:
    os.kill(os.getpid(), signal.SIGKILL)
if mode == "ok":
    sys.exit(0)
time.sleep(60)
"""


LAUNCH_ENV = {**CHILD_ENV, "JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
              "JAX_PROCESS_ID": "1"}


@pytest.mark.parametrize("mode,code", [("ok", 0), ("fail", 3), ("kill", 137), ("ignore", 3)])
def test_a_failing_child_ends_the_node(tmp_path, monkeypatch, mode, code):
    out = str(tmp_path / "c")
    monkeypatch.setattr(launch, "GRACE_SECONDS", 1.0)
    t0 = time.monotonic()
    got = launch.launch([sys.executable, "-c", CHILD, out, mode], 3, env=LAUNCH_ENV)
    took = time.monotonic() - t0
    assert got == code and took < 20
    assert sorted(open(f"{out}.ready.{r}").read() for r in range(3)) == ["3", "4", "5"]
    siblings = {"ok": [], "fail": [0, 2], "kill": [1, 2], "ignore": [0]}[mode]
    assert sorted(r for r in range(3) if os.path.exists(f"{out}.{r}")) == siblings
    if mode == "ignore":  # SIGKILLed after the grace period
        assert took >= 1.0


def test_sigterm_to_the_launcher_reaches_every_child(tmp_path):
    out = str(tmp_path / "c")
    proc = subprocess.Popen([sys.executable, "-m", "tf_operator_tpu_torch.runtime.launch",
                             "--nproc-per-node", "2", "--", sys.executable, "-c", CHILD, out,
                             "wait", "--device", "cpu"], cwd=ROOT, env=LAUNCH_ENV)
    try:
        deadline = time.monotonic() + 30
        while not all(os.path.exists(f"{out}.ready.{r}") for r in range(2)):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
    assert all(open(f"{out}.{r}").read() == "term" for r in range(2))


# --------------------------------------------- (c) the layouts on 4 gloo ranks
ARGS = ["--device", "cpu", "--model", "llama-tiny", "--steps", "4", "--batch", "4", "--seq",
        "32", "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
FP32_TINY = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                                param_dtype=torch.float32, remat=True)
WORKER = r"""
import dataclasses, json, os, shutil, sys
import torch, torch.distributed as dist
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True)
from tf_operator_tpu_torch.train import llama_train
from tf_operator_tpu_torch.train.train_step import _copies, global_norm

out_path, drop, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
args = llama_train.parse_args(argv)
s = llama_train.setup(args)
named = list(s.state.model.named_parameters())
out = llama_train.run(args, s)
grads = [p.grad for _, p in named]
full = [torch.linalg.vector_norm(g.full_tensor()) for g in grads]
result = {"losses": out["losses"], "mesh": out["mesh"], "start": out["start_step"],
          "norm": global_norm(grads).item(),
          "full_norm": torch.linalg.vector_norm(torch.stack(full)).item(),
          "copies": sorted({_copies(g) for g in grads}),
          "placements": {n: [repr(x) for x in p.placements] for n, p in named},
          "mesh_dims": {n: list(p.device_mesh.mesh_dim_names) for n, p in named},
          "restore": [out["restore"].path, out["restore"].cause, out["restore"].step]
                     if out["restore"] else None}
with open(out_path + ".%d" % dist.get_rank(), "w") as fh:
    json.dump(result, fh)
dist.barrier()
if drop and dist.get_rank() == 0:  # the newer save is lost
    shutil.rmtree(drop)
dist.destroy_process_group()
"""


def node_envs(contract, port, mesh):
    """The two pods' env of a 2-node job: the JAXJob contract (a node a
    slice) or the c10d one."""
    if contract == "jax":
        return [{**chip_smoke.node_env(2, node, 2, port), "JAX_MESH_SPEC": json.dumps(mesh)}
                for node in range(2)]
    return [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(node), "JAX_MESH_SPEC": json.dumps(mesh)} for node in range(2)]


def start_world(contract, mesh, out, argv, drop=""):
    """Two launchers of 2 CPU ranks each: a world of 4."""
    envs = node_envs(contract, chip_smoke.free_port(), mesh)
    return [subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.runtime.launch", "--nproc-per-node", "2",
         "--", sys.executable, "-c", WORKER, out, drop, *argv], cwd=ROOT,
        env={**CHILD_ENV, **env}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for env in envs]


def finish(procs, out):
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-4000:]
    return [json.loads(pathlib.Path(f"{out}.{r}").read_text()) for r in range(4)], logs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multinode")
    tokens = tmp / "tokens.bin"
    # Ids from 16 of the 256: the first updates move the loss.
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    args = [*ARGS, "--data", str(tokens)]
    ckpt = tmp / "ckpt"
    saving = [*args, "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2"]
    first = {"slice": start_world("jax", {"slice": 2, "fsdp": 2}, str(tmp / "slice"), saving,
                                  drop=str(ckpt / "dcp" / "4")),
             "dp": start_world("c10d", {"dp": 2, "fsdp": 2}, str(tmp / "dp"), args)}
    previous = llama.CONFIGS["llama-tiny"]
    llama.CONFIGS["llama-tiny"] = FP32_TINY
    try:
        parsed = llama_train.parse_args(args)
        s = llama_train.setup(parsed)
        single = llama_train.run(parsed, s)["losses"]
        single_norm = global_norm([p.grad for p in s.state.model.parameters()]).item()
    finally:
        llama.CONFIGS["llama-tiny"] = previous
    result = {"single": single, "single_norm": single_norm, "args": args,
              "tokens": str(tokens)}
    for name, procs in first.items():
        result[name], result[name + "_logs"] = finish(procs, str(tmp / name))
    # A fresh world restores the step-2 save (the step-4 one was dropped).
    result["dcp"] = sorted(os.listdir(ckpt / "dcp"))
    resumed = start_world("jax", {"slice": 2, "fsdp": 2}, str(tmp / "resumed"),
                          [*args, "--checkpoint-dir", str(ckpt)])
    result["resumed"], _ = finish(resumed, str(tmp / "resumed"))
    return result


@pytest.mark.parametrize("layout", ["slice", "dp"])
def test_hsdp_losses_match_one_process(worlds, layout):
    single = np.array(worlds["single"])
    assert single[-1] < single[0] - 0.05
    for rank in worlds[layout]:
        assert rank["mesh"] == {layout: 2, "fsdp": 2}
        np.testing.assert_allclose(rank["losses"], single, rtol=1e-5)


def test_the_one_process_run_matches_the_jax_step(worlds, monkeypatch):
    # The run the layouts are held to, from the JAX init's weights carried
    # across by the converter, against the JAX package's step on the same
    # token file: rtol 1e-4, as the 10-step sequence of
    # test_torch_train_step (the sums run in other orders).
    jcfg = dataclasses.replace(jax_llama.CONFIGS["llama-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    jmodel = jax_llama.Llama(jcfg)
    joptim = jax_ts.make_optimizer(learning_rate=3e-3, warmup_steps=1, decay_steps=4)
    jstate = jax_ts.init_train_state(jmodel, jax.random.PRNGKey(0), joptim, seq=32)
    jstep, _ = jax_ts.make_train_step(jmodel, joptim,
                                      jax_standard_mesh(1, devices=jax.devices()[:1]), jstate)
    weights = convert.flax_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    batches = JaxTokenFileDataset(worlds["tokens"], 4, 32)
    # XLA's backend optimisations cost compile time and buy nothing here.
    jstep = jstep.lower(jstate, jnp.zeros((4, 33), jnp.int32)).compile(
        {"xla_backend_optimization_level": 0})
    jlosses = []
    for _ in range(4):
        jstate, loss = jstep(jstate, jnp.asarray(next(batches)))
        jlosses.append(float(loss))
    batches.close()
    monkeypatch.setitem(llama.CONFIGS, "llama-tiny", FP32_TINY)
    parsed = llama_train.parse_args(worlds["args"])
    s = llama_train.setup(parsed)
    s.state.model.load_state_dict(weights)
    np.testing.assert_allclose(llama_train.run(parsed, s)["losses"], jlosses, rtol=1e-4)


@pytest.mark.parametrize("layout", ["slice", "dp"])
def test_global_norm_counts_the_replicate_dim(worlds, layout):
    for rank in worlds[layout]:
        # Each gradient shard is held by the 2 ranks of the replicate dim.
        assert rank["copies"] == [2]
        np.testing.assert_allclose(rank["norm"], rank["full_norm"], rtol=1e-5)
        np.testing.assert_allclose(rank["norm"], worlds["single_norm"], rtol=1e-4)


@pytest.mark.parametrize("layout", ["slice", "dp"])
def test_placements_name_the_replicate_and_the_shard_dims(worlds, layout):
    for rank in worlds[layout]:
        assert set(map(tuple, rank["mesh_dims"].values())) == {(layout, "fsdp")}
        assert set(map(tuple, rank["placements"].values())) == {("Replicate()",
                                                                 "Shard(dim=0)")}


def test_a_fresh_world_resumes_from_the_dcp_save(worlds):
    assert worlds["dcp"] == ["2"]
    for first, rank in zip(worlds["slice"], worlds["resumed"]):
        assert rank["restore"] == ["storage", "ok", 2] and rank["start"] == 2
        np.testing.assert_allclose(rank["losses"], first["losses"][2:], rtol=1e-6)


def test_each_rank_logs_its_node_and_local_rank(worlds):
    for node, log in enumerate(worlds["slice_logs"]):
        for local in range(2):
            assert (f"[gpu_init] process {2 * node + local}/4 node {node} local rank "
                    f"{local}/2 slice {node}/2") in log
    for node, log in enumerate(worlds["dp_logs"]):
        assert f"[gpu_init] process {2 * node + 1}/4 node {node} local rank 1/2" in log


# ------------------------------------------- (d) the process backend, 2 slices
@pytest.fixture
def harness():
    cluster = LocalProcessCluster(child_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    manager = OperatorManager(
        cluster, OperatorOptions(enabled_schemes=["JAXJob"], health_port=0, metrics_port=0,
                                 resync_period=0.2),
        metrics=Metrics())
    manager.start()
    yield cluster
    manager.stop()
    cluster.shutdown()


def succeeded(cluster, name):
    try:
        job = cluster.get_job("JAXJob", "default", name)
    except KeyError:
        return False
    return any(c["type"] == "Succeeded" and c["status"] == "True"
               for c in (job.get("status") or {}).get("conditions") or [])


def test_two_launcher_pods_train_across_the_slice_boundary(harness, monkeypatch):
    command = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", "--device",
               "cpu", "--model", "llama-tiny", "--seq", "32", "--batch", "4", "--steps", "4",
               "--log-every", "2"]
    port = {"name": "jaxjob-port", "containerPort": chip_smoke.free_port()}
    monkeypatch.setattr(gpu, "PYTHON", sys.executable)  # this process's, not the image's
    harness.create_job(gpu.gpu_job(
        "ms", "JAXJob", 2, command, gpus_per_node=2, image="local",
        template={"spec": {"containers": [{"name": "jax", "ports": [port]}]}}))
    deadline = time.monotonic() + 120
    while not succeeded(harness, "ms"):
        assert time.monotonic() < deadline, harness.get_pod_log("default", "ms-worker-0")
        time.sleep(0.1)
    for node in range(2):
        log = harness.get_pod_log("default", f"ms-worker-{node}")
        assert log.count("devices=4 mesh={'slice': 2, 'fsdp': 2}") == 2, log[-3000:]
        assert log.count(f"slice={node}/2") == 2
        assert log.count("[llama] done") == 2
        for local in range(2):
            assert f"[llama] process {2 * node + local}/4 devices=4" in log
