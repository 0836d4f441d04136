"""Elastic GPU jobs on the CPU: a port job resized in whole nodes through
the operator and resumed at its new world from the sharded checkpoint.

- The job: ``api/gpu.py`` ``gpu_job(elastic=(min, max))`` writes a
  JAXJob's ``spec.elastic``, refuses the bounds the operator's validation
  refuses with its message, and refuses a PyTorchJob;
  ``mixtral_8x7b_elastic`` passes the operator's validation, and so do its
  resizes by ``JobClient.scale``.
- The resize (one module fixture, the process backend): the counterpart of
  ``tests/test_e2e_process.py`` ``TestJAXJobElasticResize``. A 2-node
  ``gpu_job`` of launcher pods, 2 CPU ranks a node (``{"slice": 2,
  "fsdp": 2}``), trains fp32 llama-tiny from a seeded token file with a
  DCP checkpoint every 2 steps; after a durable step ``JobClient.scale``
  shrinks it to 1 node (``{"slice": 1, "fsdp": 2}``), and after the next
  one grows it back to 2 nodes, with the operator's warm start on. Each
  time the stale pods go in one batch, the new pods carry the new
  ``world-generation`` and env, every rank resumes at a durable step,
  and each world's losses are those of one unresized process at rtol
  1e-5.
- The gates with the port's riders: the autoscaler's checkpoint-gated
  shrink fed by the port's durability listener and heartbeat (never a
  non-durable step); a warm-start grow of a ``gpu_job`` (``TPU_WARM_START``
  until the grown world is present, handed to every local rank by the
  launcher), whose ranks refuse a peer of another world and restore from
  storage with the cause named; a grow beyond ``nvidia.com/gpu`` capacity
  that queues and admits at its new size once the GPUs free.
- Slice-local worlds shrunk to one slice read the checkpoint root in both
  packages (a finding, recorded, not fixed).

Every subprocess runs one OpenMP thread.
"""

import json
import os
import pathlib
import re
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from test_autoscaler import make_harness, rigid_manifest, running_workers, settle
from test_torch_multinode import FP32_TINY
from test_torch_recovery import tiny_state
from test_torch_slice_restart import job_condition, wait_for
from tf_operator_tpu.api import KINDS, parse_job
from tf_operator_tpu.cli import OperatorManager, OperatorOptions, build_arg_parser, \
    options_from_args
from tf_operator_tpu.cluster.memory import InMemoryCluster
from tf_operator_tpu.cluster.process import LocalProcessCluster
from tf_operator_tpu.controllers.jax import JAXController
from tf_operator_tpu.core import constants
from tf_operator_tpu.core.job_controller import EngineOptions
from tf_operator_tpu.metrics import Metrics
from tf_operator_tpu.runtime.tpu_init import topology_from_env as jax_topology_from_env
from tf_operator_tpu.sdk.client import JobClient
from tf_operator_tpu_torch.api import gpu
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.runtime import gpu_init, heartbeat, launch
from tf_operator_tpu_torch.train import checkpoint, data, llama_train, restore
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD_ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
TRAIN = ["python", "-m", "tf_operator_tpu_torch.train.llama_train"]


def pod_env(pod):
    return {e.name: e.value for e in pod.spec.containers[0].env}


# ------------------------------------------------------------------- the job
def test_an_elastic_gpu_job_declares_its_bounds_in_nodes():
    job = gpu.gpu_job("el", "JAXJob", 2, TRAIN, gpus_per_node=2, elastic=(1, 2))
    assert job["spec"]["elastic"] == {"minSlices": 1, "maxSlices": 2}
    assert job["spec"]["numSlices"] == 2 and job["spec"]["mesh"] == {"slice": 2, "fsdp": 2}
    assert gpu.gpu_job("el", "JAXJob", 3, TRAIN, elastic=(2, None))["spec"]["elastic"] == {
        "minSlices": 2}
    assert "elastic" not in gpu.gpu_job("el", "JAXJob", 2, TRAIN)["spec"]


@pytest.mark.parametrize("nodes,bounds", [(2, (0, 2)), (2, (3, 1)), (2, (3, 4)),
                                          (5, (1, 4))])
def test_elastic_bounds_are_refused_as_the_operator_refuses_them(nodes, bounds):
    manifest = gpu.gpu_job("el", "JAXJob", nodes, TRAIN)
    manifest["spec"]["elastic"] = {"minSlices": bounds[0], "maxSlices": bounds[1]}
    parsed = parse_job(manifest)
    _, set_defaults, validate = KINDS[parsed.kind]
    set_defaults(parsed)
    with pytest.raises(Exception) as operator:
        validate(parsed.spec)
    with pytest.raises(ValueError) as port:
        gpu.gpu_job("el", "JAXJob", nodes, TRAIN, elastic=bounds)
    assert str(port.value) == str(operator.value)


def test_a_pytorchjob_is_not_elastic():
    with pytest.raises(ValueError, match="a PyTorchJob is not elastic"):
        gpu.gpu_job("pt", "PyTorchJob", 2, TRAIN, elastic=(1, 2))
    cluster = InMemoryCluster()
    cluster.create_job(gpu.gpu_job("pt", "PyTorchJob", 2, TRAIN))
    with pytest.raises(ValueError, match="resizes JAXJobs"):
        JobClient(cluster, kind="PyTorchJob").scale("pt", 1)


def test_mixtral_8x7b_elastic_passes_the_operators_validation_and_its_resizes():
    manifest = gpu.mixtral_8x7b_elastic()
    job = parse_job(manifest)
    _, set_defaults, validate = KINDS[job.kind]
    set_defaults(job)
    validate(job.spec)
    assert job.spec.num_slices == 2 and job.spec.mesh == {"fsdp": 2, "ep": 4}
    assert (job.spec.elastic.min_slices, job.spec.elastic.max_slices) == (1, 4)
    container = manifest["spec"]["jaxReplicaSpecs"]["Worker"]["template"]["spec"][
        "containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "8"}
    # The TPU manifest's run: the same model, batch, sequence, steps and
    # checkpoint cadence, and the same bounds.
    import yaml

    tpu = yaml.safe_load((ROOT / "examples/jax/mixtral/jaxjob_mixtral_8x7b_v5e64.yaml")
                         .read_text())
    tpu_args = tpu["spec"]["jaxReplicaSpecs"]["Worker"]["template"]["spec"]["containers"][0][
        "command"][2:]
    assert container["command"][container["command"].index("--") + 4:] == tpu_args
    assert tpu["spec"]["elastic"] == manifest["spec"]["elastic"]
    assert tpu["spec"]["mesh"]["ep"] == manifest["spec"]["mesh"]["ep"]
    cluster = InMemoryCluster()
    cluster.create_job(manifest)
    client = JobClient(cluster, kind="JAXJob")
    for nodes in (3, 1):
        spec = client.scale("mixtral-8x7b", nodes)["spec"]
        assert spec["numSlices"] == nodes and spec["jaxReplicaSpecs"]["Worker"][
            "replicas"] == nodes
        # A per-slice mesh is resize-stable; the ranks add the slice axis.
        assert spec["mesh"] == {"fsdp": 2, "ep": 4}
        axes = gpu_init.job_mesh_axes(spec["mesh"], nodes)
        assert int(np.prod(list(axes.values()))) == nodes * 8
    with pytest.raises(Exception, match="outside elastic bounds"):
        client.scale("mixtral-8x7b", 5)


@pytest.mark.parametrize("nodes", [1, 2])
def test_the_env_after_a_resize_is_what_the_smoke_scripts_write_out(nodes):
    """A 2-node ``gpu_job`` resized by ``JobClient.scale`` to ``nodes``:
    its pods' env on the memory backend is ``chip_smoke.node_env`` with
    the mesh that ``scale()`` renders (``{"slice": 1, "fsdp": G}`` on one
    node)."""
    cluster = InMemoryCluster()
    ctrl = JAXController(cluster, options=EngineOptions())
    cluster.create_job(gpu.gpu_job("el", "JAXJob", 3 - nodes, TRAIN, gpus_per_node=2,
                                   elastic=(1, 2)))
    ctrl.run_until_idle()
    spec = JobClient(cluster, kind="JAXJob").scale("el", nodes)["spec"]
    for _ in range(4):
        ctrl.run_until_idle()
    pods = sorted((p for p in cluster.list_pods("default")
                   if p.metadata.deletion_timestamp is None), key=lambda p: p.metadata.name)
    assert len(pods) == nodes
    for node, pod in enumerate(pods):
        got = chip_smoke.node_env(nodes, node, 2, 1234, mesh=spec["mesh"])
        want = pod_env(pod)
        assert sorted(got) == sorted(want)
        hosts = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                 "MEGASCALE_COORDINATOR_ADDRESS")
        assert {k: v for k, v in got.items() if k not in hosts} == {
            k: v for k, v in want.items() if k not in hosts}
    if nodes == 1:
        assert spec["mesh"] == {"slice": 1, "fsdp": 2}


# --------------------------------------------------- the resize, end to end
STEPS, EVERY = 40, 2
ARGS = ["--device", "cpu", "--model", "llama-tiny", "--steps", str(STEPS), "--batch", "4",
        "--seq", "32", "--log-every", "10", "--lr", "3e-3", "--warmup", "1",
        "--checkpoint-every", str(EVERY)]
LOSS = re.compile(r"^\[elastic\] process (\d+) step (\d+) loss (\S+)$", re.M)
# Each pod's command: llama_train's setup and run on fp32 llama-tiny, each
# step's loss printed at full precision, and each step held while the
# PACE file asks it to (a world then still trains when it is resized).
WORKER = r"""
import dataclasses, os, sys, time
import torch
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True)
from tf_operator_tpu_torch.train import llama_train

pace, argv = sys.argv[1], sys.argv[2:]
args = llama_train.parse_args(argv)
s = llama_train.setup(args)
inner, process = s.step_fn, s.topology.process_id

def step_fn(state, batch):
    step = state.step
    state, loss = inner(state, batch)
    print(f"[elastic] process {process} step {step} loss {loss.item()!r}", flush=True)
    try:
        time.sleep(float(open(pace).read() or 0))
    except (OSError, ValueError):
        pass
    return state, loss

s.step_fn = step_fn
try:
    llama_train.run(args, s)
finally:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
"""


def live_pods(cluster, name):
    return sorted((p for p in cluster.list_pods("default", labels={"job-name": name})
                   if p.metadata.deletion_timestamp is None), key=lambda p: p.metadata.name)


@pytest.fixture(scope="module")
def resized(tmp_path_factory):
    """One elastic job through three worlds: 2 nodes, shrunk to 1, grown
    back to 2 (module doc). Each world is resized once the beat of its
    node 0 shows a durable step newer than the one it resumed from."""
    tmp = tmp_path_factory.mktemp("elastic")
    tokens, ckpt, pace = tmp / "tokens.bin", tmp / "ckpt", tmp / "pace"
    # Ids from 16 of the 256: the first updates move the loss.
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    args = [*ARGS, "--data", str(tokens)]
    pace.write_text("0.05")
    cluster = LocalProcessCluster(child_env=CHILD_ENV)
    manager = OperatorManager(cluster, OperatorOptions(
        enabled_schemes=["JAXJob"], health_port=0, metrics_port=0, resync_period=0.2,
        enable_peer_restore=True, enable_sharded_restore=True, enable_warm_start=True),
        metrics=Metrics())
    manager.start()
    command = [sys.executable, "-c", WORKER, str(pace), *args, "--checkpoint-dir", str(ckpt)]
    port = {"name": "jaxjob-port", "containerPort": chip_smoke.free_port()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu, "PYTHON", sys.executable)  # this process's, not the image's
        job = gpu.gpu_job("el", "JAXJob", 2, command, gpus_per_node=2, image="local",
                          elastic=(1, 2),
                          template={"spec": {"containers": [{"name": "jax", "ports": [port]}]}})
    # A progress deadline turns the heartbeat on: the backend points it at a
    # beat file and bridges it to the pod's Lease.
    job["spec"]["runPolicy"] = {"progressDeadlineSeconds": 300}
    client = JobClient(cluster, kind="JAXJob")
    out = {"worlds": [], "generations": [], "mixed": []}

    def observe():
        """Note every moment at which pods of two worlds run at once."""
        running = [p for p in live_pods(cluster, "el") if p.status.phase == "Running"]
        gens = {p.metadata.labels.get(constants.LABEL_WORLD_GENERATION) for p in running}
        if len(gens) > 1:
            out["mixed"].append(sorted(gens))

    def world(nodes):
        """Wait for a world of ``nodes`` Running pods of one generation
        other than the last one's; its pods."""
        def ready():
            observe()
            pods = live_pods(cluster, "el")
            gens = {p.metadata.labels.get(constants.LABEL_WORLD_GENERATION) for p in pods}
            return (len(pods) == nodes and all(p.status.phase == "Running" for p in pods)
                    and len(gens) == 1 and gens != set(out["generations"][-1:]))
        assert wait_for(ready, 120), [(p.metadata.name, p.status.phase) for p in
                                      live_pods(cluster, "el")]
        pods = live_pods(cluster, "el")
        gen = pods[0].metadata.labels[constants.LABEL_WORLD_GENERATION]
        out["generations"].append(gen)
        out["worlds"].append({"nodes": nodes, "generation": gen,
                              "pods": {p.metadata.name: p.metadata.uid for p in pods},
                              "env": {p.metadata.name: pod_env(p) for p in pods}})
        return pods

    def beat_file(pod):
        attempt = cluster._attempts[("default", pod.metadata.name)]
        return os.path.join(cluster._log_dir, f"default__{pod.metadata.name}.{attempt}.hb")

    def durable_after(pod, step):
        """Wait while node 0's beat shows no durable step after ``step``."""
        path = beat_file(pod)

        def fresh():
            observe()
            got = (chip_smoke.read_json(path) or {}).get("checkpoint_step")
            return got is not None and (step is None or got > step)
        assert wait_for(fresh, 120), cluster.get_pod_log("default", pod.metadata.name)[-3000:]
        return chip_smoke.read_json(path)["checkpoint_step"]

    try:
        cluster.create_job(job)
        resumed = None
        for nodes, then in ((2, 1), (1, 2), (2, None)):
            pods = world(nodes)
            if then is None:
                break
            published = durable_after(pods[0], resumed)
            out["worlds"][-1]["published"] = published
            t0 = time.monotonic()
            client.scale("el", then)
            # The old world is gone before any pod of the new one runs.
            assert wait_for(lambda: (observe() or not any(
                p.metadata.uid in out["worlds"][-1]["pods"].values()
                for p in live_pods(cluster, "el"))), 60)
            out["worlds"][-1]["teardown_s"] = time.monotonic() - t0
            # What storage holds once the old world's ranks are dead: the
            # step the next world resumes from.
            time.sleep(0.5)
            resumed = max(chip_smoke.durable_steps(str(ckpt / "dcp")))
            out["worlds"][-1]["stored"] = resumed
        pace.write_text("0")
        out["succeeded"] = wait_for(lambda: observe() or job_condition(cluster, "el",
                                                                         "Succeeded"), 240)
        out["status"] = cluster.get_job("JAXJob", "default", "el")["status"]
        out["events"] = [(e.reason, e.message) for e in cluster.list_events("JAXJob/default/el")]
    finally:
        manager.stop()
        cluster.shutdown()
    # Every attempt's log, world by world (a deleted pod keeps its file).
    logs = {}
    for path in sorted(pathlib.Path(cluster._log_dir).glob("default__el-worker-*.log")):
        name, attempt = path.name[len("default__"):-len(".log")].rsplit(".", 1)
        logs[(name, int(attempt))] = path.read_text()
    attempts = {name: 0 for name in ("el-worker-0", "el-worker-1")}
    for w in out["worlds"]:
        w["logs"] = {}
        for name in sorted(w["pods"]):
            attempts[name] += 1
            w["logs"][name] = logs[(name, attempts[name])]
        text = "".join(w["logs"].values())
        w["losses"] = {}
        for process, step, loss in LOSS.findall(text):
            w["losses"].setdefault(int(process), {})[int(step)] = float(loss)
        w["resumed"] = re.findall(r"\[llama\] resumed from step (\d+) via (\S+) \((\S+)\)", text)
        w["done"] = chip_smoke.done_lines(text)
    # The unresized run: one process, all the steps, the same global batch.
    previous, threads = llama.CONFIGS["llama-tiny"], torch.get_num_threads()
    llama.CONFIGS["llama-tiny"] = FP32_TINY
    torch.set_num_threads(1)  # as the pods' ranks run
    try:
        out["single"] = llama_train.run(llama_train.parse_args(args))["losses"]
    finally:
        llama.CONFIGS["llama-tiny"] = previous
        torch.set_num_threads(threads)
    return out


def test_the_job_shrinks_and_grows_through_the_operator(resized):
    assert resized["succeeded"], resized["status"]
    assert [w["nodes"] for w in resized["worlds"]] == [2, 1, 2]
    # Each resize stamps another generation (a hash of the world, so the
    # grown world's is the first's again) and replaces every pod.
    first, shrunk, grown = resized["generations"]
    assert first != shrunk != grown == first
    pods = [set(w["pods"].values()) for w in resized["worlds"]]
    assert not (pods[0] & pods[1] or pods[1] & pods[2] or pods[0] & pods[2])
    # No two worlds ever ran at once: the stale pods went in one batch.
    assert resized["mixed"] == []
    restarts = [m for r, m in resized["events"] if "Restarting" in r]
    assert any("(2 stale pod(s))" in m for m in restarts), resized["events"]
    assert any("(1 stale pod(s))" in m for m in restarts), resized["events"]


def test_the_new_pods_carry_the_new_world(resized):
    first, shrunk, grown = resized["worlds"]
    for w, mesh in ((first, {"slice": 2, "fsdp": 2}), (shrunk, {"slice": 1, "fsdp": 2}),
                    (grown, {"slice": 2, "fsdp": 2})):
        for node, name in enumerate(sorted(w["env"])):
            env = w["env"][name]
            assert env["JAX_NUM_PROCESSES"] == str(w["nodes"])
            assert env["JAX_NUM_SLICES"] == str(w["nodes"])
            assert env["JAX_PROCESS_ID"] == env["JAX_SLICE_INDEX"] == str(node)
            assert json.loads(env["JAX_MESH_SPEC"]) == mesh
        log = "".join(w["logs"].values())
        world = 2 * w["nodes"]
        assert log.count(f"devices={world} mesh={mesh}") == world, log[-3000:]
    # The grow is a warm-start grow; the shrink is not.
    assert all(e.get(heartbeat.ENV_WARM_START) == "1" for e in grown["env"].values())
    assert all(heartbeat.ENV_WARM_START not in e for e in shrunk["env"].values())


def test_every_rank_resumes_at_a_durable_step(resized):
    first, shrunk, grown = resized["worlds"]
    assert first["resumed"] == []
    for before, w in ((first, shrunk), (shrunk, grown)):
        world = 2 * w["nodes"]
        steps = {int(s) for s, _, _ in w["resumed"]}
        assert len(w["resumed"]) == world and steps == {before["stored"]}, w["resumed"]
        assert before["stored"] >= before["published"] and before["stored"] % EVERY == 0
        assert {path for _, path, _ in w["resumed"]} == {"storage"}


def test_a_warm_start_grow_falls_to_storage_with_its_cause_named(resized):
    """The grown world's peers are the shrunk world's: node 1's pod is
    given the old node 0's address, whose server ended with its pod (the
    process backend's delete), and node 0's pod none (its predecessor's
    own server is excluded). Every rank takes the storage rung at the
    stored step, each with the one cause the world names: what node 1's
    ranks met, not node 0's lack of peers."""
    grown = resized["worlds"][2]
    assert grown["env"]["el-worker-1"][heartbeat.ENV_PEER_RESTORE_ADDRS]
    assert not grown["env"]["el-worker-0"].get(heartbeat.ENV_PEER_RESTORE_ADDRS)
    assert [c for _, _, c in grown["resumed"]] == ["peer-unreachable"] * 4, grown["resumed"]
    runs = grown["done"]
    assert sorted(runs) == [0, 1, 2, 3]
    for r in runs.values():
        assert (r["restore"]["path"], r["restore"]["cause"]) == ("storage", "peer-unreachable")
        assert r["restore"]["step"] == resized["worlds"][1]["stored"]


@pytest.mark.parametrize("causes,want", [
    (["no-peers", "no-peers", "peer-unreachable", "peer-unreachable"], "peer-unreachable"),
    (["no-peers", "peer-shard-mismatch"], "peer-shard-mismatch"),
    (["peer-unreachable", "peer-shard-mismatch"], "peer-unreachable"),
    (["no-peers", "no-peers"], "no-peers"),
])
def test_a_worlds_vote_names_what_its_peers_did(causes, want, monkeypatch):
    """A rank given no address has nothing to report: the world's cause
    is the lowest rank's that names what a peer did, else ``no-peers``;
    the same in the step's agreement and in the vote."""
    gate = restore.WorldGate()
    monkeypatch.setattr(gate, "_gather", lambda item: [(None, c) for c in causes])
    assert gate.agree(None, causes[0]) == (None, want, False)
    monkeypatch.setattr(gate, "_gather", lambda item: [(False, None, c) for c in causes])
    assert gate(False, None, causes[0]) == (False, want)


@pytest.mark.parametrize("same_world", [False, True])
def test_a_peer_of_another_world_is_refused_under_warm_start(tmp_path, monkeypatch, same_world):
    """The port has no peer restore across world sizes: a warm-start
    rank (no storage probe) of a 4-rank world offered the shards of a
    rank of a 2-rank world restores from storage with the cause named;
    offered its own world's shards, it takes them from the peer."""
    from tf_operator_tpu_torch.runtime.shard_server import start_shard_server

    old = {"rank": 0, "world": 2, "mesh": {"slice": 1, "fsdp": 2}}
    new = {"rank": 0, "world": 4, "mesh": {"slice": 2, "fsdp": 2}}
    survivor = CheckpointManager(str(tmp_path / "survivor"))
    survivor._snapshot = checkpoint.take_snapshot(tiny_state(seed=1, step=8), 8, None, old)
    server = start_shard_server(survivor)
    own = CheckpointManager(str(tmp_path / "own"))
    monkeypatch.setattr(checkpoint, "shard_identity", lambda state: old if same_world else new)
    try:
        own.save(tiny_state(seed=2, step=6))
        own.wait()
        out = restore.restore_with_fallback(tiny_state(seed=3), own, [server.address],
                                            sharded=True, warm_start=True,
                                            sleep=lambda s: None)
    finally:
        server.stop()
        survivor.close()
        own.close()
    want = ("peer-sharded", "ok", 8) if same_world else ("storage", "peer-shard-mismatch", 6)
    assert (out.path, out.cause, out.step) == want


# ------------------------------------------------------------------ the gates
def test_the_shrink_gate_never_credits_a_non_durable_step_of_the_ports(tmp_path):
    """The counterpart of ``tests/test_checkpoint_recovery.py``
    ``test_autoscaler_gate_never_sees_a_non_durable_step``, through the
    operator's autoscaler: the leases of an elastic ``gpu_job``'s pods
    carry what the port's heartbeat publishes, fed by the port's
    CheckpointManager's durability listener (``llama_train.recover``). A
    step whose persist died is snapshotted but never published, and the
    shrink under queue pressure waits for the next durable step."""
    inner, controller, adm, scaler, clk, metrics, tracer = make_harness(
        capacity={"pods": "4"})
    inner.create_job(gpu.gpu_job("e0", "JAXJob", 3, TRAIN, gpus_per_node=1, elastic=(1, 4)))
    settle(controller, clk, ["e0"])
    pods = running_workers(inner, "e0")
    assert len(pods) == 3
    inner.create_job(rigid_manifest("r0", workers=2))  # queues: 1 pod free
    settle(controller, clk, ["e0", "r0"])
    assert running_workers(inner, "r0") == []

    def sink(seq, step, tokens_per_sec, checkpoint_step, peer_addr, restore_, name):
        assert heartbeat.publish_heartbeat(
            inner, "default", constants.heartbeat_lease_name(name), name, step=step,
            tokens_per_sec=tokens_per_sec, checkpoint_step=checkpoint_step)

    riders = [heartbeat.HeartbeatPublisher(lambda *a, name=n: sink(*a, name=name), 60.0)
              for n in pods]

    def beat(step):
        for rider in riders:
            rider.record_progress(step=step, tokens_per_sec=600.0)
            rider.beat_once()

    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        for rider in riders:
            mgr.add_durability_listener(rider.record_checkpoint)
        mgr.save(tiny_state(step=5))
        mgr.wait()
        beat(6)
        scaler.tick()  # the proposal, against durable step 5
        assert inner.get_job("JAXJob", "default", "e0")["spec"]["numSlices"] == 3
        mgr._persist_gate = lambda step: (_ for _ in ()).throw(OSError("persist crashed"))
        mgr.save(tiny_state(step=10))
        mgr.wait()
        assert mgr.host_snapshot().step == 10 and mgr.last_durable_step() == 5
        beat(11)
        clk.advance(1.0)
        assert scaler.tick() == []
        assert inner.get_job("JAXJob", "default", "e0")["spec"]["numSlices"] == 3
        assert metrics.labeled_counter_value(
            "training_operator_autoscaler_blocked_shrinks_total", "no-fresh-checkpoint") >= 1
        mgr._persist_gate = None
        mgr.save(tiny_state(step=15))
        mgr.wait()
        beat(16)
        clk.advance(1.0)
        applied = scaler.tick()
    assert [r.direction for r in applied] == ["shrink"]
    assert scaler.snapshot()["resize_ledger"][-1]["credited_checkpoint"] == 15
    assert inner.get_job("JAXJob", "default", "e0")["spec"]["numSlices"] == 2
    settle(controller, clk, ["e0", "r0"])
    assert len(running_workers(inner, "e0")) == 2 and len(running_workers(inner, "r0")) == 2


def test_a_warm_start_grow_of_a_gpu_job_reaches_every_local_rank():
    """The counterpart of ``tests/test_recovery_chaos.py``
    ``TestWarmStartGrow`` for a ``gpu_job``: a grow from 1 node to 2 by
    ``JobClient.scale`` injects ``TPU_WARM_START`` (with the sharded
    restore and the shard server) into both pods until the grown world is
    present, node 1's pod gets the survivor's address the port's
    heartbeat published, and the launcher hands all of it, with the new
    world's ranks, to every local rank."""
    inner = InMemoryCluster()
    controller = JAXController(inner, options=EngineOptions(
        peer_restore=True, sharded_restore=True, warm_start=True))
    job = gpu.gpu_job("wg", "JAXJob", 1, TRAIN, gpus_per_node=2, elastic=(1, 2))
    job["spec"]["runPolicy"] = {"progressDeadlineSeconds": 300}  # the heartbeat's sweep
    inner.create_job(job)
    controller.run_until_idle()
    (pod,) = inner.list_pods("default")
    inner.set_pod_phase("default", pod.metadata.name, "Running")
    assert heartbeat.publish_heartbeat(
        inner, "default", constants.heartbeat_lease_name(pod.metadata.name),
        pod.metadata.name, step=40, tokens_per_sec=10.0, checkpoint_step=40,
        peer_addr="10.0.0.7:8470")
    controller.queue.add("JAXJob:default/wg")
    controller.run_until_idle()
    JobClient(inner, kind="JAXJob").scale("wg", 2)
    pods = []
    for _ in range(100):
        controller.run_until_idle()
        pods = sorted((p for p in inner.list_pods("default", labels={"job-name": "wg"})
                       if p.metadata.deletion_timestamp is None),
                      key=lambda p: p.metadata.name)
        if len(pods) == 2:
            break
        controller.queue.add("JAXJob:default/wg")
        time.sleep(0.002)
    assert [p.metadata.name for p in pods] == ["wg-worker-0", "wg-worker-1"]
    envs = [pod_env(p) for p in pods]
    assert envs[1][heartbeat.ENV_PEER_RESTORE_ADDRS] == "10.0.0.7:8470"
    assert not envs[0].get(heartbeat.ENV_PEER_RESTORE_ADDRS)  # its own predecessor's
    for node, env in enumerate(envs):
        for local in range(2):
            child = launch.rank_env(env, local, 2, shard_server_port=4000)
            for key in (heartbeat.ENV_WARM_START, heartbeat.ENV_SHARDED_RESTORE,
                        heartbeat.ENV_SHARD_SERVER):
                assert child[key] == "1"
            assert child.get(heartbeat.ENV_PEER_RESTORE_ADDRS) == env.get(
                heartbeat.ENV_PEER_RESTORE_ADDRS)
            topo = gpu_init.topology_from_env(child)
            assert (topo.num_processes, topo.process_id) == (4, 2 * node + local)
            assert gpu_init.mesh_axes_for(topo, 4, "cuda") == {"slice": 2, "fsdp": 2}
    assert controller.engine._warm_start_pending
    for p in pods:
        inner.set_pod_phase("default", p.metadata.name, "Running")
    controller.queue.add("JAXJob:default/wg")
    controller.run_until_idle()
    assert not controller.engine._warm_start_pending


def test_a_grow_beyond_gpu_capacity_queues_then_admits_at_its_new_size():
    """The counterpart of ``tests/test_autoscaler.py``
    ``test_flat_grow_beyond_headroom_queues`` with GPU capacity: an
    elastic 1-node ``gpu_job`` of 8 H100s beside a fixed one fills
    ``--capacity nvidia.com/gpu@h100=16``; its grow to 2 nodes waits at the
    gate (the fixed job untouched, nothing preempted) and is admitted at
    16 GPUs when the fixed job's pods end."""
    argv = ["--enable-scheme", "JAXJob", "--enable-gang-admission",
            "--capacity", "nvidia.com/gpu@h100=16"]
    cluster = InMemoryCluster()
    manager = OperatorManager(cluster, options_from_args(build_arg_parser().parse_args(argv)),
                              metrics=Metrics())
    ctrl = manager.controllers["JAXJob"]
    cluster.create_job(gpu.gpu_job("el", "JAXJob", 1, TRAIN, elastic=(1, 2)))
    cluster.create_job(gpu.gpu_job("fixed", "JAXJob", 1, TRAIN))

    def drive(end=None):
        for _ in range(6):
            ctrl.run_until_idle()
            for p in cluster.list_pods("default"):
                if p.status.phase == "Pending":
                    cluster.set_pod_phase("default", p.metadata.name, "Running")
                elif end and p.metadata.name.startswith(end) and p.status.phase == "Running":
                    cluster.set_pod_phase("default", p.metadata.name, "Succeeded", exit_code=0)
            ctrl.queue.add("JAXJob:default/el")
        return (sorted(p.metadata.name for p in cluster.list_pods("default")
                       if p.status.phase == "Running" and p.metadata.deletion_timestamp is None),
                manager.debug_snapshot()["admission"])

    running, snap = drive()
    assert running == ["el-worker-0", "fixed-worker-0"]
    JobClient(cluster, kind="JAXJob").scale("el", 2)
    running, snap = drive()
    assert running == ["fixed-worker-0"]
    assert [(g["key"], g["blocked_on"]) for g in snap["waiting"]] == [
        ("JAXJob:default/el", "capacity")]
    el = cluster.get_job("JAXJob", "default", "el")
    assert any(c["type"] == "Queued" and c["status"] == "True"
               for c in el["status"]["conditions"])
    assert not manager.debug_snapshot()["admission"].get("preemptions")
    running, snap = drive(end="fixed-")
    assert running == ["el-worker-0", "el-worker-1"] and not snap["waiting"]
    (admitted,) = snap["admitted"]
    assert (admitted["key"], admitted["demand"]["nvidia.com/gpu"]) == ("JAXJob:default/el", "16")


def test_the_one_card_resize_queues_and_admits_as_chip_smoke_runs_it():
    """``chip_smoke.py`` phase t on the memory backend: an elastic 1-node x
    1-card ``gpu_job`` under ``--capacity nvidia.com/gpu@h100=1``. Its pod
    has ``chip_smoke.elastic_env``'s world; ``scale()`` to 2 nodes deletes
    it and leaves the job waiting at the gate with no pod; ``scale()``
    back to 1 admits it, and its new pod has the same world."""
    argv = ["--enable-scheme", "JAXJob", "--enable-gang-admission",
            "--capacity", "nvidia.com/gpu@h100=1"]
    cluster = InMemoryCluster()
    manager = OperatorManager(cluster, options_from_args(build_arg_parser().parse_args(argv)),
                              metrics=Metrics())
    ctrl = manager.controllers["JAXJob"]
    job = gpu.gpu_job("elastic", "JAXJob", 1, TRAIN, gpus_per_node=1, elastic=(1, 2))
    job["spec"]["runPolicy"] = {"progressDeadlineSeconds": 300}  # the beat file
    cluster.create_job(job)
    client = JobClient(cluster, kind="JAXJob")

    def drive():
        for _ in range(6):
            ctrl.run_until_idle()
            for p in cluster.list_pods("default"):
                if p.status.phase == "Pending":
                    cluster.set_pod_phase("default", p.metadata.name, "Running")
            ctrl.queue.add("JAXJob:default/elastic")
        return live_pods(cluster, "elastic")

    def world(pod):
        """The pod's JAXJob contract: ``chip_smoke.node_env(1, 0, 1)``, the
        env ``chip_smoke.elastic_env`` starts from."""
        got, want = pod_env(pod), chip_smoke.node_env(1, 0, 1, 1234)
        hosts = ("JAX_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES")
        assert {k: got[k] for k in want if k not in hosts} == {
            k: v for k, v in want.items() if k not in hosts}
        assert heartbeat.ENV_HEARTBEAT_LEASE in got
        return got

    (pod,) = drive()
    first = world(pod)
    client.scale("elastic", 2)
    assert drive() == []
    snap = manager.debug_snapshot()["admission"]
    assert [(g["key"], g["blocked_on"], g["demand"]["nvidia.com/gpu"])
            for g in snap["waiting"]] == [("JAXJob:default/elastic", "capacity", "2")]
    client.scale("elastic", 1)
    (pod,) = drive()
    assert world(pod) == first
    assert not manager.debug_snapshot()["admission"]["waiting"]


# -------------------------------------------------------- slice-local worlds
def test_a_slice_local_job_shrunk_to_one_slice_reads_the_root_in_both_packages(tmp_path):
    """A finding, recorded and not fixed: a slice-local job (each slice its
    own world and its own ``slice-<i>/`` stream) shrunk to one slice is no
    longer slice-local in either package, since both parses need more
    than one slice; the port's ``llama_train.checkpoint_stream`` and the
    JAX example's ``ckpt_dir`` (``examples/jax/llama/llama_train.py``:
    ``slice-<i>`` only while ``slice_world and num_slices > 1``) then read
    the checkpoint root, where neither slice saved: the shrunk job starts
    from step 0 in both."""
    cluster = InMemoryCluster()
    ctrl = JAXController(cluster, options=EngineOptions())
    cluster.create_job(gpu.gpu_job(
        "sl", "JAXJob", 2, TRAIN, gpus_per_node=2, mesh={"fsdp": 2}, elastic=(1, 2),
        template={"spec": {"containers": [{"name": "jax", "env": [
            {"name": "JAX_SLICE_LOCAL_WORLD", "value": "1"}]}]}}))
    ctrl.run_until_idle()
    streams = {}
    for nodes in (2, 1):
        if nodes == 1:
            JobClient(cluster, kind="JAXJob").scale("sl", 1)
            for _ in range(4):
                ctrl.run_until_idle()
        pods = sorted((p for p in cluster.list_pods("default")
                       if p.metadata.deletion_timestamp is None), key=lambda p: p.metadata.name)
        assert len(pods) == nodes
        for pod in pods:
            env = launch.rank_env(pod_env(pod), 0, 2)
            port, jax = gpu_init.topology_from_env(env), jax_topology_from_env(pod_env(pod))
            assert port.slice_world == jax.slice_world == (nodes > 1)
            jax_dir = (os.path.join("ckpt", f"slice-{jax.slice_index}")
                       if jax.slice_world and jax.num_slices > 1 else "ckpt")
            streams.setdefault(nodes, []).append(
                (llama_train.checkpoint_stream("ckpt", port), jax_dir))
    assert streams == {2: [("ckpt/slice-0", "ckpt/slice-0"), ("ckpt/slice-1", "ckpt/slice-1")],
                       1: [("ckpt", "ckpt")]}


def test_each_world_gives_the_unresized_runs_losses(resized):
    single = resized["single"]
    assert len(single) == STEPS and single[-1] < single[0] - 0.05
    for w in resized["worlds"]:
        for process, losses in w["losses"].items():
            assert losses, w["nodes"]
            steps = sorted(losses)
            assert steps == list(range(steps[0], steps[-1] + 1))
            np.testing.assert_allclose([losses[k] for k in steps],
                                       [single[k] for k in steps], rtol=1e-5)
        assert sorted(w["losses"]) == list(range(2 * w["nodes"]))
    grown = resized["worlds"][2]
    assert all(max(losses) == STEPS - 1 for losses in grown["losses"].values())
