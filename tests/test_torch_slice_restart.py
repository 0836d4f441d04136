"""Slice-local worlds through the per-node launcher, a slice restarted
alone, and GPU admission capacity, on the CPU.

- The parse: the env the operator gives the pods of a 2-slice JAXJob of 2
  hosts a slice with ``JAX_SLICE_LOCAL_WORLD=1`` in its template, through
  the JAX package's ``topology_from_env`` and the port's: field for field
  equal with no launcher variables; under the launcher (``LOCAL_WORLD_SIZE``
  2) the port's slice world is the JAX one scaled, 2 slices x 2 hosts x 2
  local ranks, every rank, and the global ``JAX_PROCESS_ID`` the launcher
  writes never reaches it.
- The launcher: a slice-local pod's ranks (no longer refused), the shard
  server's ports, and its children dying with it.
- Admission: two 2-node ``gpu_job`` JAXJobs of 8 H100s a node against
  ``--capacity nvidia.com/gpu@h100=16`` through ``options_from_args``.
- The counterpart of ``tests/test_e2e_process.py``
  ``TestSliceLocalGangRestart`` (one fixture, the process backend): a
  2-slice JAXJob of launcher pods, ``--nproc-per-node 2`` of llama-tiny a
  slice, slice 1's pod killed; the operator restarts slice 1 alone, slice
  0's pods keep their UIDs, ``sliceRestartCounts == {"1": 1}``, and slice 1
  resumes from its own ``slice-1/`` stream (DCP). The step a pod published
  as durable is one that both of its ranks' shards hold.

Every subprocess runs one OpenMP thread.
"""

import dataclasses
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from chip_smoke import durable_steps
from tf_operator_tpu.cli import OperatorManager, OperatorOptions, build_arg_parser, \
    options_from_args
from tf_operator_tpu.cluster.memory import InMemoryCluster
from tf_operator_tpu.cluster.process import LocalProcessCluster
from tf_operator_tpu.controllers.jax import JAXController
from tf_operator_tpu.core.job_controller import EngineOptions
from tf_operator_tpu.metrics import Metrics
from tf_operator_tpu.runtime.tpu_init import topology_from_env as jax_topology_from_env
from tf_operator_tpu_torch.api import gpu
from tf_operator_tpu_torch.runtime import gpu_init, heartbeat, launch
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHILD_ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
SLICE_LOCAL = {"name": "JAX_SLICE_LOCAL_WORLD", "value": "1"}


def pod_envs(slice_local: bool):
    """The env of each pod of a JAXJob of 2 slices of 2 hosts (the memory
    backend), in pod order."""
    container = {"name": "jax", "image": "img", "command": ["python", "train.py"]}
    if slice_local:
        container["env"] = [SLICE_LOCAL]
    cluster = InMemoryCluster()
    ctrl = JAXController(cluster, options=EngineOptions())
    cluster.create_job({
        "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
        "metadata": {"name": "sl", "namespace": "default"},
        "spec": {"numSlices": 2, "mesh": {"fsdp": 4},
                 "jaxReplicaSpecs": {"Worker": {"replicas": 4, "template": {
                     "spec": {"containers": [container]}}}}}})
    ctrl.run_until_idle()
    pods = sorted(cluster.list_pods("default"),
                  key=lambda p: int(p.metadata.name.rsplit("-", 1)[1]))
    return [{e.name: e.value for e in p.spec.containers[0].env} for p in pods]


# ------------------------------------------------------------------ the parse
@pytest.mark.parametrize("slice_local", [True, False])
def test_without_the_launcher_the_parse_is_the_jax_packages(slice_local):
    envs = pod_envs(slice_local)
    assert len(envs) == 4
    for env in envs:
        assert dataclasses.asdict(gpu_init.topology_from_env(env)) == \
            dataclasses.asdict(jax_topology_from_env(env))
    if slice_local:
        assert {jax_topology_from_env(env).slice_world for env in envs} == {True}


def test_the_launcher_scales_each_slice_world_by_its_local_ranks():
    worlds = {}
    for pod, env in enumerate(pod_envs(True)):
        jax = jax_topology_from_env(env)
        for local in range(2):
            child = launch.rank_env(env, local, 2)
            # The launcher's global rank: pod * 2 + local, of 8.
            assert (child["JAX_NUM_PROCESSES"], child["JAX_PROCESS_ID"]) == (
                "8", str(2 * pod + local))
            topo = gpu_init.topology_from_env(child)
            assert topo.slice_world and topo.slice_index == jax.slice_index
            assert topo.num_processes == jax.num_processes * 2 == 4
            assert topo.process_id == jax.process_id * 2 + local == jax.worker_id * 2 + local
            assert topo.coordinator_address == jax.coordinator_address
            assert gpu_init.mesh_axes_for(topo, 4, "cuda") == {"fsdp": 4}  # no slice axis
            assert gpu_init.launch_note(topo, child) == (
                f"process {topo.process_id}/4 node {jax.worker_id} local rank {local}/2 "
                f"slice {jax.slice_index}/2")
            worlds.setdefault(topo.coordinator_address, []).append(topo.process_id)
    # One rendezvous a slice, on ports the slice index sets apart, each of
    # its 4 ranks once.
    assert len(worlds) == 2 and all(sorted(ids) == [0, 1, 2, 3] for ids in worlds.values())


def test_a_slice_world_declares_the_mesh_of_one_slice():
    env = launch.rank_env(pod_envs(True)[2], 1, 2)
    topo = gpu_init.topology_from_env({**env, "JAX_MESH_SPEC": '{"fsdp": 4}'})
    assert gpu_init.mesh_axes_for(topo, 4, "cuda") == {"fsdp": 4}
    # A declared slice axis is larger than the slice's world: refused on
    # the card, as the JAX package refuses it on a TPU.
    topo = gpu_init.topology_from_env({**env, "JAX_MESH_SPEC": '{"slice": 2, "fsdp": 4}'})
    with pytest.raises(ValueError, match="has 8 devices but the world has 4"):
        gpu_init.mesh_axes_for(topo, 4, "cuda")


# --------------------------------------------------------------- the launcher
def test_rank_env_of_a_slice_local_pod():
    env = {**pod_envs(True)[3], heartbeat.ENV_SHARD_SERVER: "1",
           heartbeat.ENV_HEARTBEAT_LEASE: "sl-worker-3-hb", heartbeat.ENV_HEARTBEAT_FILE: "/hb"}
    children = [launch.rank_env(env, local, 2, shard_server_port=4000) for local in range(2)]
    assert [c[heartbeat.ENV_SHARD_SERVER_PORT] for c in children] == ["4000", "4001"]
    assert heartbeat.ENV_HEARTBEAT_LEASE in children[0]
    assert heartbeat.ENV_HEARTBEAT_LEASE not in children[1]
    assert heartbeat.ENV_SHARD_SERVER_PORT not in launch.rank_env(env, 0, 2)
    block = launch.free_port_block(3)
    socks = []
    try:
        for port in range(block, block + 3):  # each binds, as the servers will
            socks.append(socket.socket())
            socks[-1].bind(("127.0.0.1", port))
    finally:
        for sock in socks:
            sock.close()


def test_a_killed_launcher_takes_its_children(tmp_path):
    env = {**os.environ, **CHILD_ENV, "JAX_COORDINATOR_ADDRESS": "h:1",
           "JAX_NUM_PROCESSES": "1", "JAX_PROCESS_ID": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.runtime.launch", "--nproc-per-node", "2",
         "--", sys.executable, "-c", "import os, time; print(os.getpid(), flush=True); "
         "time.sleep(120)", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        pids = [int(proc.stdout.readline()) for _ in range(2)]
        proc.send_signal(signal.SIGKILL)  # no handler sees it
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()

    def running(pid):
        try:
            with open(f"/proc/{pid}/status") as f:
                return "State:\tZ" not in f.read()
        except OSError:
            return False

    deadline = time.monotonic() + 10
    while any(running(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(running(p) for p in pids)


# ----------------------------------------------------------------- admission
TRAIN = ["python", "-m", "tf_operator_tpu_torch.train.llama_train"]


@pytest.mark.parametrize("granular", [False, True])
def test_gpu_capacity_admits_h100_jobs_while_their_gpus_fit(granular):
    argv = ["--enable-scheme", "JAXJob", "--enable-gang-admission",
            "--capacity", "nvidia.com/gpu@h100=16"]
    argv += ["--admission-slice-granularity"] if granular else []
    cluster = InMemoryCluster()
    manager = OperatorManager(cluster, options_from_args(build_arg_parser().parse_args(argv)),
                              metrics=Metrics())
    ctrl = manager.controllers["JAXJob"]
    for name in ("a", "b"):
        cluster.create_job(gpu.gpu_job(name, "JAXJob", 2, TRAIN))

    def drive(phase=None, prefix=""):
        for _ in range(4):
            ctrl.run_until_idle()
            for p in cluster.list_pods("default"):
                if p.status.phase == "Pending":
                    cluster.set_pod_phase("default", p.metadata.name, "Running")
        if phase:
            for p in cluster.list_pods("default"):
                if p.metadata.name.startswith(prefix):
                    cluster.set_pod_phase("default", p.metadata.name, phase, exit_code=0)
            drive()
        snap = manager.debug_snapshot()["admission"]
        running = sorted(p.metadata.name for p in cluster.list_pods("default")
                         if p.status.phase == "Running")
        return running, snap

    keys = ["#slice-0", "#slice-1"] if granular else [""]
    running, snap = drive()
    # Job a's 16 GPUs fill the h100 pool: its gangs are admitted (one
    # node's 8 at a time under slice granularity), b's all wait.
    assert running == ["a-worker-0", "a-worker-1"]
    assert sorted((g["key"], g["generation"], g["demand"]["nvidia.com/gpu"])
                  for g in snap["admitted"]) == sorted(
        (f"JAXJob:default/a{k}", "h100", "8" if granular else "16") for k in keys)
    assert sorted((g["key"], g["blocked_on"]) for g in snap["waiting"]) == sorted(
        (f"JAXJob:default/b{k}", "capacity") for k in keys)
    assert snap["generations"]["h100"]["usage"]["nvidia.com/gpu"] == "16"
    # When a's pods end, b's gangs are admitted into the freed GPUs.
    running, snap = drive("Succeeded", "a-")
    assert running == ["b-worker-0", "b-worker-1"] and not snap["waiting"]
    assert sorted(g["key"] for g in snap["admitted"]) == sorted(
        f"JAXJob:default/b{k}" for k in keys)


# ------------------------------------------- a slice restarted alone, e2e
def wait_for(predicate, timeout, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def job_condition(cluster, name, ctype):
    try:
        job = cluster.get_job("JAXJob", "default", name)
    except KeyError:
        return False
    return any(c["type"] == ctype and c["status"] == "True"
               for c in (job.get("status") or {}).get("conditions") or [])


@pytest.fixture(scope="module")
def slice_job(tmp_path_factory):
    """A 2-slice JAXJob of launcher pods (2 CPU ranks a slice, each slice a
    slice-local world over fsdp=2) on the process backend; slice 1's pod
    is killed once its pod has published a durable step."""
    ckpt = str(tmp_path_factory.mktemp("slice-restart") / "ckpt")
    cluster = LocalProcessCluster(child_env=CHILD_ENV)
    manager = OperatorManager(cluster, OperatorOptions(
        enabled_schemes=["JAXJob"], health_port=0, metrics_port=0, resync_period=0.2),
        metrics=Metrics())
    manager.start()
    command = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", "--device",
               "cpu", "--model", "llama-tiny", "--seq", "32", "--batch", "4", "--steps",
               "400", "--checkpoint-every", "20", "--log-every", "100", "--checkpoint-dir",
               ckpt]
    template = {"spec": {"containers": [{
        "name": "jax", "env": [SLICE_LOCAL],
        "ports": [{"name": "jaxjob-port", "containerPort": launch.free_port_block(2)}]}]}}
    names = ["slc-worker-0", "slc-worker-1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu, "PYTHON", sys.executable)  # this process's, not the image's
        job = gpu.gpu_job("slc", "JAXJob", 2, command, gpus_per_node=2, mesh={"fsdp": 2},
                          image="local", template=template)
    # A progress deadline turns the heartbeat on: the backend points it at a
    # beat file and bridges it to the pod's Lease.
    job["spec"]["runPolicy"] = {"progressDeadlineSeconds": 300}
    out = {"ckpt": ckpt, "names": names}
    try:
        cluster.create_job(job)
        beat = os.path.join(cluster._log_dir, f"default__{names[1]}.1.hb")

        def published():
            return (cluster_read(beat) or {}).get("checkpoint_step")

        assert wait_for(lambda: published() is not None, timeout=180), \
            cluster.get_pod_log("default", names[1])[-3000:]
        step = published()
        dcp = os.path.join(ckpt, "slice-1", "dcp", str(step))
        out["published"] = step
        out["dcp_files"] = sorted(os.listdir(dcp))
        out["uids"] = {n: cluster.get_pod("default", n).metadata.uid for n in names}
        cluster.kill_pod("default", names[1])  # the launcher; its ranks die with it
        # What each slice's stream held when slice 1 died: slice 1 restarts
        # from its own newest step, slice 0's runs on. The slices start in
        # either order, so slice 0 may not have saved yet: its stream is
        # then empty.
        time.sleep(1.0)
        out["streams"] = {i: durable_steps(os.path.join(ckpt, f"slice-{i}", "dcp"))
                          for i in range(2)}
        out["recreated"] = wait_for(lambda: recreated(cluster, out["uids"], names[1]),
                                    timeout=120)
        out["succeeded"] = wait_for(lambda: job_condition(cluster, "slc", "Succeeded"),
                                    timeout=240)
        out["failed"] = job_condition(cluster, "slc", "Failed")
        out["uids_after"] = {n: cluster.get_pod("default", n).metadata.uid for n in names}
        out["logs"] = {n: cluster.get_pod_log("default", n) for n in names}
        out["status"] = cluster.get_job("JAXJob", "default", "slc")["status"]
    finally:
        manager.stop()
        cluster.shutdown()
    return out


def cluster_read(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def recreated(cluster, uids, name):
    try:
        return cluster.get_pod("default", name).metadata.uid != uids[name]
    except KeyError:
        return False


def test_the_operator_restarts_the_killed_slice_alone(slice_job):
    assert slice_job["recreated"] and slice_job["succeeded"] and not slice_job["failed"], \
        slice_job["logs"]["slc-worker-1"][-3000:]
    before, after = slice_job["uids"], slice_job["uids_after"]
    assert after["slc-worker-0"] == before["slc-worker-0"]
    assert after["slc-worker-1"] != before["slc-worker-1"]


def test_one_slice_attributed_restart(slice_job):
    status = slice_job["status"]
    total = (sum(status.get("restartCounts", {}).values())
             + sum(status.get("disruptionCounts", {}).values()))
    assert total == 1, status
    assert status.get("sliceRestartCounts") == {"1": 1}, status


def test_the_restarted_slice_resumes_from_its_own_stream(slice_job):
    log = slice_job["logs"]["slc-worker-1"]
    resumed = re.findall(r"\[llama\] resumed from step (\d+) via storage \(ok\)", log)
    assert len(resumed) == 2, log[-3000:]  # both ranks of the recreated pod
    step = int(resumed[0])
    assert step >= slice_job["published"] and resumed == [str(step)] * 2
    assert step == slice_job["streams"][1][-1], slice_job["streams"]
    assert log.count("[gpu_init] process ") == 2 and "slice 1/2" in log
    assert log.count("[llama] done") == 2 and "[llama] step 399 loss" in log
    survivor = slice_job["logs"]["slc-worker-0"]
    assert "resumed" not in survivor and survivor.count("[llama] done") == 2


def test_the_published_durable_step_holds_every_ranks_shards(slice_job):
    # The pod's Lease carries local rank 0's durable step: its DCP save
    # has the metadata and both ranks' data.
    files = slice_job["dcp_files"]
    assert ".metadata" in files
    assert {f for f in files if f.endswith(".distcp")} == {"__0_0.distcp", "__1_0.distcp"}
