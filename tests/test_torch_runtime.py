"""The port's runtime bootstrap (``runtime/gpu_init.py``, ``runtime/
heartbeat.py``) against the JAX package's, on the CPU: the same operator
env gives the same Topology in both packages, a PyTorchJob's c10d env is
read instead when present, and two processes launched with the env of the
JAX package's own ``bootstrap/jaxdist.gen_env`` rendezvous over gloo, each
proving liveness on its heartbeat file before the rendezvous returns."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from tf_operator_tpu.api.common import ReplicaSpec
from tf_operator_tpu.api.jaxjob import JAXJob, JAXJobSpec, TPUSpec, set_defaults
from tf_operator_tpu.api.k8s import Container, ObjectMeta, PodSpec, PodTemplateSpec
from tf_operator_tpu.api.pytorchjob import PyTorchJob, PyTorchJobSpec
from tf_operator_tpu.bootstrap import c10d, jaxdist
from tf_operator_tpu.bootstrap import heartbeat as jax_hb_env
from tf_operator_tpu.cluster.memory import InMemoryCluster
from tf_operator_tpu.core import constants
from tf_operator_tpu.runtime.tpu_init import topology_from_env as jax_topology_from_env
from tf_operator_tpu_torch.runtime import gpu_init, heartbeat
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jaxjob(replicas, tpu=None, num_slices=1, mesh=None):
    template = PodTemplateSpec(spec=PodSpec(containers=[Container(name="jax", image="img")]))
    job = JAXJob(
        metadata=ObjectMeta(name="tj", namespace="ns"),
        spec=JAXJobSpec(jax_replica_specs={"Worker": ReplicaSpec(replicas=replicas,
                                                                  template=template)},
                        tpu=tpu, num_slices=num_slices, mesh=mesh or {}))
    set_defaults(job)
    return job


def env_table():
    """Env dicts the operator injects, and variants a workload sets."""
    one = jaxjob(8, tpu=TPUSpec(accelerator_type="v5e-32"), mesh={"fsdp": 8, "tp": 4})
    multi = jaxjob(8, tpu=TPUSpec(accelerator_type="v5e-16"), num_slices=2)
    table = [{}, jaxdist.gen_env(one, "Worker", 5), jaxdist.gen_env(multi, "Worker", 6),
             jaxdist.gen_env(multi, "Worker", 1), jaxdist.gen_env(one, "Evaluator", 0)]
    for index in (2, 6):  # the slice-local remap, in both slices
        table.append({**jaxdist.gen_env(multi, "Worker", index),
                      gpu_init.ENV_SLICE_LOCAL_WORLD: "true"})
    table.append({jaxdist.ENV_NUM_PROCESSES: "not-a-number",
                  jaxdist.ENV_MESH_SPEC: "{broken json"})
    return table


@pytest.mark.parametrize("index", range(len(env_table())))
def test_topology_from_env_equals_jax(index):
    env = env_table()[index]
    got = dataclasses.asdict(gpu_init.topology_from_env(env))
    assert got == dataclasses.asdict(jax_topology_from_env(env))


def test_slice_local_remap():
    env = env_table()[6]
    topo = gpu_init.topology_from_env(env)
    assert topo.slice_world and topo.num_processes == 4 and topo.process_id == 2
    assert topo.coordinator_address.endswith(":%d" % (jaxdist.get_port(
        jaxjob(8, tpu=TPUSpec(accelerator_type="v5e-16"), num_slices=2)) + 1))


def test_env_names_match_the_operator_contract():
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MESH_SPEC",
                 "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "NUM_SLICES", "SLICE_INDEX"):
        assert getattr(gpu_init, "ENV_" + name) == getattr(jaxdist, "ENV_" + name)
    for name in ("LEASE", "NAMESPACE", "INTERVAL", "FILE"):
        assert (getattr(heartbeat, "ENV_HEARTBEAT_" + name)
                == getattr(jax_hb_env, "ENV_HEARTBEAT_" + name))
    assert heartbeat.ANNOTATION_HEARTBEAT_STEP == constants.ANNOTATION_HEARTBEAT_STEP
    assert heartbeat.ANNOTATION_HEARTBEAT_TPS == constants.ANNOTATION_HEARTBEAT_TPS


def test_c10d_env_is_read_instead():
    template = PodTemplateSpec(spec=PodSpec(containers=[Container(name="pytorch",
                                                                  image="img")]))
    job = PyTorchJob(metadata=ObjectMeta(name="pj", namespace="ns"),
                     spec=PyTorchJobSpec(pytorch_replica_specs={
                         "Master": ReplicaSpec(replicas=1, template=template),
                         "Worker": ReplicaSpec(replicas=3, template=template)}))
    env = c10d.gen_env(job, "Worker", 1)
    topo = gpu_init.c10d_topology_from_env({**env, jaxdist.ENV_MESH_SPEC: '{"tp": 2}'})
    assert (topo.num_processes, topo.process_id) == (4, 2)
    assert topo.coordinator_address == f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    assert topo.mesh_axes == {"tp": 2} and topo.distributed
    assert gpu_init.c10d_topology_from_env(jaxdist.gen_env(jaxjob(2), "Worker", 1)) is None
    assert gpu_init.local_device_index(topo, {"LOCAL_RANK": "3"}) == 3


def test_mesh_axes_rules():
    topo = gpu_init.Topology(mesh_axes={"fsdp": 2, "tp": 2})
    assert gpu_init.mesh_axes_for(topo, 4, "cuda") == {"fsdp": 2, "tp": 2}
    assert gpu_init.mesh_axes_for(gpu_init.Topology(), 4, "cuda") == {}
    multi = gpu_init.Topology(num_slices=2, mesh_axes={"fsdp": 2})
    assert gpu_init.mesh_axes_for(multi, 4, "cuda") == {"fsdp": 2, "slice": 2}
    # A size mismatch is refused on the card and falls back on the CPU.
    big = gpu_init.Topology(mesh_axes={"fsdp": 32})
    with pytest.raises(ValueError, match="declared mesh"):
        gpu_init.mesh_axes_for(big, 4, "cuda")
    with pytest.warns(UserWarning, match="falling back"):
        assert gpu_init.mesh_axes_for(big, 4, "cpu") == {}


def test_heartbeat_through_the_cluster_seam():
    cluster = InMemoryCluster()
    assert heartbeat.publish_heartbeat(cluster, "ns", "pod-hb", "pod", step=3,
                                       tokens_per_sec=12.5)
    assert heartbeat.publish_heartbeat(cluster, "ns", "pod-hb", "pod", step=4)
    lease = cluster.get_lease("ns", "pod-hb")
    assert lease["spec"]["holderIdentity"] == "pod"
    assert lease["metadata"]["annotations"] == {
        constants.ANNOTATION_HEARTBEAT_STEP: "4", constants.ANNOTATION_HEARTBEAT_TPS: "12.5"}
    env = {heartbeat.ENV_HEARTBEAT_LEASE: "pod-hb", heartbeat.ENV_HEARTBEAT_NAMESPACE: "ns",
           heartbeat.ENV_HEARTBEAT_INTERVAL: "0.05"}
    try:
        publisher = heartbeat.start_from_env(cluster=cluster, env=env)
        heartbeat.record_progress(step=9, tokens_per_sec=1.0)
        deadline = time.monotonic() + 10
        while (cluster.get_lease("ns", "pod-hb")["metadata"]["annotations"]
               [constants.ANNOTATION_HEARTBEAT_STEP] != "9"):
            assert time.monotonic() < deadline, "the renewal thread never published"
            time.sleep(0.02)
        assert publisher is heartbeat.start_from_env(cluster=cluster, env=env)
    finally:
        heartbeat.stop()
    assert heartbeat.start_from_env(env={}) is None


def test_recovery_riders_match_the_jax_package(tmp_path):
    """The checkpoint, peer-address and restore riders: the same env names,
    lease annotations and file-bridge keys as the JAX package's, and the
    same compact restore rider."""
    from tf_operator_tpu.runtime import heartbeat as jax_hb

    for name in ("SHARD_SERVER", "PEER_RESTORE_ADDRS", "SHARDED_RESTORE", "WARM_START",
                 "DELTA_PERSIST"):
        assert getattr(heartbeat, "ENV_" + name) == getattr(jax_hb_env, "ENV_" + name)
    riders = dict(step=7, tokens_per_sec=3.0, checkpoint_step=6, peer_addr="10.0.0.1:8470",
                  restore="peer:ok:0.412:1024")
    leases = []
    for module in (heartbeat, jax_hb):
        cluster = InMemoryCluster()
        assert module.publish_heartbeat(cluster, "ns", "pod-hb", "pod", **riders)
        leases.append(cluster.get_lease("ns", "pod-hb")["metadata"]["annotations"])
    assert leases[0] == leases[1]
    assert leases[0][constants.ANNOTATION_HEARTBEAT_CKPT] == "6"
    heartbeat.write_heartbeat_file(str(tmp_path / "beat"), 3, **riders)
    got = jax_hb.read_heartbeat_file(str(tmp_path / "beat"))
    assert {k: got[k] for k in riders} == riders and got["seq"] == 3
    seen = []
    ours = heartbeat.HeartbeatPublisher(lambda *payload: seen.append(payload), 60)
    theirs = jax_hb.HeartbeatPublisher(lambda *payload: seen.append(payload), 60)
    for publisher in (ours, theirs):
        publisher.record_progress(step=7, tokens_per_sec=3.0)
        publisher.record_checkpoint(6)
        publisher.record_peer_address("10.0.0.1:8470")
        publisher.record_peer_address(None)  # clears nothing
        publisher.record_restore("peer", "ok", 0.4123, 1024)
        publisher.beat_once()
    assert seen[0] == seen[1] == (1, 7, 3.0, 6, "10.0.0.1:8470", "peer:ok:0.412:1024")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous_from_the_operator_env(tmp_path):
    job = jaxjob(2)  # no declared mesh: the pure-fsdp default
    port = free_port()
    procs, beats = [], []
    try:
        for index in range(2):
            env = dict(jaxdist.gen_env(job, "Worker", index))
            # The service name resolves in a cluster; here both run on one host.
            env[jaxdist.ENV_COORDINATOR_ADDRESS] = f"127.0.0.1:{port}"
            beat = tmp_path / f"hb{index}.json"
            env.update({heartbeat.ENV_HEARTBEAT_LEASE: f"tj-worker-{index}-hb",
                        heartbeat.ENV_HEARTBEAT_FILE: str(beat),
                        heartbeat.ENV_HEARTBEAT_INTERVAL: "0.1"})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tf_operator_tpu_torch.testing.rendezvous_workload",
                 "--device", "cpu", "--timeout", "60"],
                cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1", **env},
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            beats.append(beat)
            if index == 0:
                # Rank 0 blocks in the rendezvous until rank 1 exists: its
                # beat must land while it waits.
                deadline = time.monotonic() + 60
                while not beat.exists():
                    assert procs[0].poll() is None, procs[0].communicate()[0]
                    assert time.monotonic() < deadline, "no heartbeat before the rendezvous"
                    time.sleep(0.05)
                assert procs[0].poll() is None
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out, beat in zip(procs, outs, beats):
        assert p.returncode == 0, out
        assert "[rendezvous] OK" in out and "sum=3.0 want=3.0" in out
        assert "mesh={'fsdp': 2} axes_product=2.0" in out
        assert json.loads(beat.read_text())["seq"] >= 1
