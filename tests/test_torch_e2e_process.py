"""The port's flagship as an operator job: the process backend
(``LocalProcessCluster``) runs ``python -m tf_operator_tpu_torch.train.
llama_train --device cpu`` as live pods, under the env the operator
injects, as ``tests/test_e2e_process.py`` runs the JAX script:

- preemption and resume: a one-replica JAXJob SIGKILLed after its first
  durable checkpoint is recreated, resumes ``via storage`` and Succeeds;
  the heartbeat file the backend injected carried the durable step, and
  the file bridge put it on the pod's Lease;
- gang restart: a 2-replica JAXJob forms a gloo world from the JAX env,
  born sharded over fsdp=2 (its checkpoints go through DCP); one worker is
  killed, the operator restarts both, both resume and the job Succeeds;
- the c10d env: a PyTorchJob (Master + 1 Worker) reaches Succeeded through
  ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.

Workers run llama-tiny at seq 32 with one OpenMP thread each (a second one
spins while it waits, which starves the other pods on a loaded host), and
every job takes a free port, so that a test beside another process e2e
does not contend for a coordinator address.
"""

import json
import os
import re
import socket
import sys
import time

import pytest

from tf_operator_tpu.cli import OperatorManager, OperatorOptions
from tf_operator_tpu.cluster.process import LocalProcessCluster
from tf_operator_tpu.core import constants
from tf_operator_tpu.metrics import Metrics
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = {"PYTHONPATH": REPO_ROOT, "OMP_NUM_THREADS": "1"}
TRAIN = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", "--device", "cpu",
         "--model", "llama-tiny", "--seq", "32", "--batch", "4"]


def wait_for(predicate, timeout, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def harness():
    cluster = LocalProcessCluster(child_env=CHILD_ENV)
    manager = OperatorManager(
        cluster,
        OperatorOptions(enabled_schemes=["JAXJob", "PyTorchJob"], health_port=0,
                        metrics_port=0, resync_period=0.2),
        metrics=Metrics(),
    )
    manager.start()
    yield cluster
    manager.stop()
    cluster.shutdown()


def job_condition(cluster, kind, name, ctype):
    try:
        job = cluster.get_job(kind, "default", name)
    except KeyError:
        return False
    conds = (job.get("status") or {}).get("conditions") or []
    return any(c["type"] == ctype and c["status"] == "True" for c in conds)


def replica(n, container, command, port_name):
    return {"replicas": n, "template": {"spec": {"containers": [{
        "name": container, "image": "local", "command": command,
        "ports": [{"name": port_name, "containerPort": free_port()}]}]}}}


def jaxjob(name, workers, command, run_policy=None):
    spec = {"jaxReplicaSpecs": {"Worker": replica(workers, "jax", command, "jaxjob-port")}}
    if run_policy:
        spec["runPolicy"] = run_policy
    return {"apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def start_time(cluster, pod):
    try:
        return cluster.get_pod("default", pod).status.start_time
    except KeyError:
        return None


def pod_log(cluster, pod):
    return cluster.get_pod_log("default", pod)[-3000:]


def test_preempted_port_job_resumes_from_storage(harness, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    command = [*TRAIN, "--steps", "200", "--checkpoint-every", "25", "--log-every", "50",
               "--checkpoint-dir", ckpt]
    # progressDeadlineSeconds turns the heartbeat env on; the backend points
    # it at a beat file and bridges the beats onto the pod's Lease.
    harness.create_job(jaxjob("ck", 1, command, {"progressDeadlineSeconds": 120}))
    pod = "ck-worker-0"
    beat = os.path.join(harness._log_dir, f"default__{pod}.1.hb")

    def durable():
        manifests = [n for n in os.listdir(os.path.join(ckpt, "delta"))
                     if re.fullmatch(r"manifest-\d+\.json", n)] if os.path.isdir(
                         os.path.join(ckpt, "delta")) else []
        try:
            with open(beat) as f:
                published = json.load(f).get("checkpoint_step")
        except (OSError, ValueError):
            published = None
        return manifests and published is not None

    assert wait_for(durable, timeout=90), pod_log(harness, pod)
    with open(beat) as f:
        published = json.load(f)["checkpoint_step"]
    assert published % 25 == 0 and published < 200

    def on_lease():
        # The operator's view: the file bridge carries the durable step
        # onto the pod's heartbeat Lease.
        try:
            lease = harness.get_lease("default", f"{pod}-hb")
        except KeyError:
            return False
        annotations = lease["metadata"].get("annotations") or {}
        return int(annotations.get(constants.ANNOTATION_HEARTBEAT_CKPT, -1)) >= published

    assert wait_for(on_lease, timeout=30)
    first_start = start_time(harness, pod)
    harness.kill_pod("default", pod)
    assert wait_for(lambda: (start_time(harness, pod) or 0) > first_start, timeout=60), (
        "the pod was not recreated after the kill")
    assert wait_for(lambda: job_condition(harness, "JAXJob", "ck", "Succeeded"),
                    timeout=120), pod_log(harness, pod)
    log = harness.get_pod_log("default", pod)
    resumed = int(re.search(r"\[llama\] resumed from step (\d+) via storage \(ok\)", log)[1])
    assert resumed >= published and resumed % 25 == 0, log[-3000:]
    assert f"[llama] step 199 loss" in log and "[llama] done" in log
    assert not job_condition(harness, "JAXJob", "ck", "Failed")
    assert any("Restarting" in e.reason for e in harness.list_events("JAXJob/default/ck"))


def test_gang_kill_restarts_both_ranks_and_resumes_through_dcp(harness, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    command = [*TRAIN, "--steps", "100", "--checkpoint-every", "10", "--log-every", "50",
               "--checkpoint-dir", ckpt]
    harness.create_job(jaxjob("gang", 2, command))
    names = [f"gang-worker-{i}" for i in range(2)]
    dcp = os.path.join(ckpt, "dcp")

    def committed():
        return os.path.isdir(dcp) and any(
            os.path.exists(os.path.join(dcp, e, ".metadata")) for e in os.listdir(dcp))

    assert wait_for(committed, timeout=90), pod_log(harness, names[0])
    starts = {n: start_time(harness, n) for n in names}
    harness.kill_pod("default", names[1])
    assert wait_for(lambda: all((start_time(harness, n) or 0) > starts[n] for n in names),
                    timeout=60), "the gang restart did not recreate both workers"
    assert wait_for(lambda: job_condition(harness, "JAXJob", "gang", "Succeeded"),
                    timeout=120), pod_log(harness, names[0])
    for n in names:
        log = harness.get_pod_log("default", n)
        assert "devices=2 mesh={'fsdp': 2}" in log, log[-3000:]
        assert re.search(r"\[llama\] resumed from step \d+ via storage \(ok\)", log), log[-3000:]
        assert "[llama] done" in log
    assert not job_condition(harness, "JAXJob", "gang", "Failed")


def test_pytorchjob_c10d_env_runs_to_succeeded(harness):
    command = [*TRAIN, "--steps", "6", "--log-every", "5"]
    harness.create_job({
        "apiVersion": "kubeflow.org/v1", "kind": "PyTorchJob",
        "metadata": {"name": "pt", "namespace": "default"},
        "spec": {
            "pytorchReplicaSpecs": {
                "Master": replica(1, "pytorch", command, "pytorchjob-port"),
                "Worker": replica(1, "pytorch", command, "pytorchjob-port"),
            },
            # The master's exit completes the job; keep the worker's pod
            # (and its log) while it finishes.
            "runPolicy": {"cleanPodPolicy": "None"},
        },
    })
    pods = ["pt-master-0", "pt-worker-0"]
    assert wait_for(lambda: job_condition(harness, "PyTorchJob", "pt", "Succeeded"),
                    timeout=90), pod_log(harness, pods[0]) + pod_log(harness, pods[1])
    assert wait_for(lambda: all("[llama] done" in harness.get_pod_log("default", pod)
                                for pod in pods), timeout=60), pod_log(harness, pods[1])
    for rank, pod in enumerate(pods):
        log = harness.get_pod_log("default", pod)
        assert f"[llama] process {rank}/2 devices=2" in log, log[-3000:]
        assert "[llama] step 5 loss" in log
