"""Throughput parity of the port across the operator's env, the twin of
``tests/test_throughput_parity.py``: a 2-process gloo world formed from the
env the operator injects into JAXJob pods (``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), its train state born sharded
over fsdp=2, must hold at least ``PARITY_MIN_RATIO`` of the per-device
throughput of one process training the same global batch, through
``tf_operator_tpu_torch.testing.parity_workload`` on the CPU.

The bound is the JAX test's CPU/gloo bound: on localhost sockets the
transport dominates a llama-tiny step, so the gate checks the wiring and
the order of magnitude, not a speed promise. Each process, the single
one too, gets one OpenMP thread: a second one spins while it waits. With
six busy processes on 8 cores, two threads made the 2-process step 229 ms
against 60 ms with one, while the single process kept its pace.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

PARITY_MIN_RATIO = 0.2  # the JAX test's CPU/gloo bound
STEPS, WARMUP, GLOBAL_BATCH, SEQ = 40, 3, 8, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _base_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # A stray operator env from the harness must not leak in.
    for key in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "JAX_NUM_SLICES", "JAX_SLICE_INDEX", "JAX_MESH_SPEC", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "TPU_HEARTBEAT_LEASE",
                "TPU_HEARTBEAT_FILE"):
        env.pop(key, None)
    return env


CMD = [sys.executable, "-m", "tf_operator_tpu_torch.testing.parity_workload", "--device",
       "cpu", "--steps", str(STEPS), "--warmup", str(WARMUP), "--global-batch",
       str(GLOBAL_BATCH), "--seq", str(SEQ)]


def _parse(returncode: int, out: str, err: str) -> dict:
    assert returncode == 0, f"parity workload rc={returncode}\n{out[-2000:]}\n{err[-2000:]}"
    return json.loads(out.strip().splitlines()[-1])


def test_two_process_world_holds_per_device_throughput():
    proc = subprocess.run(CMD, cwd=ROOT, env=_base_env(), capture_output=True, text=True,
                          timeout=120)
    single = _parse(proc.returncode, proc.stdout, proc.stderr)
    assert single["devices"] == 1 and single["num_processes"] == 1

    port = _free_port()
    procs = []
    try:
        for pid in (0, 1):
            env = _base_env()
            env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                        "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)})
            procs.append(subprocess.Popen(CMD, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=120) for p in procs]
        results = [_parse(p.returncode, *out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    multi = results[0]
    assert multi["devices"] == 2 and multi["num_processes"] == 2
    assert [r["process_id"] for r in results] == [0, 1]
    # Both processes time the same global steps and end on the same loss.
    assert results[1]["tokens_per_sec_chip"] == pytest.approx(multi["tokens_per_sec_chip"],
                                                              rel=0.5)
    assert results[1]["loss"] == multi["loss"]
    ratio = multi["tokens_per_sec_chip"] / single["tokens_per_sec_chip"]
    print(f"[parity] single={single['tokens_per_sec_chip']} tok/s/device "
          f"({single['step_ms']} ms/step) multi={multi['tokens_per_sec_chip']} "
          f"tok/s/device ({multi['step_ms']} ms/step) ratio={ratio:.3f}")
    assert ratio >= PARITY_MIN_RATIO, (
        f"2-process per-device throughput {multi['tokens_per_sec_chip']} is {ratio:.3f}x "
        f"of one process's {single['tokens_per_sec_chip']}, below the {PARITY_MIN_RATIO}x "
        f"CPU/gloo bound")
