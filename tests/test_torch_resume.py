"""Resume through the port's ``llama_train`` entry point on the CPU
(llama-tiny, a seeded token file):

- 6 steps uninterrupted against 3 steps and a resume to 6 in the same
  checkpoint directory: the same losses, and the final checkpoints hold
  byte-equal states (equal sha256 of every shard);
- saves every ``--checkpoint-every`` steps and at the end, with the
  durable step, the shard server's address and the restore outcome on
  the heartbeat file bridge;
- a subprocess run SIGKILLed once the heartbeat file bridge shows a
  durable checkpoint step, then rerun with the same arguments: it resumes
  from the newest durable step and prints the uninterrupted run's losses
  from there on;
- fsdp=2 over a 2-process gloo group (the harness of
  ``test_torch_sharding.py``): the sharded state takes the DCP branch,
  saves at steps 2 and 4 while training goes on (the save must stage
  before the next in-place update), and a rerun after the newer saves are
  lost resumes from step 2 with the uninterrupted run's losses;
- a DCP save starts only after the one before it has ended (a one-rank
  gloo group in this process, each save's end held back): two saves in
  flight run their collectives on two threads over one group, in orders
  that may differ between the ranks, which hung the fsdp=2 run under load.

``--warmup 6`` keeps the lr schedule the same for ``--steps 3`` and
``--steps 6`` (``decay_steps`` is max(steps, warmup + 1)), and a resumed run
is given the same ``--steps`` as the run it continues otherwise.
"""

import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Subprocesses run beside the suite's other workers: one OpenMP thread each.
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
ARGS = ["--device", "cpu", "--model", "llama-tiny", "--batch", "4", "--seq", "32",
        "--log-every", "1", "--lr", "3e-3", "--warmup", "6"]
STEP_LINE = re.compile(r"^\[llama\] step (\d+) loss (\S+) ", re.M)


@pytest.fixture(scope="module")
def tokens(tmp_path_factory):
    path = tmp_path_factory.mktemp("resume") / "tokens.bin"
    # Ids from 16 of the 256, so that the updates move the loss.
    data.write_token_file(str(path), np.random.default_rng(0).integers(
        0, 16, 200_000).astype(np.int32))
    return str(path)


def manifest(directory, step):
    with open(os.path.join(directory, "delta", f"manifest-{step}.json")) as f:
        return json.load(f)


def test_resume_gives_the_uninterrupted_losses_and_state(tokens, tmp_path):
    base = [*ARGS, "--data", tokens]
    whole = llama_train.run(llama_train.parse_args(
        [*base, "--steps", "6", "--checkpoint-dir", str(tmp_path / "u")]))
    first = llama_train.run(llama_train.parse_args(
        [*base, "--steps", "3", "--checkpoint-dir", str(tmp_path / "r")]))
    assert first["restore"].path == "none" and first["ckpt"].last_durable_step() == 3
    second = llama_train.run(llama_train.parse_args(
        [*base, "--steps", "6", "--checkpoint-dir", str(tmp_path / "r")]))
    out = second["restore"]
    assert (out.path, out.cause, out.step, second["start_step"]) == ("storage", "ok", 3, 3)
    assert first["losses"] + second["losses"] == whole["losses"]
    assert whole["losses"][-1] < whole["losses"][0] - 0.1  # the updates moved the weights
    # Byte-equal final states: every shard hashes the same.
    assert manifest(tmp_path / "u", 6)["shards"] == manifest(tmp_path / "r", 6)["shards"]
    assert second["save_seconds"] and second["ckpt"].last_persist_info["step"] == 6


def test_checkpoint_every_and_the_heartbeat_rider(tokens, tmp_path, monkeypatch):
    """Saves every 2 steps and at the end; the durable step reaches the
    file bridge only through the durability listener."""
    from tf_operator_tpu_torch.runtime import heartbeat

    beat = tmp_path / "beat.json"
    for key, value in (("TPU_HEARTBEAT_LEASE", "w-0-hb"), ("TPU_HEARTBEAT_FILE", str(beat)),
                       ("TPU_HEARTBEAT_INTERVAL_SECONDS", "0.05"), ("TPU_SHARD_SERVER", "1")):
        monkeypatch.setenv(key, value)
    heartbeat.stop()
    try:
        out = llama_train.run(llama_train.parse_args(
            [*ARGS, "--data", tokens, "--steps", "5", "--checkpoint-every", "2",
             "--checkpoint-dir", str(tmp_path / "c")]))
        heartbeat._active.beat_once()
    finally:
        heartbeat.stop()
    assert len(out["save_seconds"]) == 3
    payload = json.loads(beat.read_text())
    assert payload["checkpoint_step"] == 5 and payload["step"] == 4
    assert payload["restore"].startswith("none:no-peers:")
    assert re.fullmatch(r"127\.0\.0\.1:\d+", payload["peer_addr"])
    steps = sorted(int(p.stem.split("-")[1])
                   for p in (tmp_path / "c" / "delta").glob("manifest-*.json"))
    assert steps == [2, 4, 5]


def step_losses(text):
    return {int(step): loss for step, loss in STEP_LINE.findall(text)}


def test_sigkill_then_rerun_resumes_from_the_durable_step(tokens, tmp_path):
    argv = [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *ARGS,
            "--data", tokens, "--steps", "40", "--batch", "8", "--seq", "64",
            "--checkpoint-every", "2"]
    ckpt = ["--checkpoint-dir", str(tmp_path / "c")]
    beat = tmp_path / "beat.json"
    env = {**CHILD_ENV, "TPU_HEARTBEAT_LEASE": "w-0-hb", "TPU_HEARTBEAT_FILE": str(beat),
           "TPU_HEARTBEAT_INTERVAL_SECONDS": "0.05"}
    reference = subprocess.Popen(argv, cwd=ROOT, env=CHILD_ENV, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
    victim = subprocess.Popen([*argv, *ckpt], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 180
        seen = None
        while seen is None and victim.poll() is None and time.monotonic() < deadline:
            try:
                seen = json.loads(beat.read_text()).get("checkpoint_step")
            except (OSError, ValueError):
                pass
            time.sleep(0.01)
        victim.send_signal(signal.SIGKILL)
        killed = victim.communicate(timeout=60)[0]
        assert seen is not None and victim.returncode == -signal.SIGKILL, killed
        ref = step_losses(reference.communicate(timeout=240)[0])
    finally:
        for p in (reference, victim):
            if p.poll() is None:
                p.kill()
    assert sorted(ref) == list(range(40))
    done = max(step_losses(killed))
    assert done < 39, "the run ended before the kill"
    rerun = subprocess.run([*argv, *ckpt], cwd=ROOT, env=CHILD_ENV, capture_output=True,
                           text=True, timeout=240)
    assert rerun.returncode == 0, rerun.stderr
    resumed = int(re.search(r"resumed from step (\d+) via storage \(ok\)", rerun.stdout)[1])
    # The newest durable step: at least the one the rider published, and
    # no step the killed run had not finished.
    assert seen <= resumed <= done + 1 and resumed % 2 == 0
    losses = step_losses(rerun.stdout)
    assert sorted(losses) == list(range(resumed, 40))
    assert losses == {s: ref[s] for s in losses}


# ---------------------------------------------------------- fsdp=2, DCP
WORKER = r"""
import dataclasses, json, os, shutil, sys
import torch, torch.distributed as dist
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32)
from tf_operator_tpu_torch.train import llama_train

out_path, ckpt, args = sys.argv[1], sys.argv[2], sys.argv[3:]
run = lambda extra: llama_train.run(llama_train.parse_args([*args, *extra]))
whole = run(["--steps", "5"])
first = run(["--steps", "5", "--checkpoint-every", "2", "--checkpoint-dir", ckpt])
listing = sorted(os.listdir(ckpt))
dist.barrier()
if dist.get_rank() == 0:  # the newer saves are lost
    for step in ("4", "5"):
        shutil.rmtree(os.path.join(ckpt, "dcp", step))
dist.barrier()
second = run(["--steps", "5", "--checkpoint-dir", ckpt])
out = second["restore"]
result = {"whole": whole["losses"], "first": first["losses"], "second": second["losses"],
          "restore": [out.path, out.cause, out.step], "listing": listing,
          "snapshot": first["ckpt"].host_snapshot() is None,
          "durable": first["ckpt"].last_durable_step(), "start": second["start_step"]}
with open(out_path + ".%d" % dist.get_rank(), "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
"""


def test_fsdp2_saves_and_restores_through_dcp(tokens, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = {**CHILD_ENV, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                   "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank),
                   "JAX_MESH_SPEC": '{"fsdp": 2}'}
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(tmp_path / "out"), str(tmp_path / "c"),
                 *ARGS, "--data", tokens], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    for rank in range(2):
        r = json.loads((tmp_path / f"out.{rank}").read_text())
        assert r["listing"] == ["dcp", "model_meta.json"]  # no manifest store
        assert r["snapshot"] and r["durable"] == 5  # no host snapshot when sharded
        assert r["first"] == r["whole"]
        assert r["restore"] == ["storage", "ok", 2] and r["start"] == 2
        assert r["second"] == r["whole"][2:]
        assert r["whole"][-1] < r["whole"][0] - 0.05
    assert sorted(os.listdir(tmp_path / "c" / "dcp")) == ["2", "5"]


def test_a_dcp_save_waits_for_the_one_before(tokens, tmp_path, monkeypatch):
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from tf_operator_tpu_torch.train import checkpoint

    real, futures, in_flight = dcp.async_save, [], []

    def held(*args, **kwargs):
        """The real save, its future completed 1.5 s after it ends: longer
        than a step, so that the next save comes while it is pending."""
        in_flight.append(sum(not f.done() for f in futures))
        inner, outer = real(*args, **kwargs), Future()

        def finish():
            time.sleep(1.5)
            exc = inner.exception()
            outer.set_exception(exc) if exc else outer.set_result(inner.result())
        threading.Thread(target=finish, daemon=True).start()
        futures.append(outer)
        return outer

    monkeypatch.setattr(dcp, "async_save", held)
    # A one-rank FSDP2 state taken down the DCP branch as a sharded one.
    monkeypatch.setattr(checkpoint, "is_sharded", lambda state: True)
    monkeypatch.setenv("JAX_MESH_SPEC", '{"fsdp": 1}')
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    ckpt = str(tmp_path / "c")
    try:
        first = llama_train.run(llama_train.parse_args(
            [*ARGS, "--data", tokens, "--steps", "2", "--checkpoint-every", "1",
             "--checkpoint-dir", ckpt]))
        second = llama_train.run(llama_train.parse_args(
            [*ARGS, "--data", tokens, "--steps", "3", "--checkpoint-dir", ckpt]))
    finally:
        dist.destroy_process_group()
    assert in_flight == [0, 0, 0]  # steps 1 and 2, then 3
    assert first["ckpt"].last_durable_step() == 2
    out = second["restore"]
    assert (out.path, out.cause, out.step) == ("storage", "ok", 2)
    assert sorted(os.listdir(os.path.join(ckpt, "dcp"))) == ["1", "2", "3"]
    # Each closed manager destroyed its gloo group.
    assert first["ckpt"]._cpu_group is None and second["ckpt"]._cpu_group is None
