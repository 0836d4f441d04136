"""The port's training loop as its reference runs it
(``examples/jax/llama/llama_train.py``), on the CPU with llama-tiny:

- the host reads a step's loss only at a log step and once at the end,
  and the losses ``run()`` returns are a ``--log-every 1`` run's;
- the timed window runs from the first step's read to the last step's;
- the default model is sized to the world;
- ``runtime/profiling.py``: the ``TPU_PROFILE_*`` window and the
  on-demand capture on ``torch.profiler``, under the JAX package's env
  names, defaults and single-owner rule.
"""

import glob
import json
import os
import signal
import threading
import time
import weakref
from types import SimpleNamespace

import pytest
import torch

from tf_operator_tpu.runtime import profiling as jax_profiling
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.runtime import profiling
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import llama_train

ARGS = ["--device", "cpu", "--model", "llama-tiny", "--batch", "4", "--seq", "32",
        "--warmup", "2"]


def counting(monkeypatch):
    """Log every host read of a tensor's value (``float``, ``item``,
    ``tolist``, on any tensor) with the number of steps dispatched by then,
    and, as each step is dispatched, how many losses of the steps before the
    previous one are still alive."""
    log = SimpleNamespace(steps=0, reads=[], losses=[], alive=[])
    for name in ("__float__", "item", "tolist"):
        def read(self, *args, _real=getattr(torch.Tensor, name), _name=name, **kwargs):
            log.reads.append((log.steps, _name))
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, read)
    make_train_step = llama_train.make_train_step

    def make(optimizer):
        step_fn = make_train_step(optimizer)

        def step(state, batch):
            log.alive.append(sum(ref() is not None for ref in log.losses[:-1]))
            state, loss = step_fn(state, batch)
            log.steps += 1
            log.losses.append(weakref.ref(loss))
            return state, loss

        return step

    monkeypatch.setattr(llama_train, "make_train_step", make)
    return log


def test_the_loss_is_read_only_at_log_steps_and_at_the_end(monkeypatch):
    log = counting(monkeypatch)
    out = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "7", "--log-every", "3"]))
    # Steps 0, 3 and 6 are log steps; the end reads the whole list once.
    assert log.reads == [(1, "__float__"), (4, "__float__"), (7, "__float__"), (7, "tolist")]
    assert (out["window_steps"], len(out["losses"])) == (6, 7)
    assert out["window_seconds"] > 0
    log.steps, log.reads = 0, []
    every = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "7", "--log-every", "1"]))
    assert len(log.reads) == 8
    assert all(type(x) is float for x in out["losses"])
    assert out["losses"] == every["losses"]
    assert every["window_steps"] == 6


def test_the_loop_keeps_no_loss_of_a_step_it_has_passed(monkeypatch):
    """The losses go into one buffer allocated for the run, so what the loop
    holds does not grow with ``--steps``: once a step is dispatched, no loss
    of the steps before the previous one is alive."""
    log = counting(monkeypatch)
    out = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "9", "--log-every", "4"]))
    assert len(out["losses"]) == 9 and log.alive == [0] * 9


def test_a_resumed_run_reads_its_first_step(monkeypatch, tmp_path, capsys):
    """A resumed run's first step opens the window, log step or not."""
    base = [*ARGS, "--log-every", "4", "--checkpoint-dir", str(tmp_path)]
    llama_train.run(llama_train.parse_args([*base, "--steps", "3"]))
    log = counting(monkeypatch)
    capsys.readouterr()
    out = llama_train.run(llama_train.parse_args([*base, "--steps", "9"]))
    printed = [line.split()[2] for line in capsys.readouterr().out.splitlines()
               if line.startswith("[llama] step ")]
    assert out["start_step"] == 3 and printed == ["3", "4", "8"]
    assert log.reads == [(1, "__float__"), (2, "__float__"), (6, "__float__"), (6, "tolist")]
    assert out["window_steps"] == 5 and len(out["losses"]) == 6


def test_default_model_by_world_size():
    assert llama_train.default_model("cpu", 1) == "llama-tiny"
    assert llama_train.default_model("cpu", 8) == "llama-tiny"
    assert [llama_train.default_model("cuda", n) for n in (1, 2, 3, 4, 8, 16)] == [
        "llama-400m", "llama-400m", "llama-400m", "llama2-7b", "llama2-7b", "llama2-7b"]
    # The reckoning of llama_train's comment, from scripts/train_memory.py's
    # fit of the port's peaks on one H100 80GB HBM3: one card of a world of
    # n at --batch 32, seq 2048 holds at most half of the card's 85.0e9
    # bytes from the threshold world on, and more below it.
    config = llama.CONFIGS["llama2-7b"]
    layer, per_seq_layer, per_seq, rest = 2.789e9, 0.0110e9, 0.2604e9, 2.696e9
    gathered = 2 * 4 * (config.param_count() - 2 * config.vocab_size * config.dim) / 32

    def card(n):
        return ((rest + 32 * layer) / n + 32 / n * (32 * per_seq_layer + per_seq)
                + (gathered if n > 1 else 0))

    assert [round(card(n) / 1e9, 1) for n in (1, 2, 4, 8)] == [111.5, 57.4, 29.5, 15.6]
    world = llama_train.LLAMA2_7B_MIN_WORLD
    assert card(world) <= 85.0e9 / 2 < card(world // 2)


# ------------------------------------------------------------- profiling
def test_profiling_env_matches_the_jax_package(monkeypatch):
    for name in ("ENV_PROFILE_DIR", "ENV_PROFILE_START_STEP", "ENV_PROFILE_NUM_STEPS"):
        assert getattr(profiling, name) == getattr(jax_profiling, name)
    for env in ({}, {"TPU_PROFILE_DIR": "/p"},
                {"TPU_PROFILE_DIR": "/p", "TPU_PROFILE_START_STEP": "3",
                 "TPU_PROFILE_NUM_STEPS": "7"}):
        for key in ("TPU_PROFILE_DIR", "TPU_PROFILE_START_STEP", "TPU_PROFILE_NUM_STEPS"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        assert profiling.profile_window() == jax_profiling.profile_window()
    assert profiling.profile_window() == ("/p", 3, 7)


def test_step_profiler_noop_without_env(monkeypatch):
    """tests/test_metrics_latency.py's case for the port: no env, no
    profiler and no error."""
    monkeypatch.delenv(profiling.ENV_PROFILE_DIR, raising=False)

    def refuse():
        raise AssertionError("a profiler was started without the env")

    monkeypatch.setattr(profiling, "_start", refuse)
    assert [profiling.step_profiler(step) for step in range(5)] == [None] * 5


def traces(directory):
    return sorted(glob.glob(os.path.join(str(directory), "*.pt.trace.json")))


def test_window_writes_a_chrome_trace_of_its_steps(monkeypatch, tmp_path):
    monkeypatch.setenv(profiling.ENV_PROFILE_DIR, str(tmp_path))
    monkeypatch.setenv(profiling.ENV_PROFILE_START_STEP, "1")
    monkeypatch.setenv(profiling.ENV_PROFILE_NUM_STEPS, "2")
    x = torch.ones(8, 8)
    written = []
    for step in range(5):
        torch.mm(x, x)
        written.append(profiling.step_profiler(step))
        assert len(traces(tmp_path)) == (1 if step >= 3 else 0)
    assert written[:3] == [None, None, None] and written[4] is None
    assert traces(tmp_path) == [written[3]]
    events = json.load(open(written[3]))["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 2  # steps 2 and 3
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp"))


def test_capture_is_skipped_while_the_window_owns_the_profiler(monkeypatch, tmp_path):
    window, other = tmp_path / "window", tmp_path / "capture"
    monkeypatch.setenv(profiling.ENV_PROFILE_DIR, str(window))
    monkeypatch.setenv(profiling.ENV_PROFILE_START_STEP, "0")
    monkeypatch.setenv(profiling.ENV_PROFILE_NUM_STEPS, "1")
    profiling.step_profiler(0)
    assert profiling.capture(str(other), 0.01) is None  # skipped, not queued
    assert profiling.step_profiler(1) is not None
    assert len(traces(window)) == 1 and not other.exists()
    assert profiling.capture(str(other), 0.01) is not None  # the profiler is free
    assert len(traces(other)) == 1

    # And a live capture keeps the window from starting.
    started = threading.Event()
    real_start = profiling._start

    def start():
        prof = real_start()
        started.set()
        return prof

    monkeypatch.setattr(profiling, "_start", start)
    thread = threading.Thread(target=profiling.capture, args=(str(other), 0.3))
    thread.start()
    assert started.wait(10)
    assert profiling.step_profiler(0) is None
    thread.join()
    assert profiling.step_profiler(1) is None  # the window never started
    assert len(traces(window)) == 1 and len(traces(other)) == 2


def test_sigusr1_captures_a_trace(tmp_path):
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        profiling.install_sigusr1_handler(str(tmp_path), seconds=0.05)
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 30
        while not traces(tmp_path):
            assert time.monotonic() < deadline, "SIGUSR1 wrote no trace"
            time.sleep(0.02)
    finally:
        signal.signal(signal.SIGUSR1, previous)


def test_llama_train_traces_the_window_through_its_own_ops(monkeypatch, tmp_path):
    monkeypatch.setenv(profiling.ENV_PROFILE_DIR, str(tmp_path))
    monkeypatch.setenv(profiling.ENV_PROFILE_START_STEP, "1")
    monkeypatch.setenv(profiling.ENV_PROFILE_NUM_STEPS, "2")
    out = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "5", "--log-every", "10"]))
    assert len(out["losses"]) == 5
    (path,) = traces(tmp_path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    # The port's attention and rope run inside the window (plain versions
    # on the CPU), forward and backward.
    for op in ("_FlashAttention", "_FlashAttentionBackward", "_Rope", "_RopeBackward"):
        assert op in names, op
