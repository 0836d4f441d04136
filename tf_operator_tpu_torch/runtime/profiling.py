"""Workload-side profiling hooks on ``torch.profiler``: the port's copy of
``tf_operator_tpu/runtime/profiling.py``, under the same env names, which
users set on the pod template.

Two triggers, both free when unused:

- Step window (env-driven): ``TPU_PROFILE_DIR`` [+ ``TPU_PROFILE_START_STEP``
  (default 10) / ``TPU_PROFILE_NUM_STEPS`` (default 5)] on the pod; the
  train loop calls ``step_profiler(step)`` after every step. The trace
  starts once step ``start`` is dispatched and stops once step ``start +
  num`` is: it holds the ``num`` steps between. Without the env a call is
  one env read.
- On demand: ``install_sigusr1_handler()`` arms SIGUSR1; signalling the
  process (``kubectl exec <pod> -- kill -USR1 1``) captures a trace of a
  fixed number of seconds.

One trace at a time, process-wide: a capture is skipped while the window
owns the profiler, and the window does not start while a capture does.
The CPU activity is always traced, and the CUDA activity (kernels, copies,
on the card's own clock) once the process has put work on the card: a
run on CUDA. Stopping waits for the device, so the only host sync the
hooks add is at the window's end. A trace lands in the directory as
``<host>_<pid>.<ns>.pt.trace.json``, the chrome-trace JSON that
TensorBoard's profiler plugin and Perfetto read, written under a temporary
name and renamed, so that a reader never sees a torn file. Errors are not
swallowed: a profiler that cannot start raises.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import tempfile
import threading
import time
from typing import Optional

import torch

_log = logging.getLogger(__name__)

ENV_PROFILE_DIR = "TPU_PROFILE_DIR"
ENV_PROFILE_START_STEP = "TPU_PROFILE_START_STEP"
ENV_PROFILE_NUM_STEPS = "TPU_PROFILE_NUM_STEPS"

_state = threading.Lock()
# Which trigger owns the live trace: None, "window" or "capture". Separate
# ownership, so that the window's stop never cuts a capture short, nor a
# capture's the window.
_owner: Optional[str] = None
_window = None  # the window's torch.profiler.profile while it runs


def profile_window() -> tuple:
    """(dir, start_step, num_steps) from the env, or (None, 0, 0)."""
    out_dir = os.environ.get(ENV_PROFILE_DIR)
    if not out_dir:
        return None, 0, 0
    start = int(os.environ.get(ENV_PROFILE_START_STEP, "10"))
    num = int(os.environ.get(ENV_PROFILE_NUM_STEPS, "5"))
    return out_dir, start, num


def _start():
    """A started profiler, tracing CUDA once this process has used the card."""
    from torch.profiler import ProfilerActivity, profile

    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_initialized() else []
    prof = profile(activities=[ProfilerActivity.CPU, *cuda])
    prof.start()
    return prof


def _stop(prof, out_dir: str) -> str:
    """Stop ``prof`` and write its chrome trace into ``out_dir``; the path."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def step_profiler(step: int) -> Optional[str]:
    """Call after every train step: starts and stops the env's window. The
    trace's path on the step that wrote it, else None."""
    global _owner, _window
    out_dir, start, num = profile_window()
    if out_dir is None:
        return None
    with _state:
        if step == start and _owner is None:
            _log.info("profiler: starting trace -> %s (steps %d..%d)", out_dir, start,
                      start + num)
            _window = _start()
            _owner = "window"
        elif _owner == "window" and step >= start + num:
            prof, _window, _owner = _window, None, None
            path = _stop(prof, out_dir)
            _log.info("profiler: trace written to %s", path)
            return path
    return None


def capture(out_dir: str, seconds: float = 3.0) -> Optional[str]:
    """A trace of ``seconds``, from any thread; its path, or None when it was
    skipped (not queued) because a trace is live."""
    global _owner
    with _state:
        if _owner is not None:
            return None
        prof = _start()
        _owner = "capture"
    try:
        time.sleep(seconds)
    finally:
        with _state:
            try:
                path = _stop(prof, out_dir)
            finally:
                _owner = None
    _log.info("profiler: on-demand trace written to %s", path)
    return path


def install_sigusr1_handler(out_dir: Optional[str] = None, seconds: float = 3.0) -> None:
    """SIGUSR1 -> a capture in a background thread (the handler only starts
    the thread). ``out_dir`` defaults to ``tpu-profile`` in the temporary
    directory."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "tpu-profile")

    def _handler(signum, frame):
        threading.Thread(target=capture, args=(out_dir, seconds), daemon=True,
                         name="tpu-profile").start()

    signal.signal(signal.SIGUSR1, _handler)
