"""On-demand g++ build + ctypes load for the native components.

The port's copy of ``tf_operator_tpu/native/build.py``, with the same
source-hash cache and ownership checks. The cache lies inside the checkout,
in ``build/torch_native/`` beside the kernels' ``build/torch_kernels/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_cache: dict = {}

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"


def _build_dir() -> str:
    """A 0700 cache dir owned by this user. The .so here gets dlopen'd into
    the process: a directory another local user can write would let them
    pre-place a library at the (computable) digest name, so ownership and
    permissions are verified, and a fresh private directory is used when
    either is wrong."""
    d = str(BUILD_DIR)
    os.makedirs(d, mode=0o700, exist_ok=True)
    st = os.stat(d)
    # exist_ok skips the mode on a pre-existing dir: check it as well.
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        d = tempfile.mkdtemp(prefix="tf-operator-tpu-torch-native-")
    return d


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile native/<name>.cc (cached by source hash) and dlopen it.
    Returns None when the toolchain or compile fails: callers fall back
    to their Python implementation."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = os.path.join(_SRC_DIR, f"{name}.cc")
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            out = os.path.join(_build_dir(), f"{name}-{digest}.so")
            if not os.path.exists(out):
                tmp = f"{out}.build-{os.getpid()}"
                cmd = [
                    "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", src, "-o", tmp,
                ]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)  # atomic: concurrent builds race safely
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError) as exc:
            _log.warning("native %s unavailable (%s); using Python fallback", name, exc)
            lib = None
        _cache[name] = lib
        return lib
