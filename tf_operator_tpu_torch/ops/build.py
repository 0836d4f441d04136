"""On-demand ``nvcc`` build and ``ctypes`` load of the Hopper kernels.

Counterpart of ``tf_operator_tpu/native/build.py``. Every ``ops/csrc/*.cu``
is compiled for ``sm_90a`` into one shared library with a plain C interface,
``build/torch_kernels/libtorch_kernels-<hash>.so``, named by a hash of the
sources and flags so that an edited source is rebuilt. The sources compile
in parallel (one ``nvcc -c`` each, all started together) and are linked
once. The build happens at the first kernel launch, never at import.

There is no fallback: a missing ``nvcc`` or a failed build raises.

Binding rules (every C entry point follows them): pointers and the stream
are ``c_void_p``; the function returns ``cudaGetLastError()`` after its
launch, and :func:`check` raises on a non-zero code; kernels launch on
``torch.cuda.current_stream()``, allocate nothing and do not synchronise.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; the chip
smoke resets it before the main path and reads it after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# The flash kernels at head_dim 128, then their head_dim-64 instances.
KERNELS = ("rope", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_d64", "flash_dq_d64", "flash_dkv_d64")
LAUNCHES = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (ops/csrc/*.cu).
_SIGNATURES = {
    "tk_rope": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tk_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "tk_flash_dq": [_P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "tk_flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtorch_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """Compile every .cu in parallel, then link them into ``out``. The
    compiler's report (registers, shared memory, spills) goes to
    ``<out>.log``."""
    nvcc = _nvcc()
    tmp = out.parent / f"{out.stem}.build-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate(timeout=600)
        log.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    so = tmp / out.name
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *objs, "-o", str(so)],
        capture_output=True, text=True, timeout=600,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    Path(f"{out}.log").write_text("\n".join(log))
    os.replace(so, out)  # atomic: concurrent builds race safely
    shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Build (when the sources changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            _compile(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tk_error_string.argtypes = [ctypes.c_int]
        lib.tk_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def compiler_report() -> str:
    """What ``nvcc -Xptxas=-v`` said when the library was built."""
    log = Path(f"{library_path()}.log")
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code:
        msg = lib.tk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
