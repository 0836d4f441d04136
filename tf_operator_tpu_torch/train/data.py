"""Data for the port's training workloads: the input pipeline.

``SyntheticTokens``, ``TokenFileDataset`` and ``write_token_file`` are
copies of ``tf_operator_tpu/train/data.py``'s (the port imports nothing of
the JAX package), so the same seed, or the same token file, window skip and
process split, give the same batches in both packages. ``TokenFileDataset``
runs on the port's copy of the native loader (``native/dataloader.cc``,
built by g++ at first use), with a numpy-mmap fallback that cuts the same
windows.

``DevicePrefetch`` is the second stage: on CUDA it copies batch k+1 from a
pinned host buffer to the card on a side stream while step k runs.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch


class SyntheticTokens:
    """Infinite deterministic stream of token batches [batch, seq+1]
    (train_step splits input/target internally)."""

    def __init__(self, batch: int, seq: int, vocab_size: int, seed: int = 0):
        self.batch = batch
        self.seq = seq
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._rng.integers(
            0, self.vocab_size, size=(self.batch, self.seq + 1), dtype=np.int32
        )


class TokenFileDataset:
    """Batches [batch, seq+1] from a raw token shard file ("tokens v1":
    headerless little-endian int32 or uint16 ids).

    Backed by the native C++ loader (native/dataloader.cc — mmap +
    background prefetch ring, so batch assembly overlaps the device step)
    with a numpy-mmap fallback when the toolchain is unavailable. Both
    paths produce IDENTICAL batches: window w of this process is
    w_global = w * num_processes + process_id, starting at
    (w_global * 1000003) mod (n_tokens - seq - 1).
    """

    _STRIDE = 1000003  # keep in sync with kStride in dataloader.cc

    def __init__(
        self,
        path: str,
        batch: int,
        seq: int,
        dtype="int32",
        process_id: int = 0,
        num_processes: int = 1,
        prefetch_depth: int = 4,
        skip_windows: int = 0,
        force_python: bool = False,
    ):
        self.path = path
        self.batch = batch
        self.seq = seq
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype("int32"), np.dtype("uint16")):
            raise ValueError(f"token dtype must be uint16 or int32, got {dtype}")
        self.process_id = process_id
        self.num_processes = num_processes
        # Checkpoint resume: windows this process already consumed
        # (steps_done * local_batch) — both backends skip them.
        self._window = skip_windows
        self._handle = None
        self._lib = None
        self._mm = None

        if not force_python:
            from ..native import load_library

            lib = load_library("dataloader")
            if lib is not None:
                lib.tl_open.restype = ctypes.c_void_p
                lib.tl_open.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64,
                ]
                lib.tl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
                lib.tl_next.restype = ctypes.c_int
                lib.tl_token_count.argtypes = [ctypes.c_void_p]
                lib.tl_token_count.restype = ctypes.c_int64
                lib.tl_close.argtypes = [ctypes.c_void_p]
                handle = lib.tl_open(
                    path.encode(), batch, seq, self.dtype.itemsize,
                    process_id, num_processes, prefetch_depth, skip_windows,
                )
                if handle:
                    self._lib, self._handle = lib, handle
        if self._handle is None:
            self._mm = np.memmap(path, dtype=self.dtype, mode="r")
            if len(self._mm) <= seq + 1:
                raise ValueError(
                    f"{path}: {len(self._mm)} tokens < one window ({seq + 1})"
                )

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def n_tokens(self) -> int:
        if self.native:
            return int(self._lib.tl_token_count(self._handle))
        return len(self._mm)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        if self.native:
            rc = self._lib.tl_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            )
            if rc != 0:
                raise StopIteration
            return out
        usable = len(self._mm) - (self.seq + 1)
        if usable % self._STRIDE == 0:
            # Degenerate stride cycle: (w*STRIDE) mod usable would visit
            # only usable/STRIDE offsets. Mirrored in dataloader.cc.
            usable -= 1
        for b in range(self.batch):
            w = self._window * self.num_processes + self.process_id
            self._window += 1
            start = (w * self._STRIDE) % usable
            out[b] = self._mm[start : start + self.seq + 1].astype(np.int32)
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __del__(self):  # best-effort: stop the producer thread
        try:
            self.close()
        except Exception:
            pass


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a "tokens v1" shard (headerless raw ids, native byte order)."""
    arr = np.asarray(tokens)
    if arr.dtype not in (np.dtype("int32"), np.dtype("uint16")):
        raise ValueError(f"token dtype must be uint16 or int32, got {arr.dtype}")
    arr.tofile(path)


class DevicePrefetch:
    """Device-side double-buffered prefetch: the second stage of the input
    pipeline, after the host-side ring (native dataloader / SyntheticTokens).

    Keeps up to ``depth`` batches already placed by ``shard_batch``: on
    CUDA, each host batch is copied into a pinned buffer and sent to the
    card with a ``non_blocking`` copy on a side stream, so batch k+1's
    transfer overlaps step k. The consumer's stream waits on the copy's
    event before it reads the batch, and the batch is recorded on that
    stream so that the caching allocator does not hand its memory to
    another tensor while the step still reads it. Every batch is a fresh
    device buffer; nothing is reused. On the CPU batches pass through.

    Resume accounting as in the JAX package: one host batch is drawn per
    yielded batch plus the ``in_flight`` ones buffered ahead, so a resume
    derives its skip from steps trained, never from batches drawn.
    """

    def __init__(self, host_iter, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._it = iter(host_iter)
        self.depth = depth
        self._buf = collections.deque()
        self._exhausted = False

    @property
    def in_flight(self) -> int:
        """Batches placed but not yet yielded (resume accounting)."""
        return len(self._buf)

    def __iter__(self):
        return self

    def _fill(self) -> None:
        while not self._exhausted and len(self._buf) < self.depth:
            try:
                batch = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            self._buf.append(shard_batch(batch, self.device, self._stream))

    def __next__(self) -> torch.Tensor:
        self._fill()
        if not self._buf:
            raise StopIteration
        out, copied = self._buf.popleft()
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            out.record_stream(stream)
        # Start the replacement transfer now, before the caller launches the
        # step on `out`, so that the copy overlaps that step.
        self._fill()
        return out


def shard_batch(batch, device, stream: Optional["torch.cuda.Stream"] = None):
    """Place this rank's host batch on ``device``: (tensor, event the copy
    records, or None). Each rank feeds its own local batch to its data-
    parallel shard of the model, so no global batch is ever assembled. On
    CUDA the copy comes from pinned memory, ``non_blocking``, on ``stream``
    (the current stream when None); on the CPU the batch is wrapped, not
    copied."""
    host = torch.as_tensor(np.ascontiguousarray(batch))
    device = torch.device(device)
    if device.type != "cuda":
        return host, None
    stream = stream or torch.cuda.current_stream(device)
    pinned = host.pin_memory()
    with torch.cuda.stream(stream):
        out = pinned.to(device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    return out, copied


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    """One host batch of images and labels on ``device`` (through
    :func:`shard_batch`), the labels as int64."""
    return shard_batch(images, device)[0], shard_batch(labels, device)[0].long()
