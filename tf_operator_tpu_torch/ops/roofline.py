"""The least work of one kernel call, for its roofline bound.

``ops/flash.py`` ``flash_work`` and ``ops/rope.py`` ``rope_work`` count it;
the bound is the larger of its bytes over the card's memory rate and its
FLOPs over the card's tensor-core peak (``device.peak_for``).
"""

from __future__ import annotations

from typing import NamedTuple


class Work(NamedTuple):
    """Bytes that must move (each input read once, each output written
    once) and tensor-core FLOPs."""

    bytes: int
    flops: int
