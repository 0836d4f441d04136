"""Point-to-point collectives of the ring and the pipeline: the port's
counterpart of ``jax.lax.ppermute`` over a cyclic permutation.

:func:`ppermute` sends ``x`` to ring neighbour ``(i + shift) % n`` of
``group`` and receives from ``(i - shift) % n``, one send and one receive
posted together by ``batch_isend_irecv``. Its gradient is the same
permute with ``-shift``, as JAX transposes ``ppermute``.

- ``P2POp`` takes global ranks: the group's ranks are mapped with
  ``dist.get_global_rank``.
- NCCL makes a subgroup's P2P communicators at its first P2P: every rank
  of the group posts its first batch together, which the ring and the
  pipeline do, since every rank permutes at every step.
- With ``pending`` (a :class:`Pending`) the forward returns before the
  data has arrived: the caller overlaps work with the transfer and calls
  ``pending.wait()`` before it reads the result.
- With ``tag`` the received tensor is one a remat tape may keep
  (``ops/remat.py``): the replay of a checkpointed block then takes it
  from the tape and permutes nothing.

Several tensors that travel together go as one (stacked), so that every
rank's backward runs their permutes in one order.

``COUNTS["ppermute"]`` counts the permutes run (a forward's, a replay's
and a backward's each count one), as ``parallel/experts.py`` counts its
all-to-alls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops import remat

COUNTS = {"ppermute": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


class Pending:
    """The works of permutes posted but not yet waited on."""

    def __init__(self):
        self.works: list = []

    def wait(self) -> None:
        works, self.works = self.works, []
        _wait(works)


def _wait(works) -> None:
    for work in works:
        work.wait()


def _permute(x: torch.Tensor, group, shift: int):
    """(the tensor that will hold what ``(i - shift) % n`` sends, the
    posted works)."""
    COUNTS["ppermute"] += 1
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    return out, dist.batch_isend_irecv(ops)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift, pending, tag):
        ctx.group, ctx.shift = group, shift

        def compute():
            out, works = _permute(x, group, shift)
            if pending is None:
                _wait(works)
            else:
                pending.works += works
            return out

        return remat.saved(tag, compute)

    @staticmethod
    def backward(ctx, dy):
        dx, works = _permute(dy, ctx.group, -ctx.shift)
        _wait(works)
        return dx, None, None, None, None


def ppermute(x: torch.Tensor, group, shift: int = 1, pending: Optional[Pending] = None,
             tag: Optional[str] = None) -> torch.Tensor:
    """``x`` of ring neighbour ``(i - shift) % n`` on rank ``i`` of
    ``group``, differentiable. With ``pending`` the result may be read only
    after ``pending.wait()``; without, the permute has completed."""
    return _PPermute.apply(x, group, shift, pending, tag)
