"""The collectives of an MoE layer whose experts are placed over the mesh:
the counterpart of what XLA inserts for the JAX ``MoE``'s sharding
constraints (``tf_operator_tpu/models/llama.py`` ``MoE``, the dispatch and
combine einsums constrained to ``moe_expert_axes``).

``parallel/sharding.py`` places the experts and gives each ``MoE`` an
:class:`ExpertLayout`; the layer calls the functions here:

- :func:`to_owners` / :func:`from_owners`: the dispatch einsum's
  ``[e, b, cap, d]`` goes to the experts' owners by one all-to-all over the
  expert axis, ``[e/E, E*b, cap, d]`` on each owner, and the experts'
  output comes back by the reverse all-to-all before the combine. An
  all-to-all's gradient is the reverse all-to-all.
- :func:`expert_weight`: an expert weight's local block, whose gradient
  carries the global mean's ``1/data_size`` and is summed over the ranks
  that hold the same block with other data, where FSDP2 does not do it.
  After the backward all-to-all an owner holds the sum of every source
  rank's contribution, each from that rank's own mean loss.
- :func:`copy_to_tp` / :func:`reduce_from_tp`: with the experts' ``f``
  split over ``tp``, the input's gradient and the ``w2`` product's
  partial sums are summed over ``tp`` (Megatron's f and g).
- :func:`data_sum`: the load-balancing loss's statistics summed over every
  data rank and every ``sp`` rank, so that the aux loss is the global
  batch's over the whole sequence, as under the JAX package's ``jit``; its
  gradient is summed too, since each rank's loss carries the whole aux
  term.
- :func:`sequence_counts`: over ``sp``, each rank's per-expert route
  counts ``[k, b, e]`` (integers, no gradient) gathered from every rank of
  its ``sp`` group, from which a rank finds where its tokens' capacity
  slots start when a routing group spans several ranks
  (``models/llama.slot_offsets``). No activation crosses ``sp``.
- :func:`slot_count`: the slots a rank's experts run on where a routing
  group spans sp ranks: its own kept routes to one expert at most, the
  same over the all-to-all's group.

``COUNTS["all_to_all"]`` counts the all-to-alls run (forward, a remat
replay's forward and backward each count one), and ``COUNTS["tp"]`` the
all-reduces over ``tp`` (the ``w2`` product's in each forward, the
input's gradient in the backward), as ``ops/build.LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

COUNTS = {"all_to_all": 0, "tp": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


@dataclass(frozen=True)
class ExpertLayout:
    """Where one MoE layer's experts live and which groups its collectives
    run over. The default is one process: no collective."""

    axis: Optional[str] = None  # the resolved expert axis
    group: Any = None  # its process group: the all-to-all's
    size: int = 1  # its size, E
    tp_group: Any = None  # the f split's group, tp above 1
    data_group: Any = None  # every data and sp rank (the aux loss's statistics)
    data_size: int = 1
    replica_group: Any = None  # ranks with the same expert block and other data
    grad_scale: float = 1.0  # the expert gradient's factor besides FSDP2's
    fsdp_d: bool = False  # each expert's d sharded over fsdp by an FSDP2 group
    sp_group: Any = None  # the ring's group: the ranks that split the sequence
    sp_rank: int = 0  # this rank's piece of the sequence
    sp_size: int = 1


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    COUNTS["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group, count: Optional[str] = None) -> torch.Tensor:
    if count is not None:
        COUNTS[count] += 1
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Equal chunks of dim 0 to each rank of ``group``; the gradient goes
    back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_to_all(dy, ctx.group), None


class _SumBoth(torch.autograd.Function):
    """All-reduce (sum) forward, and its gradient summed too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _SumForward(torch.autograd.Function):
    """All-reduce (sum) over tp forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "tp")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumBackward(torch.autograd.Function):
    """Identity forward; the gradient scaled, then summed over ``group``
    (counted under ``count``)."""

    @staticmethod
    def forward(ctx, x, group, scale, count=None):
        ctx.group, ctx.scale, ctx.count = group, scale, count
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy * ctx.scale if ctx.scale != 1.0 else dy
        if ctx.group is not None:
            dy = _all_reduce(dy, ctx.group, ctx.count)
        return dy, None, None, None


def to_owners(x: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """[e, b, cap, d] on each rank -> [e/E, E*b, cap, d] on each expert's
    owner (rank j of the group owns experts j*e/E .. (j+1)*e/E - 1)."""
    e, b, cap, d = x.shape
    n = layout.size
    y = _AllToAll.apply(x, layout.group)  # chunk i: rank i's tokens for my experts
    return y.view(n, e // n, b, cap, d).transpose(0, 1).reshape(e // n, n * b, cap, d)


def from_owners(y: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """The reverse of :func:`to_owners`: [e/E, E*b, cap, d] -> [e, b, cap, d]."""
    el, nb, cap, d = y.shape
    n = layout.size
    chunks = y.view(el, n, nb // n, cap, d).transpose(0, 1).contiguous()
    return _AllToAll.apply(chunks, layout.group).view(el * n, nb // n, cap, d)


def expert_weight(w: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """The local block of an expert weight (a DTensor's, or the tensor);
    its gradient scaled by ``layout.grad_scale`` and summed over
    ``layout.replica_group``."""
    local = w.to_local() if isinstance(w, DTensor) else w
    if layout.grad_scale == 1.0 and layout.replica_group is None:
        return local
    return _SumBackward.apply(local, layout.replica_group, layout.grad_scale)


def copy_to_tp(x: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    return x if layout.tp_group is None else _SumBackward.apply(x, layout.tp_group, 1.0, "tp")


def reduce_from_tp(x: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    return x if layout.tp_group is None else _SumForward.apply(x, layout.tp_group)


def data_sum(x: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    return x if layout.data_group is None else _SumBoth.apply(x, layout.data_group)


def sequence_counts(counts: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """Every ``sp`` rank's ``counts`` ([k, b, e] integers), stacked in rank
    order: [sp, k, b, e]. Counts carry no gradient."""
    gathered = [torch.empty_like(counts) for _ in range(layout.sp_size)]
    dist.all_gather(gathered, counts.contiguous(), group=layout.sp_group)
    return torch.stack(gathered)


def slot_count(kept: torch.Tensor, layout: ExpertLayout) -> int:
    """The slots an expert needs on this rank, from its kept routes per
    batch row and expert (``kept`` [b, e]): their most, the same over the
    all-to-all's group, whose ranks exchange equal blocks. It reads the
    count on the host: a routing group across sp ranks has data-dependent
    slots."""
    most = kept.max().reshape(1)
    if layout.group is not None:
        dist.all_reduce(most, op=dist.ReduceOp.MAX, group=layout.group)
    return max(1, int(most.item()))
