"""Pipeline parallelism over the ``pp`` process group: the GPipe schedule of
``tf_operator_tpu/parallel/pipeline.py``.

The layer stack is split into ``pp`` contiguous stages (:func:`split_stages`),
one a rank of the group; a batch is split into M microbatches that flow
stage to stage by ``parallel/collectives.ppermute``. The tick loop is the
reference's: ``T = M + pp - 1`` ticks; at tick t stage 0 injects
microbatch t (clamped to the last: its results past M are discarded),
every stage computes, the last stage keeps microbatch ``t - pp + 1`` from
tick ``pp - 1`` on, and every stage's result moves one stage on (the last
stage's to stage 0, which discards it). The bubble is the reference's,
``(pp - 1) / T`` of the ticks.

The backward runs the permutes in reverse on every rank only if every
tick's permute is in every rank's autograd graph, and each tick's input
depends on the previous tick's permute:

- stage 0 selects its injected microbatch by ``torch.where``, as the
  reference does, so that the received tensor stays in its graph (with a
  zero gradient) and its permute's backward runs there too;
- the last tick's permute would carry results no stage reads: no rank
  makes it, and a stage other than the last does not compute the last
  tick either;
- a stage other than the last returns zeros of the output's shape
  (the reference's unused output slots) that hang on its last received
  tensor, so that its backward, started from them, reaches every permute.

Every stage reads the whole ``x`` for its shape and dtype; only stage 0
reads its values. With ``num_microbatches`` M and ``pp`` stages, every
stage runs ``T`` forwards of its stage function a step (the last stage;
the others ``T - 1``), and ``2 (T - 1)`` permutes (forward and backward).

Without a ``pp`` group the stages run in sequence, as the reference
falls back without a ``pp`` axis.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import ppermute


def split_stages(layers: Sequence, pp: int) -> list:
    """``layers`` as ``pp`` contiguous stages of equal length."""
    n = len(layers)
    if n % pp:
        raise ValueError(f"{n} layers not divisible by {pp} pipeline stages")
    per = n // pp
    return [list(layers[s * per:(s + 1) * per]) for s in range(pp)]


class _ZerosOn(torch.autograd.Function):
    """Zeros of ``shape`` whose backward hands ``anchor`` a zero gradient:
    the root of a stage's backward that reaches its permutes."""

    @staticmethod
    def forward(ctx, anchor, shape):
        ctx.anchor_shape = anchor.shape
        return anchor.new_zeros(shape)

    @staticmethod
    def backward(ctx, dy):
        return dy.new_zeros(ctx.anchor_shape), None


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, *consts,
                   num_microbatches: int, n_stages: int = 1,
                   group: Optional[object] = None) -> torch.Tensor:
    """Run the stages of ``stage_fn`` over microbatches of ``x``.

    ``stage_fn(stage, x_mb, *consts) -> y_mb`` applies stage ``stage``'s
    layers to one microbatch (the same shape in and out). Over ``group``
    (the ``pp`` group) this rank runs its own stage, the group's rank, in
    the tick loop and returns the last stage's outputs on the last stage,
    zeros of ``x``'s shape elsewhere; without it, the ``n_stages`` stages
    run in sequence on the whole ``x``."""
    if group is None:
        for stage in range(n_stages):
            x = stage_fn(stage, x, *consts)
        return x
    pp, stage = dist.get_world_size(group), dist.get_rank(group)
    batch, m = x.shape[0], num_microbatches
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    x_mb = x.reshape(m, batch // m, *x.shape[1:])
    ticks = m + pp - 1
    last = stage == pp - 1
    first = torch.full((), stage == 0, device=x.device)  # a fill: no host copy
    recv = torch.zeros_like(x_mb[0])
    outputs = []
    for t in range(ticks if last else ticks - 1):
        x_in = torch.where(first, x_mb[min(t, m - 1)], recv)
        y = stage_fn(stage, x_in, *consts)
        if last and t >= pp - 1:
            outputs.append(y)
        if t < ticks - 1:
            recv = ppermute(y, group, 1)
    if last:
        return torch.cat(outputs)
    return _ZerosOn.apply(recv, x.shape)
