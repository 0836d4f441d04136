"""Sharded layers run as virtual ranks in one process: each rank's piece in
turn, what its collectives would bring from the other ranks handed over in
memory. ``chip_smoke.py`` holds a layer's sharded form against its whole
form on one card this way, and the CPU tests do at small sizes, beside the
real process groups.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.llama import MoE, slot_offsets


def moe_over_sp(moe: MoE, x: torch.Tensor, n: int):
    """``moe`` over ``n`` virtual sp ranks: ``x`` [b, s, d] split into ``n``
    pieces of ``s / n`` positions, rank r routing the r-th as the layer
    over an sp group does (``MoE.route``), the ranks' route counts stacked
    in memory in place of their exchange, each rank's output from its own
    slots (``MoE.assign``), and the aux loss from the ranks' summed
    statistics. Returns ``(y [b, s, d], aux)``, differentiable in ``x``
    and the weights as the whole layer's output is."""
    layout = moe.layout
    pieces = x.chunk(n, 1)
    try:
        routings = []
        for r in range(n):
            moe.layout = dataclasses.replace(layout, sp_rank=r, sp_size=n)
            routings.append(moe.route(pieces[r]))
        counts = torch.stack([routing.counts() for routing in routings])
        ys = []
        for r, routing in enumerate(routings):
            moe.layout = dataclasses.replace(layout, sp_rank=r, sp_size=n)
            ys.append(moe.assign(routing, slot_offsets(counts, r, routing.span)))
    finally:
        moe.layout = layout
    stats = [routing.stats() for routing in routings]
    aux = moe.aux_loss(sum(f for f, _ in stats), sum(p for _, p in stats),
                       sum(routing.tokens for routing in routings))
    return torch.cat(ys, 1), aux
