"""Ring attention: sequence-parallel causal attention over the ``sp`` group.

Counterpart of ``tf_operator_tpu/ops/ring_attention.py``. Rank ``r`` of a
ring of ``n`` holds the sequence shard of global positions ``[r * s,
(r + 1) * s)`` of q, k and v (``[b, s, h(_kv), d]``). The K/V blocks
rotate around the ring (``parallel/collectives.ppermute``) while each rank
merges its per-block attention by log-sum-exp algebra (:func:`combine`),
so the whole sequence never sits on one card.

- **The blocks.** After ``i`` rotations rank ``r`` holds the block that
  started on rank ``(r - i) % n`` (:func:`block_mode`): a block left of the
  diagonal is fully visible and runs the flash forward non-causal, the
  rank's own block (step 0) runs it causal, and a block right of the
  diagonal is invisible and skipped: it launches nothing (its block stays
  in the graph at a zero gradient, so that every rank's backward makes
  every rotation, in one order). Ring rank ``r``
  thus runs ``r + 1`` flash forwards a layer, and as many dQ and dK/dV
  launches in the backward.
- **The lse path.** Every block calls ``flash_attention_with_lse``; the
  combine's weights depend on each block's lse, so the backward reaches
  the dQ and dK/dV kernels with a non-zero ``dlse`` folded into delta
  (``ops/flash.py`` ``flash_delta``). On a CPU tensor the blocks use the
  kernels' plain versions, as every port module does.
- **GQA.** The K/V that rotate are the unrepeated ones: the kernels take
  GQA natively and the dK/dV kernel sums over each group. The JAX module
  repeats K/V before the ring; the result is the same, with ``h / kvh``
  times fewer bytes on the ring.
- **Overlap.** K and V travel stacked in one permute, posted before the
  block's kernels and waited on only before the next step; the last
  step's rotation, whose result no rank would read, is not made. A ring
  of ``n`` makes ``n - 1`` rotations a forward, and the backward as many
  (each carries the dK/dV accumulated so far one hop back).
- **Remat.** The received blocks are tagged ``"ring"``: a remat tape that
  keeps them (the "dots" policies, ``models/llama.py``) serves them to the
  block's replay, which then rotates nothing; under "nothing" the replay
  rotates again, in the forward's order on every rank.
- **No sp group**: plain causal flash attention over the local sequence,
  as the JAX module falls back outside a mapped axis.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..parallel.collectives import Pending, ppermute
from .attention import NEG_INF
from .flash import flash_attention, flash_attention_with_lse

FULL, DIAGONAL, SKIP = 0, 1, 2


def block_mode(kv_idx: int, my_idx: int) -> int:
    """FULL for a K/V block strictly left of ours, DIAGONAL for our own,
    SKIP for one strictly right of it (the JAX module's switch index)."""
    if kv_idx < my_idx:
        return FULL
    return DIAGONAL if kv_idx == my_idx else SKIP


def combine(o, lse, o_blk, lse_blk):
    """Merge two normalized partials (o ``[b, s, h, d]`` fp32, lse ``[b, h,
    s]`` fp32) by log-sum-exp weights. NEG_INF rows (nothing visible yet)
    weigh zero without producing inf - inf NaNs."""
    lse_new = torch.logaddexp(lse, lse_blk)
    safe = torch.where(lse_new == NEG_INF, 0.0, lse_new)

    def weight(x):
        w = torch.exp(torch.where(x == NEG_INF, NEG_INF, x - safe))
        return w.transpose(1, 2)[..., None]  # [b, h, s] -> [b, s, h, 1]

    return o * weight(lse) + o_blk * weight(lse_blk), lse_new


class _Keep(torch.autograd.Function):
    """``o`` as it is, with ``k`` and ``v`` kept in the graph at a zero
    gradient: a skipped block's rotation still runs its backward."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.kv = (k.shape, k.dtype)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        shape, dtype = ctx.kv
        zeros = do.new_zeros(shape, dtype=dtype)
        return do, zeros, zeros


def ring_blocks(q: torch.Tensor, my_idx: int, n: int,
                kv_at: Callable[[int], tuple]) -> torch.Tensor:
    """The ring's block loop on rank ``my_idx`` of ``n``: ``kv_at(i)``
    gives the (k, v) block held after ``i`` rotations. Returns o in q's
    dtype. A skipped block launches nothing, but stays in the graph: every
    rotation is then in every rank's backward, whose rotations run in one
    order on every rank (each waits for the next step's)."""
    o = lse = None
    for i in range(n):
        k_blk, v_blk = kv_at(i)
        mode = block_mode((my_idx - i) % n, my_idx)
        if mode == SKIP:
            o = _Keep.apply(o, k_blk, v_blk)
            continue
        o_blk, lse_blk = flash_attention_with_lse(q, k_blk, v_blk, causal=mode == DIAGONAL)
        if o is None:  # step 0: the rank's own diagonal block
            o, lse = o_blk.float(), lse_blk
        else:
            o, lse = combine(o, lse, o_blk.float(), lse_blk)
    return o.to(q.dtype)


class _Rotation:
    """The K/V block held after each rotation, the next rotation posted
    before the current block is handed out."""

    def __init__(self, k, v, group, n):
        self.kv, self.group, self.n = torch.stack([k, v]), group, n
        self.pending = Pending()

    def __call__(self, i: int) -> tuple:
        self.pending.wait()
        kv = self.kv
        if i + 1 < self.n:
            self.kv = ppermute(kv, self.group, 1, self.pending, tag="ring")
        return kv[0], kv[1]


def ring_attention(q, k, v, group=None) -> torch.Tensor:
    """Causal ring attention over ``group`` (the ``sp`` process group):
    q ``[b, s, h, d]``, k/v ``[b, s, kvh, d]`` this rank's sequence shard.
    Without a group (or a group of one): causal flash attention."""
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, causal=True)
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    return ring_blocks(q, my_idx, n, _Rotation(k, v, group, n))
