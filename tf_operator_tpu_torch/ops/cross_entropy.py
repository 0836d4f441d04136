"""Next-token cross entropy in fp32, whole or with the lm head applied per
sequence chunk, with the head whole or its vocabulary split over a
tensor-parallel group.

Counterpart of the loss helpers of ``tf_operator_tpu/train/train_step.py``.
The model applies :func:`chunked_cross_entropy` inside its own forward
(``Llama.forward(targets=...)``); the train step only calls the model.
Where the head's rows are split over ``tp`` (``parallel/sharding.py``), the
model calls :func:`vocab_parallel_cross_entropy`, which XLA's partitioner
derives for the JAX package from its vocab-sharded head.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Sequence positions per lm-head/loss chunk.
CE_CHUNK = 512


def masked_nll(logits, targets, ignore_id: int = -1):
    """(negative-log-likelihood sum, valid-token count) in fp32;
    ``ignore_id`` targets masked out."""
    logits = logits.float()
    mask = (targets != ignore_id).float()
    log_probs = torch.log_softmax(logits, dim=-1)
    ll = log_probs.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def cross_entropy_loss(logits, targets, ignore_id: int = -1):
    """Mean next-token cross entropy in fp32; ``ignore_id`` targets masked out."""
    nll, count = masked_nll(logits, targets, ignore_id)
    return nll / count.clamp(min=1.0)


def chunked_cross_entropy(hidden, weight, targets, chunk: int = CE_CHUNK,
                          ignore_id: int = -1, bias=None):
    """Next-token CE with the lm head (``weight`` [vocab, d], Linear layout)
    applied per sequence chunk: the [b, s, vocab] fp32 logits never exist
    whole, only [b, chunk, vocab] at a time. Each chunk runs under
    ``torch.utils.checkpoint``, so the backward keeps only the (hidden,
    target) chunk and recomputes its logits: without it autograd would save
    every chunk's log-softmax, the full logits again."""
    b, s, _ = hidden.shape
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=ignore_id)

    def per_chunk(h, t):
        logits = F.linear(h, weight)
        if bias is not None:
            logits = logits + bias
        return masked_nll(logits, t, ignore_id)

    total = count = 0.0
    for start in range(0, s + pad, chunk):
        nll, n = checkpoint(
            per_chunk, hidden[:, start:start + chunk], targets[:, start:start + chunk],
            use_reentrant=False,
        )
        total, count = total + nll, count + n
    return total / count.clamp(min=1.0)


class VocabGroup:
    """The tensor-parallel group a head's rows are split over, this rank
    holding rows ``[rank * V/n, (rank + 1) * V/n)``: the reductions of the
    vocab-parallel loss, over dim 0 of a tensor whose dim 0 is its shards
    (1 here). Its head is ``[1, V/n, d]``."""

    def __init__(self, group):
        self.group, self.rank = group, dist.get_rank(group)

    def starts(self, rows: int, device) -> torch.Tensor:
        """The first vocabulary id of each shard held here, [shards]."""
        return torch.tensor([self.rank * rows], device=device)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group, in place."""
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the group, in place."""
        dist.all_reduce(x, group=self.group)
        return x


class StackedShards(VocabGroup):
    """Every shard of a split head held by one process, stacked on dim 0
    of the head (``[n, V/n, d]``): the same loss, its reductions over that
    dim. It holds the vocab-parallel form against the whole head on one
    device."""

    def __init__(self, n: int):
        self.group, self.rank, self.size = None, 0, n

    def starts(self, rows: int, device) -> torch.Tensor:
        return torch.arange(self.size, device=device) * rows

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0, keepdim=True)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0, keepdim=True)


class _ShardedNLL(torch.autograd.Function):
    """(negative-log-likelihood sum, valid-token count) in fp32 of one
    chunk, from the head's rows held here (``weight`` [shards, V/n, d]).
    The forward takes each shard's logits [b, chunk, V/n], their max over
    the group, then the sum of exponentials and the target's logit (from
    the shard that holds it) in one sum over the group; it keeps the
    log-sum-exp [b, chunk]. The backward recomputes the logits, as a
    checkpoint would, but reduces nothing again: the softmax less the
    target's one-hot is each shard's logits gradient, and the hidden
    state's gradient is summed over the group. Three collectives a chunk."""

    @staticmethod
    def forward(ctx, h, weight, targets, shards: VocabGroup, ignore_id: int):
        logits = torch.einsum("bcd,nvd->nbcv", h, weight).float()
        top = shards.max(logits.amax(-1))  # [1, b, c]
        target, held = _target(targets, weight.shape[1], shards)
        picked = logits.gather(-1, target[..., None])[..., 0] - top
        parts = torch.stack([(logits - top[..., None]).exp().sum(-1),
                             torch.where(held, picked, 0.0)], -1)
        sumexp, target_logit = shards.sum(parts).unbind(-1)  # [1, b, c] each
        mask = (targets != ignore_id).float()
        ctx.save_for_backward(h, weight, targets, top + sumexp.log(), mask)
        ctx.shards = shards
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((sumexp.log() - target_logit)[0] * mask).sum(), count

    @staticmethod
    def backward(ctx, grad_nll, _grad_count):
        h, weight, targets, lse, mask = ctx.saved_tensors
        shards = ctx.shards
        grad = (torch.einsum("bcd,nvd->nbcv", h, weight).float() - lse[..., None]).exp_()
        target, held = _target(targets, weight.shape[1], shards)
        grad.scatter_add_(-1, target[..., None], -held.float()[..., None])
        grad = grad.mul_((grad_nll * mask)[None, ..., None]).to(h.dtype)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = shards.sum(torch.einsum("nbcv,nvd->bcd", grad, weight)[None])[0]
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("nbcv,bcd->nvd", grad, h)
        return dh, dw, None, None, None


def _target(targets, rows: int, shards: VocabGroup) -> tuple:
    """Each target's row within each shard ([shards, b, c], clamped to the
    shard) and whether that shard holds it."""
    local = targets[None] - shards.starts(rows, targets.device)[:, None, None]
    return local.clamp(0, rows - 1), (local >= 0) & (local < rows)


def vocab_parallel_cross_entropy(hidden, weight, targets, shards: VocabGroup,
                                 chunk: int = CE_CHUNK, ignore_id: int = -1):
    """:func:`chunked_cross_entropy` with the head's rows split over a
    tensor-parallel group (``shards``; ``weight`` the rows held here,
    ``[V/n, d]``, or ``[n, V/n, d]`` for :class:`StackedShards`). Per
    chunk: the local logits in fp32, the max all-reduced over the group,
    then the sum of exponentials and the target's logit (taken by the rank
    that holds it) in one all-reduce, ``ignore_id`` masked; the backward
    recomputes the chunk's logits and sums the hidden state's gradient
    over the group. No rank ever holds ``[b, chunk, V]``, and the backward
    keeps only each chunk's log-sum-exp besides its inputs. ``hidden`` is
    the same on every rank of the group."""
    if weight.dim() == 2:
        weight = weight[None]
    b, s, _ = hidden.shape
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=ignore_id)
    total = count = 0.0
    for start in range(0, s + pad, chunk):
        nll, n = _ShardedNLL.apply(hidden[:, start:start + chunk], weight,
                                   targets[:, start:start + chunk], shards, ignore_id)
        total, count = total + nll, count + n
    return total / count.clamp(min=1.0)
