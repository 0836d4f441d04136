"""Attention ops: the flash kernels and the plain reference.

Counterpart of ``tf_operator_tpu/ops/attention.py``. Both functions take and
return BSHD (``[batch, seq, heads, head_dim]``). ``flash_attention`` runs the
Hopper kernels on a CUDA tensor and their plain versions on a CPU tensor;
there is no fallback that hides a missing kernel.
"""

from __future__ import annotations

import math

import torch

from . import flash

NEG_INF = float(torch.finfo(torch.float32).min)


def _repeat_kv(q, k, v):
    groups = q.shape[2] // k.shape[2]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    return k, v


def xla_attention(q, k, v, causal: bool = True, bias=None):
    """Reference implementation: scores in fp32, an fp32 softmax cast back
    to q's dtype. ``bias`` is an optional additive fp32 score bias
    broadcastable to [b, h, s_q, s_k] (padding masks etc.)."""
    k, v = _repeat_kv(q, k, v)
    head_dim = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if bias is not None:
        scores = scores + bias
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device).tril(s_k - s_q)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, causal: bool = True):
    """The kernel path: Hopper kernels for CUDA tensors, their plain
    versions for CPU tensors."""
    return flash.flash_attention(q, k, v, causal=causal)
