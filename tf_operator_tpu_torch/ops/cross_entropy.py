"""Next-token cross entropy in fp32, whole or with the lm head applied per
sequence chunk.

Counterpart of the loss helpers of ``tf_operator_tpu/train/train_step.py``.
The model applies :func:`chunked_cross_entropy` inside its own forward
(``Llama.forward(targets=...)``); the train step only calls the model.
"""

from __future__ import annotations

import torch
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
