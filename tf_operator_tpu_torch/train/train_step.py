"""Training step: chunked cross-entropy loss, optax-exact AdamW, one step.

Counterpart of ``tf_operator_tpu/train/train_step.py`` on one device. The
optimizer reproduces ``make_optimizer``'s optax chain rather than torch's
defaults, because that is where an optimizer port drifts:

- ``warmup_cosine_decay_schedule(0.0, lr, warmup, max(decay, warmup+1))``:
  the first update runs at lr 0, and ``decay_steps`` counts the warmup;
- ``clip_by_global_norm``: no ``+1e-6`` in the divisor (unlike
  ``clip_grad_norm_``), clipping only when the norm reaches the limit;
- AdamW with eps 1e-8 and bias correction, weight decay on every leaf
  (norm scales included), moments kept in the parameter dtype.

Parameters and moments are updated in place (the JAX step donates its
state buffers for the same reason: no second copy of the model).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# Sequence positions per lm-head/loss chunk.
CE_CHUNK = 512


def _masked_nll(logits, targets, ignore_id: int = -1):
    """(negative-log-likelihood sum, valid-token count) in fp32;
    ``ignore_id`` targets masked out."""
    logits = logits.float()
    mask = (targets != ignore_id).float()
    log_probs = torch.log_softmax(logits, dim=-1)
    ll = log_probs.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def cross_entropy_loss(logits, targets, ignore_id: int = -1):
    """Mean next-token cross entropy in fp32; ``ignore_id`` targets masked out."""
    nll, count = _masked_nll(logits, targets, ignore_id)
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
        return _masked_nll(logits, t, ignore_id)

    total = count = 0.0
    for start in range(0, s + pad, chunk):
        nll, n = checkpoint(
            per_chunk, hidden[:, start:start + chunk], targets[:, start:start + chunk],
            use_reentrant=False,
        )
        total, count = total + nll, count + n
    return total / count.clamp(min=1.0)


def loss_fn(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1], with
    the head cast to the hidden dtype and applied per chunk."""
    hidden = model(tokens[:, :-1], return_hidden=True)
    weight = model.output.weight.to(hidden.dtype)
    return chunked_cross_entropy(hidden, weight, tokens[:, 1:])


@dataclass
class OptState:
    count: int
    mu: list
    nu: list


@dataclass
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...))``
    on a list of parameters."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay) at
        ``count`` updates done (end value 0)."""
        peak, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:
            return peak * count / warmup
        span = self.decay_steps - warmup
        done = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))

    def init(self, params) -> OptState:
        return OptState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    @torch.no_grad()
    def update_(self, params, grads, state: OptState) -> OptState:
        """One update, in place on ``params`` and the state's moments."""
        params, grads = list(params), list(grads)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        # optax: t if norm < clip else (t / norm) * clip, with no epsilon.
        factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        grads = torch._foreach_mul(grads, factor)

        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count = state.count + 1
        updates = torch._foreach_div(mu, 1.0 - self.b1**count)
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(updates, params, alpha=self.weight_decay)
        # The schedule is read at the count before this update: 0 first.
        torch._foreach_add_(params, updates, alpha=-self.schedule(state.count))
        return OptState(count=count, mu=mu, nu=nu)


def make_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 100,
    decay_steps: int = 10_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    return AdamW(learning_rate, warmup_steps, max(decay_steps, warmup_steps + 1),
                 weight_decay, b1, b2, grad_clip)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: OptState


def init_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    return TrainState(step=0, model=model, opt_state=optimizer.init(list(model.parameters())))


def make_train_step(optimizer: AdamW, loss=loss_fn):
    """``step(state, batch) -> (state, loss)``: forward, backward and one
    optimizer update. ``batch`` is a [b, s+1] token array (numpy or
    tensor); it moves to the model's device."""

    def step(state: TrainState, batch):
        model = state.model
        params = list(model.parameters())
        device = params[0].device
        tokens = torch.as_tensor(batch).to(device=device, dtype=torch.long)
        for p in params:
            p.grad = None
        value = loss(model, tokens)
        value.backward()
        opt_state = optimizer.update_(params, [p.grad for p in params], state.opt_state)
        return TrainState(state.step + 1, model, opt_state), value.detach()

    return step
