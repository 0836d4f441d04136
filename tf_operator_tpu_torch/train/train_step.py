"""Training step: the next-token loss, optax-exact AdamW, one step.

Counterpart of ``tf_operator_tpu/train/train_step.py``, unsharded or sharded
(``init_sharded_train_state``: FSDP2 and tensor parallelism over a device
mesh, ``parallel/sharding.py``). The
optimizer reproduces ``make_optimizer``'s optax chain rather than torch's
defaults, because that is where an optimizer port drifts:

- ``warmup_cosine_decay_schedule(0.0, lr, warmup, max(decay, warmup+1))``:
  the first update runs at lr 0, and ``decay_steps`` counts the warmup;
- ``clip_by_global_norm``: no ``+1e-6`` in the divisor (unlike
  ``clip_grad_norm_``), clipping only when the norm reaches the limit;
- AdamW with eps 1e-8 and bias correction, weight decay on every leaf
  (norm scales included), moments kept in the parameter dtype.

:func:`adamw` is the same AdamW as ``optax.adamw`` alone: a constant
learning rate, no clip (the BERT example's optimizer).

Parameters and moments are updated in place (the JAX step donates its
state buffers for the same reason: no second copy of the model). On a
sharded model each rank updates its own shards: AdamW is elementwise, so
only the clip's global norm needs the other ranks (one all-reduce).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops.cross_entropy import (  # noqa: F401 (the step's loss helpers)
    chunked_cross_entropy,
    cross_entropy_loss,
)


def loss_fn(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token LM loss: predict tokens[:, 1:] from tokens[:, :-1]. The
    model applies its head per chunk inside its own forward
    (``Llama.forward(targets=...)``), where FSDP2 has gathered a sharded
    head; read from outside, the head would be this rank's shard. Over
    ``sp`` each rank takes its piece of the shifted sequence: the mean of
    the ranks' losses is the whole sequence's."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    n = getattr(model, "sp_size", 1)
    if n > 1:
        s = inputs.shape[1]
        if s % n:
            raise ValueError(f"sequence {s} not divisible by sp={n}")
        piece = slice(model.sp_rank * s // n, (model.sp_rank + 1) * s // n)
        inputs, targets = inputs[:, piece], targets[:, piece]
    return model(inputs, targets=targets)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view: writes reach the DTensor);
    a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _copies(g: DTensor, stages: int = 1) -> int:
    """Ranks of the world that hold each element of ``g``: the world (over
    the pipeline's ``stages``: only one stage holds ``g``) over the product
    of the mesh dims that shard it. FSDP2 shards a tensor-parallel weight's
    tp-sharded dim again as ``_StridedShard``, which ``is_shard()`` does
    not count: every placement but ``Replicate`` shards."""
    shards = 1
    for dim, placement in enumerate(g.placements):
        if placement.is_partial():
            raise ValueError(f"gradient with a pending reduction {g.placements}")
        if not placement.is_replicate():
            shards *= g.device_mesh.size(dim)
    return dist.get_world_size() // stages // shards


def global_norm(grads, stages: int = 1) -> torch.Tensor:
    """fp32 L2 norm over every element of ``grads``. Sharded gradients
    (DTensors; a sharded model has no other kind) count each element once
    over the whole world: each rank's squared norm of its shard is divided
    by the number of ranks that hold a copy of it, and one all-reduce sums
    the ranks' shares, over the ``stages`` of a pipeline too."""
    grads = list(grads)
    norms = torch.stack([torch.linalg.vector_norm(_local(g), dtype=torch.float32)
                         for g in grads])
    if not isinstance(grads[0], DTensor):
        return torch.linalg.vector_norm(norms)
    copies = torch.tensor([_copies(g, stages) for g in grads], dtype=torch.float32,
                          device=norms.device)
    total = (norms.square() / copies).sum()
    dist.all_reduce(total)
    return total.sqrt()


@dataclass
class OptState:
    count: int
    mu: list
    nu: list


@dataclass
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, ...))``
    on a list of parameters; with ``decay_steps`` None the learning rate is
    constant, and with ``grad_clip`` None nothing is clipped."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: Optional[int] = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: Optional[float] = 1.0
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay) at
        ``count`` updates done (end value 0), or the constant rate."""
        peak, warmup = self.learning_rate, self.warmup_steps
        if self.decay_steps is None:
            return peak
        if count < warmup:
            return peak * count / warmup
        span = self.decay_steps - warmup
        done = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))

    def init(self, params) -> OptState:
        """Moments shaped like each parameter's local shard."""
        return OptState(
            count=0,
            mu=[torch.zeros_like(_local(p)) for p in params],
            nu=[torch.zeros_like(_local(p)) for p in params],
        )

    @torch.no_grad()
    def update_(self, params, grads, state: OptState, stages: int = 1) -> OptState:
        """One update, in place on ``params`` (their local shards, for
        DTensors) and the state's moments; ``stages``: the pipeline's, of
        which ``params`` are one stage's."""
        grads = list(grads)
        if self.grad_clip is not None:
            # optax: t if norm < clip else (t / norm) * clip, with no epsilon.
            norm = global_norm(grads, stages)
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        params, grads = [_local(p) for p in params], [_local(g) for g in grads]
        if self.grad_clip is not None:
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


def adamw(learning_rate: float, weight_decay: float = 1e-4, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay)``: constant
    learning rate, no clip."""
    return AdamW(learning_rate, warmup_steps=0, decay_steps=None, weight_decay=weight_decay,
                 b1=b1, b2=b2, grad_clip=None, eps=eps)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: OptState


def init_train_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    return TrainState(step=0, model=model, opt_state=optimizer.init(list(model.parameters())))


def init_sharded_train_state(model: nn.Module, optimizer: AdamW, mesh, device,
                             generator=None) -> TrainState:
    """The train state born sharded (``init_sharded_train_state`` in the JAX
    package): ``model``, built on the meta device, is sharded over ``mesh``
    (``parallel/sharding.shard_model``), given storage for its shards only
    on ``device`` (``to_empty``), and initialised by its ``init_weights``
    from ``generator``, which leaves each shard as the unsharded model
    would hold it. Nothing ever exists unsharded but one parameter at a
    time while it is drawn."""
    from ..parallel.sharding import shard_model

    shard_model(model, mesh)
    model.to_empty(device=device)
    model.init_weights(generator)
    return init_train_state(model, optimizer)


@torch.no_grad()
def average_gradients(params, group) -> None:
    """Average every parameter's gradient over ``group`` (a replicated
    model's data-parallel step): one all-reduce (a sum, then divided by the
    size) of all the gradients of one dtype at once."""
    size = dist.get_world_size(group)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= size
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def _on_device(batch, device):
    """A batch array (numpy or tensor) on ``device``, integer ids as int64
    and a boolean mask as it is; a tuple of them element by element."""
    if isinstance(batch, tuple):
        return tuple(_on_device(b, device) for b in batch)
    t = torch.as_tensor(batch)
    return t.to(device=device, dtype=torch.bool if t.dtype == torch.bool else torch.long)


def make_train_step(optimizer: AdamW, loss=loss_fn, replica_group=None):
    """``step(state, batch) -> (state, loss)``: forward, backward and one
    optimizer update of ``loss(model, batch)``. ``batch`` is this rank's
    [b, s+1] token array (numpy or tensor), or a tuple of arrays (the BERT
    example's ids, labels and mask); a host batch moves to the model's
    device, and a batch already there (``data.DevicePrefetch``) is only
    cast to int64 in place of a copy. On a sharded model the loss returned
    is the global batch's: the mean over all ranks (each ``sp`` rank's of
    its piece of the sequence), where over a pipeline only the last
    stage's ranks hold a loss. The reduction is one all-reduce of a scalar
    on the device; the host reads nothing. With
    ``replica_group`` the model is replicated over that group (data
    parallel, ``parallel/sharding.data_parallel_group``): the gradients
    and the loss returned are averaged over it before the update."""

    def step(state: TrainState, batch):
        model = state.model
        params = list(model.parameters())
        device = _local(params[0]).device
        tokens = _on_device(batch, device)
        for p in params:
            p.grad = None
        value = loss(model, tokens)
        value.backward()
        if replica_group is not None:
            average_gradients(params, replica_group)
        stages = getattr(model, "stages", 1)
        opt_state = optimizer.update_(params, [p.grad for p in params], state.opt_state,
                                      stages)
        value = value.detach()
        if replica_group is not None:
            dist.all_reduce(value, group=replica_group)
            value = value / dist.get_world_size(replica_group)
        elif isinstance(params[0], DTensor):
            # Ranks of one tensor-parallel group hold the same loss, so the
            # world's mean is the data-parallel mean; of a pipeline's
            # stages, the last holds the loss and the others 0.
            dist.all_reduce(value)
            value = value * stages / dist.get_world_size()
        return TrainState(state.step + 1, model, opt_state), value

    return step
