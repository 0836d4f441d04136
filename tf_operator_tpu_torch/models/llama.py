"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``tf_operator_tpu/models/llama.py`` (dense path): RMSNorm with
fp32 math, RoPE on the two halves of each head (``ops/rope.py``), causal GQA
flash attention (``ops/flash.py``) with separate wq/wk/wv projections, a
SwiGLU MLP (or, with ``cfg.n_experts``, a mixture of SwiGLU experts:
:class:`MoE`), and a final RMSNorm and output head. Dense layers compute in
``cfg.dtype``; parameters live in ``cfg.param_dtype``.

Parameter names follow the JAX model's tree (``tok_embeddings``,
``layers.{i}.attention.wq``, ``layers.{i}.feed_forward.w1`` or
``.feed_forward.router``/``.experts_w1``, ``norm``, ``output``), so
``models/convert.py`` maps one onto the other leaf by leaf.

Under ``cfg.remat`` each block runs under a reentrant
``torch.utils.checkpoint``, and ``cfg.remat_policy`` (the JAX model's
policy strings, ``_remat_policy``) names what the block's remat tape
(``ops/remat.py``) keeps for the backward's replay: "nothing" keeps nothing
and replays the whole block; "dots" (the default) keeps the outputs of the
matrix products and the flash forward's o and lse, so the replay runs no
matmul and no flash forward; "+rope", "+act" and "+norms" add the rotated
q/k, the MLP activation and the norms' outputs. Remat changes memory and
launch counts, never results.

For sharded training (``parallel/sharding.py``) the model is built on the
meta device, sharded, moved with ``to_empty`` and initialised by
:meth:`Llama.init_weights`, which draws each parameter whole, in the
unsharded order, and keeps the local shard: the sharded model holds
exactly the unsharded one's weights (JAX's init is sharding-invariant too).
Over ``sp`` the attention is the ring (``attention_impl="ring"``) and each
rank's positions are offset by its place in the sequence; over ``pp`` the
model is one pipeline stage (:class:`Llama` ``pp``/``stage``), whose
layers run in the tick loop of ``parallel/pipeline.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import attention as attn_ops
from ..ops import remat
from ..ops.cross_entropy import VocabGroup, chunked_cross_entropy, vocab_parallel_cross_entropy
from ..ops.ring_attention import ring_attention
from ..ops.rope import rope
from ..parallel import experts as ep
from ..parallel.pipeline import pipeline_apply, split_stages


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # Checkpoint policy under remat (``_remat_policy``): "nothing", or "dots"
    # joined by "+" with any of REMAT_SAVEABLE's tokens.
    remat_policy: str = "dots"
    # "pallas": the flash kernels (plain versions for CPU tensors); "xla":
    # the plain reference attention; "ring": ring attention over the sp
    # group through the flash kernels (ops/ring_attention.py), plain causal
    # flash without one.
    attention_impl: str = "pallas"
    # Mixture-of-experts FFN (0 = dense): top-k routing with a per-expert
    # capacity of capacity_factor * s * k / e slots (:class:`MoE`).
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Token routing: "einsum", the GShard one-hot dispatch/combine
    # products; "gather", slot-indexed gathers and scatters of the same
    # capacity assignment (the JAX package's differential oracle).
    moe_impl: str = "einsum"
    # Grouped dispatch: tokens route in independent groups of this many
    # positions when it divides a longer sequence (0 = one group).
    moe_group_size: int = 0
    # Microbatches per pipeline round over a pp group (0 = one per stage):
    # more shrink the GPipe bubble ((pp-1)/(M+pp-1)) at the cost of smaller
    # per-stage matmuls.
    pp_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self, seq: Optional[int] = None) -> float:
        """Approximate training FLOPs per token (fwd+bwd ~ 6 * active params
        + attention term), for MFU accounting."""
        p = self.active_param_count()
        attn = 12 * self.n_layers * self.dim * (seq or self.max_seq_len)
        return 6 * p + attn

    def _per_layer_params(self, n_ffn_experts: int) -> float:
        d, f = self.dim, self.ffn_dim
        return (
            d * d  # wq
            + 2 * d * (self.n_kv_heads * self.head_dim)  # wk, wv
            + d * d  # wo
            + 3 * d * f * max(n_ffn_experts, 1)  # w1, w2, w3 (per expert)
            + (d * self.n_experts if self.n_experts else 0)  # router
            + 2 * d  # norms
        )

    def param_count(self) -> int:
        d, v = self.dim, self.vocab_size
        per_layer = self._per_layer_params(self.n_experts)
        return int(v * d + self.n_layers * per_layer + d + d * v)

    def geometry(self) -> dict:
        """Shape-invisible geometry for checkpoint metadata (head grouping
        is invisible in the flattened projection weights)."""
        return {
            "dim": self.dim,
            "n_layers": self.n_layers,
            "n_heads": self.n_heads,
            "n_kv_heads": self.n_kv_heads,
            "head_dim": self.head_dim,
            "ffn_dim": self.ffn_dim,
            "vocab_size": self.vocab_size,
            "n_experts": self.n_experts,
            "experts_per_token": self.experts_per_token,
        }

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the top-k experts)."""
        d, v = self.dim, self.vocab_size
        k = self.experts_per_token if self.n_experts else 0
        per_layer = self._per_layer_params(k)
        return int(v * d + self.n_layers * per_layer + d + d * v)


# The JAX package's canonical configs, each at its remat policy but
# llama-400m, which keeps "dots": on an H100 its step is within 1% of the
# reference's "dots+rope" in 1.5 GiB less, every gradient equal.
CONFIGS = {
    "llama2-7b": LlamaConfig(),
    "llama-1b": LlamaConfig(dim=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                            ffn_dim=5504, remat_policy="dots+rope+norms"),
    "llama-400m": LlamaConfig(dim=1024, n_layers=24, n_heads=8, n_kv_heads=8,
                              ffn_dim=2816),
    "llama-125m": LlamaConfig(dim=768, n_layers=12, n_heads=6, n_kv_heads=6, ffn_dim=2048),
    "llama-tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        max_seq_len=128, remat=False,
    ),
    "mixtral-8x7b": LlamaConfig(
        n_kv_heads=8, ffn_dim=14336, max_seq_len=4096, rope_theta=1e6,
        n_experts=8, experts_per_token=2,
    ),
    "moe-125m": LlamaConfig(
        dim=768, n_layers=12, n_heads=6, n_kv_heads=6, ffn_dim=2048,
        n_experts=8, experts_per_token=2, remat_policy="dots+rope+norms",
        moe_group_size=256,
    ),
    "moe-tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        max_seq_len=128, remat=False, n_experts=4, experts_per_token=2,
    ),
}


# ---------------------------------------------------------------- remat
# Saveable-tensor vocabulary of the "dots+..." policies: token -> the JAX
# model's checkpoint_name tags.
REMAT_SAVEABLE = {
    "act": ("mlp_act",),
    "rope": ("rope_q", "rope_k"),
    "norms": ("norm_out",),
}
# What "dots" keeps: the outputs of the Dense layers (the counterpart of
# dots_with_no_batch_dims_saveable: products with no batch dimension), the
# flash forward's (o, lse), which the JAX model tags flash_o/flash_lse, and
# the K/V blocks that ring attention received (the JAX model's replay
# rotates them again; keeping them spares the replay n - 1 rotations a
# layer for (n - 1) K/V blocks of memory).
_DOTS = ("dots", "flash", "ring")


def _remat_policy(cfg: LlamaConfig) -> frozenset:
    """The tags that ``cfg.remat_policy`` keeps on a block's remat tape:
    none for "nothing"; for "dots+...", the dots, the flash forward's
    (o, lse) and the tags of the "+" tokens."""
    name = cfg.remat_policy
    if name == "nothing":
        return frozenset()
    parts = name.split("+")
    if parts[0] != "dots" or not all(p in REMAT_SAVEABLE for p in parts[1:]):
        raise ValueError(
            f"unknown remat_policy {name!r}: expected 'nothing' or 'dots' "
            f"joined with any of {sorted(REMAT_SAVEABLE)} (e.g. 'dots+rope')"
        )
    return frozenset(_DOTS) | {t for p in parts[1:] for t in REMAT_SAVEABLE[p]}


class _Linear(torch.autograd.Function):
    """``F.linear(x, w)`` whose output a remat tape can keep ("dots")."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return remat.saved("dots", lambda: F.linear(x, w))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dw = dy.flatten(0, -2).t() @ x.flatten(0, -2)
        return dy @ w, dw


class _Mul(torch.autograd.Function):
    """``a * b`` (b broadcast over a) whose output a remat tape can keep."""

    @staticmethod
    def forward(ctx, a, b, tag):
        ctx.save_for_backward(a, b)
        return remat.saved(tag, lambda: a * b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        return (dy * b).sum_to_size(a.shape), (dy * a).sum_to_size(b.shape), None


class _Cast(torch.autograd.Function):
    """``x.to(dtype)`` whose output a remat tape can keep."""

    @staticmethod
    def forward(ctx, x, dtype, tag):
        ctx.src_dtype = x.dtype
        return remat.saved(tag, lambda: x.to(dtype))

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.src_dtype), None, None


def linear(x, w):
    """``F.linear(x, w)``: the matrix product whose output a "dots" remat
    tape keeps (JAX's dots_with_no_batch_dims_saveable), else the plain
    product."""
    return _Linear.apply(x, w) if remat.saving("dots") else F.linear(x, w)


def _mul(a, b, tag: str):
    """``a * b``, the op that the JAX model names ``tag``: one the tape
    keeps when the policy saves ``tag``, else the plain product."""
    return _Mul.apply(a, b, tag) if remat.saving(tag) else a * b


def _cast(x, dtype, tag: str):
    """``x.to(dtype)``, named ``tag`` as :func:`_mul` names its product."""
    return _Cast.apply(x, dtype, tag) if remat.saving(tag) else x.to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        scale = self.scale.float()
        # norm_out is the last op: the product in fp32, else the cast.
        if x.dtype == torch.float32:
            return _mul(normed, scale, "norm_out")
        return _cast(normed * scale, x.dtype, "norm_out")


def rope_table(head_dim: int, max_len: int, theta: float, device=None):
    """cos/sin tables [max_len, head_dim/2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def gather_rope(cfg: LlamaConfig, positions: torch.Tensor):
    """Per-position cos/sin, [b, s, 1, d/2] fp32, from tables built at
    ``cfg.max_seq_len``."""
    cos, sin = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, positions.device)
    return cos[positions][:, :, None, :], sin[positions][:, :, None, :]


def apply_rope(x, cos, sin, tag: Optional[str] = None):
    """x: [b, s, h, d]; rotate pairs by pre-gathered cos/sin ([b, s, 1, d/2]).
    The rope kernel takes one table for the whole batch, so it runs when the
    positions are shared (cos.shape[0] == 1) and cover x's sequence; only
    then can a remat tape keep its output under ``tag``."""
    if cos.shape[0] == 1 and x.shape[1] == cos.shape[1]:
        return rope(x, cos[0, :, 0, :], sin[0, :, 0, :], tag)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Dense(nn.Linear):
    """Bias-free dense layer computed in ``cfg.dtype`` (Flax's
    ``dtype=cfg.dtype``) on a weight kept in ``cfg.param_dtype``, or both
    in ``dtype`` when it is given (the MoE router's fp32). It is called as
    a module, so that the tensor-parallel plans' hooks
    (``parallel/sharding.py``) see its input and output."""

    def __init__(self, cfg: LlamaConfig, d_in: int, d_out: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(d_in, d_out, bias=False, device=device,
                         dtype=dtype or cfg.param_dtype)
        self.compute_dtype = dtype or cfg.dtype

    def forward(self, x):
        return linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class Attention(nn.Module):
    """Causal GQA attention. ``sp_group`` (set by
    ``parallel/sharding.shard_model`` on a mesh with ``sp``) is the ring of
    ``attention_impl="ring"``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.sp_group = None
        hd = cfg.head_dim
        # Three separate projections, as the JAX model keeps them.
        self.wq = Dense(cfg, cfg.dim, cfg.n_heads * hd, device)
        self.wk = Dense(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wv = Dense(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wo = Dense(cfg, cfg.n_heads * hd, cfg.dim, device)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        # Head counts come from the tensors: under tensor parallelism each
        # rank holds only its own heads.
        q = self.wq(x).view(b, s, -1, hd)
        k = self.wk(x).view(b, s, -1, hd)
        v = self.wv(x).view(b, s, -1, hd)
        q = apply_rope(q, cos, sin, "rope_q")
        k = apply_rope(k, cos, sin, "rope_k")
        if cfg.attention_impl == "pallas":
            out = attn_ops.flash_attention(q, k, v, causal=True)
        elif cfg.attention_impl == "ring":
            out = ring_attention(q, k, v, self.sp_group)
        else:
            out = attn_ops.xla_attention(q, k, v, causal=True)
        return self.wo(out.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.w1 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w3 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w2 = Dense(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, x):
        return self.w2(_mul(F.silu(self.w1(x)), self.w3(x), "mlp_act"))


def routing_groups(cfg: LlamaConfig, s_local: int, sp_size: int = 1) -> tuple:
    """(positions of one routing group, sp ranks it spans) for a piece of
    ``s_local`` positions of a sequence split over ``sp_size`` ranks. As in
    the JAX layer, the whole sequence routes in groups of
    ``moe_group_size`` positions when that divides a longer sequence, else
    as one group. A group inside one rank's piece routes there alone (span
    1); a group of several whole pieces spans their ranks, which exchange
    their counts; any other split is refused."""
    whole = s_local * sp_size
    group = cfg.moe_group_size
    length = group if group and whole > group and whole % group == 0 else whole
    if s_local % length == 0:
        return length, 1
    if length % s_local == 0:
        return length, length // s_local
    raise ValueError(
        f"moe_group_size={group} over {sp_size} sp ranks of {s_local} positions each: a "
        f"routing group of {length} positions neither lies inside one rank's piece nor "
        "covers whole pieces")


def slot_offsets(counts: torch.Tensor, rank: int, span: int) -> torch.Tensor:
    """Where sp rank ``rank``'s routes start taking slots, per routing rank,
    batch row and expert ([k, b, e]), from ``counts`` [n, k, b, e], the
    route counts of every sp rank (of this rank alone, [1, k, b, e] at
    rank 0, when its routing groups span 1 rank), its group the ``span``
    ranks from ``rank - rank % span``. Slots go rank-major over the whole
    group: routing rank j starts after every route of the routing ranks
    below j and rank j's routes at the group's earlier positions, on the
    ranks before this one."""
    place = rank % span
    group = counts[rank - place:rank - place + span]
    total = group.sum(0)
    return group[:place].sum(0) + total.cumsum(0) - total


@dataclass
class Routing:
    """The router's choices for one rank's tokens (``MoE.route``): the
    grouped input ``x`` [b, s, d], the fp32 ``probs`` [b, s, e], the
    renormalised ``gate`` and expert ``idx`` [b, s, k], their ``onehot``
    [b, s, k, e], the per-expert capacity ``cap``, the sp ranks a routing
    group ``span``s, and the input's ``shape``."""

    x: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    onehot: torch.Tensor
    cap: int
    span: int
    shape: tuple

    @property
    def tokens(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    def counts(self) -> torch.Tensor:
        """Routes to each expert per routing rank and batch row, [k, b, e]."""
        return self.onehot.sum(1).transpose(0, 1)

    def stats(self) -> tuple:
        """(routes to each expert, summed router probability of each), [e]
        each in fp32: the load-balancing loss's sums over these tokens."""
        return self.onehot.float().sum((0, 1, 2)), self.probs.sum((0, 1))


class MoE(nn.Module):
    """Mixture-of-experts SwiGLU FFN with GShard capacity dispatch, the
    counterpart of the JAX model's ``MoE``; ``forward`` returns the output
    and the layer's Switch load-balancing loss.

    A bias-free router whose weight is fp32 whatever ``param_dtype`` says
    scores the fp32 tokens; softmax, top-k and the renormalised gate pick
    ``experts_per_token`` experts. Slots are assigned rank-major (every
    rank-0 choice before any rank-1 choice), in integers, one rank at a
    time; a token past an expert's ``capacity_factor * s * k / e`` slots is
    dropped by that expert (the residual passes it through). With
    ``moe_group_size`` the sequence routes in groups folded into the batch,
    each with its own capacity. ``moe_impl`` routes by the one-hot
    dispatch/combine einsums ("einsum") or by slot gathers ("gather"): two
    formulations of one assignment. Expert weights are ``experts_w1``/
    ``experts_w3`` ``[e, d, f]`` and ``experts_w2`` ``[e, f, d]``.

    Under remat the router's product, which has no batch dimension, is kept
    by "dots" (JAX's dots_with_no_batch_dims_saveable), so the replay routes
    from the forward's own logits; the dispatch, expert and combine products
    have one (b or e) and are replayed, and so are the all-to-alls between
    them: no policy keeps an all-to-all's output.

    ``layout`` (``parallel/experts.ExpertLayout``, set by
    ``parallel/sharding.shard_model``) says where the experts live. With an
    expert axis the dispatch einsum's ``[e, b, cap, d]`` goes to the
    experts' owners by an all-to-all, the owners run their ``e/E`` experts
    on ``[e/E, E*b, cap, d]`` and the output comes back by the reverse
    all-to-all before the combine; the gather routing then falls back to
    the einsums, as in the JAX layer. Capacity is per batch row, so
    splitting the batch drops the same tokens. The load-balancing loss is
    formed from statistics summed over every data and sp rank: the global
    batch's over the whole sequence, as the JAX layer's under ``jit``.

    Over ``sp`` (``layout.sp_size`` ranks, each with its piece of the
    sequence) the routing, the capacity and the dropped tokens are those of
    the whole sequence (:func:`routing_groups`). Where a routing group
    spans several ranks, they exchange their route counts
    (``parallel/experts.sequence_counts``), from which each finds where its
    tokens' slots start (:func:`slot_offsets`). Every slot is then filled
    by one token of one rank, and an empty slot's SwiGLU output is 0, so
    each rank runs the experts on its own kept routes alone, compacted
    into as many slots as it needs (:meth:`assign`), and no activation
    crosses ``sp``. ``forward`` is :meth:`route`, the counts' exchange,
    :meth:`assign` and :meth:`aux_loss` in turn.
    """

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        if cfg.moe_impl not in ("einsum", "gather"):
            raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
        self.router = Dense(cfg, d, e, device, dtype=torch.float32)

        def weight(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=cfg.param_dtype, device=device))

        self.experts_w1 = weight(e, d, f)
        self.experts_w3 = weight(e, d, f)
        self.experts_w2 = weight(e, f, d)
        self.layout = ep.ExpertLayout()

    def forward(self, x):
        layout = self.layout
        routing = self.route(x)
        counts, rank = routing.counts()[None], 0
        if routing.span > 1:
            # The routing group spans several sp ranks: the slots that its
            # earlier positions took, from every rank's counts.
            counts, rank = ep.sequence_counts(counts[0], layout), layout.sp_rank
        y = self.assign(routing, slot_offsets(counts, rank, routing.span))
        f_sum, p_sum = routing.stats()
        aux = self.aux_loss(ep.data_sum(f_sum, layout), ep.data_sum(p_sum, layout),
                            routing.tokens * layout.data_size)
        return y, aux

    def route(self, x) -> "Routing":
        """The router's choices for ``x`` (this rank's piece of the
        sequence, when ``layout.sp_size`` ranks split it), in the routing
        groups of :func:`routing_groups`."""
        cfg = self.cfg
        b0, s0, d = x.shape
        length, span = routing_groups(cfg, s0, self.layout.sp_size)
        if length < s0:
            x = x.reshape(b0 * (s0 // length), length, d)
        e, k = cfg.n_experts, cfg.experts_per_token
        cap = max(1, int(cfg.capacity_factor * length * k / e))
        probs = torch.softmax(self.router(x.float()), dim=-1)  # [b, s, e] fp32
        gate, idx = torch.topk(probs, k)  # [b, s, k], descending as lax.top_k
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        return Routing(x, probs, gate, idx, F.one_hot(idx, e), cap, span, (b0, s0, d))

    def assign(self, routing: "Routing", offsets) -> torch.Tensor:
        """The layer's output [b0, s0, d] for ``routing``, each routing
        rank's slots starting at ``offsets`` ([k, b, e], from
        :func:`slot_offsets`).

        A route is kept where its slot in the whole group is below the
        capacity. The kept routes of this rank then take the slots of its
        own, rank-major: routing rank j's after the kept routes of the
        routing ranks below j. Within one rank's group this is the group's
        own slot; where the group spans several sp ranks, the experts run
        on as many slots as this rank keeps routes to one expert at most
        (``experts.slot_count``), not on the group's capacity."""
        x, onehot, cap = routing.x, routing.onehot, routing.cap
        # Capacity, rank-major, in integers (a bf16 count is exact only to
        # 256): per routing rank, each token's slot in its chosen expert
        # and whether it won one. Never [b, s, k, e, cap].
        kept = (cap - offsets).clamp(min=0).minimum(routing.counts())  # [k, b, e]
        start = kept.cumsum(0) - kept
        slots = cap if routing.span == 1 else ep.slot_count(kept.sum(0), self.layout)
        pos, keep = [], []
        for j in range(onehot.shape[2]):
            oh = onehot[:, :, j]
            p = oh.cumsum(1) - oh
            pos.append(p + start[j][:, None, :])
            keep.append((p < kept[j][:, None, :]) & (oh > 0))
        gather = self.cfg.moe_impl == "gather" and self.layout.axis is None
        route = self._gather if gather else self._einsum
        y = route(x, routing.gate, routing.idx, pos, keep, slots)
        return y.to(x.dtype).reshape(routing.shape)

    def aux_loss(self, f_sum, p_sum, tokens: int) -> torch.Tensor:
        """Switch load-balance loss e * sum(f * P): f the share of routes to
        each expert, P its mean probability, from the sums of
        :meth:`Routing.stats` over ``tokens`` positions (every data and sp
        rank's)."""
        e, k = self.cfg.n_experts, self.cfg.experts_per_token
        return e * ((f_sum / (tokens * k)) * (p_sum / tokens)).sum() * self.cfg.router_aux_weight

    def _experts(self, h):
        """The SwiGLU experts on their slots: [e, b, cap, d] -> same, for
        the experts this rank holds (their ``f`` split over ``tp``: the
        ``w2`` product's partial sums are summed there)."""
        dt, layout = self.cfg.dtype, self.layout
        w1, w3, w2 = (ep.expert_weight(w, layout).to(dt)
                      for w in (self.experts_w1, self.experts_w3, self.experts_w2))
        h = ep.copy_to_tp(h, layout)
        act = (F.silu(torch.einsum("ebcd,edf->ebcf", h, w1))
               * torch.einsum("ebcd,edf->ebcf", h, w3))
        return ep.reduce_from_tp(torch.einsum("ebcf,efd->ebcd", act, w2), layout)

    def _einsum(self, x, gate, idx, pos, keep, cap):
        """GShard routing: combine [b, s, e, cap] built in ``cfg.dtype``, and
        the dispatch mask from it (a gate that underflows drops its token)."""
        dt = self.cfg.dtype
        slots = torch.arange(cap, device=x.device)
        combine = 0
        for j in range(len(pos)):
            weight = keep[j].to(dt) * gate[:, :, j, None].to(dt)  # [b, s, e]
            slot = (pos[j].clamp(max=cap - 1)[..., None] == slots).to(dt)
            combine = combine + weight[..., None] * slot
        dispatch = (combine > 0).to(dt)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x.to(dt))
        if self.layout.group is not None:
            out = ep.from_owners(self._experts(ep.to_owners(expert_in, self.layout)),
                                 self.layout)
        else:
            out = self._experts(expert_in)
        # A bf16 product accumulates in fp32 and is rounded once, as the
        # JAX einsum's preferred_element_type=float32 and its cast back.
        return torch.einsum("bsec,ebcd->bsd", combine, out)

    def _gather(self, x, gate, idx, pos, keep, cap):
        """Slot-indexed routing: each (token, rank) takes flat slot
        ``expert * cap + pos``, or the overflow row ``e * cap`` when it lost
        the race. Every kept slot has one writer and duplicate writes land
        only in the overflow row, which is dropped, so the order in which
        the device applies the index writes changes no result."""
        dt = self.cfg.dtype
        b, s, d = x.shape
        e, k = self.cfg.n_experts, self.cfg.experts_per_token

        def chosen(per_rank):  # [b, s, e] per rank -> [b, s, k] at idx
            return torch.stack([t.gather(2, idx[:, :, j, None])[..., 0]
                                for j, t in enumerate(per_rank)], -1)

        fslot = torch.where(chosen(keep), idx * cap + chosen(pos), e * cap).reshape(b, s * k)
        token = torch.arange(s, device=x.device).repeat_interleave(k).expand(b, -1)
        token_of_slot = torch.zeros(b, e * cap + 1, dtype=torch.long,
                                    device=x.device).scatter_(1, fslot, token)
        valid = torch.zeros(b, e * cap + 1, dtype=dt, device=x.device).scatter_(1, fslot, 1.0)
        rows = x.to(dt).gather(1, token_of_slot[:, :-1, None].expand(-1, -1, d))
        expert_in = (rows * valid[:, :-1, None]).view(b, e, cap, d).transpose(0, 1)
        out = self._experts(expert_in)  # [e, b, cap, d]
        # The overflow row is zeros: a dropped route adds nothing.
        out_flat = torch.cat([out.transpose(0, 1).reshape(b, e * cap, d),
                              out.new_zeros(b, 1, d)], dim=1)
        contrib = out_flat.gather(1, fslot[..., None].expand(-1, -1, d)).view(b, s, k, d)
        # The gate in cfg.dtype, as the einsum routing's combine holds it,
        # and the k products summed in fp32: in bf16 too the two routings
        # give the same output, so a layer routes the same tokens after
        # either (the JAX gather path takes the fp32 gate: in fp32 the same).
        return (contrib.float() * gate.to(dt).float()[..., None]).sum(2)


class Block(nn.Module):
    """One decoder layer. Under ``cfg.remat`` its forward runs under a
    reentrant checkpoint, with a remat tape that keeps what the config's
    policy saves. Reentrant: the forward runs with no autograd graph and
    no per-tensor hooks, the cheapest form on the host, which feeds the
    card; the backward replays the block and differentiates the replay.
    The checkpoint sits inside the block, so that when the block is
    sharded (FSDP2 hooks on its call), the replay runs on the weights that
    FSDP2 gathered for the backward, with no second forward hook.

    ``forward`` returns ``(x, aux)``: the MoE layer's load-balancing loss,
    or None for a dense layer. The aux term is an output of the
    checkpointed function, not state kept on the module: the reentrant
    forward runs with no graph, and only the replay's outputs carry one.
    """

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.attention = Attention(cfg, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.moe = cfg.n_experts > 0
        self.feed_forward = MoE(cfg, device) if self.moe else MLP(cfg, device)
        self.remat = cfg.remat
        self.saves = _remat_policy(cfg)

    def _forward(self, x, cos, sin):
        x = x + self.attention(self.attention_norm(x), cos, sin)
        if self.moe:
            h, aux = self.feed_forward(self.ffn_norm(x))
            return x + h, aux
        return x + self.feed_forward(self.ffn_norm(x)), None

    def forward(self, x, cos, sin):
        # A reentrant checkpoint differentiates only through inputs that
        # need a gradient: a block fed by frozen embeddings runs unsaved.
        if self.remat and torch.is_grad_enabled() and x.requires_grad:
            tape = remat.Tape(self.saves)
            return checkpoint(tape.run, self._forward, x, cos, sin, use_reentrant=True,
                              preserve_rng_state=False)
        return self._forward(x, cos, sin)


# The JAX model's refusals of a pipeline over pp (its ``Llama.__call__``),
# with its reasons.
PP_REFUSALS = {
    "moe": "MoE + pipeline parallelism is not supported yet (the blocks' sown aux losses "
           "don't cross the pipeline)",
    "ring": "ring attention + pipeline parallelism is not supported yet (a nested "
            "full-mesh shard_map is illegal inside the pp-manual region)",
}


class Llama(nn.Module):
    """Decoder stack. Weights are drawn from ``generator`` (normal(0.02)
    for every matrix, ones for the norm scales), on ``device``: ``cuda``
    unless the caller asks for the CPU, or ``meta`` (shapes only, drawn
    nothing) for a model that is sharded before it is initialised.

    With ``pp`` above 1 the model is stage ``stage`` of a pipeline
    (``parallel/pipeline.py``): it keeps only its ``n_layers / pp``
    contiguous layers, under their unsharded names (``layers.{i}``, in a
    ``ModuleDict``), so that its checkpoint restores into a model without
    a pipeline, as the JAX model's "checkpoints are interchangeable"; the
    embedding lives on stage 0, the final norm and the head on the last
    stage (the JAX model keeps both on every stage: a layout difference,
    the same loss). ``pp_group`` (set by ``parallel/sharding.shard_model``)
    is the pipeline's group; without it a pipelined model cannot run.
    ``sp_rank``/``sp_size`` (also set there) place the local sequence at
    positions ``[sp_rank * s, (sp_rank + 1) * s)``. ``tp_mesh`` (also set
    there, over ``tp`` above 1) splits the embedding's d and the head's
    vocab over tp: the forward gathers the embedding's d, and takes the
    loss by ``vocab_parallel_cross_entropy`` (the logits, asked for, are
    gathered over the vocabulary once at the end)."""

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None, pp: int = 1, stage: int = 0):
        super().__init__()
        if config.attention_impl not in ("pallas", "xla", "ring"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}")
        if pp > 1:
            if config.n_experts:
                raise NotImplementedError(PP_REFUSALS["moe"])
            if config.attention_impl == "ring":
                raise NotImplementedError(PP_REFUSALS["ring"])
        if not 0 <= stage < pp:
            raise ValueError(f"stage {stage} of {pp} pipeline stages")
        meta = device is not None and torch.device(device).type == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        self.config = config
        self.stages, self.stage = pp, stage
        self.pp_group = None
        self.sp_rank, self.sp_size = 0, 1
        self.tp_mesh = None
        first, last = stage == 0, stage == pp - 1
        self.tok_embeddings = nn.Embedding(
            config.vocab_size, config.dim, device=device,
            dtype=config.param_dtype) if first else None
        if pp == 1:
            self.layers = nn.ModuleList(Block(config, device) for _ in range(config.n_layers))
        else:
            mine = split_stages(range(config.n_layers), pp)[stage]
            self.layers = nn.ModuleDict({str(i): Block(config, device) for i in mine})
        self.norm = RMSNorm(config.dim, config.norm_eps, config.param_dtype,
                            device) if last else None
        self.output = Dense(config, config.dim, config.vocab_size, device) if last else None
        if not meta:
            self.init_weights(generator)

    def blocks(self) -> list:
        """This model's layers, in order."""
        return list(self.layers.values() if isinstance(self.layers, nn.ModuleDict)
                    else self.layers)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter of the whole model in ``named_parameters``
        order; a pipeline stage keeps its own and draws the others only to
        advance ``generator``. A sharded parameter (DTensor) is drawn whole
        on its local device, as the unsharded model draws it, and keeps its
        own shard of it."""
        own = dict(self.named_parameters())
        first = next(iter(own.values()))
        device = (first.to_local() if isinstance(first, DTensor) else first).device
        whole = self if self.stages == 1 else Llama(self.config, device="meta")
        for name, p in whole.named_parameters():
            if name.endswith(".scale") or name == "scale":
                if name in own:
                    own[name].fill_(1.0)
                continue
            p = own.get(name)
            if isinstance(p, DTensor):
                full = torch.empty(p.shape, dtype=p.dtype, device=device)
                full.normal_(0.0, 0.02, generator=generator)
                local = distribute_tensor(full, p.device_mesh, p.placements,
                                          src_data_rank=None)
                p.to_local().copy_(local.to_local())
            elif p is not None:
                p.normal_(0.0, 0.02, generator=generator)
            else:  # another stage's
                shape = whole.get_parameter(name).shape
                torch.empty(shape, dtype=self.config.param_dtype,
                            device=device).normal_(0.0, 0.02, generator=generator)

    def _stage(self, stage: int, x, cos, sin):
        """This stage's layers on ``x``: ``parallel/pipeline.py``'s stage
        function, called with this rank's stage (a pipelined model holds
        its own stage's layers only)."""
        for layer in self.layers.values():
            x, _ = layer(x, cos, sin)
        return x

    def forward(self, tokens, targets=None, return_hidden: bool = False,
                return_aux: bool = False):
        """Logits [b, s, vocab] fp32; with ``targets``, the mean next-token
        loss plus the MoE layers' load-balancing losses (the loss the JAX
        package's ``loss_fn`` forms), its head applied per sequence chunk
        (``chunked_cross_entropy``) inside this forward, where FSDP2 has
        gathered a sharded head (over ``tp``, each rank's rows of it:
        ``vocab_parallel_cross_entropy``); with ``return_hidden``, the
        pre-logits hidden
        states. ``return_aux`` returns ``(logits or hidden, aux)``, the sum
        of the layers' load-balancing losses (None for a dense model).

        On a pipeline stage other than the last, the loss is 0 and the
        other outputs are zeros of the hidden state's shape: their backward
        drives the stage's."""
        cfg = self.config
        b, s = tokens.shape
        offset = self.sp_rank * s
        positions = torch.arange(offset, offset + s, device=tokens.device)[None]
        cos, sin = gather_rope(cfg, positions)
        if self.stages > 1:
            return self._pipelined(tokens, targets, cos, sin, return_hidden, return_aux)
        x = self._embed(tokens)
        aux = None
        for layer in self.layers:
            x, layer_aux = layer(x, cos, sin)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        return self._head(x, targets, return_hidden, return_aux, aux)

    def _gather_tp(self, local: torch.Tensor) -> torch.Tensor:
        """``local``'s last dim gathered over ``tp_mesh``; its gradient,
        which every tp rank holds whole, split back to each rank's part."""
        spread = DTensor.from_local(local, self.tp_mesh, [Shard(local.dim() - 1)],
                                    run_check=False)
        return spread.redistribute(self.tp_mesh, [Replicate()]).to_local()

    def _embed(self, tokens):
        weight = self.tok_embeddings.weight
        if self.tp_mesh is None:
            return F.embedding(tokens, weight.to(self.config.dtype))
        # Each tp rank looks up its part of d; one gather makes the row.
        local = weight.to_local() if isinstance(weight, DTensor) else weight
        return self._gather_tp(F.embedding(tokens, local.to(self.config.dtype)))

    def _head(self, x, targets, return_hidden, return_aux, aux=None):
        x = self.norm(x)
        weight = self.output.weight
        if self.tp_mesh is not None and isinstance(weight, DTensor):
            weight = weight.to_local()  # this rank's rows of the vocabulary
        if targets is not None:
            # The [b, s, vocab] fp32 logits never exist whole.
            if self.tp_mesh is None:
                loss = chunked_cross_entropy(x, weight.to(x.dtype), targets)
            else:
                loss = vocab_parallel_cross_entropy(x, weight.to(x.dtype), targets,
                                                    VocabGroup(self.tp_mesh.get_group()))
            return loss if aux is None else loss + aux
        if return_hidden:
            out = x
        elif self.tp_mesh is None:
            out = self.output(x).float()
        else:
            out = self._gather_tp(linear(x, weight.to(x.dtype))).float()
        return (out, aux) if return_aux else out

    def _pipelined(self, tokens, targets, cos, sin, return_hidden, return_aux):
        cfg = self.config
        if self.pp_group is None:
            raise RuntimeError("a pipeline stage runs over its pp group: shard the model "
                               "over a mesh with pp (parallel/sharding.shard_model)")
        b, s = tokens.shape
        if self.stage == 0:
            x = self._embed(tokens)
        else:
            x = torch.zeros(b, s, cfg.dim, dtype=cfg.dtype, device=tokens.device)
        x = pipeline_apply(self._stage, x, cos, sin,
                           num_microbatches=cfg.pp_microbatches or self.stages,
                           group=self.pp_group)
        if self.stage == self.stages - 1:
            return self._head(x, targets, return_hidden, return_aux)
        if targets is not None:
            return x.sum(dtype=torch.float32)
        return (x, None) if return_aux else x
