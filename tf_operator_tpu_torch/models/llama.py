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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import attention as attn_ops
from ..ops import remat
from ..ops.cross_entropy import chunked_cross_entropy
from ..ops.rope import rope


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
    # the plain reference attention; "ring" is not ported yet.
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


# The JAX package's canonical configs.
CONFIGS = {
    "llama2-7b": LlamaConfig(),
    "llama-1b": LlamaConfig(dim=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                            ffn_dim=5504),
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
# dots_with_no_batch_dims_saveable: products with no batch dimension) and
# the flash forward's (o, lse), which the JAX model tags flash_o/flash_lse.
_DOTS = ("dots", "flash")


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
        x, w = x.to(self.compute_dtype), self.weight.to(self.compute_dtype)
        if remat.saving("dots"):
            return _Linear.apply(x, w)
        return F.linear(x, w)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
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
    have one (b or e) and are replayed.
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

    def forward(self, x):
        cfg = self.cfg
        b0, s0, d = x.shape
        group = cfg.moe_group_size
        if group and s0 > group and s0 % group == 0:
            x = x.reshape(b0 * (s0 // group), group, d)
        b, s, _ = x.shape
        e, k = cfg.n_experts, cfg.experts_per_token
        cap = max(1, int(cfg.capacity_factor * s * k / e))

        probs = torch.softmax(self.router(x.float()), dim=-1)  # [b, s, e] fp32
        gate, idx = torch.topk(probs, k)  # [b, s, k], descending as lax.top_k
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

        # Capacity, rank-major, in integers (a bf16 count is exact only to
        # 256): per rank, each token's slot in its chosen expert and
        # whether it won one. Never [b, s, k, e, cap].
        onehot = F.one_hot(idx, e)  # [b, s, k, e]
        taken = torch.zeros(b, 1, e, dtype=onehot.dtype, device=x.device)
        pos, keep = [], []
        for j in range(k):
            oh = onehot[:, :, j]
            p = oh.cumsum(1) - oh + taken
            pos.append(p)
            keep.append((p < cap) & (oh > 0))
            taken = taken + oh.sum(1, keepdim=True)
        route = self._gather if cfg.moe_impl == "gather" else self._einsum
        y = route(x, gate, idx, pos, keep, cap)

        # Switch load-balance loss e * sum(f * P): f the share of routes to
        # each expert, P its mean probability, over the grouped shapes.
        f_frac = onehot.float().sum(2).mean((0, 1)) / k
        aux = e * (f_frac * probs.mean((0, 1))).sum() * cfg.router_aux_weight
        return y.to(x.dtype).reshape(b0, s0, d), aux

    def _experts(self, h):
        """The SwiGLU experts on their slots: [e, b, cap, d] -> same."""
        dt = self.cfg.dtype
        w1, w3, w2 = (w.to(dt) for w in (self.experts_w1, self.experts_w3, self.experts_w2))
        act = (F.silu(torch.einsum("ebcd,edf->ebcf", h, w1))
               * torch.einsum("ebcd,edf->ebcf", h, w3))
        return torch.einsum("ebcf,efd->ebcd", act, w2)

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


class Llama(nn.Module):
    """Decoder stack. Weights are drawn from ``generator`` (normal(0.02)
    for every matrix, ones for the norm scales), on ``device``: ``cuda``
    unless the caller asks for the CPU, or ``meta`` (shapes only, drawn
    nothing) for a model that is sharded before it is initialised."""

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None, pp: int = 1):
        super().__init__()
        if config.attention_impl == "ring":
            raise NotImplementedError(
                "ring attention is not ported yet (ROADMAP Queue 1: off-path models, "
                "ring attention)")
        if config.attention_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}")
        if pp > 1:
            raise NotImplementedError(
                "pipeline parallelism is not ported yet (ROADMAP Queue 1: off-path "
                "models, pipeline)")
        meta = device is not None and torch.device(device).type == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        self.config = config
        self.tok_embeddings = nn.Embedding(
            config.vocab_size, config.dim, device=device, dtype=config.param_dtype)
        self.layers = nn.ModuleList(Block(config, device) for _ in range(config.n_layers))
        self.norm = RMSNorm(config.dim, config.norm_eps, config.param_dtype, device)
        self.output = Dense(config, config.dim, config.vocab_size, device)
        if not meta:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter in ``named_parameters`` order. A sharded
        parameter (DTensor) is drawn whole on its local device, as the
        unsharded model draws it, and keeps its own shard of it."""
        for name, p in self.named_parameters():
            if name.endswith(".scale") or name == "scale":
                p.fill_(1.0)
            elif isinstance(p, DTensor):
                full = torch.empty(p.shape, dtype=p.dtype, device=p.to_local().device)
                full.normal_(0.0, 0.02, generator=generator)
                local = distribute_tensor(full, p.device_mesh, p.placements,
                                          src_data_rank=None)
                p.to_local().copy_(local.to_local())
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens, targets=None, return_hidden: bool = False,
                return_aux: bool = False):
        """Logits [b, s, vocab] fp32; with ``targets``, the mean next-token
        loss plus the MoE layers' load-balancing losses (the loss the JAX
        package's ``loss_fn`` forms), its head applied per sequence chunk
        (``chunked_cross_entropy``) inside this forward, where a sharded
        head is gathered; with ``return_hidden``, the pre-logits hidden
        states. ``return_aux`` returns ``(logits or hidden, aux)``, the sum
        of the layers' load-balancing losses (None for a dense model)."""
        cfg = self.config
        s = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embeddings.weight.to(cfg.dtype))
        positions = torch.arange(s, device=tokens.device)[None]
        cos, sin = gather_rope(cfg, positions)
        aux = None
        for layer in self.layers:
            x, layer_aux = layer(x, cos, sin)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
        x = self.norm(x)
        if targets is not None:
            # The [b, s, vocab] fp32 logits never exist whole.
            loss = chunked_cross_entropy(x, self.output.weight.to(x.dtype), targets)
            return loss if aux is None else loss + aux
        out = x if return_hidden else self.output(x).float()
        return (out, aux) if return_aux else out

