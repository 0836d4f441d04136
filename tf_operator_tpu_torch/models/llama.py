"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``tf_operator_tpu/models/llama.py`` (dense path): RMSNorm with
fp32 math, RoPE on the two halves of each head (``ops/rope.py``), causal GQA
flash attention (``ops/flash.py``) with separate wq/wk/wv projections, a
SwiGLU MLP, and a final RMSNorm and output head. Dense layers compute in
``cfg.dtype``; parameters live in ``cfg.param_dtype``.

Parameter names follow the JAX model's tree (``tok_embeddings``,
``layers.{i}.attention.wq``, ``layers.{i}.feed_forward.w1``, ``norm``,
``output``), so ``models/convert.py`` maps one onto the other leaf by leaf.

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
    # Mixture-of-experts size, kept so CONFIGS and their parameter and FLOP
    # accounting mirror the JAX package; the port's Llama refuses
    # n_experts > 0 for now.
    n_experts: int = 0
    experts_per_token: int = 2

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


# The JAX package's canonical configs (its MoE routing settings are not
# ported yet).
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
        n_experts=8, experts_per_token=2,
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
    ``dtype=cfg.dtype``) on a weight kept in ``cfg.param_dtype``. It is
    called as a module, so that the tensor-parallel plans' hooks
    (``parallel/sharding.py``) see its input and output."""

    def __init__(self, cfg: LlamaConfig, d_in: int, d_out: int, device=None):
        super().__init__(d_in, d_out, bias=False, device=device, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

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


class Block(nn.Module):
    """One decoder layer. Under ``cfg.remat`` its forward runs under a
    reentrant checkpoint, with a remat tape that keeps what the config's
    policy saves. Reentrant: the forward runs with no autograd graph and
    no per-tensor hooks, the cheapest form on the host, which feeds the
    card; the backward replays the block and differentiates the replay.
    The checkpoint sits inside the block, so that when the block is
    sharded (FSDP2 hooks on its call), the replay runs on the weights that
    FSDP2 gathered for the backward, with no second forward hook."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.attention = Attention(cfg, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.feed_forward = MLP(cfg, device)
        self.remat = cfg.remat
        self.saves = _remat_policy(cfg)

    def _forward(self, x, cos, sin):
        x = x + self.attention(self.attention_norm(x), cos, sin)
        return x + self.feed_forward(self.ffn_norm(x))

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
        if config.n_experts:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP Queue 1: off-path models, MoE)")
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

    def forward(self, tokens, targets=None, return_hidden: bool = False):
        """Logits [b, s, vocab] fp32; with ``targets``, the mean next-token
        loss, its head applied per sequence chunk (``chunked_cross_entropy``)
        inside this forward, where a sharded head is gathered; with
        ``return_hidden``, the pre-logits hidden states."""
        cfg = self.config
        s = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embeddings.weight.to(cfg.dtype))
        positions = torch.arange(s, device=tokens.device)[None]
        cos, sin = gather_rope(cfg, positions)
        for layer in self.layers:
            x = layer(x, cos, sin)
        x = self.norm(x)
        if targets is not None:
            # The [b, s, vocab] fp32 logits never exist whole.
            return chunked_cross_entropy(x, self.output.weight.to(x.dtype), targets)
        if return_hidden:
            return x
        return self.output(x).float()

