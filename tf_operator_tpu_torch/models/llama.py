"""Llama-family decoder-only transformer in PyTorch.

Counterpart of ``tf_operator_tpu/models/llama.py`` (dense path): RMSNorm with
fp32 math, RoPE on the two halves of each head (``ops/rope.py``), causal GQA
flash attention (``ops/flash.py``) with separate wq/wk/wv projections, a
SwiGLU MLP, and a final RMSNorm and output head. Dense layers compute in
``cfg.dtype``; parameters live in ``cfg.param_dtype``.

Parameter names follow the JAX model's tree (``tok_embeddings``,
``layers.{i}.attention.wq``, ``layers.{i}.feed_forward.w1``, ``norm``,
``output``), so ``models/convert.py`` maps one onto the other leaf by leaf.

Under ``cfg.remat`` each block runs under a non-reentrant
``torch.utils.checkpoint`` that saves nothing: the block's forward (two rope
launches and one flash forward) is replayed in the backward. The JAX
model's selective ``remat_policy`` ("dots", "dots+rope", ...) is not ported
yet; remat changes memory and launch counts, never results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops import attention as attn_ops
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


# The JAX package's canonical configs (its remat policies and MoE routing
# settings are not ported yet).
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


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale.float()).to(x.dtype)


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


def apply_rope(x, cos, sin):
    """x: [b, s, h, d]; rotate pairs by pre-gathered cos/sin ([b, s, 1, d/2]).
    The rope kernel takes one table for the whole batch, so it runs when the
    positions are shared (cos.shape[0] == 1) and cover x's sequence."""
    if cos.shape[0] == 1 and x.shape[1] == cos.shape[1]:
        return rope(x, cos[0, :, 0, :], sin[0, :, 0, :])
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _linear(cfg: LlamaConfig, d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=cfg.param_dtype)


def _dense(x, layer: nn.Linear, dtype):
    """Dense layer computed in ``dtype`` (Flax's ``dtype=cfg.dtype``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        # Three separate projections, as the JAX model keeps them.
        self.wq = _linear(cfg, cfg.dim, cfg.n_heads * hd, device)
        self.wk = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wv = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wo = _linear(cfg, cfg.n_heads * hd, cfg.dim, device)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = _dense(x, self.wq, cfg.dtype).view(b, s, cfg.n_heads, hd)
        k = _dense(x, self.wk, cfg.dtype).view(b, s, cfg.n_kv_heads, hd)
        v = _dense(x, self.wv, cfg.dtype).view(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cfg.attention_impl == "pallas":
            out = attn_ops.flash_attention(q, k, v, causal=True)
        else:
            out = attn_ops.xla_attention(q, k, v, causal=True)
        return _dense(out.reshape(b, s, cfg.n_heads * hd), self.wo, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.w1 = _linear(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w3 = _linear(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w2 = _linear(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, x):
        dt = self.cfg.dtype
        act = F.silu(_dense(x, self.w1, dt)) * _dense(x, self.w3, dt)
        return _dense(act, self.w2, dt)


class Block(nn.Module):
    """One decoder layer."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.attention = Attention(cfg, device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.param_dtype, device)
        self.feed_forward = MLP(cfg, device)

    def forward(self, x, cos, sin):
        x = x + self.attention(self.attention_norm(x), cos, sin)
        return x + self.feed_forward(self.ffn_norm(x))


class Llama(nn.Module):
    """Decoder stack. Weights are drawn from ``generator`` (normal(0.02)
    for every matrix, ones for the norm scales), on ``device``: ``cuda``
    unless the caller asks for the CPU."""

    # Capability flag for train_step.loss_fn: forward(return_hidden=True)
    # yields pre-logits hidden states for the chunked CE path.
    supports_return_hidden = True

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
        device = resolve_device(device)
        self.config = config
        self.tok_embeddings = nn.Embedding(
            config.vocab_size, config.dim, device=device, dtype=config.param_dtype)
        self.layers = nn.ModuleList(Block(config, device) for _ in range(config.n_layers))
        self.norm = RMSNorm(config.dim, config.norm_eps, config.param_dtype, device)
        self.output = _linear(config, config.dim, config.vocab_size, device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters():
            if name.endswith(".scale") or name == "scale":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens, return_hidden: bool = False):
        cfg = self.config
        s = tokens.shape[1]
        x = F.embedding(tokens, self.tok_embeddings.weight.to(cfg.dtype))
        positions = torch.arange(s, device=tokens.device)[None]
        cos, sin = gather_rope(cfg, positions)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, cos, sin, use_reentrant=False)
            else:
                x = layer(x, cos, sin)
        x = self.norm(x)
        if return_hidden:
            # Pre-logits hidden for the chunked loss: the train step applies
            # the head per sequence chunk, so the [b, s, vocab] fp32 logits
            # never exist whole.
            return x
        return _dense(x, self.output, cfg.dtype).float()

