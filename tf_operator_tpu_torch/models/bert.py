"""BERT encoder in PyTorch, with the tied-embedding MLM head.

Counterpart of ``tf_operator_tpu/models/bert.py``: learned token, position
and type embeddings summed and normalised; post-LN layers (``LN(x + attn)``,
then ``LN(x + ffn_out(gelu(ffn_in(x))))``); an MLM head of a dense layer,
GELU, LayerNorm and the token embedding read back as the output matrix, plus
an fp32 bias. Dense layers carry a bias and compute in ``cfg.dtype`` on
weights kept in ``cfg.param_dtype``; LayerNorms compute in fp32 on fp32
scale and bias, and cast back to ``cfg.dtype`` where the JAX model does.
GELU is the tanh approximation, Flax's ``nn.gelu`` default.

Attention: with no padding mask and ``attention_impl == "pallas"`` the
non-causal flash kernels (``ops/flash.py``: head_dim 64 at bert-base and
bert-large, 16 at bert-tiny; their plain versions on a CPU tensor);
otherwise the plain reference attention with the additive bias
``where(mask, 0, -1e9)``.

Parameter names follow the JAX model's tree (``tok_embeddings`` for
``tok_embed``, ``layers.{i}`` for ``layer_{i}``, ``attention.query`` ...
``mlm_bias``), so ``models/convert.py`` maps one onto the other leaf by leaf.

Under ``cfg.remat`` each layer runs under a reentrant checkpoint with a
remat tape (``ops/remat.py``). "dots" keeps the outputs of the matrix
products, as JAX's ``dots_with_no_batch_dims_saveable`` alone does: unlike
the Llama tape it keeps no flash output, so the backward replays the flash
forward (two forward launches a layer and step). "nothing" keeps nothing.
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
from ..ops import remat
from ..ops.cross_entropy import chunked_cross_entropy
from .llama import linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # What a layer's remat tape keeps (REMAT_POLICIES): "dots" or "nothing".
    remat_policy: str = "dots"
    # "pallas": the flash kernels when there is no padding mask (plain
    # versions for CPU tensors); "xla": the plain reference attention.
    attention_impl: str = "pallas"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def param_count(self) -> int:
        """The JAX model's count: the embeddings and the layers (the MLM
        head's transform, norm and bias are not counted)."""
        d, f = self.dim, self.ffn_dim
        embed = (self.vocab_size + self.max_len + self.type_vocab_size) * d + 2 * d
        per_layer = 4 * d * d + 4 * d + 2 * d * f + d + f + 4 * d
        return int(embed + self.n_layers * per_layer)

    def flops_per_token(self, seq: Optional[int] = None) -> float:
        """Training FLOPs per token (6 * params + the attention term), for
        MFU accounting."""
        p = self.param_count()
        attn = 12 * self.n_layers * self.dim * (seq or self.max_len)
        return 6 * p + attn


# The JAX package's canonical configs.
CONFIGS = {
    "bert-base": BertConfig(),
    "bert-large": BertConfig(dim=1024, n_layers=24, n_heads=16, ffn_dim=4096),
    "bert-tiny": BertConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, ffn_dim=128, max_len=128,
        remat=False,
    ),
}

# A remat policy's tags on the layer's tape.
REMAT_POLICIES = {"nothing": frozenset(), "dots": frozenset({"dots"})}


class Dense(nn.Linear):
    """Flax ``Dense``/``DenseGeneral`` with a bias: ``x W^T + b`` in
    ``cfg.dtype``, the weight ``[out, in]`` and the bias in
    ``cfg.param_dtype``. A "dots" tape keeps the product; the bias add is
    replayed."""

    def __init__(self, cfg: BertConfig, d_in: int, d_out: int, device=None):
        super().__init__(d_in, d_out, bias=True, device=device, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        dt = self.compute_dtype
        return linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype=float32, param_dtype=float32)``: fp32 in and
    out, fp32 ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)


def gelu(x):
    return F.gelu(x, approximate="tanh")


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.query = Dense(cfg, cfg.dim, cfg.dim, device)
        self.key = Dense(cfg, cfg.dim, cfg.dim, device)
        self.value = Dense(cfg, cfg.dim, cfg.dim, device)
        self.out = Dense(cfg, cfg.dim, cfg.dim, device)

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, cfg.n_heads, cfg.head_dim)
                   for proj in (self.query, self.key, self.value))
        if cfg.attention_impl == "pallas" and attention_mask is None:
            out = attn_ops.flash_attention(q, k, v, causal=False)
        else:
            bias = None
            if attention_mask is not None:
                bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, -1e9)
            out = attn_ops.xla_attention(q, k, v, causal=False, bias=bias)
        return self.out(out.reshape(b, s, cfg.dim))


class Layer(nn.Module):
    """One post-LN encoder layer, under a reentrant checkpoint with its
    policy's tape when ``cfg.remat`` is on (as ``models/llama.py``'s
    ``Block``)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: expected one of "
                             f"{sorted(REMAT_POLICIES)}")
        self.cfg = cfg
        self.attention = SelfAttention(cfg, device)
        self.ln_attn = LayerNorm(cfg.dim, cfg.norm_eps, device)
        self.ffn_in = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.ffn_out = Dense(cfg, cfg.ffn_dim, cfg.dim, device)
        self.ln_ffn = LayerNorm(cfg.dim, cfg.norm_eps, device)
        self.saves = REMAT_POLICIES[cfg.remat_policy]

    def _forward(self, x, attention_mask):
        dt = self.cfg.dtype
        x = self.ln_attn(x + self.attention(x, attention_mask)).to(dt)
        h = self.ffn_out(gelu(self.ffn_in(x)))
        return self.ln_ffn(x + h).to(dt)

    def forward(self, x, attention_mask=None):
        if self.cfg.remat and torch.is_grad_enabled() and x.requires_grad:
            tape = remat.Tape(self.saves)
            return checkpoint(tape.run, self._forward, x, attention_mask, use_reentrant=True,
                              preserve_rng_state=False)
        return self._forward(x, attention_mask)


class Bert(nn.Module):
    """Encoder and tied-embedding MLM head. Weights are drawn from
    ``generator`` on ``device`` (``cuda`` unless the caller asks for the
    CPU): normal(0.02) for every matrix and embedding, zeros for every
    bias, ones for the LayerNorm scales."""

    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.attention_impl not in ("pallas", "xla"):
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}")
        device = resolve_device(device)
        self.config = config
        d, pd = config.dim, config.param_dtype
        self.tok_embeddings = nn.Embedding(config.vocab_size, d, device=device, dtype=pd)
        self.pos_embeddings = nn.Embedding(config.max_len, d, device=device, dtype=pd)
        self.type_embeddings = nn.Embedding(config.type_vocab_size, d, device=device, dtype=pd)
        self.ln_embed = LayerNorm(d, config.norm_eps, device)
        self.layers = nn.ModuleList(Layer(config, device) for _ in range(config.n_layers))
        self.mlm_transform = Dense(config, d, d, device)
        self.mlm_ln = LayerNorm(d, config.norm_eps, device)
        self.mlm_bias = nn.Parameter(
            torch.zeros(config.vocab_size, dtype=torch.float32, device=device))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens, targets=None, attention_mask=None, token_type_ids=None,
                return_hidden: bool = False):
        """MLM logits [b, s, vocab] fp32 (the product rounded to
        ``cfg.dtype``, then the fp32 bias); with ``targets``, the mean
        cross entropy over the targets not -1, the tied head and its bias
        applied per sequence chunk (``chunked_cross_entropy``), the loss the
        JAX package's ``loss_fn`` forms through ``head_kernel_and_bias``;
        with ``return_hidden``, the post-``mlm_ln`` hidden states in
        ``cfg.dtype``."""
        cfg = self.config
        dt = cfg.dtype
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = (F.embedding(tokens, self.tok_embeddings.weight.to(dt))
             + F.embedding(positions, self.pos_embeddings.weight.to(dt))
             + F.embedding(token_type_ids, self.type_embeddings.weight.to(dt)))
        x = self.ln_embed(x).to(dt)
        for layer in self.layers:
            x = layer(x, attention_mask)
        x = self.mlm_ln(gelu(self.mlm_transform(x))).to(dt)
        head = self.tok_embeddings.weight.to(dt)
        if targets is not None:
            return chunked_cross_entropy(x, head, targets, bias=self.mlm_bias)
        if return_hidden:
            return x
        return F.linear(x, head).float() + self.mlm_bias
