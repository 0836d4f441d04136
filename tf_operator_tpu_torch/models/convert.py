"""Weights carried across: the JAX Llama's and BERT's params -> the port's
state_dicts.

Takes the JAX package's parameter tree as nested dicts of numpy arrays (as
``jax.tree.map(np.asarray, params)`` gives them, with or without the
top-level ``"params"`` key) and returns the ``state_dict`` of
``models.llama.Llama``. The conversion is exact: only axes move.

- ``nn.scan`` stacks the layers on a leading ``[n_layers]`` axis under
  ``params/layers/...``; it is unstacked into ``layers.{i}``.
- wq/wk/wv ``[d, h, hd]`` become Linear weights ``[h*hd, d]``; wo
  ``[h, hd, d]`` becomes ``[d, h*hd]``.
- Dense kernels are transposed (w1/w3 ``[d, f]``, w2 ``[f, d]``, output
  ``[d, V]``, and an MoE layer's fp32 ``router/kernel`` ``[d, e]``);
  ``tok_embeddings/embedding`` ``[V, d]``, the norm ``scale``s and the
  expert weights ``experts_w1``/``experts_w3`` ``[e, d, f]`` and
  ``experts_w2`` ``[e, f, d]`` stay as they are.
- BERT (:func:`bert_flax_to_state_dict`): ``layer_{i}`` becomes
  ``layers.{i}``; the query/key/value ``DenseGeneral`` kernels ``[d, h, hd]``
  become ``[h*hd, d]`` and their biases ``[h, hd]`` ``[h*hd]``; ``Dense``
  kernels are transposed; the embeddings, the fp32 LayerNorm ``scale``/
  ``bias`` and ``mlm_bias`` stay as they are.
- bf16 leaves arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  rejects; they travel as a ``uint16`` view, reinterpreted as bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    """numpy array (bf16 included) -> CPU tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _proj_in(kernel: np.ndarray) -> np.ndarray:
    d, h, hd = kernel.shape  # DenseGeneral [d, h, hd] -> Linear [h*hd, d]
    return kernel.reshape(d, h * hd).T


def _proj_out(kernel: np.ndarray) -> np.ndarray:
    h, hd, d = kernel.shape  # DenseGeneral [h, hd, d] -> Linear [d, h*hd]
    return kernel.reshape(h * hd, d).T


def flax_to_state_dict(params: dict) -> dict:
    """JAX Llama params (numpy leaves) -> the port's state_dict (CPU
    tensors in the leaves' dtypes)."""
    p = params.get("params", params)
    layers = p["layers"]
    attn, ffn = layers["attention"], layers["feed_forward"]
    n_layers = np.asarray(layers["attention_norm"]["scale"]).shape[0]
    out = {
        "tok_embeddings.weight": p["tok_embeddings"]["embedding"],
        "norm.scale": p["norm"]["scale"],
        "output.weight": np.asarray(p["output"]["kernel"]).T,
    }
    for i in range(n_layers):
        pre = f"layers.{i}."
        out[pre + "attention_norm.scale"] = np.asarray(layers["attention_norm"]["scale"])[i]
        out[pre + "ffn_norm.scale"] = np.asarray(layers["ffn_norm"]["scale"])[i]
        for name in ("wq", "wk", "wv"):
            out[pre + f"attention.{name}.weight"] = _proj_in(np.asarray(attn[name]["kernel"])[i])
        out[pre + "attention.wo.weight"] = _proj_out(np.asarray(attn["wo"]["kernel"])[i])
        if "router" in ffn:  # MoE
            out[pre + "feed_forward.router.weight"] = np.asarray(ffn["router"]["kernel"])[i].T
            for name in ("experts_w1", "experts_w2", "experts_w3"):
                out[pre + f"feed_forward.{name}"] = np.asarray(ffn[name])[i]
            continue
        for name in ("w1", "w2", "w3"):
            out[pre + f"feed_forward.{name}.weight"] = np.asarray(ffn[name]["kernel"])[i].T
    return {k: _to_tensor(v) for k, v in out.items()}


def bert_flax_to_state_dict(params: dict) -> dict:
    """JAX BERT params (numpy leaves) -> the state_dict of
    ``models.bert.Bert`` (CPU tensors in the leaves' dtypes)."""
    p = params.get("params", params)
    out = {
        "tok_embeddings.weight": p["tok_embed"]["embedding"],
        "pos_embeddings.weight": p["pos_embed"]["embedding"],
        "type_embeddings.weight": p["type_embed"]["embedding"],
        "mlm_bias": p["mlm_bias"],
    }

    def dense(name, leaf):
        out[f"{name}.weight"] = np.asarray(leaf["kernel"]).T
        out[f"{name}.bias"] = leaf["bias"]

    def norm(name, leaf):
        out[f"{name}.scale"] = leaf["scale"]
        out[f"{name}.bias"] = leaf["bias"]

    norm("ln_embed", p["ln_embed"])
    dense("mlm_transform", p["mlm_transform"])
    norm("mlm_ln", p["mlm_ln"])
    n_layers = sum(name.startswith("layer_") for name in p)
    for i in range(n_layers):
        layer, pre = p[f"layer_{i}"], f"layers.{i}."
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            out[pre + f"attention.{name}.weight"] = _proj_in(np.asarray(attn[name]["kernel"]))
            out[pre + f"attention.{name}.bias"] = np.asarray(attn[name]["bias"]).reshape(-1)
        dense(pre + "attention.out", attn["out"])
        for name in ("ffn_in", "ffn_out"):
            dense(pre + name, layer[name])
        for name in ("ln_attn", "ln_ffn"):
            norm(pre + name, layer[name])
    return {k: _to_tensor(v) for k, v in out.items()}
