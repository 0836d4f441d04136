"""Weights carried across: the JAX Llama's params -> the port's state_dict.

Takes the JAX package's parameter tree as nested dicts of numpy arrays (as
``jax.tree.map(np.asarray, params)`` gives them, with or without the
top-level ``"params"`` key) and returns the ``state_dict`` of
``models.llama.Llama``. The conversion is exact: only axes move.

- ``nn.scan`` stacks the layers on a leading ``[n_layers]`` axis under
  ``params/layers/...``; it is unstacked into ``layers.{i}``.
- wq/wk/wv ``[d, h, hd]`` become Linear weights ``[h*hd, d]``; wo
  ``[h, hd, d]`` becomes ``[d, h*hd]``.
- Dense kernels are transposed (w1/w3 ``[d, f]``, w2 ``[f, d]``, output
  ``[d, V]``); ``tok_embeddings/embedding`` ``[V, d]`` and the norm
  ``scale``s stay as they are.
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
        for name in ("w1", "w2", "w3"):
            out[pre + f"feed_forward.{name}.weight"] = np.asarray(ffn[name]["kernel"])[i].T
    return {k: _to_tensor(v) for k, v in out.items()}
