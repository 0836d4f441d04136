"""Weights carried across: the JAX Llama's, BERT's, ResNet's and MNIST's
variables -> the port's state_dicts.

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
- ResNet (:func:`resnet_flax_to_state_dict`) and MNIST
  (:func:`mnist_flax_to_state_dict`): convolution kernels go from HWIO to
  OIHW, dense kernels are transposed; a ResNet's ``batch_stats``
  ``mean``/``var`` become the BatchNorm's ``running_mean``/``running_var``
  and its ``scale`` the ``weight``; the blocks ``BottleneckBlock_{k}``/
  ``BasicBlock_{k}`` become ``blocks.{k}``, ``Conv_{i}``/``BatchNorm_{i}``
  ``conv{i}``/``norm{i}``, ``Dense_0`` ``head``.
- bf16 leaves arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
  rejects; they travel as a ``uint16`` view, reinterpreted as bfloat16.
"""

from __future__ import annotations

import re

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


def _conv(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"] = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if "bias" in leaf:
        out[f"{name}.bias"] = leaf["bias"]


def _dense(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"] = np.asarray(leaf["kernel"]).T
    out[f"{name}.bias"] = leaf["bias"]


_RESNET_LAYER = re.compile(r"^(Conv|BatchNorm)_(\d+)$")
_RESNET_PREFIX = {"Conv": "conv", "BatchNorm": "norm"}


def resnet_flax_to_state_dict(variables: dict) -> dict:
    """The JAX ResNet's ``{"params", "batch_stats"}`` (numpy leaves, as
    ``init_variables`` gives them) -> the state_dict of
    ``models.resnet.ResNet``, running statistics included."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {}

    def norm(name, p, s):
        out.update({f"{name}.weight": p["scale"], f"{name}.bias": p["bias"],
                    f"{name}.running_mean": s["mean"], f"{name}.running_var": s["var"]})

    _conv(out, "conv_init", params["conv_init"])
    norm("bn_init", params["bn_init"], stats["bn_init"])
    _dense(out, "head", params["Dense_0"])
    blocks = {int(name.rsplit("_", 1)[1]): name for name in params
              if name.startswith(("BottleneckBlock_", "BasicBlock_"))}
    for k, name in blocks.items():
        for sub, leaf in params[name].items():
            m = _RESNET_LAYER.match(sub)
            port = f"blocks.{k}." + (_RESNET_PREFIX[m[1]] + m[2] if m else sub)
            if "kernel" in leaf:
                _conv(out, port, leaf)
            else:
                norm(port, leaf, stats[name][sub])
    return {k: _to_tensor(v) for k, v in out.items()}


def mnist_flax_to_state_dict(params: dict) -> dict:
    """The JAX ``MnistCNN``'s params (numpy leaves, with or without the
    top-level ``"params"`` key) -> the state_dict of
    ``models.mnist.MnistCNN``. The first dense kernel's rows are already in
    the NHWC order the port flattens in."""
    p = params.get("params", params)
    out = {}
    _conv(out, "conv0", p["Conv_0"])
    _conv(out, "conv1", p["Conv_1"])
    _dense(out, "dense0", p["Dense_0"])
    _dense(out, "dense1", p["Dense_1"])
    return {k: _to_tensor(v) for k, v in out.items()}
