"""The port's Llama against the JAX package's Flax Llama from the same
weights, carried across by models/convert.py, on the CPU.

fp32 cases hold logits to 1e-4 relative (1e-5 absolute) and every
parameter gradient to 1e-4 relative in norm (the two frameworks sum in
different orders); the bf16 case is loose (2e-2 relative in norm), since
bf16 rounds at other places in the two frameworks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu_torch.models import convert, llama

NARROW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
              ffn_dim=512, max_seq_len=64)


def configs(name, fp32):
    """(JAX config, port config) of the same model."""
    if name == "narrow_hd128":
        jcfg, tcfg = jax_llama.LlamaConfig(**NARROW), llama.LlamaConfig(**NARROW)
    else:
        jcfg, tcfg = jax_llama.CONFIGS[name], llama.CONFIGS[name]
    if fp32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32, param_dtype=torch.float32)
    return jcfg, tcfg


@functools.cache
def jax_model(name, fp32):
    """(JAX model, its params): initialised once per module run."""
    jmodel = jax_llama.Llama(configs(name, fp32)[0])
    return jmodel, jax_llama.init_params(jmodel, jax.random.PRNGKey(0), seq=32)


def build(name, fp32=True, seq=32, batch=2):
    jcfg, tcfg = configs(name, fp32)
    jmodel, params = jax_model(name, fp32)
    tmodel = llama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(jax.tree.map(np.asarray, params)))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (batch, seq), np.int32)
    return jmodel, params, tmodel, tokens


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("name", ["llama-tiny", "narrow_hd128", "moe-tiny"])
def test_converter_keys_shapes_and_layout(name):
    jmodel, params, tmodel, _ = build(name)
    state = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    assert set(state) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert state[k].shape == v.shape, k
    p = jax.tree.map(np.asarray, params)["params"]
    # Only axes move: spot-check one leaf of each kind of reshaping.
    wq = p["layers"]["attention"]["wq"]["kernel"][1]  # [d, h, hd]
    np.testing.assert_array_equal(state["layers.1.attention.wq.weight"].numpy(),
                                  wq.reshape(wq.shape[0], -1).T)
    wo = p["layers"]["attention"]["wo"]["kernel"][0]  # [h, hd, d]
    np.testing.assert_array_equal(state["layers.0.attention.wo.weight"].numpy(),
                                  wo.reshape(-1, wo.shape[-1]).T)
    np.testing.assert_array_equal(state["output.weight"].numpy(), p["output"]["kernel"].T)
    n = sum(p.numel() for p in tmodel.parameters())
    assert n == tmodel.config.param_count()


def test_bf16_leaves_convert_exactly():
    _, params, tmodel, _ = build("llama-tiny", fp32=False)
    leaf = np.asarray(params["params"]["tok_embeddings"]["embedding"])
    assert leaf.dtype.name == "bfloat16"
    got = tmodel.tok_embeddings.weight
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), leaf.astype(np.float32))


@pytest.mark.parametrize("name", ["llama-tiny", "narrow_hd128"])
def test_logits_hidden_and_grads_match_fp32(name):
    jmodel, params, tmodel, tokens = build(name)
    w = np.random.default_rng(2).standard_normal(
        (*tokens.shape, tmodel.config.vocab_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, tokens) * w)

    jlogits = jmodel.apply(params, tokens)
    jhidden = jmodel.apply(params, tokens, return_hidden=True)
    jgrads = jax.grad(jloss)(params)

    tt = torch.from_numpy(tokens).long()
    logits = tmodel(tt)
    (logits * torch.from_numpy(w)).sum().backward()
    with torch.no_grad():
        hidden = tmodel(tt, return_hidden=True)

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=1e-4, atol=1e-5)
    ref = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for pname, p in tmodel.named_parameters():
        assert rel_err(p.grad.numpy(), ref[pname].numpy()) < 1e-4, pname


def test_logits_bf16():
    jmodel, params, tmodel, tokens = build("llama-tiny", fp32=False)
    jlogits = np.asarray(jmodel.apply(params, tokens))
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32
    assert rel_err(logits.numpy(), jlogits) < 2e-2


def test_unported_features_raise():
    ring = dataclasses.replace(llama.CONFIGS["llama-tiny"], attention_impl="ring")
    with pytest.raises(NotImplementedError, match="ring"):
        llama.Llama(ring, device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        llama.Llama(llama.CONFIGS["llama-tiny"], device="cpu", pp=2)


def test_config_accounting_matches():
    for name, jcfg in jax_llama.CONFIGS.items():
        tcfg = llama.CONFIGS[name]
        assert tcfg.param_count() == jcfg.param_count(), name
        assert tcfg.flops_per_token(2048) == jcfg.flops_per_token(2048), name
        assert tcfg.geometry() == jcfg.geometry(), name


def test_attention_impls_agree():
    """The kernel path ("pallas": plain flash on the CPU) and the plain
    reference attention ("xla") give the same logits."""
    cfg = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                              param_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 32))).long()
    flash_model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ref_model = llama.Llama(dataclasses.replace(cfg, attention_impl="xla"), device="cpu")
    ref_model.load_state_dict(flash_model.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(flash_model(tokens).numpy(), ref_model(tokens).numpy(),
                                   rtol=1e-5, atol=1e-5)
