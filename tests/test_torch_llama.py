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
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

NARROW = dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
              ffn_dim=512, max_seq_len=64)
# Two heads of 256: the head dim of the flash kernels' widest instance.
NARROW_HD256 = dict(vocab_size=256, dim=512, n_layers=2, n_heads=2, n_kv_heads=1,
                    ffn_dim=512, max_seq_len=64)
NARROWS = {"narrow_hd128": NARROW, "narrow_hd256": NARROW_HD256}


def configs(name, fp32):
    """(JAX config, port config) of the same model."""
    if name in NARROWS:
        jcfg = jax_llama.LlamaConfig(**NARROWS[name])
        tcfg = llama.LlamaConfig(**NARROWS[name])
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


@pytest.mark.parametrize("name", ["llama-tiny", "narrow_hd128", "narrow_hd256"])
def test_logits_hidden_and_grads_match_fp32(name):
    jmodel, params, tmodel, tokens = build(name)
    w = np.random.default_rng(2).standard_normal(
        (*tokens.shape, tmodel.config.vocab_size)).astype(np.float32)

    def reference(p):
        """The logits, the hidden state and the gradients of sum(logits *
        w), in one program."""
        logits, pullback = jax.vjp(lambda p: jmodel.apply(p, tokens), p)
        return logits, jmodel.apply(p, tokens, return_hidden=True), pullback(w)[0]

    # XLA's backend optimisations cost compile time and buy nothing here.
    jlogits, jhidden, jgrads = jax.jit(reference).lower(params).compile(
        {"xla_backend_optimization_level": 0})(params)

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
    # Ring attention and the pipeline are ported: a ring model without an
    # sp group is causal flash, and a pipeline stage builds; what still
    # raises are the JAX model's refusals under a pipeline.
    ring = dataclasses.replace(llama.CONFIGS["llama-tiny"], attention_impl="ring")
    llama.Llama(ring, device="cpu")
    stage = llama.Llama(llama.CONFIGS["llama-tiny"], device="meta", pp=2, stage=1)
    assert [n for n, _ in stage.named_parameters()][0].startswith("layers.1.")
    with pytest.raises(NotImplementedError, match="ring attention \\+ pipeline"):
        llama.Llama(ring, device="meta", pp=2)
    with pytest.raises(NotImplementedError, match="MoE \\+ pipeline"):
        llama.Llama(llama.CONFIGS["moe-tiny"], device="meta", pp=2)


@pytest.mark.parametrize("feature", ["ring", "pipeline"])
def test_unported_features_name_their_roadmap_items(feature):
    # Items 7c (ring) and 7d (pipeline) are done: each is accepted, and the
    # JAX model's refusal that remains names the JAX model's reason.
    cfg = llama.CONFIGS["llama-tiny"]
    if feature == "ring":
        ring = dataclasses.replace(cfg, attention_impl="ring")
        model = llama.Llama(ring, device="cpu", generator=torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16))).long()
        plain = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(model(tokens), plain(tokens), rtol=0, atol=0)
        with pytest.raises(NotImplementedError, match="a nested full-mesh shard_map is "
                                                      "illegal inside the pp-manual region"):
            llama.Llama(ring, device="meta", pp=2)
    else:
        for stage in (0, 1):
            llama.Llama(cfg, device="meta", pp=2, stage=stage)
        with pytest.raises(NotImplementedError, match="the blocks' sown aux losses don't "
                                                      "cross the pipeline"):
            llama.Llama(llama.CONFIGS["moe-tiny"], device="meta", pp=2)


# The one remat policy kept apart from the reference's on purpose: "dots"
# for llama-400m's "dots+rope", measured on the card with every gradient
# equal (ROADMAP, Divergences).
REMAT_DIVERGENCES = {"llama-400m": ("dots", "dots+rope")}


def test_config_accounting_matches():
    for name, jcfg in jax_llama.CONFIGS.items():
        tcfg = llama.CONFIGS[name]
        assert tcfg.param_count() == jcfg.param_count(), name
        assert tcfg.flops_per_token(2048) == jcfg.flops_per_token(2048), name
        assert tcfg.geometry() == jcfg.geometry(), name
        policies = (tcfg.remat, tcfg.remat_policy), (jcfg.remat, jcfg.remat_policy)
        if name in REMAT_DIVERGENCES:
            assert (policies[0][1], policies[1][1]) == REMAT_DIVERGENCES[name], name
        else:
            assert policies[0] == policies[1], name


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
