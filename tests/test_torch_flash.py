"""The port's flash attention (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode and its XLA reference.

Inputs come from a numpy seed and go through both packages. Tolerances are
those of tests/test_flash_pallas.py: fp32 2e-5 forward and 3e-5 gradients;
bf16 2e-2 forward and 5e-2 gradients (bf16 rounds at other places in the
two frameworks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.attention import xla_attention as jax_xla_attention
from tf_operator_tpu.ops.flash_pallas import (
    flash_attention_pallas,
    flash_attention_with_lse as jax_flash_with_lse,
)
from tf_operator_tpu_torch.ops import flash
from tf_operator_tpu_torch.ops.attention import xla_attention
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

# The JAX references run jitted: the Pallas interpreter traced once into
# one XLA program costs about half of its op-by-op run.
pallas = jax.jit(functools.partial(flash_attention_pallas, interpret=True),
                 static_argnames=("causal", "block_q", "block_k"))


def rand_qkv(seed, batch, seq, heads, kv_heads, dim):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((batch, seq, heads, dim)).astype(np.float32),
        rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32),
        rng.standard_normal((batch, seq, kv_heads, dim)).astype(np.float32),
    )


def to_jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def to_torch(arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def weights(shape, seed=99):
    """Non-uniform cotangent weights: masking bugs cannot cancel out."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas_and_xla(causal):
    arrays = rand_qkv(0, 2, 128, 4, 4, 64)
    got = flash.flash_attention(*to_torch(arrays), causal=causal, block_q=64, block_k=64)
    ref = pallas(*to_jax(arrays), causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(f32(got), f32(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        f32(got), f32(jax_xla_attention(*to_jax(arrays), causal=causal)),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "shape,blocks",
    [
        ((1, 128, 8, 2, 32), (64, 64)),     # GQA 8:2
        ((1, 256, 2, 2, 32), (256, 64)),    # 4 K blocks per Q block
        ((1, 96, 2, 2, 32), (1024, 1024)),  # seq 96: blocks step down to a divisor
    ],
    ids=["gqa", "multi_k_block", "seq96"],
)
def test_forward_cases_match_xla(shape, blocks):
    arrays = rand_qkv(1, *shape)
    got = flash.flash_attention(*to_torch(arrays), causal=True,
                                block_q=blocks[0], block_k=blocks[1])
    ref = jax_xla_attention(*to_jax(arrays), causal=True)
    np.testing.assert_allclose(f32(got), f32(ref), atol=2e-5, rtol=2e-5)
    # The port's own plain reference agrees too.
    np.testing.assert_allclose(
        f32(got), f32(xla_attention(*to_torch(arrays), causal=True)), atol=2e-5, rtol=2e-5)


def test_bf16_forward():
    arrays = rand_qkv(3, 1, 128, 2, 2, 64)
    got = flash.flash_attention(*to_torch(arrays, torch.bfloat16), block_q=64, block_k=64)
    ref = pallas(*to_jax(arrays, jnp.bfloat16), causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(ref), atol=2e-2, rtol=2e-2)


def test_forward_lse_matches_pallas():
    arrays = rand_qkv(4, 1, 128, 4, 2, 32)
    o, lse = flash.flash_attention_with_lse(*to_torch(arrays), block_q=64, block_k=64)
    ro, rlse = jax.jit(functools.partial(jax_flash_with_lse, block_q=64, block_k=64,
                                         interpret=True))(*to_jax(arrays))
    assert tuple(lse.shape) == (1, 4, 128)
    np.testing.assert_allclose(f32(o), f32(ro), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(f32(lse), f32(rlse), atol=2e-5, rtol=2e-5)


def test_rejects_bad_gqa_ratio_and_causal_cross_attention():
    q, k, v = to_torch(rand_qkv(5, 1, 64, 6, 4, 32))
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)
    q, k, v = to_torch(rand_qkv(5, 1, 64, 4, 4, 32))
    with pytest.raises(ValueError):
        flash.flash_attention(q[:, :32], k, v, causal=True)


def torch_grads(fn, arrays, w, dtype=torch.float32):
    q, k, v = to_torch(arrays, dtype, grad=True)
    out = fn(q, k, v)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad for t in (q, k, v)]


def jax_grads(fn, arrays, w, dtype=jnp.float32):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*to_jax(arrays, dtype))


def assert_grads(got, ref, tol):
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(f32(g), f32(r), atol=tol, rtol=tol, err_msg=f"d{name}")


def test_grads_match_pallas_causal():
    arrays = rand_qkv(10, 1, 128, 4, 2, 32)
    w = weights((1, 128, 4, 32))
    got = torch_grads(functools.partial(flash.flash_attention, block_q=64, block_k=64),
                      arrays, w)
    ref = jax_grads(functools.partial(pallas, block_q=64, block_k=64), arrays, w)
    assert_grads(got, ref, 3e-5)


@pytest.mark.parametrize(
    "shape,causal,blocks",
    [
        ((2, 128, 4, 4, 32), False, (64, 64)),
        ((1, 128, 8, 2, 32), True, (64, 64)),     # dk/dv sum over the group
        ((1, 256, 2, 2, 32), True, (64, 64)),     # several blocks on both axes
        ((1, 96, 2, 2, 32), True, (1024, 1024)),  # seq 96
    ],
    ids=["non_causal", "gqa", "multiblock", "seq96"],
)
def test_grads_match_xla(shape, causal, blocks):
    arrays = rand_qkv(11, *shape)
    w = weights(shape[:3] + shape[4:])
    got = torch_grads(functools.partial(
        flash.flash_attention, causal=causal, block_q=blocks[0], block_k=blocks[1]),
        arrays, w)
    ref = jax_grads(functools.partial(jax_xla_attention, causal=causal), arrays, w)
    assert_grads(got, ref, 3e-5)


def test_grads_bf16():
    arrays = rand_qkv(13, 1, 128, 2, 2, 32)
    w = weights((1, 128, 2, 32))
    got = torch_grads(flash.flash_attention, arrays, w, torch.bfloat16)
    ref = jax_grads(jax_xla_attention, arrays, w, jnp.bfloat16)
    for g in got:
        assert g.dtype == torch.bfloat16
    assert_grads(got, ref, 5e-2)


@pytest.mark.parametrize("causal", [False, True], ids=["non_causal", "causal"])
def test_grads_match_pallas_head_dim_64(causal):
    """head_dim 64, BERT's (non-causal) and a causal case, against the
    Pallas kernels, which take head_dim from the shape."""
    arrays = rand_qkv(15, 1, 128, 2, 2, 64)
    w = weights((1, 128, 2, 64))
    got = torch_grads(functools.partial(flash.flash_attention, causal=causal,
                                        block_q=64, block_k=64), arrays, w)
    ref = jax_grads(functools.partial(pallas, causal=causal, block_q=64, block_k=64), arrays, w)
    assert_grads(got, ref, 3e-5)


def test_kernels_take_head_dims_64_and_128_only():
    """Head dims 64 and 128 keep their own instances and the counter names
    they had (flash_*_d64 and flash_*); an off-rule head dim is refused
    before a launch."""
    for d in (64, 128):
        t = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
        flash._check_kernel_qkv(t, t, t, causal=True)
    t = torch.zeros(1, 64, 2, 20, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"multiple of 8 from 8 to 256, not 20"):
        flash._check_kernel_qkv(t, t, t, causal=True)
    assert [flash.kernel_name("flash_dq", d) for d in (128, 64)] == ["flash_dq", "flash_dq_d64"]


@pytest.mark.parametrize("taken", [True, False], ids=["taken", "refused"])
def test_kernel_head_dim_rule(taken):
    """The kernels take a head_dim that is a multiple of 8 from 8 to 256
    (16, 80 and 256 here) and refuse any other (4, 20, 272) before a
    launch, naming the rule and its ROADMAP item; each head dim counts on
    the instance that serves it, and flash_work counts the true head dim,
    not the instance's width."""
    if not taken:
        for d in (4, 20, 272):
            t = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
            with pytest.raises(ValueError, match=rf"multiple of 8 from 8 to 256, not {d} "
                                                 r"\(ROADMAP.md, Queue 2"):
                flash._check_kernel_qkv(t, t, t, causal=True)
            with pytest.raises(ValueError, match="multiple of 8"):
                flash.kernel_name("flash_dkv", d)
        return
    for d in (16, 80, 256):
        t = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16)
        flash._check_kernel_qkv(t, t, t, causal=True)
    names = {d: flash.kernel_name("flash_dkv", d) for d in (16, 32, 64, 80, 96, 128, 144, 256)}
    assert names == {16: "flash_dkv_d64", 32: "flash_dkv_d64", 64: "flash_dkv_d64",
                     80: "flash_dkv", 96: "flash_dkv", 128: "flash_dkv",
                     144: "flash_dkv_d256", 256: "flash_dkv_d256"}
    w80, w128 = (flash.flash_work(2, 256, 256, 8, 2, d, True) for d in (80, 128))
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert w80[kernel].flops * 128 == w128[kernel].flops * 80
    pairs = 2 * 8 * 256 * 257 // 2
    assert w80["flash_fwd"].flops == 4 * pairs * 80
    assert w80["flash_fwd"].bytes == 2 * (2 * 2 * 256 * 8 * 80 + 2 * 2 * 256 * 2 * 80) \
        + 4 * 2 * 8 * 256


def test_dlse_cotangent_matches_pallas():
    """Both outputs carry cotangents: dlse folds into delta."""
    arrays = rand_qkv(14, 1, 128, 4, 2, 32)
    wo = weights((1, 128, 4, 32), seed=1)
    wl = weights((1, 4, 128), seed=2)

    q, k, v = to_torch(arrays, grad=True)
    o, lse = flash.flash_attention_with_lse(q, k, v, block_q=64, block_k=64)
    ((o * torch.from_numpy(wo)).sum() + (lse * torch.from_numpy(wl)).sum()).backward()

    def loss(q, k, v):
        o, lse = jax_flash_with_lse(q, k, v, block_q=64, block_k=64, interpret=True)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*to_jax(arrays))
    assert_grads([q.grad, k.grad, v.grad], ref, 3e-5)
