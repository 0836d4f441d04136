"""The port's RoPE (plain version, CPU) against the JAX package's Pallas
kernel in interpret mode and its jnp path, forward and gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models.llama import rope_table as jax_rope_table
from tf_operator_tpu.ops.rope_pallas import _rope_bwd, rope_pallas
from tf_operator_tpu_torch.models.llama import apply_rope, rope_table
from tf_operator_tpu_torch.ops.rope import rope, rope_plain
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

kernel = functools.partial(rope_pallas, interpret=True)


def jnp_rope(x, cos, sin):
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    return jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1).astype(x.dtype)


def inputs(seed, b=2, s=64, h=4, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = (np.array(t) for t in jax_rope_table(d, s, 10000.0))
    return x, g, cos, sin


def test_tables_match():
    cos, sin = rope_table(32, 64, 10000.0)
    jcos, jsin = jax_rope_table(32, 64, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)


def test_forward_and_grad_match_pallas_and_jnp():
    x, g, cos, sin = inputs(0)
    tx = torch.tensor(x, requires_grad=True)
    out = rope(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    (out * torch.from_numpy(g)).sum().backward()

    jx, cos, sin = jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)
    for ref in (kernel, jnp_rope):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref(jx, cos, sin)),
                                   atol=1e-5)
        ref_grad = jax.grad(lambda x: jnp.sum(ref(x, cos, sin) * g))(jx)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_grad), atol=1e-5)


def test_bf16_matches_pallas():
    x, _, cos, sin = inputs(1)
    out = rope(torch.tensor(x, dtype=torch.bfloat16), torch.from_numpy(cos),
               torch.from_numpy(sin))
    ref = kernel(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos), jnp.asarray(sin))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_rotation_inverse_property():
    """The backward's rotation by -θ really is the transpose: R(-θ)R(θ) = I."""
    x, _, cos, sin = inputs(2, b=1, s=16, h=2, d=16)
    tx, c, s = torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin)
    np.testing.assert_allclose(rope_plain(rope_plain(tx, c, s), c, -s).numpy(), x,
                               atol=1e-5)


def test_inverse_flag_is_the_backward_rotation():
    """inverse=True (the kernel's flag, taken by the backward) is the
    rotation by the negated table, and the JAX package's _rope_bwd."""
    x, g, cos, sin = inputs(4)
    c, s = torch.from_numpy(cos), torch.from_numpy(sin)
    got = rope_plain(torch.from_numpy(g), c, s, inverse=True)
    np.testing.assert_allclose(got.numpy(), rope_plain(torch.from_numpy(g), c, -s).numpy(),
                               atol=1e-5)
    ref, _, _ = _rope_bwd(512, True, (jnp.asarray(cos), jnp.asarray(sin)), jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("shared", [True, False], ids=["kernel_path", "broadcast_path"])
def test_apply_rope_paths_agree(shared):
    """apply_rope takes the rope op when positions are shared and the
    broadcast formula otherwise; both equal the jnp path."""
    x, _, cos, sin = inputs(3)
    b = 1 if shared else x.shape[0]
    c = np.broadcast_to(cos[None, :, None, :], (b, *cos.shape[:1], 1, cos.shape[1]))
    s = np.broadcast_to(sin[None, :, None, :], (b, *sin.shape[:1], 1, sin.shape[1]))
    out = apply_rope(torch.from_numpy(x), torch.from_numpy(c.copy()), torch.from_numpy(s.copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jnp_rope(jnp.asarray(x), cos, sin)),
                               atol=1e-5)
