"""The port's flash attention (plain versions, CPU) at the head dims its
kernels' 64-, 128- and 256-wide instances take besides 64 and 128,
against the JAX package's Pallas kernels in interpret mode and its XLA
reference.

Inputs come from a numpy seed and go through both packages, at the
tolerances of tests/test_flash_pallas.py: fp32 2e-5 forward and 3e-5
gradients; bf16 2e-2 forward and 5e-2 gradients. A file of its own with
few tests: xdist's loadfile order hands out the files with most tests
first, and the Pallas interpreter's compiles kept out of that first wave
leave the CPU to the timed recovery legs of tests/test_torch_recovery.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.attention import xla_attention as jax_xla_attention
from tf_operator_tpu.ops.flash_pallas import flash_attention_with_lse as jax_flash_with_lse
from tf_operator_tpu_torch.ops import flash
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)


def rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d", [16, 32, 80, 96, 256])
def test_head_dims_match_pallas(d):
    """The plain versions at head dims the kernels' 64-, 128- and 256-wide
    instances take besides 64 and 128: o and lse, and the gradients of both
    (a dlse cotangent), against the Pallas kernels in interpret mode, and o
    against the XLA reference; GQA 2:1, causal, blocks of 64. fp32 at 2e-5
    (o, lse) and 3e-5 (gradients), bf16 at 2e-2 and 5e-2."""
    arrays = rand(16 + d, (1, 128, 2, d), (1, 128, 1, d), (1, 128, 1, d))
    wo, wl = rand(d, (1, 128, 2, d), (1, 2, 128))

    def loss(q, k, v):
        o, lse = jax_flash_with_lse(q, k, v, block_q=64, block_k=64, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * wo) + jnp.sum(lse * wl), (o, lse)

    reference = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    for dtype, tol_o, tol_g in (("float32", 2e-5, 3e-5), ("bfloat16", 2e-2, 5e-2)):
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        q, k, v = (torch.tensor(a, dtype=tdt, requires_grad=True) for a in arrays)
        o, lse = flash.flash_attention_with_lse(q, k, v, block_q=64, block_k=64)
        ((o.float() * torch.from_numpy(wo)).sum()
         + (lse * torch.from_numpy(wl)).sum()).backward()
        (_, (ro, rlse)), ref = reference(*(jnp.asarray(a, jdt) for a in arrays))
        assert o.dtype == tdt and tuple(lse.shape) == (1, 2, 128)
        np.testing.assert_allclose(f32(o), f32(ro), atol=tol_o, rtol=tol_o, err_msg=dtype)
        np.testing.assert_allclose(f32(lse), f32(rlse), atol=tol_o, rtol=tol_o, err_msg=dtype)
        np.testing.assert_allclose(
            f32(o), f32(jax_xla_attention(*(jnp.asarray(a, jdt) for a in arrays), causal=True)),
            atol=tol_o, rtol=tol_o, err_msg=dtype)
        for g, r, name in zip((q.grad, k.grad, v.grad), ref, "qkv"):
            np.testing.assert_allclose(f32(g), f32(r), atol=tol_g, rtol=tol_g,
                                       err_msg=f"{dtype} d{name}")
