"""fp32 and the head dims that are a multiple of 8 (not of 16): the port's
plain versions (CPU) against the JAX package's Pallas kernels in interpret
mode, a 2-layer fp32 Llama of head_dim 24 against the Flax model, and the
kernels' dispatch (instances, launch counters, refusals, work counts).

Inputs come from a numpy seed and go through both packages, at the
tolerances of tests/test_flash_pallas.py (fp32 2e-5 forward and 3e-5
gradients; bf16 2e-2 and 5e-2) and of tests/test_torch_llama.py (fp32
logits 1e-4 relative, gradients 1e-4 relative L2). A file of its own with
few tests: xdist's loadfile order hands out the files with most tests
first, and the Pallas interpreter's compiles kept out of that first wave
leave the CPU to the timed recovery legs of tests/test_torch_recovery.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu.models.llama import rope_table as jax_rope_table
from tf_operator_tpu.ops.flash_pallas import flash_attention_with_lse as jax_flash_with_lse
from tf_operator_tpu.ops.rope_pallas import rope_pallas
from tf_operator_tpu_torch.models import convert, llama
from tf_operator_tpu_torch.ops import build, flash, rope
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

TOLS = {"float32": (2e-5, 3e-5), "bfloat16": (2e-2, 5e-2)}


def rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("d", [8, 24, 40, 136])
def test_plain_flash_matches_pallas(d):
    """The plain versions at head dims that are a multiple of 8 and not of
    16 (8, 24 and 40 on the 64-wide instances, 136 on the 256-wide): o and
    lse, and the gradients of both (a dlse cotangent), against the Pallas
    kernels in interpret mode; GQA 2:1, causal, blocks of 64, in fp32 and
    bf16."""
    arrays = rand(8 + d, (1, 128, 2, d), (1, 128, 1, d), (1, 128, 1, d))
    wo, wl = rand(d, (1, 128, 2, d), (1, 2, 128))

    def loss(q, k, v):
        o, lse = jax_flash_with_lse(q, k, v, block_q=64, block_k=64, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * wo) + jnp.sum(lse * wl), (o, lse)

    reference = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    for dtype, (tol_o, tol_g) in TOLS.items():
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        q, k, v = (torch.tensor(a, dtype=tdt, requires_grad=True) for a in arrays)
        o, lse = flash.flash_attention_with_lse(q, k, v, block_q=64, block_k=64)
        ((o.float() * torch.from_numpy(wo)).sum()
         + (lse * torch.from_numpy(wl)).sum()).backward()
        args = [jnp.asarray(a, jdt) for a in arrays]
        # XLA's backend optimisations cost compile time and buy nothing here.
        (_, (ro, rlse)), ref = reference.lower(*args).compile(
            {"xla_backend_optimization_level": 0})(*args)
        assert o.dtype == tdt and lse.dtype == torch.float32
        np.testing.assert_allclose(f32(o), f32(ro), atol=tol_o, rtol=tol_o, err_msg=dtype)
        np.testing.assert_allclose(f32(lse), f32(rlse), atol=tol_o, rtol=tol_o, err_msg=dtype)
        for g, r, name in zip((q.grad, k.grad, v.grad), ref, "qkv"):
            assert g.dtype == tdt
            np.testing.assert_allclose(f32(g), f32(r), atol=tol_g, rtol=tol_g,
                                       err_msg=f"{dtype} d{name}")


@pytest.mark.parametrize("d", [8, 24])
def test_rope_plain_matches_pallas(d):
    """rope_plain and its inverse (the backward) against the Pallas kernel
    in interpret mode at head dims whose half is not a multiple of 8, in
    fp32 and bf16; the output keeps x's dtype."""
    x, g = rand(d, (2, 32, 3, d), (2, 32, 3, d))
    cos, sin = (np.array(t) for t in jax_rope_table(d, 32, 10000.0))
    kernel = jax.jit(lambda x, c, s: rope_pallas(x, c, s, interpret=True))
    for dtype, (tol, _) in TOLS.items():
        tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
        tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
        out = rope.rope_plain(torch.tensor(x, dtype=tdt), tc, ts)
        assert out.dtype == tdt
        np.testing.assert_allclose(f32(out), f32(kernel(jnp.asarray(x, jdt), cos, sin)),
                                   atol=tol, rtol=tol, err_msg=dtype)
        back = rope.rope_plain(torch.tensor(g, dtype=tdt), tc, ts, inverse=True)
        np.testing.assert_allclose(f32(back), f32(kernel(jnp.asarray(g, jdt), cos, -sin)),
                                   atol=tol, rtol=tol, err_msg=f"{dtype} inverse")


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def test_llama_head_dim_24_fp32_matches_jax():
    """A 2-layer Llama of 4 heads of 24 (2 KV heads) in fp32, the JAX
    model's weights carried across by models/convert.py: the logits, the
    next-token loss and every parameter's gradient of that loss against the
    Flax model's."""
    widths = dict(vocab_size=256, dim=96, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=192,
                  max_seq_len=64)
    jcfg = jax_llama.LlamaConfig(**widths, dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = llama.LlamaConfig(**widths, dtype=torch.float32, param_dtype=torch.float32)
    assert tcfg.head_dim == 24
    jmodel = jax_llama.Llama(jcfg)
    params = jax_llama.init_params(jmodel, jax.random.PRNGKey(0), seq=32)
    tmodel = llama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(jax.tree.map(np.asarray, params)))
    tokens = np.random.default_rng(3).integers(0, 256, (2, 33), np.int32)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss(p):
        logits = jmodel.apply(p, inputs)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)
        return jnp.mean(nll), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
        params).compile({"xla_backend_optimization_level": 0})(params)

    logits = tmodel(torch.from_numpy(inputs).long())
    tloss = torch.nn.functional.cross_entropy(logits.reshape(-1, 256),
                                              torch.from_numpy(targets).long().reshape(-1))
    tloss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    ref = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in tmodel.named_parameters():
        assert rel_err(p.grad.numpy(), ref[name].numpy()) < 1e-4, name


def test_kernel_width_and_names_at_new_head_dims_and_fp32():
    """Every multiple of 8 from 8 to 256 goes to the narrowest instance that
    holds it, and fp32 counts on its own counters (``_f32`` after the
    kernel's name), rope too; every counter is one of build.KERNELS."""
    for d in range(8, 257, 8):
        assert flash.kernel_width(d) == (64 if d <= 64 else 128 if d <= 128 else 256)
    bf16, fp32 = torch.bfloat16, torch.float32
    names = {(d, dt): flash.kernel_name("flash_fwd", d, dt)
             for d in (8, 24, 40, 72, 136, 248) for dt in (bf16, fp32)}
    assert names == {
        (8, bf16): "flash_fwd_d64", (8, fp32): "flash_fwd_f32_d64",
        (24, bf16): "flash_fwd_d64", (24, fp32): "flash_fwd_f32_d64",
        (40, bf16): "flash_fwd_d64", (40, fp32): "flash_fwd_f32_d64",
        (72, bf16): "flash_fwd", (72, fp32): "flash_fwd_f32",
        (136, bf16): "flash_fwd_d256", (136, fp32): "flash_fwd_f32_d256",
        (248, bf16): "flash_fwd_d256", (248, fp32): "flash_fwd_f32_d256",
    }
    assert [flash.kernel_name(k, 24, fp32) for k in ("flash_dq", "flash_dkv")] == \
        ["flash_dq_f32_d64", "flash_dkv_f32_d64"]
    assert flash.kernel_name("flash_dq", 128) == "flash_dq"  # bf16 by default
    assert (rope.kernel_name(bf16), rope.kernel_name(fp32)) == ("rope", "rope_f32")
    counters = {flash.kernel_name(k, d, dt) for k in ("flash_fwd", "flash_dq", "flash_dkv")
                for d in (8, 128, 256) for dt in (bf16, fp32)}
    assert counters | {"rope", "rope_f32"} == set(build.KERNELS)
    for d in (8, 24, 136):
        for dt in (bf16, fp32):
            t = torch.zeros(1, 64, 2, d, dtype=dt)
            flash._check_kernel_qkv(t, t, t, causal=True)


def test_refusals_before_a_launch():
    """A head dim above 256 or not a multiple of 8 raises ValueError naming
    the rule and its ROADMAP item; fp16 (and q, k, v of mixed dtypes)
    raises TypeError, from the flash checks and from rope."""
    for d in (12, 260, 264):
        t = torch.zeros(1, 64, 2, d, dtype=torch.float32)
        with pytest.raises(ValueError, match=rf"multiple of 8 from 8 to 256, not {d} "
                                             r"\(ROADMAP.md, Queue 2"):
            flash._check_kernel_qkv(t, t, t, causal=True)
        with pytest.raises(ValueError, match="multiple of 8"):
            flash.kernel_name("flash_dq", d, torch.float32)
    half = torch.zeros(1, 64, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32, not torch.float16"):
        flash._check_kernel_qkv(half, half, half, causal=True)
    with pytest.raises(TypeError, match="float16"):
        flash.kernel_name("flash_fwd", 64, torch.float16)
    with pytest.raises(TypeError, match="float16"):
        rope.kernel_name(torch.float16)
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        flash._check_kernel_qkv(q, q.bfloat16(), q.bfloat16(), causal=True)


def test_work_counts_4_byte_elements():
    """flash_work and rope_work on fp32 (4-byte elements) against a hand
    count at b 1, seq 64, 2 query heads, 1 KV head, head dim 24, causal:
    each input read once and each output written once, lse and delta fp32
    in both dtypes; the FLOPs do not depend on the dtype."""
    q = 4 * 1 * 64 * 2 * 24     # q, o, dO and dQ: 12288 bytes each
    kv = 4 * 1 * 64 * 1 * 24    # k, v, dK and dV: 6144 bytes each
    row = 4 * 1 * 2 * 64        # lse and delta: 512 bytes each
    w = flash.flash_work(1, 64, 64, 2, 1, 24, True, itemsize=4)
    # forward: q, k, v in; o, lse out
    assert w["flash_fwd"].bytes == q + 2 * kv + q + row == 37376
    # dQ: q, k, v, dO, lse, delta in; dQ out
    assert w["flash_dq"].bytes == q + 2 * kv + q + 2 * row + q == 50176
    # dK/dV: q, k, v, dO, lse, delta in; dK, dV out
    assert w["flash_dkv"].bytes == q + 2 * kv + q + 2 * row + 2 * kv == 50176
    pairs = 2 * 64 * 65 // 2
    assert w["flash_fwd"].flops == 4 * pairs * 24 == 399360
    w2 = flash.flash_work(1, 64, 64, 2, 1, 24, True)
    assert w2["flash_fwd"].bytes == q // 2 + kv + q // 2 + row
    assert all(w2[n].flops == w[n].flops for n in w)
    assert rope.rope_work(1, 64, 2, 24, itemsize=4).bytes == 2 * q + 2 * 4 * 64 * 12 == 30720
    assert rope.rope_work(1, 64, 2, 24).bytes == q + 2 * 4 * 64 * 12


def test_fp32_is_scored_against_a_third_of_the_tf32_peak():
    """An fp32 bound or MFU divides by a third of the card's dense TF32
    peak (3xTF32), a bf16 one by the bf16 peak; no other dtype has one."""
    from tf_operator_tpu_torch.device import TF32_PASSES, peak_for, tflops_for

    peak, assumed = peak_for("NVIDIA H100 80GB HBM3")
    assert assumed is None and (peak.bf16_tflops, peak.tf32_tflops) == (989.0, 494.7)
    assert TF32_PASSES == 3
    assert tflops_for(peak, torch.float32) == pytest.approx(494.7 / 3)
    assert tflops_for(peak, torch.bfloat16) == 989.0
    with pytest.raises(ValueError, match="float16"):
        tflops_for(peak, torch.float16)
