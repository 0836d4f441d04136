"""3xTF32, the arithmetic of the fp32 flash kernels on the tensor cores (the
forward, dQ and dK/dV; tf_operator_tpu_torch/ops/csrc/tf32x3.cuh), emulated
in plain torch on the CPU and held to the JAX package's Pallas kernels in
interpret mode.

A .tf32 product reads 10 mantissa bits of each fp32 operand. The kernels
split each operand x into hi and lo = x - hi and sum three passes, hi hi +
hi lo + lo hi, in the fp32 accumulator. hi is x rounded to nearest TF32,
for a tile that TMA loads (split in place: hi over x, lo beside it) as for
a register value or a transposed tile; the tensor core then truncates lo.
Here the split is done by bit masks on int32 views, and an attention
forward, its dQ and its dK/dV are built from those products tile by tile
as the kernels build them (the online softmax over key tiles of 64, 32 or
16 keys; key tiles of 64 or 32 for dQ; query tiles of 32 or 16 for dK/dV),
then held to flash_attention_with_lse at tests/test_flash_pallas.py's fp32
tolerances (2e-5 forward, 3e-5 gradients): causal GQA 2:1 at head dims 24
and 128, plain and with logits x 8 (a peaky softmax). The same built from
one TF32 pass fails those tolerances: that is why the kernels take three.
Against fp64, the products of two tiles that TMA loads err at least twice
as far with a hi truncated to TF32 (the tensor core's own reading of a raw
tile) as with the rounded one. Inputs come from a numpy seed.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.flash_pallas import flash_attention_with_lse as jax_flash_with_lse
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

TOL_O, TOL_G = 2e-5, 3e-5  # tests/test_flash_pallas.py, fp32
LOW = 0x1FFF               # the 13 mantissa bits TF32 drops
LOG2E = 1.4426950408889634
SEQ, HEADS, KV_HEADS = 128, 4, 2


def tf32_trunc(x):
    return (x.view(torch.int32) & ~LOW).view(torch.float32)


def tf32_round(x):
    """Round to nearest, ties away from zero (cvt.rna.tf32.f32): on the
    sign-magnitude bits, half of the dropped unit added to the magnitude."""
    return ((x.view(torch.int32) + 0x1000) & ~LOW).view(torch.float32)


def parts(x, hi_of):
    """(hi, lo) as the tensor core reads them: hi = hi_of(x), and lo = x - hi
    (exact in fp32) truncated by the core."""
    hi = hi_of(x)
    return hi, tf32_trunc(x - hi)


def three_products(a, b, hi_a, hi_b):
    """a @ b as the kernels compute it: lo(a) hi(b) + hi(a) lo(b) + hi(a)
    hi(b), each product of TF32 values exact in fp32, summed in fp32."""
    ah, al = parts(a, hi_a)
    bh, bl = parts(b, hi_b)
    return al @ bh + ah @ bl + ah @ bh


def one_product(a, b, hi_a, hi_b):
    """a @ b from one TF32 pass over the same operands."""
    return hi_a(a) @ hi_b(b)


def tiles(d):
    """(keys of a forward tile, keys of a dQ tile, queries of a dK/dV tile)
    of the instance that serves head dim d (flash_fwd_f32.cu,
    flash_dq_f32.cu, flash_dkv_f32.cu)."""
    return (64, 64, 32) if d <= 64 else (32, 32, 16)


def emulate_forward(q, k, v, mm, hi=tf32_round):
    """The forward kernel's arithmetic, causal: per block of 64 query rows,
    S = Q K^T over key tiles (both natural tiles, split in place: ``hi``),
    the online softmax in exp2, O += P V (P split in registers, V^T by the
    producer from the raw V: rounded hi). q [b, kvh, g, s, d], k and v [b,
    kvh, 1, s, d]; returns o like q and lse [b, kvh, g, s]."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    kn, _, _ = tiles(d)
    os, lses = [], []
    for q0 in range(0, SEQ, 64):
        qb = q[..., q0:q0 + 64, :]
        rows = q0 + torch.arange(64)[:, None]
        m = torch.full(qb.shape[:-1], -math.inf)
        l = torch.zeros(qb.shape[:-1])
        acc = torch.zeros(qb.shape)
        for k0 in range(0, q0 + 64, kn):
            s = mm(qb, k[..., k0:k0 + kn, :].transpose(-1, -2), hi, hi)
            cols = k0 + torch.arange(kn)[None, :]
            s = s.masked_fill(cols > rows, -math.inf)
            mx = torch.maximum(m, s.amax(-1))
            ms = torch.where(mx == -math.inf, 0.0, mx * c)
            alpha = torch.exp2(m * c - ms)
            p = torch.exp2(s * c - ms[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + mm(p, v[..., k0:k0 + kn, :], tf32_round, tf32_round)
            m = mx
        os.append(acc / l[..., None])
        lses.append(m * scale + torch.log(l))
    return torch.cat(os, -2), torch.cat(lses, -1)


def emulate_dq(q, k, v, do, lse, delta, mm, hi=tf32_round):
    """The dQ kernel's arithmetic, causal: per block of 64 query rows, over
    the key tiles up to the block's last row, S = Q K^T and dP = dO V^T
    (natural tiles, split in place: ``hi``), P and dS in registers, dQ +=
    dS K (dS split in registers: rounded hi; K^T from K's split: ``hi``).
    Shapes as emulate_dkv's; returns dq like q."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    _, kn, _ = tiles(d)
    dqs = []
    for q0 in range(0, SEQ, 64):
        qb, dob = q[..., q0:q0 + 64, :], do[..., q0:q0 + 64, :]
        lb, dlb = lse[..., q0:q0 + 64, None], delta[..., q0:q0 + 64, None]
        rows = q0 + torch.arange(64)[:, None]
        dq = torch.zeros(qb.shape)
        for k0 in range(0, q0 + 64, kn):
            kt, vt = k[..., k0:k0 + kn, :], v[..., k0:k0 + kn, :]
            s = mm(qb, kt.transpose(-1, -2), hi, hi)
            p = torch.exp2(s * c - lb * LOG2E)
            p = p.masked_fill(k0 + torch.arange(kn)[None, :] > rows, 0.0)
            dp = mm(dob, vt.transpose(-1, -2), hi, hi)
            dq = dq + mm(p * (dp - dlb), kt, tf32_round, hi)
        dqs.append(dq * scale)
    return torch.cat(dqs, -2)


def emulate_dkv(q, k, v, do, lse, delta, mm, hi=tf32_round):
    """The dK/dV kernel's arithmetic, causal: per block of 64 keys, over the
    group's query heads and the query tiles from the diagonal on, S^T = K
    Q^T and dP^T = V dO^T (natural tiles, split in place: ``hi``), P^T and
    dS^T in registers, dV += P^T dO and dK += dS^T Q (P^T and dS^T split in
    registers: rounded hi; Q^T and dO^T from Q's and dO's splits: ``hi``).
    Shapes as emulate_forward's, lse and delta [b, kvh, g, s]; returns dk
    and dv [b, kvh, s, d]."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    _, _, qn = tiles(d)
    dks, dvs = [], []
    for k0 in range(0, SEQ, 64):
        kb, vb = k[:, :, 0, k0:k0 + 64], v[:, :, 0, k0:k0 + 64]
        keys = k0 + torch.arange(64)[:, None]
        dk = torch.zeros(kb.shape)
        dv = torch.zeros(vb.shape)
        for g in range(q.shape[2]):
            for q0 in range(k0, SEQ, qn):
                qt, dot = q[:, :, g, q0:q0 + qn], do[:, :, g, q0:q0 + qn]
                lt, dlt = lse[:, :, g, q0:q0 + qn], delta[:, :, g, q0:q0 + qn]
                st = mm(kb, qt.transpose(-1, -2), hi, hi)
                p = torch.exp2(st * c - (lt * LOG2E)[..., None, :])
                p = p.masked_fill(q0 + torch.arange(qn)[None, :] < keys, 0.0)
                dpt = mm(vb, dot.transpose(-1, -2), hi, hi)
                ds = p * (dpt - dlt[..., None, :])
                dv = dv + mm(p, dot, tf32_round, hi)
                dk = dk + mm(ds, qt, tf32_round, hi)
        dks.append(dk * scale)
        dvs.append(dv)
    return torch.cat(dks, -2), torch.cat(dvs, -2)


def inputs(d, logit, through="k"):
    """q, k, v, dO and dlse, the logits scaled by ``logit`` through k or q.
    Either gives the same softmax, but scales dQ (through k) or dK (through
    q) by it too, past what the elementwise 3e-5 holds at |dQ| or |dK| near
    20 even for exact products (fp64 products rounded to fp32 reach 1.1x and
    1.4x that tolerance at head dim 128): dQ is held on the inputs scaled
    through q, the other outputs on those scaled through k (:func:`held`)."""
    rng = np.random.default_rng(1900 + d)
    q = rng.standard_normal((1, SEQ, HEADS, d)).astype(np.float32)
    k = rng.standard_normal((1, SEQ, KV_HEADS, d)).astype(np.float32)
    v = rng.standard_normal((1, SEQ, KV_HEADS, d)).astype(np.float32)
    do = rng.standard_normal((1, SEQ, HEADS, d)).astype(np.float32)
    dlse = rng.standard_normal((1, HEADS, SEQ)).astype(np.float32)
    if through == "q":
        q = q * np.float32(logit)
    else:
        k = k * np.float32(logit)
    return q, k, v, do, dlse


@functools.cache
def reference():
    """flash_attention_with_lse in interpret mode, causal, blocks of 64:
    (o, lse, dq, dk, dv) under the cotangents (do, dlse), jitted."""
    def run(q, k, v, do, dlse):
        (o, lse), vjp = jax.vjp(
            lambda q, k, v: jax_flash_with_lse(q, k, v, causal=True, block_q=64, block_k=64,
                                               interpret=True), q, k, v)
        dq, dk, dv = vjp((do, dlse))
        return o, lse, dq, dk, dv

    return jax.jit(run)


@functools.cache
def expected(d, logit, through="k"):
    args = [jnp.asarray(a) for a in inputs(d, logit, through)]
    fn = reference()
    # XLA's backend optimisations cost compile time and buy nothing here.
    out = fn.lower(*args).compile({"xla_backend_optimization_level": 0})(*args)
    return tuple(np.asarray(x) for x in out)


@functools.cache
def emulate(d, logit, mm, hi=tf32_round, through="k"):
    """(o, lse, dq, dk, dv) in the JAX package's layouts, from the kernels'
    arithmetic with products ``mm`` and natural tiles split to ``hi``;
    delta = rowsum(dO o) - dlse, as ops/flash.py flash_delta computes it,
    from the emulated o."""
    q, k, v, do, dlse = (torch.from_numpy(a) for a in inputs(d, logit, through))
    g = HEADS // KV_HEADS

    def grouped(x):  # [b, s, h, d] -> [b, kvh, g, s, d]
        return x.permute(0, 2, 1, 3).reshape(1, KV_HEADS, -1, SEQ, d)

    qg, dog = grouped(q), grouped(do)
    kg, vg = grouped(k), grouped(v)
    o, lse = emulate_forward(qg, kg, vg, mm, hi)
    delta = (dog * o).sum(-1) - dlse.reshape(1, KV_HEADS, g, SEQ)
    dq = emulate_dq(qg, kg, vg, dog, lse, delta, mm, hi)
    dk, dv = emulate_dkv(qg, kg, vg, dog, lse, delta, mm, hi)
    return (o.reshape(1, HEADS, SEQ, d).permute(0, 2, 1, 3).numpy(),
            lse.reshape(1, HEADS, SEQ).numpy(),
            dq.reshape(1, HEADS, SEQ, d).permute(0, 2, 1, 3).numpy(),
            dk.permute(0, 2, 1, 3).numpy(), dv.permute(0, 2, 1, 3).numpy())


NAMES = ("o", "lse", "dq", "dk", "dv")
TOLS = (TOL_O, TOL_O, TOL_G, TOL_G, TOL_G)


def held(d, logit, mm):
    """(emulated, Pallas) outputs (o, lse, dq, dk, dv) with products
    ``mm``: dq from the inputs with the logits scaled through q, the others
    through k (:func:`inputs`)."""
    got, want = list(emulate(d, logit, mm)), list(expected(d, logit))
    if logit != 1:
        got[2] = emulate(d, logit, mm, through="q")[2]
        want[2] = expected(d, logit, "q")[2]
    return got, want


def worst(got, want):
    """Per output, the largest |got - want| over atol + rtol |want| at the
    tolerance assert_allclose would apply: above 1 fails."""
    return [float(np.max(np.abs(g - w) / (t + t * np.abs(w))))
            for g, w, t in zip(got, want, TOLS)]


@pytest.mark.parametrize("hi_of,bound", [(tf32_round, 2.0**-21), (tf32_trunc, 2.0**-20)],
                         ids=["rounded", "truncated"])
def test_split_reconstructs(hi_of, bound):
    """hi + lo is x exactly in fp32, and hi + lo as the tensor core reads
    lo (truncated) is x within 2^-21 relative for a rounded hi (|lo| <=
    half a TF32 unit), 2^-20 for a truncated one (|lo| < one unit); hi and
    the core's lo are TF32 values (their 13 low bits zero)."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(4096) * 1e6,
        rng.standard_normal(4096) * 1e-6]).astype(np.float32))
    hi = hi_of(x)
    assert torch.equal(hi + (x - hi), x)
    h, lo = parts(x, hi_of)
    for part in (h, lo):
        assert not (part.view(torch.int32) & LOW).any()
    rel = ((h.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert 0 < rel <= bound
    # One TF32 pass alone is off by up to 2^-10 (truncated) or 2^-11.
    assert (hi.double() - x.double()).abs().div(x.double().abs()).max().item() > 2.0**-12


@pytest.mark.parametrize("logit", [1.0, 8.0], ids=["x1", "x8"])
@pytest.mark.parametrize("d", [24, 128])
def test_three_products_match_pallas(d, logit):
    """o, lse, dQ, dK and dV built from 3xTF32 products within the Pallas
    tests' fp32 tolerances of the Pallas kernels in interpret mode."""
    got, want = held(d, logit, three_products)
    for g, w, tol, name in zip(got, want, TOLS, NAMES):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("logit", [1.0, 8.0], ids=["x1", "x8"])
@pytest.mark.parametrize("d", [24, 128])
def test_one_tf32_pass_fails_pallas_tolerance(d, logit):
    """The same from one TF32 pass a product: o, dQ, dK and dV leave the
    tolerances the three passes keep (by more than 3x for o and dV), which
    pins why the kernels take three."""
    ratios = dict(zip(NAMES, worst(*held(d, logit, one_product))))
    assert ratios["o"] > 3 and ratios["dv"] > 3, ratios
    assert ratios["dk"] > 1 and ratios["dq"] > 1, ratios
    assert max(worst(*held(d, logit, three_products))) <= 1


def split_errors(d, hi_of):
    """The three passes' own error in every product of the emulation with
    logits x 8, natural tiles split to ``hi_of``: the passes taken and
    summed exactly (fp64) against the fp64 product of the same operands, as
    max |error| over max |product|. Returns the largest over the products
    of two natural tiles (S and dP, S^T and dP^T) and over all."""
    def natural(x):  # a function of its own: a product tells natural tiles apart
        return hi_of(x)

    both = every = 0.0

    def mm(a, b, hi_a, hi_b):
        nonlocal both, every
        (ah, al), (bh, bl) = parts(a, hi_a), parts(b, hi_b)
        exact = a.double() @ b.double()
        passes = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
        err = ((passes - exact).abs().max() / exact.abs().max()).item()
        every = max(every, err)
        if hi_a is natural and hi_b is natural:
            both = max(both, err)
        return exact.float()

    emulate.__wrapped__(d, 8.0, mm, natural)
    return both, every


@pytest.mark.parametrize("d", [24, 128])
def test_rounded_hi_cuts_the_products_error(d):
    """With the natural tiles' hi rounded in place, the products of two
    natural tiles err at least 2x less against fp64 than with it truncated
    (the tensor core's reading of a raw tile): |lo| halves, and with it lo
    lo and the core's truncation of lo. A product with one operand split in
    registers gains less (its rounded side is the same in both), so over
    all products the largest error is only held no larger."""
    rounded, truncated = split_errors(d, tf32_round), split_errors(d, tf32_trunc)
    assert 2 * rounded[0] <= truncated[0], (rounded, truncated)
    assert rounded[1] <= truncated[1], (rounded, truncated)


def test_fragment_order_keeps_the_product():
    """The register A fragment of a k8 step takes accumulators {4j, 4j +
    2, 4j + 1, 4j + 3} (split_frags) and the transposed tile stores key e
    of each group of 8 at column (e >> 1) + 4 (e & 1) (tcol): read with the
    wgmma semantics (a0 row g column t, a1 row g + 8, a2 column t + 4, a3
    both; the accumulator's columns {2t, 2t + 1} of each group), they give
    P V for every lane of a warp."""
    rng = np.random.default_rng(5)
    keys, n = 32, 8
    p = rng.standard_normal((16, keys))
    v = rng.standard_normal((keys, n))
    tcol = [(e & ~7) + ((e & 7) >> 1) + 4 * (e & 1) for e in range(keys)]
    bt = np.zeros((n, keys))  # B[n][position]: V^T as the producer writes it
    for e in range(keys):
        bt[:, tcol[e]] = v[e]
    out = np.zeros((16, n))
    for j in range(keys // 8):
        a = np.zeros((16, 8))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # The thread's accumulators of columns 8j .. 8j + 7: (row, column).
            acc = {4 * j: (g, 8 * j + 2 * t), 4 * j + 1: (g, 8 * j + 2 * t + 1),
                   4 * j + 2: (g + 8, 8 * j + 2 * t), 4 * j + 3: (g + 8, 8 * j + 2 * t + 1)}
            frag = [acc[4 * j], acc[4 * j + 2], acc[4 * j + 1], acc[4 * j + 3]]
            for (row, col), (ar, ac) in zip(frag, [(g, t), (g + 8, t), (g, t + 4),
                                                   (g + 8, t + 4)]):
                a[ar, ac] = p[row, col]
        out += a @ bt[:, 8 * j:8 * j + 8].T
    np.testing.assert_allclose(out, p @ v, rtol=1e-12, atol=1e-12)
