"""The roofline accounting of the flash kernels (ops/flash.py flash_work),
which chip_smoke.py divides by the card's peaks to get each kernel's bound.

The llama-400m counts are pinned by hand: bs 8, seq 2048, 8 heads x 128,
causal has b * h * s (s + 1) / 2 = 134,283,264 visible (q, k) pairs.
"""

import pytest

from tf_operator_tpu_torch.ops.flash import Work, flash_work

PAIRS = 134_283_264
Q_BYTES = 2 * 8 * 2048 * 8 * 128      # one bf16 [8, 2048, 8, 128] tensor
ROWS_BYTES = 4 * 8 * 8 * 2048         # one fp32 [8, 8, 2048] tensor


def test_llama_400m_counts():
    w = flash_work(8, 2048, 2048, 8, 8, 128, causal=True)
    assert 8 * 8 * 2048 * 2049 // 2 == PAIRS
    assert w["flash_fwd"].flops == 4 * PAIRS * 128 == 68_753_031_168
    assert w["flash_dq"].flops == 6 * PAIRS * 128 == 103_129_546_752
    assert w["flash_dkv"].flops == 8 * PAIRS * 128 == 137_506_062_336
    # forward: read q, k, v; write o and lse
    assert w["flash_fwd"].bytes == 4 * Q_BYTES + ROWS_BYTES == 134_742_016
    # dQ: read q, k, v, dO, lse, delta; write dQ
    assert w["flash_dq"].bytes == 5 * Q_BYTES + 2 * ROWS_BYTES
    # dK/dV: read q, k, v, dO, lse, delta; write dK, dV
    assert w["flash_dkv"].bytes == 6 * Q_BYTES + 2 * ROWS_BYTES


def test_llama_400m_bounds_on_the_h100():
    """Operations bound all three at these shapes (989 TFLOP/s, 3.35 TB/s)."""
    w = flash_work(8, 2048, 2048, 8, 8, 128, causal=True)
    for name, ms in (("flash_fwd", 0.0695), ("flash_dq", 0.1043), ("flash_dkv", 0.1390)):
        t_ops = w[name].flops / 989e12 * 1e3
        t_bytes = w[name].bytes / 3.35e12 * 1e3
        assert t_ops > t_bytes
        assert t_ops == pytest.approx(ms, abs=5e-5)


def test_gqa_counts_kv_bytes_once_per_kv_head():
    b, s, h, kvh, d = 2, 320, 8, 1, 128
    w = flash_work(b, s, s, h, kvh, d, causal=True)
    q = 2 * b * s * h * d
    kv = 2 * b * s * kvh * d
    rows = 4 * b * h * s
    pairs = b * h * s * (s + 1) // 2
    assert w["flash_fwd"] == Work(q + 2 * kv + q + rows, 4 * pairs * d)
    assert w["flash_dq"] == Work(q + 2 * kv + 2 * q + 2 * rows, 6 * pairs * d)
    assert w["flash_dkv"] == Work(q + 2 * kv + q + 2 * rows + 2 * kv, 8 * pairs * d)
    # GQA changes the bytes, never the FLOPs: every query head sees its keys.
    mha = flash_work(b, s, s, h, h, d, causal=True)
    for name in w:
        assert w[name].flops == mha[name].flops
        assert w[name].bytes < mha[name].bytes


@pytest.mark.parametrize("s_q,s_k", [(512, 512), (256, 640)])
def test_non_causal_counts_every_pair(s_q, s_k):
    w = flash_work(2, s_q, s_k, 8, 8, 128, causal=False)
    pairs = 2 * 8 * s_q * s_k
    assert w["flash_fwd"].flops == 4 * pairs * 128
    assert w["flash_dkv"].flops == 8 * pairs * 128
    causal = flash_work(2, s_q, s_q, 8, 8, 128, causal=True)
    if s_q == s_k:  # causal sees a little over half the pairs
        assert causal["flash_fwd"].flops * 2 == 4 * (pairs + 2 * 8 * s_q) * 128


def test_causal_cross_length_is_refused():
    with pytest.raises(ValueError):
        flash_work(2, 256, 640, 8, 8, 128, causal=True)
