"""Flash attention: the Hopper kernels (forward, dQ, dK/dV) and their plain
versions.

Counterpart of ``tf_operator_tpu/ops/flash_pallas.py``. The public API is
BSHD (``[batch, seq, heads, head_dim]``), with GQA (``heads % kv_heads == 0``)
and an optional causal mask (which requires ``s_q == s_k``):

- :func:`flash_attention` returns o in q's dtype (``flash_attention_pallas``);
- :func:`flash_attention_with_lse` returns (o, lse ``[b, h, s]`` fp32) and
  is differentiable in both (``flash_attention_with_lse``).

The backward is the FlashAttention-2 split: one pass for dQ, one for dK/dV.
``delta = rowsum(dO * O) - dlse`` is computed here in plain torch, outside
the kernels, as the JAX package computes it in XLA. A remat policy that
saves the forward's (o, lse) (the JAX package tags them ``flash_o``/
``flash_lse``) names them ``"flash"`` on its tape (``ops/remat.py``): the
block's replay then takes them back and launches no second forward.

A CUDA tensor goes through the kernels (bf16, head_dim 64 or 128, fixed
tiles): ``ops/csrc/flash_fwd.cu`` (forward), ``ops/csrc/flash_dq.cu`` (dQ)
and ``ops/csrc/flash_dkv.cu`` (dK/dV), each built as one kernel for each
head_dim, whose launches count apart (``kernel_name``: ``flash_fwd`` at
128, ``flash_fwd_d64`` at 64); a CPU tensor through the plain versions,
which emulate the kernels' blockwise online-softmax recurrence with
``block_q``/``block_k`` blocks that step down to a divisor of the sequence
length (``_block_size``). :func:`flash_work` counts the least bytes and
FLOPs of each kernel call, for its roofline bound.
"""

from __future__ import annotations

import torch

from . import build, remat
from .roofline import Work

# Large-but-finite mask value: exp(x - x) on a fully-masked row must not
# produce inf - inf = nan.
MASK_VALUE = -1e30
# The head dims the kernels are built for; any other is refused on the card.
KERNEL_HEAD_DIMS = (64, 128)


def kernel_name(kernel: str, head_dim: int) -> str:
    """The launch counter of ``kernel`` ("flash_fwd", "flash_dq" or
    "flash_dkv") at ``head_dim``: the kernel's own name at 128, with
    ``_d64`` at 64."""
    return kernel if head_dim == 128 else f"{kernel}_d{head_dim}"


def _block_size(want: int, total: int) -> int:
    size = min(want, total)
    while total % size:
        size //= 2
    return max(size, 1)


def _check_args(q, k, v, causal):
    _, s_q, heads, _ = q.shape
    _, s_k, kv_heads, _ = k.shape
    if heads % kv_heads:
        raise ValueError(f"{heads} query heads not divisible by {kv_heads} KV heads")
    if causal and s_q != s_k:
        raise ValueError("causal flash kernel requires s_q == s_k (self-attention)")
    if v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")


def _grouped(q, k):
    """q as [b, kv_heads, groups, s, d] and k as [b, kv_heads, 1, s, d]
    views: each group of query heads meets its KV head by broadcasting,
    never by a repeated copy."""
    b, s_q, h, d = q.shape
    kvh = k.shape[2]
    qg = q.permute(0, 2, 1, 3).reshape(b, kvh, h // kvh, s_q, d)
    return qg, k.permute(0, 2, 1, 3)[:, :, None]


def flash_work(b: int, s_q: int, s_k: int, h: int, kvh: int, d: int,
               causal: bool) -> dict[str, Work]:
    """Bytes and tensor-core FLOPs of the forward, dQ and dK/dV kernels on
    bf16 q ``[b, s_q, h, d]`` and k/v ``[b, s_k, kvh, d]``, with fp32 lse and
    delta ``[b, h, s_q]``. FLOPs count only the visible (q, k) pairs: 2 per
    pair and head dim for each product, of which the forward has 2 (Q K^T,
    P V), dQ 3 (adds dO V^T, dS K) and dK/dV 4 (adds dS^T Q, P^T dO)."""
    if causal and s_q != s_k:
        raise ValueError("causal attention requires s_q == s_k")
    pairs = b * h * (s_q * (s_q + 1) // 2 if causal else s_q * s_k)
    q_bytes = 2 * b * s_q * h * d        # q, o, dO and dQ alike
    kv_bytes = 2 * b * s_k * kvh * d     # k, v, dK and dV alike
    rows_bytes = 4 * b * h * s_q         # lse, delta
    qkv = q_bytes + 2 * kv_bytes
    return {
        "flash_fwd": Work(qkv + q_bytes + rows_bytes, 4 * pairs * d),
        "flash_dq": Work(qkv + 2 * q_bytes + 2 * rows_bytes, 6 * pairs * d),
        "flash_dkv": Work(qkv + q_bytes + 2 * rows_bytes + 2 * kv_bytes, 8 * pairs * d),
    }


def _causal_mask(q_start, bq, k_start, bk, device):
    row = q_start + torch.arange(bq, device=device)[:, None]
    col = k_start + torch.arange(bk, device=device)[None, :]
    return row >= col


# ------------------------------------------------------------ plain versions
def flash_forward_plain(q, k, v, causal=True, block_q=1024, block_k=1024):
    """Plain version of the forward kernel: (o BSHD in q's dtype,
    lse [b, h, s_q] fp32)."""
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / d**0.5
    bq, bk = _block_size(block_q, s_q), _block_size(block_k, s_k)
    qg, kg = _grouped(q, k)
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    o = torch.empty(qg.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(qg.shape[:-1], dtype=torch.float32, device=q.device)
    for qs in range(0, s_q, bq):
        qb = qg[..., qs:qs + bq, :].float()
        m = torch.full((*qb.shape[:-1], 1), MASK_VALUE, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for ks in range(0, s_k, bk):
            if causal and qs + bq - 1 < ks:
                continue  # above the diagonal: invisible to every row
            s = scale * (qb @ kg[..., ks:ks + bk, :].float().transpose(-1, -2))
            if causal:
                s = torch.where(_causal_mask(qs, bq, ks, bk, q.device), s, MASK_VALUE)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            # P cast to V's dtype for the PV product; the accumulator is fp32.
            acc = acc * alpha + p.to(v.dtype).float() @ vg[..., ks:ks + bk, :].float()
        l_safe = torch.where(l == 0.0, 1.0, l)
        o[..., qs:qs + bq, :] = (acc / l_safe).to(q.dtype)
        lse[..., qs:qs + bq] = (m + torch.log(l_safe))[..., 0]
    o = o.reshape(b, h, s_q, d).permute(0, 2, 1, 3).contiguous()
    return o, lse.reshape(b, h, s_q)


def flash_delta(do, o, dlse=None):
    """delta = rowsum(dO * O) - dlse, [b, h, s] fp32. A cotangent on lse
    adds p * dlse to dS (d lse / d s_j = p_j), so it folds into the same
    per-row subtrahend and the backward kernels run unchanged."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _backward_blocks(q, k, v, do, lse, delta, causal, block_q, block_k):
    """Yield, per visible (q block, k block), the fp32 operands and the
    recomputed P and dS of the backward recurrence (shared by the dQ and
    dK/dV plain versions)."""
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / d**0.5
    bq, bk = _block_size(block_q, s_q), _block_size(block_k, s_k)
    qg, kg = _grouped(q, k)
    dog, vg = _grouped(do, v)
    lse_g = lse.reshape(b, kvh, h // kvh, s_q, 1)
    delta_g = delta.reshape(b, kvh, h // kvh, s_q, 1)
    for qs in range(0, s_q, bq):
        for ks in range(0, s_k, bk):
            if causal and qs + bq - 1 < ks:
                continue
            qb = qg[..., qs:qs + bq, :].float()
            kb = kg[..., ks:ks + bk, :].float()
            vb = vg[..., ks:ks + bk, :].float()
            dob = dog[..., qs:qs + bq, :].float()
            s = scale * (qb @ kb.transpose(-1, -2))
            if causal:
                s = torch.where(_causal_mask(qs, bq, ks, bk, q.device), s, MASK_VALUE)
            p = torch.exp(s - lse_g[..., qs:qs + bq, :])
            dp = dob @ vb.transpose(-1, -2)
            ds = p * (dp - delta_g[..., qs:qs + bq, :])
            yield (qs, bq, ks, bk), qb, kb, dob, p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal=True, block_q=1024, block_k=1024):
    """Plain version of the dQ kernel: dQ = scale * sum_k dS K."""
    b, s_q, h, d = q.shape
    scale = 1.0 / d**0.5
    dq = torch.zeros(_grouped(q, k)[0].shape, dtype=torch.float32, device=q.device)
    for (qs, bq, _, _), _, kb, _, _, ds in _backward_blocks(
            q, k, v, do, lse, delta, causal, block_q, block_k):
        # dS cast to K's dtype for the product; the sum is fp32.
        dq[..., qs:qs + bq, :] += scale * (ds.to(k.dtype).float() @ kb)
    return dq.reshape(b, h, s_q, d).permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_dkv_plain(q, k, v, do, lse, delta, causal=True, block_q=1024, block_k=1024):
    """Plain version of the dK/dV kernel: dV = sum P^T dO and
    dK = scale * sum dS^T Q, summed over each KV head's query-head group."""
    b, s_k, kvh, d = k.shape
    scale = 1.0 / d**0.5
    dk = torch.zeros((b, kvh, s_k, d), dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for (_, _, ks, bk), qb, _, dob, p, ds in _backward_blocks(
            q, k, v, do, lse, delta, causal, block_q, block_k):
        pt = p.to(do.dtype).float().transpose(-1, -2)
        dst = ds.to(q.dtype).float().transpose(-1, -2)
        dv[..., ks:ks + bk, :] += (pt @ dob).sum(2)
        dk[..., ks:ks + bk, :] += scale * (dst @ qb).sum(2)
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ------------------------------------------------------------ kernel wrappers
def _check_cuda(**tensors):
    ref = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"flash kernels take CUDA tensors; {name} is on {t.device}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernels take contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _check_kernel_qkv(q, k, v, causal):
    _check_args(q, k, v, causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernels take bfloat16; {name} is {t.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {KERNEL_HEAD_DIMS}, "
                         f"not {q.shape[-1]}")
    if q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")


def _check_backward(q, k, v, do, lse, delta, causal):
    """Checks of the backward kernels' inputs; returns dO made contiguous."""
    _check_kernel_qkv(q, k, v, causal)
    do = do.contiguous()
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q in shape and dtype")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be float32 {list(want)}")
    _check_cuda(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    return do


def _dims(q, k):
    b, s_q, h, d = q.shape
    return b, h, k.shape[2], s_q, k.shape[1], d


def flash_forward_cuda(q, k, v, causal=True):
    """Launch the forward kernel: (o BSHD bf16, lse [b, h, s_q] fp32)."""
    _check_kernel_qkv(q, k, v, causal)
    _check_cuda(q=q, k=k, v=v)
    b, h, kvh, s_q, s_k, d = _dims(q, k)
    lib = build.load()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    code = lib.tk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, kvh, s_q, s_k, d, int(causal), 1.0 / d**0.5, build.stream_ptr(q.device),
    )
    build.check(lib, code, "flash forward kernel")
    build.count(kernel_name("flash_fwd", d))
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, delta, causal=True):
    """Launch the dQ kernel."""
    do = _check_backward(q, k, v, do, lse, delta, causal)
    b, h, kvh, s_q, s_k, d = _dims(q, k)
    lib = build.load()
    dq = torch.empty_like(q)
    code = lib.tk_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, kvh, s_q, s_k, d, int(causal),
        1.0 / d**0.5, build.stream_ptr(q.device),
    )
    build.check(lib, code, "flash dQ kernel")
    build.count(kernel_name("flash_dq", d))
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal=True):
    """Launch the dK/dV kernel."""
    do = _check_backward(q, k, v, do, lse, delta, causal)
    b, h, kvh, s_q, s_k, d = _dims(q, k)
    lib = build.load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = lib.tk_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, s_q, s_k, d,
        int(causal), 1.0 / d**0.5, build.stream_ptr(q.device),
    )
    build.check(lib, code, "flash dK/dV kernel")
    build.count(kernel_name("flash_dkv", d))
    return dk, dv


# ------------------------------------------------------------ autograd
def _on_cuda(t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention: unsupported device {t.device}")


def _forward(q, k, v, causal, block_q, block_k):
    """(o, lse), or under a remat tape that saves "flash", the replay's
    copy of them."""
    def compute():
        if _on_cuda(q):
            return flash_forward_cuda(q, k, v, causal)
        return flash_forward_plain(q, k, v, causal, block_q, block_k)
    return remat.saved("flash", compute)


def _backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    causal, block_q, block_k = ctx.flash_args
    if do is None:  # only lse was used downstream
        do = torch.zeros_like(o)
    delta = flash_delta(do, o, dlse)
    if _on_cuda(q):
        dq = flash_dq_cuda(q, k, v, do, lse, delta, causal)
        dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal)
    else:
        dq = flash_dq_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
        dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, causal, block_q, block_k)
    return dq, dk, dv, None, None, None


class _FlashAttention(torch.autograd.Function):
    """o only (``_flash_attention`` in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = _forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash_args = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class _FlashAttentionLse(torch.autograd.Function):
    """(o, lse), differentiable in both (``_flash_attention_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        ctx.set_materialize_grads(False)
        o, lse = _forward(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash_args = (causal, block_q, block_k)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024):
    """BSHD flash attention, differentiable. q: [b, s_q, h, d]; k/v:
    [b, s_k, h_kv, d] with h % h_kv == 0. Returns [b, s_q, h, d] in q's
    dtype. ``block_q``/``block_k`` size the plain version's blocks (CPU);
    the kernels use their own tiles."""
    _check_args(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


def flash_attention_with_lse(q, k, v, causal: bool = True, block_q: int = 1024,
                             block_k: int = 1024):
    """BSHD flash attention that also returns the per-row logsumexp
    ([b, h, s] fp32), differentiable in both outputs: the building block for
    blockwise/ring composition, whose combine weights carry lse gradients."""
    _check_args(q, k, v, causal)
    return _FlashAttentionLse.apply(q, k, v, causal, block_q, block_k)
