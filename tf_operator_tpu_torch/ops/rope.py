"""Rotary position embedding (RoPE): the Hopper kernel and its plain version.

Counterpart of ``tf_operator_tpu/ops/rope_pallas.py``. ``rope(x, cos, sin)``
rotates the pairs (x[..., :d/2], x[..., d/2:]) of x ``[b, s, h, d]`` by the
angles of the ``[s, d/2]`` fp32 tables, in fp32, and casts back to x's dtype.
RoPE is a rotation R(θ) per pair, so its gradient is the rotation by -θ:
the backward is the same kernel with ``inverse=True``, which negates sin
inside the kernel (``_rope_bwd`` in the JAX package passes ``-sin``); the
tables get no gradient.

A CUDA tensor goes through ``ops/csrc/rope.cu`` (bf16 or fp32 x, a
head_dim that is a multiple of 8; launches count as "rope" and
"rope_f32"); a CPU tensor through
:func:`rope_plain`. A forward given a ``tag`` is served from the block's
remat tape (``ops/remat.py``) in the replay when the policy saves that tag
("dots+rope" saves ``rope_q`` and ``rope_k``). :func:`rope_work` counts the
least bytes of a call, for its roofline bound.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build, remat
from .roofline import Work


def rope_work(b: int, s: int, h: int, d: int, itemsize: int = 2) -> Work:
    """Bytes of one rope call on x ``[b, s, h, d]`` of ``itemsize``-byte
    elements (2 for bf16, 4 for fp32): x read and the result written once,
    and both fp32 ``[s, d/2]`` tables read once. Its 6 flops a pair are not
    tensor-core work."""
    return Work(2 * itemsize * b * s * h * d + 2 * 4 * s * (d // 2), 0)


def kernel_name(dtype: torch.dtype) -> str:
    """The launch counter of the rope kernel on ``dtype`` x: "rope" for
    bf16, "rope_f32" for fp32; any other dtype raises ``TypeError``."""
    return "rope" + build.suffix(dtype, "rope kernels")


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               inverse: bool = False) -> torch.Tensor:
    """The same function in plain PyTorch (x [b, s, h, d]; cos/sin [s, d/2]);
    ``inverse`` rotates by -θ."""
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    if inverse:
        s = -s
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """Launch the rope kernel (bf16 or fp32 x, head_dim a multiple of 8) on
    x's device and the current stream; ``inverse`` rotates by -θ."""
    b, s, h, d = x.shape
    if not x.is_cuda:
        raise ValueError(f"rope kernel takes a CUDA tensor, not one on {x.device}")
    counter = kernel_name(x.dtype)
    if d % 8:
        raise ValueError(f"rope kernel takes head_dim a multiple of 8, got {d}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
        if tuple(t.shape) != (s, d // 2) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{s}, {d // 2}] table")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("rope kernel takes a contiguous, 16-byte aligned x")
    lib = build.load()
    out = torch.empty_like(x)
    code = build.entry(lib, "rope", x.dtype)(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        b, s, h, d, int(inverse), build.stream_ptr(x.device),
    )
    build.check(lib, code, "rope kernel")
    build.count(counter)
    return out


def _rope_raw(x, cos, sin, inverse=False):
    if x.is_cuda:
        return rope_cuda(x, cos, sin, inverse)
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin, inverse)
    raise ValueError(f"rope: unsupported device {x.device}")


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin, tag):
        ctx.save_for_backward(cos, sin)
        return remat.saved(tag, lambda: _rope_raw(x, cos, sin))

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        # R(-θ): the rotation's transpose.
        return _rope_raw(g.contiguous(), cos, sin, inverse=True), None, None, None


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         tag: Optional[str] = None) -> torch.Tensor:
    """Differentiable RoPE. x: [b, s, h, d]; cos/sin: [s, d/2] fp32; ``tag``
    names the output to a remat policy (``rope_q``, ``rope_k``)."""
    return _Rope.apply(x, cos, sin, tag)
