"""ResNet in PyTorch: the port's twin of ``tf_operator_tpu/models/resnet.py``.

Images come in NHWC, as in the reference; ``images.permute(0, 3, 1, 2)``
is an NCHW view whose memory is channels_last, so every convolution,
BatchNorm and pool runs channels_last without a copy. Compute runs in
``cfg.dtype`` (bf16); parameters and BatchNorm statistics are fp32 (Flax's
``param_dtype`` default) and convolution weights are cast at use. The head
is fp32.

What the reference's Flax layers do, and the port does the same way:

- ``padding="SAME"`` pads ``total = max((ceil(n/s) - 1) * s + k - n, 0)``
  with ``total // 2`` before and the rest after (:func:`same_pads`). At
  stride 2 on an even size that is (0, 1), not torch's symmetric 1: each
  3x3 stride-2 convolution and the stem's max-pool (padded with -inf) pad
  explicitly. The stem's 7x7 convolution keeps its symmetric (3, 3).
- BatchNorm (:class:`BatchNorm`) in training uses the biased batch
  statistics, reduced in fp32 as E[x^2] - E[x]^2 clipped at 0, normalises
  as ``(x - mean) * rsqrt(var + eps) * scale + bias`` in fp32, and updates
  ``ra = 0.9 * ra + 0.1 * batch`` with the biased variance. Evaluation
  (``model.eval()``) uses the running values. Torch's ``batch_norm``
  updates with the unbiased variance and reads its momentum as 1 - Flax's,
  so it is not used.
- The statistics are the global batch's: the reference jits one step
  over the global array, so XLA reduces them over every process's rows.
  Given a process group, :class:`BatchNorm` sums the count and the
  per-channel sum and sum of squares over it, and in the backward the two
  per-channel sums of the input gradient (:class:`_BatchNormTrain`, on
  gloo or NCCL). The parameter gradients stay this rank's, for the data-
  parallel average (``train_step.average_gradients``).
- The last BatchNorm of each block starts with scale 0.
- Init is Flax's: lecun_normal (a normal truncated at 2 standard
  deviations, ``std = 1 / sqrt(fan_in) / 0.8796``) for the convolution and
  dense kernels, zero biases, BatchNorm scale 1 and bias 0, running mean 0
  and variance 1.

Parameter names follow the reference's tree: ``conv_init``, ``bn_init``,
``blocks.{k}`` for ``BottleneckBlock_{k}``/``BasicBlock_{k}`` (``conv{i}``
and ``norm{i}`` for ``Conv_{i}``/``BatchNorm_{i}``, ``conv_proj``,
``norm_proj``) and ``head`` for ``Dense_0``, so ``models/convert.py``
carries the reference's variables over leaf by leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    num_filters: int = 64
    bottleneck: bool = True
    dtype: torch.dtype = torch.bfloat16
    # The reference's cross-replica axis name. The port's BatchNorm takes a
    # process group at construction (``ResNet(..., group=...)``) instead.
    sync_bn_axis: Any = None

    def forward_flops(self, image_size: int) -> float:
        """FLOPs of one image's forward pass through the convolutions and
        the head, 2 a multiply-add (BatchNorm, ReLU and pools not counted)."""
        flops, size = 0.0, math.ceil(image_size / 2)
        flops += 2 * size * size * 7 * 7 * 3 * self.num_filters
        size = math.ceil(size / 2)  # the max-pool
        cin = self.num_filters
        for i, blocks in enumerate(self.stage_sizes):
            filters = self.num_filters * 2**i
            out = filters * 4 if self.bottleneck else filters
            for j in range(blocks):
                stride = 2 if i > 0 and j == 0 else 1
                new = math.ceil(size / stride)
                if self.bottleneck:
                    convs = [(size, 1, cin, filters), (new, 3, filters, filters),
                             (new, 1, filters, out)]
                else:
                    convs = [(new, 3, cin, filters), (new, 3, filters, filters)]
                if stride != 1 or cin != out:
                    convs.append((new, 1, cin, out))
                flops += sum(2 * n * n * k * k * a * b for n, k, a, b in convs)
                cin, size = out, new
        return flops + 2 * cin * self.num_classes


CONFIGS = {
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False),
    "resnet50": ResNetConfig(),
    "resnet101": ResNetConfig(stage_sizes=(3, 4, 23, 3)),
    # CI/dev-sized: two tiny stages, 8 classes.
    "resnet-tiny": ResNetConfig(
        stage_sizes=(1, 1), num_classes=8, num_filters=8, bottleneck=False
    ),
}


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax's ``padding="SAME"`` on one dim."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``."""
    (top, bottom), (left, right) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Flax's ``lecun_normal``: truncated at 2 standard deviations, its
    std scaled so that the truncated normal has variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv(nn.Module):
    """Flax ``nn.Conv`` on NCHW tensors: an OIHW fp32 weight (channels_last)
    cast to ``dtype`` at use, "SAME" padding unless ``padding`` is given
    (symmetric, per dim), and an optional fp32 bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, *,
                 dtype: torch.dtype, padding: Optional[int] = None, bias: bool = False,
                 device=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        weight = torch.empty(cout, cin, kernel, kernel, device=device)
        self.weight = nn.Parameter(weight.to(memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        cout, cin, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.padding
        if pad is None:
            (top, bottom), (left, right) = (same_pads(n, self.kernel, self.stride)
                                            for n in x.shape[2:])
            if (top, left) == (bottom, right):
                pad = (top, left)
            else:
                x, pad = F.pad(x, (left, right, top, bottom)), 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias, self.stride, pad)


_DIMS = (0, 2, 3)  # the reduced dims of an NCHW tensor: all but the channel


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank of ``group``
    (this rank's alone when None): returns the output in the input's dtype
    and the fp32 batch mean and biased variance (no gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        sums = torch.cat([xf.sum(_DIMS), xf.square().sum(_DIMS),
                          xf.new_full((1,), x.numel() // x.shape[1])])
        if group is not None:
            dist.all_reduce(sums, group=group)
        c = x.shape[1]
        count = sums[-1]
        mean = sums[:c] / count
        var = (sums[c:2 * c] / count - mean.square()).clamp(min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = ((xf - _channel(mean)) * _channel(rstd * weight) + _channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, rstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd, count = ctx.saved_tensors
        g = dy.float()
        xhat = (x.float() - _channel(mean)) * _channel(rstd)
        local = torch.stack([g.sum(_DIMS), (g * xhat).sum(_DIMS)])
        sums = local
        if ctx.group is not None:
            sums = local.clone()
            dist.all_reduce(sums, group=ctx.group)
        mean_g, mean_gx = sums / count
        dx = (g - _channel(mean_g) - xhat * _channel(mean_gx)) * _channel(rstd * weight)
        return dx.to(x.dtype), local[1], local[0], None, None


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, param_dtype=float32)``
    on NCHW tensors (module doc): fp32 ``weight`` (Flax's ``scale``) and
    ``bias``, fp32 ``running_mean``/``running_var`` buffers; the output in
    the input's dtype. Training mode normalises by the batch statistics of
    every rank of ``group`` and updates the running values; eval mode
    uses them."""

    def __init__(self, features: int, *, zero_scale: bool = False, group=None,
                 momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.zero_scale, self.group, self.momentum, self.eps = zero_scale, group, momentum, eps
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.empty(features, device=device))
        self.register_buffer("running_var", torch.empty(features, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            rstd = torch.rsqrt(self.running_var + self.eps)
            y = (x.float() - _channel(self.running_mean)) * _channel(rstd * self.weight)
            return (y + _channel(self.bias)).to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps, self.group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean * (1 - m))
            self.running_var.mul_(m).add_(var * (1 - m))
        return y


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, cfg: ResNetConfig, group=None,
                 device=None):
        super().__init__()
        out = filters * 4
        conv = dict(dtype=cfg.dtype, device=device)
        norm = dict(group=group, device=device)
        self.conv0, self.norm0 = Conv(cin, filters, 1, **conv), BatchNorm(filters, **norm)
        self.conv1 = Conv(filters, filters, 3, stride, **conv)
        self.norm1 = BatchNorm(filters, **norm)
        self.conv2 = Conv(filters, out, 1, **conv)
        self.norm2 = BatchNorm(out, zero_scale=True, **norm)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != out:
            self.conv_proj = Conv(cin, out, 1, stride, **conv)
            self.norm_proj = BatchNorm(out, **norm)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, cfg: ResNetConfig, group=None,
                 device=None):
        super().__init__()
        conv = dict(dtype=cfg.dtype, device=device)
        norm = dict(group=group, device=device)
        self.conv0 = Conv(cin, filters, 3, stride, **conv)
        self.norm0 = BatchNorm(filters, **norm)
        self.conv1 = Conv(filters, filters, 3, **conv)
        self.norm1 = BatchNorm(filters, zero_scale=True, **norm)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj = Conv(cin, filters, 1, stride, **conv)
            self.norm_proj = BatchNorm(filters, **norm)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(images)``: NHWC images -> fp32 logits [b, num_classes].
    Weights are drawn from ``generator`` on ``device`` (``cuda`` unless the
    caller asks for the CPU); ``group`` is the process group whose ranks'
    batches make the BatchNorm statistics (the data-parallel group)."""

    def __init__(self, config: ResNetConfig, device=None,
                 generator: Optional[torch.Generator] = None, group=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.conv_init = Conv(3, cfg.num_filters, 7, 2, padding=3, dtype=cfg.dtype,
                              device=device)
        self.bn_init = BatchNorm(cfg.num_filters, group=group, device=device)
        block = BottleneckBlock if cfg.bottleneck else BasicBlock
        blocks, cin = [], cfg.num_filters
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, cfg.num_filters * 2**i, stride, cfg, group, device))
                cin = cfg.num_filters * 2**i * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, cfg.num_classes, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.config.dtype)  # channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())
