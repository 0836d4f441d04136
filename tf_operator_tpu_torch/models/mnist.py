"""MNIST ConvNet in PyTorch: the port's twin of ``tf_operator_tpu/models/mnist.py``.

conv 5x5x32 -> ReLU -> 2x2 max-pool -> conv 5x5x64 -> ReLU -> 2x2 max-pool
-> dense 128 -> ReLU -> dense 10, the reference's topology. Images come in
NHWC (or [b, 28, 28]) fp32; compute runs in ``cfg.dtype`` (bf16) on fp32
parameters cast at use; the logits are fp32. The convolutions are "SAME"
at stride 1 (symmetric padding 2), the pools VALID. The flatten before the
first dense layer is in NHWC order, as the reference reshapes
``[b, 7, 7, 64]``: under channels_last that permute is a free view, and the
dense kernel carries over by a transpose alone (``models/convert.py``).

:class:`SyntheticMnist` is a copy of the reference's numpy generator: the
same seed gives the same bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .resnet import Conv, lecun_normal_


@dataclass(frozen=True)
class MnistConfig:
    num_classes: int = 10
    hidden: int = 128
    dtype: torch.dtype = torch.bfloat16


class Dense(nn.Linear):
    """Flax ``nn.Dense``: fp32 weight and bias cast to ``dtype`` at use."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__(d_in, d_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class MnistCNN(nn.Module):
    """``forward(images)``: [b, 28, 28, 1] or [b, 28, 28] -> fp32 logits
    [b, num_classes]. Weights are drawn from ``generator`` on ``device``
    (``cuda`` unless the caller asks for the CPU) as Flax draws them:
    lecun_normal kernels, zero biases."""

    def __init__(self, config: Optional[MnistConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config or MnistConfig()
        self.conv0 = Conv(1, 32, 5, dtype=cfg.dtype, bias=True, device=device)
        self.conv1 = Conv(32, 64, 5, dtype=cfg.dtype, bias=True, device=device)
        self.dense0 = Dense(7 * 7 * 64, cfg.hidden, cfg.dtype, device)
        self.dense1 = Dense(cfg.hidden, cfg.num_classes, torch.float32, device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        self.conv0.reset_parameters(generator)
        self.conv1.reset_parameters(generator)
        for dense in (self.dense0, self.dense1):
            lecun_normal_(dense.weight, dense.in_features, generator)
            dense.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images if images.dim() == 4 else images[..., None]
        x = x.permute(0, 3, 1, 2).to(self.config.dtype)  # NHWC -> channels_last
        x = F.max_pool2d(F.relu(self.conv0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the reference's NHWC order
        x = F.relu(self.dense0(x))
        return self.dense1(x).float()


def make_model(config: Optional[MnistConfig] = None, device=None, generator=None) -> MnistCNN:
    return MnistCNN(config, device=device, generator=generator)


def loss_and_accuracy(model: MnistCNN, images: torch.Tensor, labels: torch.Tensor):
    """(mean cross-entropy, accuracy) of ``model`` on one batch, as the
    reference's ``loss_and_accuracy`` (the accuracy carries no gradient)."""
    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, accuracy


class SyntheticMnist:
    """Deterministic synthetic digits: class-dependent blobs, learnable in a
    few steps. A copy of the reference's generator (same draws, same
    bytes): [b, 28, 28, 1] float32 images and int32 labels."""

    def __init__(self, batch: int, seed: int = 0):
        self.batch = batch
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        labels = self._rng.integers(0, 10, size=(self.batch,))
        images = self._rng.normal(0.1, 0.25, size=(self.batch, 28, 28, 1))
        # Signal: a bright row per class.
        for i, lab in enumerate(labels):
            images[i, 2 + 2 * lab : 4 + 2 * lab, :, 0] += 1.5
        return images.astype(np.float32), labels.astype(np.int32)
