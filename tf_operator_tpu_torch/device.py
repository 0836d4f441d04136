"""Device resolution and the card's peak rates for MFU and roofline accounting.

Counterpart of the device handling in ``bench.py`` (``peak_tflops_for``):
the peak comes from the card's name, because the SXM, PCIe and NVL parts of
the H100 differ. An unknown card warns and is scored against an assumed
part, whose name the caller stamps beside the number (``assumed_chip``).
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch


class Peak(NamedTuple):
    """Dense bf16 tensor-core TFLOP/s, device-memory TB/s and dense TF32
    tensor-core TFLOP/s of one card. fp32 work is scored against the TF32
    rate (:func:`tflops_for`)."""

    bf16_tflops: float
    hbm_tbps: float
    tf32_tflops: float


# Keyed by a lower-case fragment of torch.cuda.get_device_name(); the first
# match wins, so the specific parts come before the generic "h100".
# (NVIDIA data sheets, dense rates without sparsity.)
PEAKS = {
    "h100 pcie": Peak(756.0, 2.0, 378.0),
    "h100 nvl": Peak(835.0, 3.9, 417.5),
    "h200": Peak(989.0, 4.8, 494.7),
    "h100": Peak(989.0, 3.35, 494.7),  # SXM5: "NVIDIA H100 80GB HBM3"
}
# fp32 products that keep fp32 accuracy on the tensor cores take three TF32
# products each (3xTF32: the high parts' product and the two cross terms),
# so their least time is the FLOPs over a third of the TF32 peak.
TF32_PASSES = 3
ASSUMED = "h100"


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA where there is none raises; nothing falls back
    to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tflops_for(peak: Peak, dtype: torch.dtype) -> float:
    """The TFLOP/s that ``dtype``'s products are scored against: the bf16
    peak for bf16, a third of the TF32 peak (TF32_PASSES) for fp32."""
    if dtype == torch.bfloat16:
        return peak.bf16_tflops
    if dtype == torch.float32:
        return peak.tf32_tflops / TF32_PASSES
    raise ValueError(f"no peak for {dtype}")


def peak_for(name: str) -> tuple[Peak, Optional[str]]:
    """(peak, assumed-part name or None) for a card name as
    ``torch.cuda.get_device_name`` reports it."""
    low = name.lower()
    for key, peak in PEAKS.items():
        if key in low:
            return peak, None
    print(
        f"device: WARNING unknown card {name!r}; MFU and bounds are scored "
        f"against the assumed {ASSUMED!r} peak {PEAKS[ASSUMED]}",
        file=sys.stderr,
    )
    return PEAKS[ASSUMED], ASSUMED
