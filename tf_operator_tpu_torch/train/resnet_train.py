"""ResNet data-parallel training: the port's twin of
``examples/jax/resnet/resnet_train.py``.

    python -m tf_operator_tpu_torch.train.resnet_train [--model resnet50]
        [--steps 100] [--batch 256] [--image-size 224] [--lr 0.1]
        [--log-every 10] [--device cuda|cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent. As in the JAX script: the model defaults to resnet50 on the card
and resnet-tiny on the CPU, where the image size is capped at 32 and the
global batch at 2 a process; the weights are drawn from seed 0; the
optimizer is ``optax.sgd(lr, momentum=0.9, nesterov=True)``, which
``torch.optim.SGD`` with the same arguments computes step for step (its
momentum buffer starts as the first gradient, optax's trace as zeros plus
it); each process draws its ``--batch`` over the process count images
and labels from ``np.random.default_rng(process id)`` in the script's
order (:func:`batches`), and the loss is the mean cross-entropy.

Rendezvous goes through ``runtime/gpu_init``. Over several processes the
step is data parallel over the whole world, as the script shards the batch
over every mesh axis: every process draws the same weights, the gradients
are averaged (``train_step.average_gradients``), and the BatchNorm
statistics are the global batch's (``models/resnet.py``), as XLA reduces
them over the global array. Prints the script's ``[resnet] ...``,
``[resnet] step N loss L images/sec X`` and ``[resnet] done`` lines; the
host reads the loss only at a log step (the run's first, every
``--log-every``-th and its last), so the steps between queue ahead of the
card, and ``run()`` returns the losses and the window between the first
and the last read, as ``llama_train.run`` does.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..models import resnet
from ..runtime import gpu_init
from .data import to_device
from .train_step import average_gradients


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="resnet_train")
    parser.add_argument("--model", default=None,
                        help="default: resnet50 on the card, resnet-tiny on the CPU")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=256, help="global batch size")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def batches(process_id: int, local_batch: int, image_size: int,
            num_classes: int) -> Iterator[tuple]:
    """This process's (images [b, h, w, 3] float32, labels [b] int32) of
    each step, drawn as the JAX script draws them."""
    rng = np.random.default_rng(process_id)
    while True:
        images = rng.normal(0, 1, (local_batch, image_size, image_size, 3)).astype(np.float32)
        labels = rng.integers(0, num_classes, (local_batch,)).astype(np.int32)
        yield images, labels


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, group=None):
    """``step(images, labels) -> loss``: forward, backward, and one
    optimizer update of the mean cross-entropy. With ``group`` the
    gradients are averaged over it before the update, and the loss
    returned is the group's mean, the global batch's (one all-reduce of a
    scalar on the device)."""
    params = list(model.parameters())

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        if group is not None:
            average_gradients(params, group)
        optimizer.step()
        loss = loss.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
            loss /= dist.get_world_size(group)
        return loss

    return step


def run(args: argparse.Namespace, data: Optional[Iterator[tuple]] = None,
        seed: int = 0) -> dict:
    """Train ``args.steps`` steps on :func:`batches`, or on ``data``, an
    iterator of this process's host batches (the caller's global batch,
    for a one-process reference of a data-parallel run); returns the losses (one float a step), the
    window of steps between the first and the last host read, and the
    model."""
    device = resolve_device(args.device)
    topo = gpu_init.initialize(device=device)
    group, world = None, 1
    if dist.is_initialized():
        group, world = dist.group.WORLD, dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cudnn.benchmark = True  # fixed shapes: pick each conv's fastest
    else:
        args.image_size = min(args.image_size, 32)
        args.batch = min(args.batch, 2 * world)
    if args.model is None:
        args.model = "resnet50" if device.type == "cuda" else "resnet-tiny"
    if args.batch % world:
        raise SystemExit("--batch must divide by the process count")
    cfg = resnet.CONFIGS[args.model]
    print(f"[resnet] {args.model} process {topo.process_id}/{topo.num_processes} "
          f"devices={world} batch={args.batch}", flush=True)

    model = resnet.ResNet(cfg, device=device, group=group,
                          generator=torch.Generator(device=device).manual_seed(seed))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9, nesterov=True)
    step_fn = make_train_step(model, optimizer, group)
    if data is None:
        data = batches(topo.process_id, args.batch // world, args.image_size, cfg.num_classes)
    losses = torch.empty(args.steps, dtype=torch.float32, device=device)
    window, last = None, args.steps - 1  # (step, host clock) of the first read
    t0 = time.perf_counter()
    for step in range(args.steps):
        images, labels = to_device(*next(data), device)
        loss = step_fn(images, labels)
        losses[step].copy_(loss)
        if step % args.log_every == 0 or step == last:
            value = float(loss)  # the host read: waits for the device
            now = time.perf_counter()
            window = window or (step, now)
            ips = (step + 1) * images.shape[0] * world / max(now - t0, 1e-9)
            print(f"[resnet] step {step} loss {value:.4f} images/sec {ips:,.0f}", flush=True)
    print("[resnet] done", flush=True)
    window_steps, window_seconds = (last - window[0], now - window[1]) if window else (0, 0.0)
    return {"config": cfg, "model": model, "losses": losses.tolist(),
            "window_steps": window_steps, "window_seconds": window_seconds,
            "images_per_step": images.shape[0] * world if args.steps else 0}


def main(argv=None) -> int:
    was_up = dist.is_initialized()
    try:
        run(parse_args(argv))
    finally:
        if not was_up and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
