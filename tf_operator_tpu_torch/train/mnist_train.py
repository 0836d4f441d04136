"""Distributed MNIST: the port's twin of ``examples/jax/mnist/mnist_train.py``.

    python -m tf_operator_tpu_torch.train.mnist_train [--steps 200]
        [--batch 64] [--lr 0.05] [--target-accuracy 0.0] [--device cuda|cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent. As in the JAX script: ``MnistCNN`` from seed 0's weights, the
optimizer ``optax.sgd(lr, momentum=0.9)`` (``torch.optim.SGD`` computes
it step for step), and each process's ``--batch`` over the process count
rows from ``SyntheticMnist(local batch, seed=process id * 7919)``. Over
several processes the step is data parallel over the whole world, as in
``resnet_train``: gradients averaged (``train_step.average_gradients``),
the loss and the accuracy the global batch's. Prints the script's ``[mnist] process ...``,
``[mnist] step N loss L acc A`` (every 50th step and the last; the host
reads nothing between) and ``[mnist] done final_acc=A`` lines, and exits
1 when the last step's accuracy is below ``--target-accuracy``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import mnist
from ..runtime import gpu_init
from .data import to_device
from .train_step import average_gradients


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="mnist_train")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=64, help="global batch size")
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--target-accuracy", type=float, default=0.0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def run(args: argparse.Namespace, data: Optional[Iterator[tuple]] = None,
        seed: int = 0) -> dict:
    """Train ``args.steps`` steps on ``SyntheticMnist``, or on ``data``, an
    iterator of this process's host batches; returns the losses and
    accuracies (one float each a step) and the model."""
    device = resolve_device(args.device)
    topo = gpu_init.initialize(device=device)
    group, world = None, 1
    if dist.is_initialized():
        group, world = dist.group.WORLD, dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"[mnist] process {topo.process_id}/{topo.num_processes} devices={world} "
          f"device={device}", flush=True)
    if args.batch % world:
        raise SystemExit("--batch must divide by the process count")

    model = mnist.make_model(device=device,
                             generator=torch.Generator(device=device).manual_seed(seed))
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    params = list(model.parameters())
    if data is None:
        data = mnist.SyntheticMnist(args.batch // world, seed=topo.process_id * 7919)
    metrics = torch.empty(args.steps, 2, dtype=torch.float32, device=device)
    for step in range(args.steps):
        images, labels = to_device(*next(data), device)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = mnist.loss_and_accuracy(model, images, labels)
        loss.backward()
        both = torch.stack([loss.detach(), acc])
        if group is not None:
            average_gradients(params, group)
            dist.all_reduce(both, group=group)
            both /= world
        optimizer.step()
        metrics[step].copy_(both)
        if step % 50 == 0 or step == args.steps - 1:
            loss_v, acc_v = both.tolist()  # the host read: waits for the device
            print(f"[mnist] step {step} loss {loss_v:.4f} acc {acc_v:.3f}", flush=True)
    losses, accuracies = metrics.T.tolist()
    final_acc = accuracies[-1] if accuracies else 0.0
    print(f"[mnist] done final_acc={final_acc:.3f}", flush=True)
    return {"model": model, "losses": losses, "accuracies": accuracies,
            "final_accuracy": final_acc}


def main(argv=None) -> int:
    args = parse_args(argv)
    was_up = dist.is_initialized()
    try:
        final_acc = run(args)["final_accuracy"]
    finally:
        if not was_up and dist.is_initialized():
            dist.destroy_process_group()
    if args.target_accuracy and final_acc < args.target_accuracy:
        print(f"[mnist] FAIL: accuracy {final_acc} < {args.target_accuracy}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
