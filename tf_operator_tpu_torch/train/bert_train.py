"""BERT MLM pretraining: the port's twin of ``examples/jax/bert/bert_train.py``.

    python -m tf_operator_tpu_torch.train.bert_train [--model bert-base]
        [--steps 100] [--batch 64] [--seq 512] [--mask-prob 0.15] [--lr 1e-4]
        [--log-every 10] [--device cuda|cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent. As in the JAX script: the model defaults to bert-base on the card
and bert-tiny on the CPU, where the batch is capped at 2 a process;
``--seq`` is capped at the model's ``max_len``; the weights are drawn from
seed 0; the optimizer is ``optax.adamw(lr, weight_decay=0.01)``
(``train_step.adamw``); each step draws a synthetic MLM batch of
``--batch`` over the process count rows from
``np.random.default_rng(process id)`` (:func:`mlm_batch`) and trains on
the full-logits masked mean (:func:`mlm_loss`) of the global batch.
Prints the JAX script's ``[bert] ... devices=N seq=S``,
``[bert] step N loss X tokens/sec Y`` and ``[bert] done`` lines; the loss is
read on the host only at a log step (the run's first, every
``--log-every``-th and its last).

The script passes an all-ones attention mask, as the JAX script does, so
its attention takes the reference path with the mask's additive bias, not
the flash kernels; the chunked loss of ``train_step.loss_fn`` with no mask
(``chip_smoke.py`` phase l) is the path that runs them.

Rendezvous goes through ``runtime/gpu_init``. Over several processes the
step is the JAX script's data-parallel one: parameters replicated (every
process draws them from the same seed), the batch sharded over every
process whatever axes the mesh declares, as the JAX script shards it over
all of its mesh's axes (``parallel/sharding.data_parallel_group``: over
``{"fsdp": 2, "tp": 2}`` too, four data replicas), gradients averaged over
them, and one loss over the global batch: each process's masked sum over the global count of masked
positions, times the process count, so that the average is the global
mean whatever each process's count.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import bert
from ..ops.cross_entropy import cross_entropy_loss, masked_nll
from ..parallel.sharding import data_parallel_group
from ..runtime import gpu_init
from .train_step import adamw, init_train_state, make_train_step

MASK_ID = 4  # the JAX script's [MASK]-style id of the synthetic stream


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="bert_train")
    parser.add_argument("--model", default=None,
                        help="default: bert-base on the card, bert-tiny on the CPU")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=64, help="global batch size")
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--mask-prob", type=float, default=0.15)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def mlm_batch(rng: np.random.Generator, vocab_size: int, batch: int, seq: int,
              mask_prob: float):
    """(input_ids, labels, attention_mask) of one synthetic MLM batch, drawn
    from ``rng`` as the JAX script draws them: ids in [5, vocab), each
    position masked with ``mask_prob`` (its id replaced by MASK_ID, its
    label the id; -1 elsewhere), and an all-ones mask."""
    tokens = rng.integers(5, vocab_size, (batch, seq)).astype(np.int32)
    mask_pos = rng.random((batch, seq)) < mask_prob
    labels = np.where(mask_pos, tokens, -1).astype(np.int32)
    input_ids = np.where(mask_pos, MASK_ID, tokens).astype(np.int32)
    return input_ids, labels, np.ones((batch, seq), dtype=bool)


def mlm_loss(model: bert.Bert, batch, group=None) -> torch.Tensor:
    """The JAX script's loss: the mean negative log-likelihood of the
    labels over the masked positions, from the full fp32 logits. With the
    data-parallel ``group``, this process's share of the global batch's
    mean times the group's size: its sum over the masked positions of every
    process (at least 1, as the JAX script's ``maximum``)."""
    input_ids, labels, mask = batch
    logits = model(input_ids, attention_mask=mask)
    if group is None:
        return cross_entropy_loss(logits, labels)
    nll, count = masked_nll(logits, labels)
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return nll * dist.get_world_size(group) / count.clamp(min=1.0)


def run(args: argparse.Namespace, seed: int = 0) -> dict:
    """Train ``args.steps`` steps; returns the losses (one float a step)."""
    device = resolve_device(args.device)
    topo = gpu_init.initialize(device=device)
    if args.model is None:
        args.model = "bert-base" if device.type == "cuda" else "bert-tiny"
    config = bert.CONFIGS[args.model]
    group, world = None, 1
    if dist.is_initialized():
        group, world = data_parallel_group(config, gpu_init.global_mesh(topo, device))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        args.batch = min(args.batch, 2 * world)
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} must divide by the process count {world}")
    args.seq = min(args.seq, config.max_len)
    print(f"[bert] {args.model} process {topo.process_id}/{topo.num_processes} "
          f"devices={world} seq={args.seq} device={device}", flush=True)

    model = bert.Bert(config, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))
    optimizer = adamw(args.lr, weight_decay=0.01)
    state = init_train_state(model, optimizer)
    loss = mlm_loss if group is None else functools.partial(mlm_loss, group=group)
    step_fn = make_train_step(optimizer, loss=loss, replica_group=group)
    rng = np.random.default_rng(topo.process_id)
    losses = torch.empty(args.steps, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = mlm_batch(rng, config.vocab_size, args.batch // world, args.seq,
                          args.mask_prob)
        state, loss = step_fn(state, batch)
        losses[step].copy_(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            value = float(loss)  # the host read: waits for the device
            tps = (step + 1) * args.batch * args.seq / max(time.perf_counter() - t0, 1e-9)
            print(f"[bert] step {step} loss {value:.4f} tokens/sec {tps:,.0f}", flush=True)
    print("[bert] done", flush=True)
    return {"config": config, "losses": losses.tolist()}


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
