"""Llama pretraining on one GPU: the port's twin of
``examples/jax/llama/llama_train.py``.

    python -m tf_operator_tpu_torch.train.llama_train [--model llama-400m]
        [--steps 100] [--batch 32] [--seq 2048] [--lr 3e-4] [--log-every 10]
        [--device cuda|cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent. The default model is llama-400m on CUDA and llama-tiny on the CPU.
Prints the JAX script's ``[llama] step N loss X tokens/sec Y (Z/chip)``
lines. Checkpointing, token-file data and multi-process runs are not ported
yet (ROADMAP Queue 1): their flags are not accepted, and a ``WORLD_SIZE``
above 1 is refused.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..device import resolve_device
from ..models import llama
from .data import SyntheticTokens
from .train_step import init_train_state, make_optimizer, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="llama_train")
    parser.add_argument("--model", default=None,
                        help="default: llama-400m on CUDA, llama-tiny on the CPU")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=32, help="global batch size")
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def setup(args: argparse.Namespace, seed: int = 0):
    """What a run needs: (config, state, step_fn, data). The model is drawn
    from a generator seeded with ``seed`` on the run's device."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("multi-process training is not ported yet (WORLD_SIZE > 1)")
    device = resolve_device(args.device)
    if args.model is None:
        args.model = "llama-400m" if device.type == "cuda" else "llama-tiny"
    config = llama.CONFIGS[args.model]
    if device.type == "cpu":
        args.seq = min(args.seq, config.max_seq_len)
    if args.seq != config.max_seq_len:
        # Rope tables are built at max_seq_len; size them to the run (as
        # bench.py does), which keeps the rope kernel on the table it takes.
        config = type(config)(**{**config.__dict__, "max_seq_len": args.seq})
    generator = torch.Generator(device=device).manual_seed(seed)
    model = llama.Llama(config, device=device, generator=generator)
    optimizer = make_optimizer(learning_rate=args.lr, decay_steps=max(args.steps, 101))
    state = init_train_state(model, optimizer)
    data = SyntheticTokens(args.batch, args.seq, config.vocab_size, seed=seed)
    return config, state, make_train_step(optimizer), data


def run(args: argparse.Namespace) -> dict:
    """Train ``args.steps`` steps; returns the losses and the wall time of
    each step (each step ends in a device synchronise)."""
    config, state, step_fn, data = setup(args)
    device = next(state.model.parameters()).device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[llama] process 0/1 devices=1 device={device} ({name}) model={args.model} "
          f"params={config.param_count():,}", flush=True)
    losses, seconds = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        t_step = time.perf_counter()
        state, loss = step_fn(state, next(data))
        losses.append(float(loss))  # waits for the device
        seconds.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tps = (step + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"[llama] step {step} loss {losses[-1]:.4f} "
                  f"tokens/sec {tps:,.0f} ({tps:,.0f}/chip)", flush=True)
    print("[llama] done", flush=True)
    return {"config": config, "losses": losses, "step_seconds": seconds,
            "tokens_per_step": args.batch * args.seq, "device": name}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
