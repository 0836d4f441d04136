"""Host time of a training step's Python under each remat policy.

    python3 scripts/remat_host_cost.py [--layers 8] [--steps 20]

Runs the port's llama-tiny widths (dim 64, seq 16, batch 1, fp32) on the
CPU, so that the device work is negligible and the time is the host's:
eager dispatch, the checkpoint's replay, and the remat tape
(``ops/remat.py``). Prints, for remat off and each policy, the milliseconds of
one layer's forward and backward, averaged over ``--steps`` steps after 3
warm-up steps, then one JSON object of the same numbers. On a card's
machine it measures that host's speed, the one that feeds the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)

    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.train_step import loss_fn

    torch.set_num_threads(1)
    base = dataclasses.replace(llama.CONFIGS["llama-tiny"], n_layers=args.layers,
                               dtype=torch.float32, param_dtype=torch.float32, remat=True)
    tokens = torch.randint(0, base.vocab_size, (1, 17), generator=torch.Generator().manual_seed(0))
    runs = {"off": dataclasses.replace(base, remat=False)}
    for policy in ("nothing", "dots", "dots+rope"):
        runs[policy] = dataclasses.replace(base, remat_policy=policy)
    result = {}
    for name, cfg in runs.items():
        model = llama.Llama(cfg, device="cpu")
        for _ in range(3):
            loss_fn(model, tokens).backward()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss_fn(model, tokens).backward()
        result[name] = (time.perf_counter() - t0) / args.steps / args.layers * 1e3
        print(f"remat {name:10s} {result[name]:.3f} ms of host time a layer (fwd+bwd)")
    print(json.dumps({"host": platform.processor() or platform.machine(),
                      "ms_per_layer": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
