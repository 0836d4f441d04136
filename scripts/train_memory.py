"""Peak device memory of the port's training step at llama2-7b width, by
depth and batch, and what it implies for a card of a sharded llama2-7b run.

    python3 scripts/train_memory.py

Runs the port's entry point (``llama_train.run``) in this process, 2 steps
a run, on llama2-7b cut to 2 and 4 layers at local batches 4 and 8, under
the config's remat policy at the entry point's default seq, and reads ``torch.cuda.max_memory_allocated``
for each. The four peaks fit, exactly, M(L, b) = E + L (S + b A) + b H:
S the bytes a layer holds whatever the batch (weights, AdamW moments,
gradients), A a layer's activations per sequence, H the per-sequence bytes
outside the layers (logits and their gradient), E the rest (embedding and
head state). A fifth run, 6 layers at batch 8, checks the fit. From them,
one card of a run over N cards under FSDP (state sharded N ways, the batch
split N ways, two layers gathered at a time) holds

    (E + 32 S) / N + (B / N) (32 A + H) + [N > 1] 2 G,

G one layer's bf16 weights and gradients, B the entry point's default
global batch. Prints each
run and that reckoning at N = 1, 2, 4 and 8; the last line is one JSON
object of the same numbers. Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tf_operator_tpu_torch.models import llama  # noqa: E402
from tf_operator_tpu_torch.train import llama_train  # noqa: E402


def peak(layers: int, batch: int, seq: int) -> int:
    name = f"llama2-7b-{layers}l"
    llama.CONFIGS[name] = dataclasses.replace(llama.CONFIGS["llama2-7b"], n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    llama_train.run(llama_train.parse_args(
        ["--model", name, "--batch", str(batch), "--seq", str(seq), "--steps", "2",
         "--warmup", "1", "--log-every", "10"]))
    gc.collect()
    return torch.cuda.max_memory_allocated()


def main() -> int:
    args = llama_train.parse_args([])  # the defaults: --batch 32, --seq 2048
    if not torch.cuda.is_available():
        print("train_memory: CUDA is not available", file=sys.stderr)
        return 1

    m = {(layers, b): peak(layers, b, args.seq) for layers, b in ((2, 4), (4, 4), (2, 8), (4, 8))}
    a = (m[4, 8] - m[4, 4] - m[2, 8] + m[2, 4]) / 8
    h = (m[2, 8] - m[2, 4] - 8 * a) / 4
    s = (m[4, 4] - m[2, 4]) / 2 - 4 * a
    e = m[2, 4] - 2 * s - 8 * a - 4 * h
    checked = peak(6, 8, args.seq)
    fitted = e + 6 * (s + 8 * a) + 8 * h
    for (layers, b), v in m.items():
        print(f"{layers} layers, batch {b}: peak {v / 1e9:.3f} GB")
    print(f"fit: S {s / 1e9:.4f} GB a layer, A {a / 1e9:.4f} GB a layer and sequence, "
          f"H {h / 1e9:.4f} GB a sequence, E {e / 1e9:.4f} GB; 6 layers, batch 8: "
          f"peak {checked / 1e9:.3f} GB against the fit's {fitted / 1e9:.3f} GB")

    config = llama.CONFIGS["llama2-7b"]
    layer_params = (config.param_count() - 2 * config.vocab_size * config.dim) / config.n_layers
    g = 2 * 2 * layer_params  # one layer's bf16 weights and gradients
    card = {}
    for n in (1, 2, 4, 8):
        b = args.batch / n
        card[n] = ((e + config.n_layers * s) / n + b * (config.n_layers * a + h)
                   + (2 * g if n > 1 else 0))
        print(f"llama2-7b over {n} card(s), global batch {args.batch}, seq {args.seq}: "
              f"{card[n] / 1e9:.1f} GB a card")
    total = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{smi.stdout.strip()}: {total / 1e9:.1f} GB")
    print(json.dumps({"peaks": {f"{k[0]}l_b{k[1]}": v for k, v in m.items()},
                      "fit": {"S": s, "A": a, "H": h, "E": e},
                      "check": {"measured": checked, "fitted": fitted},
                      "card_bytes": card, "total_memory": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
