"""Where the time of one llama-400m training step goes on the GPU (PyTorch port).

    python3 scripts/profile_torch_step.py [--model llama-400m] [--batch 8]
        [--seq 2048] [--steps 2] [--remat-policy dots]
    python3 scripts/profile_torch_step.py --model bert-base --batch 16 --seq 512
    python3 scripts/profile_torch_step.py --model resnet50 --batch 256

Builds the port's train step through the llama_train entry point's setup
(a BERT model: the JAX bench's BERT step, ``bert_setup``; a ResNet:
``resnet_train``'s step on one 224x224 batch resident on the card,
``resnet_setup``), runs one
warm-up step, then traces ``--steps`` steps with torch.profiler
(CPU and CUDA activities). Prints the step wall time (host clock around
steps that end in a device synchronise), the device time of every kernel
summed by group (the port's four hand-written kernels, convolutions, matrix products,
the optimizer's multi-tensor kernels, torch's elementwise and reduction
kernels, everything else), the device's busy and idle share of the traced
wall time, the peak device memory of the traced steps, and the 25 kernels
with the most device time. The last line is one JSON object of the same
numbers. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT_KERNELS = ("rope_kernel", "flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def group_of(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "elementwise" in low or "reduce" in low:
        return "elementwise+reduce"
    return "other"


def bert_setup(args):
    """(state, step, batches) of the JAX bench's BERT step (``bench.py``
    ``bench_bert``): ``make_train_step`` with ``train_step.loss_fn`` (no
    mask: the flash kernels; the chunked loss over the tied head),
    ``make_optimizer(warmup_steps=10, decay_steps=1000)``, and seeded
    synthetic token batches ``[batch, seq + 1]`` on the card."""
    import numpy as np

    from tf_operator_tpu_torch.models import bert
    from tf_operator_tpu_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = dataclasses.replace(bert.CONFIGS[args.model], remat_policy=args.remat_policy)
    model = bert.Bert(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    optimizer = make_optimizer(warmup_steps=10, decay_steps=1000)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.seq + 1),
                                                dtype=np.int32)).cuda()

    return init_train_state(model, optimizer), make_train_step(optimizer), batches()


def resnet_setup(args):
    """(model, step, batches) of ``resnet_train``'s step (SGD with Nesterov
    momentum 0.9 at lr 0.1) on one seeded batch of ``--batch`` 224x224
    images drawn as the entry point draws them, kept on the card."""
    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.train import data, resnet_train

    torch.backends.cudnn.benchmark = True
    cfg = resnet.CONFIGS[args.model]
    model = resnet.ResNet(cfg, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    step = resnet_train.make_train_step(model, optimizer)
    batch = data.to_device(*next(resnet_train.batches(0, args.batch, 224, cfg.num_classes)),
                           torch.device("cuda"))

    def batches():
        while True:
            yield batch

    return model, lambda model, b: (model, step(*b)), batches()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="llama-400m")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--remat-policy", default="dots")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from tf_operator_tpu_torch.train import llama_train

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    if args.model.startswith("bert"):
        state, step_fn, data = bert_setup(args)
    elif args.model.startswith("resnet"):
        state, step_fn, data = resnet_setup(args)
    else:
        targs = llama_train.parse_args(["--model", args.model, "--batch", str(args.batch),
                                        "--seq", str(args.seq), "--steps", str(args.steps),
                                        "--remat-policy", args.remat_policy])
        run = llama_train.setup(targs)
        state, step_fn, data = run.state, run.step_fn, run.batches
    state, loss = step_fn(state, next(data))  # warm-up: kernel build, allocator
    float(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = step_fn(state, next(data))
            float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(group_of(e.key), {"ms": 0.0, "launches": 0})
        g["ms"] += e.self_device_time_total / 1e3 / args.steps
        g["launches"] += e.count // args.steps
    busy = sum(g["ms"] for g in groups.values())
    step_ms = wall_ms / args.steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"remat_policy {args.remat_policy}: step {step_ms:.2f} ms (wall, profiler on); "
          f"device busy {busy:.2f} ms ({busy / step_ms:.4f} of the step), idle "
          f"{1 - busy / step_ms:.4f}; peak device memory {peak_gib:.2f} GiB")
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {name:18s} {g['ms']:9.3f} ms/step {g['ms'] / busy:.4f} of busy, "
              f"{g['launches']} launches/step")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    print(json.dumps({"card": smi, "model": args.model, "batch": args.batch,
                      "seq": args.seq, "remat_policy": args.remat_policy,
                      "step_ms": step_ms, "device_busy_ms": busy,
                      "peak_memory_gib": peak_gib, "groups": groups}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
