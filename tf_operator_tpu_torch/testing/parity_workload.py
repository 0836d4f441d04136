"""Throughput-parity workload: the port's twin of the JAX package's
``testing/parity_workload.py``, under the same arguments and with the same
one JSON line a process::

    {"process_id": N, "num_processes": N, "devices": N,
     "tokens_per_sec_chip": X, "step_ms": X, "loss": X}

    python -m tf_operator_tpu_torch.testing.parity_workload [--steps 20]
        [--warmup 3] [--global-batch 8] [--seq 64] [--model llama-tiny]
        [--device cuda|cpu]

The llama train step of the port's entry point, built by its ``setup``:
``gpu_init`` rendezvous from the operator's env (the JAXJob ``JAX_*`` or a
PyTorchJob's c10d env) and the declared mesh, the train state born sharded
over it, and the input through ``DevicePrefetch``. ``--warmup`` steps run
first; then ``--steps`` steps are timed between two host reads of the
loss, so nothing waits for the device in between. A test compares a
2-process world with one process of the same global batch: the operator's
env must cost nothing but the transport.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch.distributed as dist


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="parity_workload")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--model", default="llama-tiny")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..parallel.mesh import mesh_axes
    from ..train import llama_train

    train_args = ["--model", args.model, "--batch", str(args.global_batch),
                  "--seq", str(args.seq), "--steps", str(args.warmup + args.steps),
                  "--warmup", "1"]
    if args.device:
        train_args += ["--device", args.device]
    try:
        s = llama_train.setup(llama_train.parse_args(train_args))
        n = dist.get_world_size() if dist.is_initialized() else 1
        topo = s.topology
        mesh = mesh_axes(s.mesh) if s.mesh is not None else {}
        print(f"[parity] process {topo.process_id}/{topo.num_processes} devices={n} "
              f"mesh={mesh}", file=sys.stderr, flush=True)
        state = s.state
        for _ in range(max(args.warmup, 1)):
            state, loss = s.step_fn(state, next(s.batches))
        float(loss)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = s.step_fn(state, next(s.batches))
        final_loss = float(loss)  # the host read is the barrier
        dt = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    tokens_per_sec = args.global_batch * args.seq * args.steps / dt
    print(json.dumps({
        "process_id": topo.process_id,
        "num_processes": topo.num_processes,
        "devices": n,
        "tokens_per_sec_chip": round(tokens_per_sec / n, 1),
        "step_ms": round(dt / args.steps * 1000.0, 3),
        "loss": round(final_loss, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
