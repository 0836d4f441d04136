"""Llama pretraining: the port's twin of ``examples/jax/llama/llama_train.py``.

    python -m tf_operator_tpu_torch.train.llama_train [--model llama-400m]
        [--steps 100] [--batch 32] [--seq 2048] [--lr 3e-4] [--warmup 100]
        [--log-every 10]
        [--data TOKENS --data-dtype int32|uint16] [--remat-policy dots]
        [--checkpoint-dir DIR --checkpoint-every 200] [--device cuda|cpu]

Runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent. The default model is sized to the world (:func:`default_model`):
llama2-7b from 4 cards, llama-400m below that, llama-tiny on the CPU.

One process per card. ``gpu_init`` rendezvouses from the operator-injected
env (the JAXJob ``JAX_*`` contract, or a PyTorchJob's c10d env) and builds
the declared mesh; whenever a process group is up, the train state is born
sharded over it (FSDP2 over the data axes, tensor parallelism over ``tp``)
and each rank reads the batch of its data-parallel coordinate: ``--batch``
is global, and each rank takes ``--batch`` over the data-parallel size.
Over ``sp`` the ranks of one ring read the same rows, each training on its
piece of the sequence through ring attention, which the mesh's ``sp``
picks (:func:`pick_attention`); over ``pp`` each rank builds and holds its
own pipeline stage. The start line names the attention and the pipeline.
Batches come from ``SyntheticTokens`` or, with ``--data``, from a token
file through the native loader, and reach the card through
``DevicePrefetch``. Prints the JAX script's ``[llama] process i/n
devices=N mesh={...}`` and ``[llama] step N loss X tokens/sec Y (Z/chip)``
lines, ends on ``[llama] done {...}`` (a JSON object of the losses, the
window, the kernels' launches, the peak memory and, with a checkpoint
directory, the restore and the last persist with their seconds split and
the recovery telemetry's text), and publishes the step and tokens/s on
the heartbeat at the log cadence. Each step's loss stays on the device:
the host reads it only at a log step (the run's first, every
``--log-every``-th and its last), so the steps between queue ahead of the
card as the JAX script's do, and once at the end for the whole list. ``step_profiler`` runs after every
step: ``TPU_PROFILE_DIR`` traces a window of steps (runtime/profiling.py).

With ``--checkpoint-dir`` (or ``CHECKPOINT_DIR``) the run checkpoints
through ``train/checkpoint.py`` every ``--checkpoint-every`` steps and at
its end, and first restores through the ladder of ``train/restore.py``
(peers from ``TPU_PEER_RESTORE_ADDRS``, then storage), printing ``[llama]
resumed from step N via <path> (<cause>)``; the operator's env turns on a
shard server (``TPU_SHARD_SERVER``), scatter-gather (``TPU_SHARDED_
RESTORE``), warm start (``TPU_WARM_START``) and delta persists
(``TPU_DELTA_PERSIST``). A resumed run skips the token-file windows
already trained on (synthetic batches start again, as in the JAX
script), so a run that is killed and started again with the same
arguments trains as one uninterrupted run would. The durable step, the
shard server's address and the restore outcome ride the heartbeat.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..metrics import METRICS
from ..models import llama
from ..ops import build
from ..parallel.mesh import mesh_axes
from ..parallel.sharding import data_coords
from ..runtime import gpu_init
from ..runtime import heartbeat
from ..runtime.heartbeat import record_progress
from ..runtime.profiling import step_profiler
from ..runtime.shard_server import local_peer_addresses, start_shard_server
from .checkpoint import CheckpointManager, is_sharded
from .data import DevicePrefetch, SyntheticTokens, TokenFileDataset
from .restore import RestoreOutcome, WorldGate, checksum_digest, restore_with_fallback
from .train_step import (
    init_sharded_train_state,
    init_train_state,
    make_optimizer,
    make_train_step,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="llama_train")
    parser.add_argument("--model", default=None,
                        help="default: sized to the world (default_model)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=32, help="global batch size")
    parser.add_argument("--seq", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--warmup", type=int, default=100,
                        help="learning-rate warmup steps (the first update runs at lr 0)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--data", default="",
                        help="token shard file (raw ids); synthetic when empty")
    parser.add_argument("--data-dtype", default="int32", choices=["int32", "uint16"])
    parser.add_argument("--remat-policy", default=None,
                        help="the model's remat policy (default: the config's, 'dots')")
    parser.add_argument("--checkpoint-dir", default=os.environ.get("CHECKPOINT_DIR", ""))
    parser.add_argument("--checkpoint-every", type=int, default=200)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def check_vocab(path: str, dtype: str, vocab_size: int, model: str) -> None:
    """Refuse a token file whose ids fall outside the model's vocabulary.
    Every process scans the same file prefix, before any collective, so the
    verdict is the same on every host."""
    head = np.memmap(path, dtype=dtype, mode="r")
    head = head[: min(len(head), 10_000_000)]
    lo, hi = int(head.min()), int(head.max())
    if hi >= vocab_size or lo < 0:
        raise SystemExit(
            f"--data token ids span [{lo}, {hi}] but {model} has vocab_size="
            f"{vocab_size}; the embedding gather would fail on them: pick a "
            "matching --model/config")


# The least world that trains llama2-7b at the default --batch 32, seq 2048
# and remat policy: the least N at which one card's reckoned peak is at
# most half of an 80 GB card (85.0e9 bytes), the other half left to what
# the reckoning does not see (NCCL buffers, fragmentation). The peak is
# the update's: 14 bytes a parameter (bf16 weight, AdamW moments and
# gradient, and the update's bf16 clipped gradient, step and denominator),
# all sharded N ways by FSDP. The blocks save only their inputs for the
# backward, so activations are small beside it. scripts/train_memory.py
# fits the port's own peaks on an H100 80GB HBM3 (2-6 layers of llama2-7b
# at batch 4 and 8) as 2.789e9 bytes a layer, 0.0110e9 a layer and
# sequence, 0.2604e9 a sequence outside the layers and 2.696e9 besides;
# with two gathered layers (1.62e9) that gives one card 111.5e9 bytes on
# 1 card, 57.4e9 on 2, 29.5e9 on 4 and 15.6e9 on 8.
LLAMA2_7B_MIN_WORLD = 4


def default_model(device_type: str, world: int) -> str:
    """The model a run picks when ``--model`` is not given, as the JAX
    script sizes it to the hardware: llama2-7b on a world of at least
    ``LLAMA2_7B_MIN_WORLD`` cards, llama-400m on fewer, llama-tiny on the
    CPU."""
    if device_type != "cuda":
        return "llama-tiny"
    return "llama2-7b" if world >= LLAMA2_7B_MIN_WORLD else "llama-400m"


def pick_attention(config: llama.LlamaConfig, axes: dict) -> llama.LlamaConfig:
    """The config a mesh runs: over ``sp`` above 1 a model whose attention
    is the default "pallas" runs "ring" (each rank holds a piece of the
    sequence); any other attention over sp is refused when the model is
    sharded (``parallel/sharding.check_shardable``), never gathered."""
    if axes.get("sp", 1) > 1 and config.attention_impl == "pallas":
        return dataclasses.replace(config, attention_impl="ring")
    return config


@dataclasses.dataclass
class Setup:
    """What a run needs, from :func:`setup`."""

    config: llama.LlamaConfig
    state: object
    step_fn: object
    batches: DevicePrefetch
    dataset: object
    topology: gpu_init.Topology
    mesh: Optional[object]
    local_batch: int
    ckpt: Optional[CheckpointManager] = None
    shard_srv: Optional[object] = None
    restore: Optional[RestoreOutcome] = None


_TRUTHY = ("1", "true", "yes")


def checkpoint_stream(root: str, topo: gpu_init.Topology) -> str:
    """The directory of this run's checkpoint stream under ``root``.
    Slice-local worlds are independent training replicas: each slice owns
    ``slice-<i>/``. A job of one slice is not slice-local
    (``gpu_init.topology_from_env``), so a slice-local job resized to one
    slice reads ``root``, where no slice saved, as the JAX example does
    (``examples/jax/llama/llama_train.py``)."""
    if topo.slice_world and topo.num_slices > 1:
        return os.path.join(root, f"slice-{topo.slice_index}")
    return root


def recover(args: argparse.Namespace, state, topo: gpu_init.Topology, config):
    """The checkpoint manager of ``args.checkpoint_dir``, the restore of
    ``state`` in place through the ladder, and the shard server when the
    operator asked for one: ``(ckpt, shard_srv, outcome)``.

    Under the per-node launcher each local rank asks the survivors'
    servers of its own local rank (``shard_server.local_peer_addresses``)
    and, with ``TPU_SHARD_SERVER``, serves its own shards on the port the
    launcher gave it; the pod publishes local rank 0's address. A sharded
    state restores through the ladder's world vote (``restore.WorldGate``):
    every rank from its own peer at one step, or every rank from storage."""
    ckpt_dir = checkpoint_stream(args.checkpoint_dir, topo)
    delta_persist = os.environ.get(heartbeat.ENV_DELTA_PERSIST) in _TRUTHY
    ckpt = CheckpointManager(ckpt_dir, model_meta=config.geometry(),
                             delta_persist=delta_persist)
    # DURABILITY ORDERING: record_checkpoint fires ONLY from the persist
    # worker after the finalize, never after save() returns: save() proves
    # the snapshot only, and a step published while its persist is in
    # flight lets the operator's checkpoint-gated shrink take workers away
    # against a checkpoint that a crash can still erase.
    ckpt.add_durability_listener(heartbeat.record_checkpoint)
    peers = [a for a in os.environ.get(heartbeat.ENV_PEER_RESTORE_ADDRS, "").split(",") if a]
    local_rank = int(os.environ.get(gpu_init.ENV_LOCAL_RANK, "0") or 0)
    outcome = restore_with_fallback(
        state, ckpt, local_peer_addresses(peers, local_rank),
        sharded=os.environ.get(heartbeat.ENV_SHARDED_RESTORE) in _TRUTHY,
        warm_start=os.environ.get(heartbeat.ENV_WARM_START) in _TRUTHY,
        have=delta_persist,
        commit=WorldGate() if dist.is_initialized() and is_sharded(state) else None,
    )
    heartbeat.record_restore(outcome.path, outcome.cause, outcome.seconds,
                             outcome.bytes_moved)
    if outcome.step is not None:
        print(f"[llama] resumed from step {outcome.step} via {outcome.path} "
              f"({outcome.cause})", flush=True)
    shard_srv = None
    if os.environ.get(heartbeat.ENV_SHARD_SERVER) in _TRUTHY:
        sliced = topo.num_slices > 1
        port = int(os.environ.get(heartbeat.ENV_SHARD_SERVER_PORT, "0") or 0)
        try:
            shard_srv = start_shard_server(
                ckpt, port=port, slice_index=topo.slice_index if sliced else None,
                num_slices=topo.num_slices if sliced else None)
        except OSError as err:
            # The launcher found the port free, but another process took it
            # since. Only the peer path degrades: this rank serves nothing
            # and publishes nothing, and a restoring peer of its local rank
            # falls to storage.
            print(f"[llama] no shard server: port {port}: {err}", flush=True)
        else:
            heartbeat.record_peer_address(shard_srv.address)
    return ckpt, shard_srv, outcome


def setup(args: argparse.Namespace, seed: int = 0,
          config: Optional[llama.LlamaConfig] = None) -> Setup:
    """Rendezvous, build the (sharded) train state and the input pipeline.
    The model is drawn from a generator seeded with ``seed`` on the run's
    device; a sharded model holds the same weights as an unsharded one.
    ``config`` replaces ``CONFIGS[args.model]`` for a model of no named
    configuration (``args.model`` then only names it)."""
    device = resolve_device(args.device)
    topo = gpu_init.initialize(device=device)
    if args.model is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        args.model = default_model(device.type, world)
    config = config or llama.CONFIGS[args.model]
    if device.type == "cpu":
        args.seq = min(args.seq, config.max_seq_len)
    # Rope tables are built at max_seq_len; size them to the run (as
    # bench.py does), which keeps the rope kernel on the table it takes.
    config = dataclasses.replace(config, max_seq_len=args.seq)
    if args.remat_policy is not None:
        config = dataclasses.replace(config, remat_policy=args.remat_policy)
    if args.data:
        check_vocab(args.data, args.data_dtype, config.vocab_size, args.model)

    mesh = gpu_init.global_mesh(topo, device) if dist.is_initialized() else None
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    data_rank, data_size = data_coords(mesh) if mesh is not None else (0, 1)
    if args.batch % data_size:
        raise SystemExit(f"--batch {args.batch} must divide by the data-parallel "
                         f"size {data_size}")
    local_batch = args.batch // data_size

    generator = torch.Generator(device=device).manual_seed(seed)
    optimizer = make_optimizer(learning_rate=args.lr, warmup_steps=args.warmup,
                               decay_steps=max(args.steps, args.warmup + 1))
    if mesh is None:
        state = init_train_state(llama.Llama(config, device=device, generator=generator),
                                 optimizer)
    else:
        config = pick_attention(config, mesh_axes(mesh))
        pp = mesh_axes(mesh).get("pp", 1)
        stage = mesh.get_local_rank("pp") if pp > 1 else 0
        state = init_sharded_train_state(llama.Llama(config, device="meta", pp=pp, stage=stage),
                                         optimizer, mesh, device, generator)
    ckpt = shard_srv = outcome = None
    if args.checkpoint_dir:
        # The restore runs BEFORE the dataset is built: skip_windows reads
        # the restored step, or a resumed run would train on the early
        # windows twice.
        ckpt, shard_srv, outcome = recover(args, state, topo, config)
    if args.data:
        dataset = TokenFileDataset(args.data, local_batch, args.seq, dtype=args.data_dtype,
                                   process_id=data_rank, num_processes=data_size,
                                   skip_windows=state.step * local_batch)
    else:
        # Synthetic batches do not skip on resume, as in the JAX script: a
        # resumed run starts their stream again.
        dataset = SyntheticTokens(local_batch, args.seq, config.vocab_size, seed=data_rank)
    return Setup(config, state, make_train_step(optimizer),
                 DevicePrefetch(dataset, device, depth=2), dataset, topo, mesh, local_batch,
                 ckpt, shard_srv, outcome)


def run(args: argparse.Namespace, s: Optional[Setup] = None) -> dict:
    """Train ``s`` (by default a new :func:`setup` of ``args``) from the
    restored step (0 on a fresh run) to ``args.steps``; returns the losses (the global batch's, one float a step), the timed
    window (``window_steps`` steps in ``window_seconds``, from the host's
    read of the first step's loss to its read of the last's, so that the
    first step, which warms the allocator and the libraries up, stays
    outside) and, with a checkpoint directory, the restore outcome, the
    seconds each save blocked the loop, and the (closed) checkpoint
    manager, whose host snapshot stays servable."""
    s = s or setup(args)
    try:
        out = _train(args, s)
    finally:
        # Drain the persist queue on EVERY exit path: a completing or
        # failing run must never leave a write in flight.
        if s.ckpt is not None:
            s.ckpt.close()
        if s.shard_srv is not None:
            s.shard_srv.stop()
        # One last beat: the renewal thread is a daemon, and the final
        # durable step must be published before the process exits.
        heartbeat.flush()
    # What a process that started this one reads back (the per-node
    # launcher's children): the losses, the window, the kernels' launches,
    # the peak memory, the restore and the last persist with their splits,
    # and the recovery families this process observed.
    print("[llama] done " + json.dumps(done_summary(s, out)), flush=True)
    return out


def done_summary(s: Setup, out: dict) -> dict:
    """The ``[llama] done`` object of a finished run."""
    restore = None
    if s.restore is not None:
        r = s.restore
        restore = {"path": r.path, "cause": r.cause, "step": r.step, "seconds": r.seconds,
                   "split": r.split, "bytes_moved": r.bytes_moved,
                   "digest": checksum_digest(r.checksums) if r.checksums else None}
    return {"process": s.topology.process_id, "losses": out["losses"],
            "window_steps": out["window_steps"], "window_seconds": out["window_seconds"],
            "tokens_per_step": out["tokens_per_step"], "launches": out["launches"],
            "peak_bytes": out["peak_bytes"], "start_step": out["start_step"],
            "restore": restore,
            "persist": s.ckpt.last_persist_info if s.ckpt is not None else None,
            "telemetry": METRICS.render() if s.ckpt is not None else None}


def attention_note(config: llama.LlamaConfig, mesh: dict) -> str:
    """The attention a run uses and, over sp or pp, why and how."""
    note = config.attention_impl
    if mesh.get("sp", 1) > 1:
        note += f" (over sp={mesh['sp']}: the mesh's sp picks the ring)"
    if mesh.get("pp", 1) > 1:
        note += (f" pipeline=pp{mesh['pp']}x{config.n_layers // mesh['pp']} layers, "
                 f"{config.pp_microbatches or mesh['pp']} microbatches")
    return note


def _train(args: argparse.Namespace, s: Setup) -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    device = torch.device(s.batches.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    mesh = mesh_axes(s.mesh) if s.mesh is not None else {}
    slice_note = (f" slice={s.topology.slice_index}/{s.topology.num_slices}"
                  if s.topology.num_slices > 1 else "")
    print(f"[llama] process {s.topology.process_id}/{s.topology.num_processes} "
          f"devices={world} mesh={mesh}{slice_note} device={device} ({name}) "
          f"model={args.model} params={s.config.param_count():,} "
          f"remat_policy={s.config.remat_policy} attention={attention_note(s.config, mesh)}",
          flush=True)
    save_seconds = []
    state = s.state
    start, last = state.step, args.steps - 1
    # One buffer for the run's losses, allocated once: each step's loss is
    # copied in on the device, so nothing waits and nothing grows per step.
    losses = torch.empty(max(args.steps - start, 0), dtype=torch.float32, device=device)
    window = None  # (step, host clock) of the first read
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        state, loss = s.step_fn(state, next(s.batches))
        losses[step - start].copy_(loss.detach())
        step_profiler(step)
        if step == start or step % args.log_every == 0 or step == last:
            value = float(loss)  # the host read: waits for the device
            now = time.perf_counter()
            window = window or (step, now)
            tps = (step - start + 1) * args.batch * args.seq / max(now - t0, 1e-9)
            print(f"[llama] step {step} loss {value:.4f} "
                  f"tokens/sec {tps:,.0f} ({tps / world:,.0f}/chip)", flush=True)
            # Log cadence, not per step: each call wakes the heartbeat thread.
            record_progress(step=step, tokens_per_sec=tps)
        if s.ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            # The snapshot only; the persist runs in the background and the
            # durability listener publishes the step once it is finalized.
            t_save = time.perf_counter()
            s.ckpt.save(state)
            save_seconds.append(time.perf_counter() - t_save)
    window_steps, window_seconds = (last - window[0], now - window[1]) if window else (0, 0.0)
    if s.ckpt is not None:
        t_save = time.perf_counter()
        if s.ckpt.save(state, force=True):
            save_seconds.append(time.perf_counter() - t_save)
    losses = losses.tolist()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"config": s.config, "losses": losses, "window_steps": window_steps,
            "window_seconds": window_seconds,
            "tokens_per_step": args.batch * args.seq, "device": name, "mesh": mesh,
            "native_loader": getattr(s.dataset, "native", None), "restore": s.restore,
            "save_seconds": save_seconds, "ckpt": s.ckpt, "start_step": start,
            "launches": {k: n for k, n in build.LAUNCHES.items() if n}, "peak_bytes": peak}


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
