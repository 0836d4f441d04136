"""The port's main paths on every visible card: phase n of ``chip_smoke.py``.

    python3 scripts/multicard_smoke.py [--out FILE]
    python3 scripts/multicard_smoke.py --device cpu --procs 4   # rehearsal

Needs N >= 2 cards and exits non-zero with fewer. One process per card over
NCCL, started with the PyTorchJob c10d env (``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``, ``LOCAL_RANK``: each rank sets its card before
the group is made) and a ``JAX_MESH_SPEC`` per row. First, in this
process, the one-card references on card 0 at the same global batch and
seed; then, in the N processes, the rows:

- llama2-7b, the model ``llama_train`` picks from 4 cards, on its default
  mesh (fsdp=N), ``--batch 8N`` (32 at 4 cards), seq 2048, 3 steps: the
  first loss within 0.5 of what the init gives (:func:`first_loss`:
  ln(32000) plus half the logits' variance, 11.19); tokens/s per card,
  MFU, and the peak
  memory of the fullest card against the reckoned bytes of
  ``llama_train.LLAMA2_7B_MIN_WORLD``'s comment (29.5e9 at 4 cards);
- llama-400m over fsdp=N, over fsdp=N/2 x tp=2 and, the multislice
  layout (HSDP: replicated over the first axis, sharded over fsdp), over
  slice=2 x fsdp=N/2 and dp=2 x fsdp=N/2, global batch 8N, seq 2048, 4
  steps from a seeded token file: each loss within ``chip_smoke.LOSS_TOL``
  of the one-card run's; after the N workers, the same run over 2 nodes
  of N/2 cards through the per-node launcher (:func:`launch_row`): two
  launchers on their halves of the cards under a 2-node JAXJob's env
  (``chip_smoke.node_env``), its losses the one-card run's and the
  slice=2 x fsdp=N/2 row's (``LOSS_TOL``), every rank's launches and
  peak memory from its ``[llama] done`` summary; in the three HSDP rows
  every parameter shard bit-equal to its replica's across the replicate
  dim after the last step (:func:`replica_mismatches`); then the
  recovery plane over the same 2 nodes (:func:`slice_local_row`): each
  node a slice-local world of N/2 ranks, slice 1 killed and restored by
  each rank from its own peer, its losses slice 0's;
- moe-125m over ep=N, over fsdp=N (the expert axis is fsdp: 8 experts
  divide it) and over ep=2 x fsdp=N/2, global batch 8N: the first loss at
  ``LOSS_TOL``, the later ones at ``PARITY_TOL["loss"]``, with the share
  of (token, rank) routes of the first forward whose expert differs from
  the one-card run's; the all-to-alls a step; the ep=N run, and
  llama-400m's fsdp=N one, run again, traced by the entry point's
  ``TPU_PROFILE_*`` window (steps 1-2): per card the compute kernels'
  busy ms, the idle share and the NCCL kernels' ms a step (all-to-all
  among them), and one all-to-all of the dispatch's shape timed alone;
- bert-base data parallel over dp=N on the JAX bench's BERT path
  (``train_step.loss_fn`` with no mask: the d=64 flash kernels), global
  batch 16N, seq 512, 4 steps: the losses at ``LOSS_TOL``; and over
  fsdp=N/2 x tp=2, where BERT's step is data parallel over the whole
  world too: its losses bit-equal to the dp=N row's;
- moe-125m over ep=N through DCP: 2 steps, a save, a restore into a new
  setup byte-equal to the saved state (every rank's shards and moments),
  and 2 steps resumed from it with the ep=N run's losses of steps 2-3;
- at N = 4, the sequence and pipeline axes: llama-400m at seq 8192,
  global batch 4, over sp=4, sp=2 x fsdp=2 and sp=2 x tp=2 (ring
  attention), against a one-card run of the same batch, each ring rank's
  launches and K/V rotations a step against what the ring implies
  (:func:`ring_expect`), the sp=4 run traced again: the port's flash
  kernels in every rank's trace and none of torch's attention; llama-400m
  at seq 2048, global batch 8N, over pp=4 (6 layers a stage, M=4 and
  M=8 microbatches), pp=2 x fsdp=2 and pp=2 x tp=2 (M=2) against the
  one-card llama run, each stage's launches and permutes a step against
  :func:`pipe_expect`; moe-125m at seq 8192, global batch 4, over sp=4
  and sp=2 x ep=2 against a one-card run of the same batch, each ring
  rank's launches and permutes against :func:`ring_expect` under its
  "+rope" policy, its all-to-alls a step;
- resnet50 data parallel over the N cards through ``resnet_train`` at
  224x224, global batch 64N (256 at 4 cards), 4 steps, the BatchNorm
  statistics the global batch's: each loss against a one-card run of the
  same global batch (the N ranks' draws, rank-major) at ``LOSS_TOL``,
  rank 0's running BatchNorm statistics after the 4 steps against that
  run's at ``RESNET_STATS_TOL`` (per-rank statistics would differ by the
  sampling of 64 images against 256), images/s a card and the fullest
  card's peak memory.

Every row prints tokens/s per card, the step time, the peak memory of the
fullest card and the kernels' launches a step per card. The last line is
a JSON object of every row, ``{"ok": ...}``; with ``--out`` it is also
written to FILE. The rehearsal runs the same rows on the CPU over gloo
with fp32 llama-tiny (4 layers), moe-tiny and bert-tiny (seq 32, 2 rows a
process; the ring rows at seq 64).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the repo root, for its tolerances and helpers)

# The reckoned bytes one card of a 4-card llama2-7b run at --batch 32 holds
# (scripts/train_memory.py's fit; llama_train.LLAMA2_7B_MIN_WORLD).
LLAMA2_7B_RECKONED = {4: 29.5e9, 8: 15.6e9, 2: 57.4e9}
STEPS = 4
WORKER_TIMEOUT = 900.0  # the workers' whole run
COLLECTIVE_TIMEOUT = 300  # a collective that waits longer aborts its process
NCCL_A2A = ("SendRecv", "AllToAll")
# Rank 0's running BatchNorm statistics against the one-card run's, worst
# relative L2 over the buffers. resnet50 on 4 H100s read 2.2e-3 with the
# global batch's statistics and 1.47 with each rank's own (both at the
# stem's running mean), where the losses stayed within 1.4e-4: the limit
# sits 9x above the first reading and 70x below the second.
RESNET_STATS_TOL = 2e-2


@dataclasses.dataclass
class Plan:
    """The models and sizes of a run: the card's, or the CPU rehearsal's."""

    device: str
    procs: int
    llama: str = "llama-400m"
    moe: str = "moe-125m"
    bert: str = "bert-base"
    seq: int = 2048
    bert_seq: int = 512
    rows: int = 8  # a card's rows of llama and moe
    bert_rows: int = 16
    long_seq: int = 8192  # the ring rows' sequence
    long_rows: int = 4  # the ring rows' global batch
    resnet: str = "resnet50"
    image: int = 224
    resnet_rows: int = 64  # a card's images

    @classmethod
    def for_device(cls, device: str, procs: int) -> "Plan":
        if device == "cuda":
            return cls("cuda", procs)
        return cls("cpu", procs, "llama-tiny", "moe-tiny", "bert-tiny", 32, 32, 2, 2, 64, 4,
                   "resnet-tiny", 32, 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def fp32_on_cpu(plan: Plan) -> None:
    """The rehearsal's models in fp32, where one process and N agree to
    the last bits; the card runs bf16."""
    if plan.device != "cpu":
        return
    from tf_operator_tpu_torch.models import bert, llama, resnet

    for table, name in ((llama.CONFIGS, plan.llama), (llama.CONFIGS, plan.moe),
                        (bert.CONFIGS, plan.bert)):
        table[name] = dataclasses.replace(table[name], dtype=torch.float32,
                                          param_dtype=torch.float32)
    resnet.CONFIGS[plan.resnet] = dataclasses.replace(resnet.CONFIGS[plan.resnet],
                                                      dtype=torch.float32)
    # Layers that 4 pipeline stages divide.
    llama.CONFIGS[plan.llama] = dataclasses.replace(llama.CONFIGS[plan.llama], n_layers=4)


def llama_args(plan: Plan, model: str, tokens: str, steps: int = STEPS, long: bool = False
               ) -> list:
    """The entry point's arguments; ``long``: the ring rows' sequence and
    global batch."""
    batch, seq = (plan.long_rows, plan.long_seq) if long else (plan.rows * plan.procs, plan.seq)
    return ["--model", model, "--batch", str(batch), "--seq", str(seq),
            "--log-every", "100", "--warmup", "1", "--steps", str(steps), "--data", tokens,
            "--data-dtype", "uint16", "--device", plan.device]


def reset(plan: Plan) -> None:
    from tf_operator_tpu_torch.ops import build
    from tf_operator_tpu_torch.parallel import collectives, experts

    gc.collect()
    build.reset_launches()
    experts.reset_counts()
    collectives.reset_counts()
    if plan.device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def counters(plan: Plan, steps: int) -> dict:
    """This process's launches, all-to-alls and permutes a step, and its
    peak memory."""
    from tf_operator_tpu_torch.ops import build
    from tf_operator_tpu_torch.parallel import collectives, experts

    launches = {k: n / steps for k, n in build.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated() if plan.device == "cuda" else 0
    return {"launches": launches, "all_to_all": experts.COUNTS["all_to_all"] / steps,
            "ppermute": collectives.COUNTS["ppermute"] / steps, "peak_bytes": peak}


def route_hooks(model, routes: dict) -> None:
    """Keep each layer's top-k expert ids of its first forward."""
    for i, layer in enumerate(model.layers):
        if layer.moe:
            k = layer.feed_forward.cfg.experts_per_token

            def keep(module, args, out, i=i, k=k):
                routes.setdefault(i, torch.topk(out, k)[1].cpu())
            layer.feed_forward.router.register_forward_hook(keep)


def train_llama(plan: Plan, argv: list, routes: dict = None) -> dict:
    """One llama_train run; its losses, window and counters."""
    from tf_operator_tpu_torch.parallel.sharding import data_coords
    from tf_operator_tpu_torch.train import llama_train

    reset(plan)
    args = llama_train.parse_args(argv)
    s = llama_train.setup(args)
    if routes is not None:
        route_hooks(s.state.model, routes)
    data_rank = data_coords(s.mesh)[0] if s.mesh is not None else 0
    out = llama_train.run(args, s)
    steps = len(out["losses"])
    step_s = out["window_seconds"] / max(out["window_steps"], 1)
    return {"model": args.model, "losses": out["losses"], "mesh": out["mesh"],
            "step_s": step_s, "tokens_per_s": out["tokens_per_step"] / step_s,
            "flops_per_token": out["config"].flops_per_token(args.seq),
            "data_rank": data_rank, "replicas": replica_mismatches(s.state.model, s.mesh),
            **counters(plan, steps)}


def replica_mismatches(model, mesh):
    """How many parameters differ, in any bit, between some rank's shard
    and its peer's across the HSDP replicate dim (``slice`` or ``dp``),
    summed over the world: 0 when every replica took the same steps; None
    on a mesh without that dim. The losses cannot show this: a world whose
    replicas never all-reduce their gradients keeps them within
    ``LOSS_TOL`` over a row's steps."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names if mesh is not None else ()
    dims = [a for a in ("slice", "dp") if a in names and mesh[a].size() > 1]
    if not dims:
        return None
    group, size = mesh[dims[0]].get_group(), mesh[dims[0]].size()
    differ = 0
    for p in model.parameters():
        local = (p.to_local() if hasattr(p, "to_local") else p).detach().contiguous()
        peers = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(peers, local, group=group)
        differ += any(not torch.equal(peers[0], x) for x in peers[1:])
    total = torch.tensor([differ], device=local.device)
    dist.all_reduce(total)
    return int(total.item())


def bert_batches(plan: Plan, vocab: int) -> list:
    """The global batches of the BERT rows, [16N, seq+1] from seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    n = plan.bert_rows * plan.procs
    return [rng.integers(0, vocab, (n, plan.bert_seq + 1), dtype=np.int32)
            for _ in range(STEPS)]


def train_bert(plan: Plan, group=None, rank: int = 0, world: int = 1) -> dict:
    """bert-base on the bench path (make_train_step with loss_fn, no mask),
    this process's rows of the global batches; data parallel over
    ``group`` when given."""
    from tf_operator_tpu_torch.models import bert
    from tf_operator_tpu_torch.train.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    reset(plan)
    cfg = bert.CONFIGS[plan.bert]
    device = torch.device(plan.device, torch.cuda.current_device()) \
        if plan.device == "cuda" else torch.device("cpu")
    model = bert.Bert(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    optimizer = make_optimizer(warmup_steps=1, decay_steps=1000)
    state = init_train_state(model, optimizer)
    step_fn = make_train_step(optimizer, replica_group=group)
    rows = plan.bert_rows * plan.procs // world
    batches = [torch.from_numpy(b[rank * rows:(rank + 1) * rows]).to(device)
               for b in bert_batches(plan, cfg.vocab_size)]
    losses = torch.empty(STEPS, dtype=torch.float32, device=device)
    for i, batch in enumerate(batches):
        state, loss = step_fn(state, batch)
        losses[i].copy_(loss)
        if i == 0:
            losses[0].item()
            t0 = time.perf_counter()
    losses = losses.tolist()
    step_s = (time.perf_counter() - t0) / (STEPS - 1)
    tokens = plan.bert_rows * plan.procs * plan.bert_seq
    out = {"model": plan.bert, "losses": losses, "step_s": step_s,
           "tokens_per_s": tokens / step_s, "flops_per_token": cfg.flops_per_token(plan.bert_seq),
           **counters(plan, STEPS)}
    del model, state, step_fn, batches
    return out


def resnet_batches(plan: Plan):
    """The global batch of each step of the ResNet row: the N ranks' own
    draws (``resnet_train.batches``), rank-major, as one process's."""
    import numpy as np

    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.train import resnet_train

    classes = resnet.CONFIGS[plan.resnet].num_classes
    parts = [resnet_train.batches(r, plan.resnet_rows, plan.image, classes)
             for r in range(plan.procs)]
    while True:
        yield tuple(np.concatenate(a) for a in zip(*(next(p) for p in parts)))


def train_resnet(plan: Plan, distributed: bool = False) -> dict:
    """resnet_train on the row's global batch: over the process group, or
    in one process on :func:`resnet_batches`."""
    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.train import resnet_train

    reset(plan)
    args = resnet_train.parse_args([
        "--model", plan.resnet, "--batch", str(plan.resnet_rows * plan.procs), "--image-size",
        str(plan.image), "--steps", str(STEPS), "--log-every", "100", "--device", plan.device])
    out = resnet_train.run(args, data=None if distributed else resnet_batches(plan))
    step_s = out["window_seconds"] / max(out["window_steps"], 1)
    row = {"model": plan.resnet, "losses": out["losses"], "step_s": step_s,
           "tokens_per_s": out["images_per_step"] / step_s, "unit": "images",
           "flops_per_token": 3 * resnet.CONFIGS[plan.resnet].forward_flops(plan.image),
           "stats": {k: v.float().cpu() for k, v in out["model"].named_buffers()},
           **counters(plan, STEPS)}
    del out
    return row


# ------------------------------------------------------------- the parent
def references(plan: Plan, tokens: str) -> dict:
    """The one-card runs, in this process on card 0 (no process group)."""
    refs = {"llama": train_llama(plan, llama_args(plan, plan.llama, tokens))}
    refs["moe_routes"] = {}
    refs["moe"] = train_llama(plan, llama_args(plan, plan.moe, tokens), refs["moe_routes"])
    refs["bert"] = train_bert(plan)
    refs["resnet"] = train_resnet(plan)
    names = ["llama", "moe", "bert", "resnet"]
    if plan.procs == 4:
        for name, model in (("llama_long", plan.llama), ("moe_long", plan.moe)):
            refs[name] = train_llama(plan, llama_args(plan, model, tokens, long=True))
            names.append(name)
    for name in names:
        r = refs[name]
        log(f"[n] one card: {r['model']} losses {r['losses']}, step {r['step_s']:.4f} s, "
            f"{r.get('unit', 'tokens')}/s {r['tokens_per_s']:.1f}, peak "
            f"{r['peak_bytes'] / 1e9:.3f} GB, launches a step {r['launches']}")
    return refs


def wait_all(procs: list) -> None:
    """Wait for ``procs`` for ``WORKER_TIMEOUT`` in all; kill what is left."""
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def spawn(plan: Plan, tmp: str, tokens: str) -> list:
    """The N worker processes, their output in ``tmp``; returns their
    results (rank 0's list of rows)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for rank in range(plan.procs):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "WORLD_SIZE": str(plan.procs), "RANK": str(rank), "LOCAL_RANK": str(rank)}
        if plan.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        logs.append(open(os.path.join(tmp, f"worker{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "--device", plan.device,
             "--procs", str(plan.procs), "--tmp", tmp, "--tokens", tokens],
            cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        wait_all(procs)
    finally:
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        with open(os.path.join(tmp, f"worker{rank}.log")) as f:
            text = f.read()
        if rank == 0 or p.returncode != 0:
            for line in text.splitlines()[-60 if p.returncode else -400:]:
                log(f"[n] rank {rank}| {line}")
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} exited {p.returncode}")
    return cs.read_json(os.path.join(tmp, "rows.json"))


def launch_row(plan: Plan, tmp: str, tokens: str) -> dict:
    """llama over 2 nodes of N/2 cards through the per-node launcher: two
    launchers, each on its half of the cards (``CUDA_VISIBLE_DEVICES``),
    under the env the operator gives the two pods of a 2-node ``gpu_job``
    (``chip_smoke.node_env``: mesh {"slice": 2, "fsdp": N/2}); each child
    runs the entry point's ``main`` (:func:`train_main`). The row of their
    ``[llama] done`` summaries."""
    half = plan.procs // 2
    port = cs.free_port()
    command = cs.launch_argv(half, [
        sys.executable, os.path.abspath(__file__), "--device", plan.device, "--procs",
        str(plan.procs), "--train", *llama_args(plan, plan.llama, tokens)])
    procs, paths = [], []
    for node in range(2):
        env = {**os.environ, **cs.node_env(2, node, half, port)}
        if plan.device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(node * half + i) for i in range(half))
        else:
            env["OMP_NUM_THREADS"] = "1"
        paths.append(os.path.join(tmp, f"launcher{node}.log"))
        with open(paths[-1], "w") as out:
            procs.append(subprocess.Popen(command, cwd=ROOT, env=env, stdout=out,
                                          stderr=subprocess.STDOUT))
    wait_all(procs)
    runs, texts, replicas = {}, [], []
    for node, path in enumerate(paths):
        with open(path) as f:
            texts.append(f.read())
        runs.update(cs.done_lines(texts[-1]))
        for line in texts[-1].splitlines():
            if line.startswith(REPLICAS):
                replicas.append(json.loads(line[len(REPLICAS):]))
            if line.startswith(("[gpu_init]", "[llama] process", REPLICAS)):
                log(f"[n] launcher {node}| {line}")
    codes = [p.returncode for p in procs]
    if (codes != [0, 0] or sorted(runs) != list(range(plan.procs))
            or sorted(r["process"] for r in replicas) != list(range(plan.procs))):
        for node, text in enumerate(texts):
            for line in text.splitlines()[-60:]:
                log(f"[n] launcher {node}| {line}")
        raise AssertionError(f"the launchers exited {codes} with the summaries of processes "
                             f"{sorted(runs)} and the replicas' checks of {replicas}")
    first = runs[0]
    steps = len(first["losses"])
    step_s = first["window_seconds"] / max(first["window_steps"], 1)
    from tf_operator_tpu_torch.models import llama

    return {"name": f"{plan.llama} 2 nodes x {half} (launch)", "model": plan.llama,
            "mesh": {"slice": 2, "fsdp": half}, "losses": first["losses"], "step_s": step_s,
            "tokens_per_s": first["tokens_per_step"] / step_s,
            "flops_per_token": llama.CONFIGS[plan.llama].flops_per_token(plan.seq),
            "ranks": [{"launches": {k: n / steps for k, n in runs[r]["launches"].items()},
                       "all_to_all": 0.0, "ppermute": 0.0, "peak_bytes": runs[r]["peak_bytes"],
                       "expect": None} for r in sorted(runs)],
            "replicas": max(r["mismatched"] for r in replicas), "ref": "llama", "kernels": True,
            "same_as": f"{plan.llama} slice=2 x fsdp={half}"}


REPLICAS = "[n] replicas "  # a launch row child's line: its replica_mismatches
# The slice-local row: enough steps that slice 0 still trains when slice 1
# has restarted, a checkpoint every SLICE_LOCAL_EVERY.
SLICE_LOCAL_STEPS = 160
SLICE_LOCAL_EVERY = 20


def slice_local_row(plan: Plan, tmp: str, tokens: str, refs: dict) -> list:
    """The recovery plane over 2 nodes of N/2 cards: two launchers, each
    on its half of the cards, under the env of a 2-node, 2-slice JAXJob
    with JAX_SLICE_LOCAL_WORLD=1 and TPU_SHARD_SERVER=1, so that each node
    is a slice-local world of N/2 ranks (fsdp=N/2) with its own
    checkpoint stream (DCP) and each rank serves its own shards. Slice 1's
    launcher and children are SIGKILLed as a process group after its first
    durable checkpoint and started again with slice 0's published
    address: every rank must restore its own shards from its peer at one
    step (``peer``; each rank's digest its own), and slice 1's losses from
    there must be slice 0's (``LOSS_TOL``); slice 0's first two losses
    are the one-card run's (the schedule's length enters from the third).
    Each rank's restore path, cause and seconds split is printed. Returns
    the failures."""
    half = plan.procs // 2
    port = cs.free_port()
    root = os.path.join(tmp, "slice-local")
    beats = [os.path.join(tmp, f"slice-beat{node}.json") for node in range(2)]
    command = cs.launch_argv(half, [
        sys.executable, os.path.abspath(__file__), "--device", plan.device, "--procs",
        str(plan.procs), "--train", *llama_args(plan, plan.llama, tokens, SLICE_LOCAL_STEPS),
        "--checkpoint-dir", root, "--checkpoint-every", str(SLICE_LOCAL_EVERY)])
    paths = {}

    def start(node: int, tag: str, peers: str = ""):
        env = cs.slice_env(node, port, beats[node], peers, gpus=half)
        if plan.device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(node * half + i) for i in range(half))
        else:
            env["OMP_NUM_THREADS"] = "1"
        paths[tag] = os.path.join(tmp, f"{tag}.log")
        with open(paths[tag], "w") as out:
            return subprocess.Popen(command, cwd=ROOT, env=env, stdout=out,
                                    stderr=subprocess.STDOUT, start_new_session=True)

    procs = [start(0, "slice0"), start(1, "slice1")]
    fails = []
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        durable = None
        while time.monotonic() < deadline and procs[1].poll() is None:
            durable = (cs.read_json(beats[1]) or {}).get("checkpoint_step")
            if durable is not None:
                break
            time.sleep(0.05)
        os.killpg(procs[1].pid, signal.SIGKILL)
        procs[1].wait()
        survivor = cs.published_peer(beats[0], procs[0], 120.0)
        log(f"[n] slice-local: slice 1 SIGKILLed (its process group) at its durable step "
            f"{durable}; slice 0 durable {survivor.get('checkpoint_step')}, serving at "
            f"{survivor.get('peer_addr')}")
        if durable is None or procs[0].poll() is not None or not survivor.get("peer_addr"):
            raise AssertionError(f"slice 1 made no durable checkpoint while slice 0 served: "
                                 f"{survivor}")
        procs.append(start(1, "slice1-restarted", survivor["peer_addr"]))
        wait_all([procs[0], procs[2]])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    texts = {tag: open(path).read() for tag, path in paths.items()}
    zero, one = cs.done_lines(texts["slice0"]), cs.done_lines(texts["slice1-restarted"])
    for tag in ("slice0", "slice1-restarted"):
        for line in texts[tag].splitlines():
            if line.startswith(("[gpu_init]", "[llama] resumed")):
                log(f"[n] slice-local {tag}| {line}")
    codes = [p.returncode for p in (procs[0], procs[2])]
    if codes != [0, 0] or sorted(zero) != list(range(half)) or sorted(one) != list(range(half)):
        for tag, text in texts.items():
            for line in text.splitlines()[-40:]:
                log(f"[n] slice-local {tag}| {line}")
        return [f"slice-local: slice 0 and the restarted slice 1 exited {codes} with the "
                f"summaries of ranks {sorted(zero)} and {sorted(one)}"]
    restores = [one[r]["restore"] for r in range(half)]
    for r, restore in enumerate(restores):
        log(f"[n] slice-local: restarted slice 1 rank {r}: {restore['path']} "
            f"({restore['cause']}) at step {restore['step']}, {restore['bytes_moved']} bytes in "
            f"{restore['seconds']:.3f} s, split {restore['split']}, digest {restore['digest']}; "
            f"last persist {one[r]['persist']}")
    steps = {restore["step"] for restore in restores}
    if any((x["path"], x["cause"]) != ("peer", "ok") for x in restores) or len(steps) != 1:
        fails.append(f"slice-local: the restarted ranks' restores {restores}")
    if len({x["digest"] for x in restores}) != half:
        fails.append("slice-local: two ranks restored the same shards")
    k = one[0]["start_step"]
    for r in range(half):
        worst = max(cs.rel(a, b) for a, b in zip(one[r]["losses"], zero[r]["losses"][k:]))
        log(f"[n] slice-local rank {r}: {len(one[r]['losses'])} steps from step {k} against "
            f"slice 0's: worst rel {worst:.3e} (tol {cs.LOSS_TOL}), bit-equal "
            f"{one[r]['losses'] == zero[r]['losses'][k:]}; launches a step "
            f"{ {n: c / len(one[r]['losses']) for n, c in one[r]['launches'].items()} }")
        if worst > cs.LOSS_TOL or len(one[r]["losses"]) != SLICE_LOCAL_STEPS - k:
            fails.append(f"slice-local rank {r}: losses from step {k} against slice 0's")
    first = max(cs.rel(a, b) for a, b in zip(zero[0]["losses"][:2], refs["llama"]["losses"]))
    log(f"[n] slice-local: slice 0's first losses {zero[0]['losses'][:2]} against one card's "
        f"{refs['llama']['losses'][:2]}: worst rel {first:.3e} (tol {cs.LOSS_TOL})")
    if first > cs.LOSS_TOL:
        fails.append("slice-local: slice 0's first losses against one card's")
    if plan.device == "cuda" and not all(one[r]["launches"] for r in range(half)):
        fails.append("slice-local: no kernel launched")
    return fails


def train_main(plan: Plan, argv: list) -> int:
    """A child of the launch row: what ``llama_train.main`` does (a setup
    and a run of ``argv``) on the plan's models, then the replicas' check
    of the trained parameters."""
    import torch.distributed as dist

    fp32_on_cpu(plan)
    from tf_operator_tpu_torch.train import llama_train

    args = llama_train.parse_args(argv)
    s = llama_train.setup(args)
    llama_train.run(args, s)
    print(REPLICAS + json.dumps({"process": dist.get_rank(),
                                 "mismatched": replica_mismatches(s.state.model, s.mesh)}),
          flush=True)
    dist.destroy_process_group()
    return 0


def interleave(parts: list, rows: int) -> torch.Tensor:
    """Per-rank [rows * groups, ...] tensors as the one-card batch holds
    them: batch row j from rank j mod N."""
    per_rank = [p.reshape(rows, -1, *p.shape[1:]) for p in parts]
    return torch.stack(per_rank, 1).flatten(0, 2)


def first_loss(cfg) -> float:
    """The expected first loss of a model from ``Llama.init_weights``:
    its head's normal(0.02) rows on unit-RMS hidden states give logits of
    variance 0.02**2 * dim, and a cross entropy of ln(vocab) plus half
    that (11.19 at llama2-7b's dim 4096, 10.58 at llama-400m's 1024)."""
    return math.log(cfg.vocab_size) + 0.5 * 0.02**2 * cfg.dim


def flips(got: dict, want: dict) -> list:
    """Per layer, the share of (token, rank) routes whose expert differs."""
    return [(got[i] != want[i]).float().mean().item() for i in sorted(want)]


def stats_rel(got: dict, want: dict) -> tuple:
    """(buffer, relative L2) of the buffer that differs most."""
    rels = {k: ((got[k] - w).norm() / w.norm()).item() for k, w in want.items()}
    worst = max(rels, key=rels.get)
    return worst, rels[worst]


def check_row(plan: Plan, row: dict, refs: dict) -> list:
    """The row's failures (empty when it passed); prints its line."""
    fails = []
    ranks = row["ranks"]
    peak = max(r["peak_bytes"] for r in ranks)
    per_card = row["tokens_per_s"] / plan.procs
    mfu = 0.0
    if plan.device == "cuda":
        mfu = per_card * row["flops_per_token"] / (peak_tflops() * 1e12)
    losses = row["losses"]
    what = f"{row['name']} mesh {row.get('mesh')}"
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"{what}: non-finite loss {losses}")
    ref = refs.get(row.get("ref"))
    worst = None
    if ref is not None:
        tol = cs.LOSS_TOL
        worst = max(cs.rel(a, b) for a, b in zip(losses, ref["losses"]))
        if row.get("ref") in ("moe", "moe_long"):
            first = cs.rel(losses[0], ref["losses"][0])
            later = max(cs.rel(a, b) for a, b in zip(losses[1:], ref["losses"][1:]))
            ok = first <= cs.LOSS_TOL and later <= cs.PARITY_TOL["loss"]
            tol = f"{cs.LOSS_TOL} first, {cs.PARITY_TOL['loss']} later"
        else:
            ok = worst <= cs.LOSS_TOL
        if len(losses) != len(ref["losses"]) or not ok:
            fails.append(f"{what}: losses {losses} against one card's {ref['losses']}")
        log(f"[n] {what}: losses {losses} against one card {ref['losses']}: worst rel "
            f"{worst:.3e} (tol {tol})")
    if "twin" in row:
        worst_twin = max(cs.rel(a, b) for a, b in zip(losses, row["twin"]))
        log(f"[n] {what}: losses {losses} against the {row['same_as']} row's {row['twin']}: "
            f"worst rel {worst_twin:.3e} (tol {cs.LOSS_TOL}), bit-equal {losses == row['twin']}")
        if len(losses) != len(row["twin"]) or not worst_twin <= cs.LOSS_TOL or (
                row.get("bit_equal") and losses != row["twin"]):
            fails.append(f"{what}: losses {losses} against the {row['same_as']} row's "
                         f"{row['twin']}")
    if row.get("replicas") is not None:
        log(f"[n] {what}: parameters whose shard differs from its replica's across the "
            f"replicate dim: {row['replicas']} (must be 0)")
        if row["replicas"]:
            fails.append(f"{what}: {row['replicas']} parameters differ between replicas")
    if "stats_rel" in row:
        name, value = row["stats_rel"]
        log(f"[n] {what}: rank 0's running statistics after {len(losses)} steps against one "
            f"card's: worst rel L2 {value:.3e} at {name} (tol {RESNET_STATS_TOL})")
        if value > RESNET_STATS_TOL:
            fails.append(f"{what}: running statistics rel L2 {value} at {name}")
    if "routes" in row:
        log(f"[n] {what}: share of first-forward routes whose expert differs from one card's, "
            f"per layer {row['routes']}")
    if "first_loss_target" in row:
        off = abs(losses[0] - row["first_loss_target"])
        log(f"[n] {what}: first loss {losses[0]:.4f}, {off:.4f} from the init's expected "
            f"{row['first_loss_target']:.4f} (ln(vocab) plus half the logits' variance)")
        if off > 0.5:
            fails.append(f"{what}: first loss {losses[0]} is far from "
                         f"{row['first_loss_target']}")
    launches = ranks[0]["launches"]
    every = [r["launches"] for r in ranks]
    shown = f"{launches} (every rank)" if every.count(launches) == len(every) else every
    a2a = [r["all_to_all"] for r in ranks]
    unit = row.get("unit", "tokens")
    log(f"[n] {what}: step {row['step_s']:.4f} s, {unit}/s {row['tokens_per_s']:.1f} "
        f"({per_card:.1f} a card), MFU {mfu:.4f}; peak memory of the fullest card "
        f"{peak / 1e9:.3f} GB; launches a step a card {shown}; all-to-alls a step a "
        f"card {a2a}")
    if row.get("a2a_expected") and not all(n > 0 for n in a2a):
        fails.append(f"{what}: no all-to-all ran")
    if plan.device == "cuda" and row.get("kernels") and not launches:
        fails.append(f"{what}: no kernel launched")
    if "reckoned_bytes" in row:
        log(f"[n] {what}: peak {peak / 1e9:.3f} GB a card against the reckoned "
            f"{row['reckoned_bytes']} bytes")
    if "restore_equal" in row and not row["dcp_ok"]:
        fails.append(f"{what}: restore {row['restore']}, byte-equal {row['restore_equal']}, "
                     f"losses {losses} against {row['resumed_against']}")
    for t in row.get("trace", []):
        log(f"[n] {what}: traced steps 1-2, a card: window {t['window_ms']:.2f} ms a step, "
            f"compute kernels busy {t['busy_ms']:.2f} ms (idle share {t['idle_share']}); "
            f"NCCL kernels ms a step {t['nccl_ms']}")
    expected = [(i, r) for i, r in enumerate(ranks) if r.get("expect")]
    for i, r in expected:
        keys = r["expect"] if plan.device == "cuda" else ("ppermute",)
        got = {k: r["ppermute"] if k == "ppermute" else r["launches"].get(k, 0) for k in keys}
        want = {k: r["expect"][k] for k in keys}
        log(f"[n] {what}: rank {i} launches and permutes a step {got}, the layout implies "
            f"{want}")
        if got != want:
            fails.append(f"{what}: rank {i} launches and permutes a step {got}, want {want}")
    for i, t in enumerate(row.get("trace", []) if expected else []):
        log(f"[n] {what}: rank {i} traced steps 1-2: the port's kernels {t['ours']}; torch's "
            f"attention kernels {t['sdpa']}")
        if t["sdpa"] or (plan.device == "cuda" and not all(
                t["ours"][k] for k in ("flash_fwd", "flash_dq", "flash_dkv"))):
            fails.append(f"{what}: rank {i}'s trace: torch's attention {t['sdpa']}, the port's "
                         f"kernels {t['ours']}")
    if "a2a_ms" in row:
        shares = [round(m / t["window_ms"], 4) if t["window_ms"] else None
                  for m, t in zip(row["a2a_ms"], row["trace"])]
        log(f"[n] {what}: all-to-all device ms a step a card {row['a2a_ms']} ({shares} of "
            f"the traced step); one all-to-all of the dispatch's shape alone, ms a card "
            f"{row['a2a_alone_ms']}")
    row.update(per_card_tokens_per_s=per_card, mfu=mfu, peak_bytes=peak, worst_rel=worst)
    return fails


def peak_tflops() -> float:
    """The card's dense bf16 peak, from its name (``device.peak_for``)."""
    from tf_operator_tpu_torch.device import peak_for

    return peak_for(torch.cuda.get_device_name(0))[0].bf16_tflops


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="multicard_smoke")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--procs", type=int, default=0, help="CPU rehearsal: processes")
    parser.add_argument("--out", default="")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--tmp", default="")
    parser.add_argument("--tokens", default="")
    parser.add_argument("--train", nargs=argparse.REMAINDER,
                        help="a child of the launch row: llama_train's arguments")
    args = parser.parse_args(argv)
    if args.train is not None:
        return train_main(Plan.for_device(args.device, args.procs), args.train)
    if args.worker:
        return worker(Plan.for_device(args.device, args.procs), args.tmp, args.tokens)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multicard_smoke: CUDA is not available", file=sys.stderr)
            return 1
        procs = torch.cuda.device_count()
        if procs < 2:
            print(f"multicard_smoke: {procs} card visible, 2 or more needed", file=sys.stderr)
            return 1
        from tf_operator_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.load()
        log(f"[n] {cs.smi_line()}; {procs} cards; kernels built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        procs = args.procs
    plan = Plan.for_device(args.device, procs)
    fp32_on_cpu(plan)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        from tf_operator_tpu_torch.models import llama

        tokens = cs.seeded_tokens(tmp, vocab=llama.CONFIGS[plan.llama].vocab_size)
        refs = references(plan, tokens)
        one_card_stats = refs["resnet"].pop("stats")
        moe_routes = refs.pop("moe_routes")
        gc.collect()
        if plan.device == "cuda":
            torch.cuda.empty_cache()
        rows = spawn(plan, tmp, tokens)
        rows.append(launch_row(plan, tmp, tokens))
        slice_fails = slice_local_row(plan, tmp, tokens, refs)
        routes = torch.load(os.path.join(tmp, "routes.pt"))
        dp_stats = torch.load(os.path.join(tmp, "resnet_stats.pt"))
    fails = list(slice_fails)
    by_name = {row["name"]: row for row in rows}
    for row in rows:
        if "same_as" in row:
            row["twin"] = by_name[row["same_as"]]["losses"]
        if row["name"] in routes:
            row["routes"] = flips(routes[row["name"]], moe_routes)
        if row.get("ref") == "resnet":
            row["stats_rel"] = stats_rel(dp_stats, one_card_stats)
        fails += check_row(plan, row, refs)
    for f in fails:
        log(f"[n] FAIL {f}")
    summary = {"ok": not fails, "cards": procs, "seconds": time.perf_counter() - t_start,
               "references": refs, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    log(json.dumps({"ok": not fails, "cards": procs, "rows": [
        {k: row.get(k) for k in ("name", "mesh", "losses", "step_s", "per_card_tokens_per_s",
                                 "mfu", "peak_bytes", "worst_rel", "routes", "a2a_ms",
                                 "a2a_alone_ms", "restore_equal", "ppermute", "stats_rel",
                                 "replicas")}
        for row in rows]}))
    return 0 if not fails else 1


# ------------------------------------------------------------- the workers
def worker(plan: Plan, tmp: str, tokens: str) -> int:
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.parallel.mesh import mesh_axes
    from tf_operator_tpu_torch.parallel.sharding import data_parallel_group
    from tf_operator_tpu_torch.runtime import gpu_init

    fp32_on_cpu(plan)
    gpu_init.initialize(device=plan.device, timeout_seconds=COLLECTIVE_TIMEOUT)
    rank, n = dist.get_rank(), dist.get_world_size()
    rows, routes = [], {}

    def gather(row: dict, name: str, **extra) -> None:
        """Every rank's counters beside rank 0's row."""
        mine = {k: row.get(k) for k in ("launches", "all_to_all", "ppermute", "peak_bytes",
                                        "expect")}
        ranks = [None] * n
        dist.all_gather_object(ranks, mine)
        row.update(name=name, ranks=ranks, **extra)
        rows.append(row)
        log(f"[n] rank {rank}: {name} done: losses {row['losses']}")

    def layout(name: str, spec, argv: list, ref=None, moe=False, expect=None,
               **extra) -> dict:
        if spec is None:
            os.environ.pop("JAX_MESH_SPEC", None)
        else:
            os.environ["JAX_MESH_SPEC"] = json.dumps(spec)
        mine = {} if moe else None
        row = train_llama(plan, argv, mine)
        row["expect"] = expect
        if moe:
            # Every data rank's routes of its rows, in the one-card batch's
            # row order: the token file deals row j to data rank j mod N.
            all_routes = [None] * n
            dist.all_gather_object(all_routes, (row["data_rank"], mine))
            ordered = [r for _, r in sorted(all_routes, key=lambda x: x[0])]
            routes[name] = {i: interleave([r[i] for r in ordered], plan.rows)
                            for i in ordered[0]}
        a2a = extra.pop("a2a_expected", moe and "tp" not in (spec or {}))
        gather(row, name, ref=ref, kernels=True, a2a_expected=a2a, **extra)
        return row

    half = n // 2
    seven_b = ["--batch", str(plan.rows * n), "--seq", str(plan.seq), "--log-every", "100",
               "--warmup", "1", "--steps", "3", "--device", plan.device]
    row = layout("llama2-7b default", None, seven_b)
    row["first_loss_target"] = first_loss(llama.CONFIGS[row["model"]])
    row["reckoned_bytes"] = LLAMA2_7B_RECKONED.get(n) if plan.device == "cuda" else None
    dense = layout(f"{plan.llama} fsdp={n}", {"fsdp": n}, llama_args(plan, plan.llama, tokens),
                   ref="llama")
    layout(f"{plan.llama} fsdp={half} x tp=2", {"fsdp": half, "tp": 2},
           llama_args(plan, plan.llama, tokens), ref="llama")
    # The multislice layout, HSDP: replicated over slice (or dp), sharded
    # over fsdp inside each half of the cards.
    for spec in ({"slice": 2, "fsdp": half}, {"dp": 2, "fsdp": half}):
        layout(f"{plan.llama} " + " x ".join(f"{a}={k}" for a, k in spec.items()), spec,
               llama_args(plan, plan.llama, tokens), ref="llama")
    moe_args = llama_args(plan, plan.moe, tokens)
    ep = layout(f"{plan.moe} ep={n}", {"ep": n}, moe_args, ref="moe", moe=True)
    layout(f"{plan.moe} fsdp={n}", {"fsdp": n}, moe_args, ref="moe", moe=True)
    layout(f"{plan.moe} ep=2 x fsdp={half}", {"fsdp": half, "ep": 2}, moe_args, ref="moe",
           moe=True)

    # Where the time goes: the ep=N and fsdp=N runs again, traced at
    # steps 1-2 by the entry point's profiler window.
    for row, spec, model in ((ep, {"ep": n}, plan.moe), (dense, {"fsdp": n}, plan.llama)):
        os.environ["JAX_MESH_SPEC"] = json.dumps(spec)
        mine = traced(plan, os.path.join(tmp, f"profile-{model}-{rank}"),
                      llama_args(plan, model, tokens))
        row["trace"] = [None] * n
        dist.all_gather_object(row["trace"], mine)
        log(f"[n] rank {rank}: {row['name']} traced: {mine}")
    ep["a2a_ms"] = [sum(ms for k, ms in t["nccl_ms"].items() if any(a in k for a in NCCL_A2A))
                    for t in ep["trace"]]
    ep["a2a_alone_ms"] = a2a_alone(plan, n)

    # BERT data parallel over dp=N, and over fsdp=N/2 x tp=2: data
    # parallel over the whole world there too, as the JAX example is.
    from tf_operator_tpu_torch.models import bert

    for spec in ({"dp": n}, {"fsdp": half, "tp": 2}):
        os.environ["JAX_MESH_SPEC"] = json.dumps(spec)
        mesh = gpu_init.global_mesh(device=plan.device)
        group, size = data_parallel_group(bert.CONFIGS[plan.bert], mesh)
        name = f"{plan.bert} " + " x ".join(f"{a}={k}" for a, k in spec.items())
        twin = {} if "dp" in spec else {"same_as": f"{plan.bert} dp={n}", "bit_equal": True}
        gather(train_bert(plan, group, rank, size), name, mesh=mesh_axes(mesh), ref="bert",
               kernels=True, **twin)

    dcp_row(plan, tokens, tmp, ep, rows, gather, n)
    if n == 4:
        sequence_and_pipeline_rows(plan, tokens, tmp, layout, rows, rank)
    else:
        log(f"[n] the sp and pp rows need 4 cards; {n} here")

    # resnet50 data parallel over the world, global-batch BatchNorm.
    row = train_resnet(plan, distributed=True)
    stats = row.pop("stats")
    gather(row, f"{plan.resnet} dp={n}", mesh={"dp": n}, ref="resnet")
    if rank == 0:
        with open(os.path.join(tmp, "rows.json"), "w") as f:
            json.dump(rows, f)
        torch.save(routes, os.path.join(tmp, "routes.pt"))
        torch.save(stats, os.path.join(tmp, "resnet_stats.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# Kernel names of torch's own attention (scaled_dot_product_attention's
# flash, memory-efficient and cuDNN back ends): none may run in a ring row.
SDPA_MARKS = ("pytorch_flash", "fmha", "sdpa", "efficient_attention")


def ring_expect(layers: int, n: int, r: int, policy: str = "dots") -> dict:
    """Launches and permutes a step on ring rank r of n under a "dots"
    policy: r + 1 flash forwards a layer (the skipped blocks launch
    nothing), as many dQ and dK/dV, 6 ropes (forward, replay, backward; q
    and k; 4 where the policy keeps the rotated q and k, "+rope"), and
    n - 1 K/V rotations forward and n - 1 backward (the tape serves the
    replay's)."""
    ropes = 4 if "rope" in policy.split("+") else 6
    return {"flash_fwd": layers * (r + 1), "flash_dq": layers * (r + 1),
            "flash_dkv": layers * (r + 1), "rope": ropes * layers,
            "ppermute": 2 * (n - 1) * layers}


def pipe_expect(layers: int, pp: int, m: int, stage: int) -> dict:
    """Launches and permutes a step on pipeline stage ``stage``: each of
    its layers runs once a tick computed (T = M + pp - 1 ticks on the last
    stage, T - 1 on the others) forward, dQ and dK/dV; T - 1 permutes
    forward and as many backward."""
    ticks = m + pp - 1
    computed = (ticks if stage == pp - 1 else ticks - 1) * layers // pp
    return {"flash_fwd": computed, "flash_dq": computed, "flash_dkv": computed,
            "ppermute": 2 * (ticks - 1)}


def sequence_and_pipeline_rows(plan: Plan, tokens: str, tmp: str, layout, rows: list,
                               rank: int) -> None:
    """The sp rows (llama at ``plan.long_seq``, ring attention) and the pp
    rows (llama at ``plan.seq``, the GPipe pipeline) on 4 cards, each with
    every rank's expected launches and permutes; the sp=4 run again,
    traced, for the kernels' names."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.parallel.sharding import resolve_expert_axis

    cfg = llama.CONFIGS[plan.llama]
    long_args = llama_args(plan, plan.llama, tokens, long=True)
    ring = []
    for spec in ({"sp": 4}, {"sp": 2, "fsdp": 2}, {"sp": 2, "tp": 2}):
        r = (rank // spec.get("tp", 1)) % spec["sp"]  # sp is outside tp, inside fsdp
        ring.append(layout(f"{plan.llama} seq {plan.long_seq} " + " x ".join(
            f"{a}={k}" for a, k in spec.items()), spec, long_args, ref="llama_long",
            expect=ring_expect(cfg.n_layers, spec["sp"], r)))
    os.environ["JAX_MESH_SPEC"] = json.dumps({"sp": 4})
    mine = traced(plan, os.path.join(tmp, f"profile-ring-{rank}"), long_args)
    row = ring[0]
    row["trace"] = [None] * 4
    dist.all_gather_object(row["trace"], mine)
    # MoE over sp: the ring's blocks and the experts on each rank's own
    # slots, the aux loss's statistics summed over sp.
    moe = llama.CONFIGS[plan.moe]
    moe_args = llama_args(plan, plan.moe, tokens, long=True)
    for spec in ({"sp": 4}, {"sp": 2, "ep": 2}):
        r = rank % spec["sp"]  # sp is the innermost axis here
        layout(f"{plan.moe} seq {plan.long_seq} " + " x ".join(
            f"{a}={k}" for a, k in spec.items()), spec, moe_args, ref="moe_long",
            expect=ring_expect(moe.n_layers, spec["sp"], r, moe.remat_policy),
            a2a_expected=resolve_expert_axis(spec, moe.n_experts) is not None)
    base = cfg
    for spec, m in (({"pp": 4}, 4), ({"pp": 4}, 8), ({"pp": 2, "fsdp": 2}, 0),
                    ({"pp": 2, "tp": 2}, 0)):
        pp = spec["pp"]
        stage = rank * pp // 4  # pp is the outermost axis
        llama.CONFIGS[plan.llama] = dataclasses.replace(base, pp_microbatches=m)
        try:
            layout(f"{plan.llama} " + " x ".join(f"{a}={k}" for a, k in spec.items())
                   + f" M={m or pp}", spec, llama_args(plan, plan.llama, tokens), ref="llama",
                   expect=pipe_expect(base.n_layers, pp, m or pp, stage))
        finally:
            llama.CONFIGS[plan.llama] = base


def traced(plan: Plan, prof: str, argv: list) -> dict:
    """A llama_train run traced at steps 1-2 (``TPU_PROFILE_*``): per step,
    the window's ms (first kernel's start to last kernel's end), the
    busy ms of every kernel but NCCL's (the union of their intervals),
    the idle share that leaves, and the NCCL kernels' ms by name (their
    time includes waiting for the slowest peer); the names of any kernel
    of torch's own attention, and the launches of each of the port's
    kernels in the two steps."""
    os.environ.update(TPU_PROFILE_DIR=prof, TPU_PROFILE_START_STEP="1",
                      TPU_PROFILE_NUM_STEPS="2")
    try:
        train_llama(plan, argv)
    finally:
        for key in ("TPU_PROFILE_DIR", "TPU_PROFILE_START_STEP", "TPU_PROFILE_NUM_STEPS"):
            os.environ.pop(key)
    (trace,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    kernels = [e for e in cs.read_json(trace)["traceEvents"] if e.get("cat") == "kernel"]
    if not kernels:
        return {"window_ms": 0.0, "busy_ms": 0.0, "idle_share": None, "nccl_ms": {},
                "sdpa": [], "ours": {}}
    sdpa = sorted({e["name"] for e in kernels if any(m in e["name"] for m in SDPA_MARKS)})
    ours = {name: sum(sym in e["name"] and not any(m in e["name"] for m in SDPA_MARKS)
                      for e in kernels) for name, sym in cs.KERNEL_SYMBOLS.items()}
    nccl, busy, end = {}, 0.0, -math.inf
    for e in sorted(kernels, key=lambda e: e["ts"]):
        if e["name"].startswith("nccl"):
            nccl[e["name"]] = nccl.get(e["name"], 0.0) + e["dur"] / 2e3
            continue
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    window = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 2e3
    return {"window_ms": window, "busy_ms": busy / 2e3, "idle_share": 1 - busy / 2e3 / window,
            "nccl_ms": nccl, "sdpa": sdpa, "ours": ours}


def a2a_alone(plan: Plan, n: int) -> list:
    """Every rank's ms of one all-to-all of the ep=N dispatch's shape
    ([e, b * s / group, cap, d] of moe-125m at 8 rows) alone, by CUDA
    events around 20 calls after a barrier; None on the CPU."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import llama

    if plan.device != "cuda":
        return [None] * n
    cfg = llama.CONFIGS[plan.moe]
    groups = plan.rows * plan.seq // cfg.moe_group_size
    cap = int(cfg.capacity_factor * cfg.moe_group_size * cfg.experts_per_token / cfg.n_experts)
    x = torch.randn(cfg.n_experts, groups, cap, cfg.dim, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(x)
    for _ in range(3):
        dist.all_to_all_single(out, x)
    dist.barrier()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        dist.all_to_all_single(out, x)
    end.record()
    torch.cuda.synchronize()
    ms = [None] * n
    dist.all_gather_object(ms, start.elapsed_time(end) / 20)
    return ms


def dcp_row(plan: Plan, tokens: str, tmp: str, ep: dict, rows: list, gather, n: int) -> None:
    """moe over ep=N: 2 steps, a DCP save, a restore into a new setup
    (byte-equal on every rank) and 2 steps resumed: the ep=N run's
    losses of steps 2-3."""
    import torch.distributed as dist

    from tf_operator_tpu_torch.runtime.shard_server import flatten_state
    from tf_operator_tpu_torch.train import llama_train

    os.environ["JAX_MESH_SPEC"] = json.dumps({"ep": n})
    ckpt = os.path.join(tmp, "ckpt")
    argv = llama_args(plan, plan.moe, tokens) + ["--checkpoint-dir", ckpt]
    reset(plan)
    s = llama_train.setup(llama_train.parse_args(argv))
    state, first = s.state, []
    for _ in range(2):
        state, loss = s.step_fn(state, next(s.batches))
        first.append(loss.item())
    t0 = time.perf_counter()
    s.ckpt.save(state, force=True)
    blocked = time.perf_counter() - t0
    s.ckpt.close()
    persist = s.ckpt.last_persist_seconds
    saved = {k: v.detach().clone() for k, v in flatten_state(state).items()}
    del s, state
    reset(plan)
    t1 = time.perf_counter()
    r = llama_train.setup(llama_train.parse_args(argv))
    restore_s = time.perf_counter() - t1
    mine = cs.bits_equal(flatten_state(r.state), saved)
    equal = [None] * n
    dist.all_gather_object(equal, mine)
    outcome = (r.restore.path, r.restore.cause, r.restore.step)
    out = llama_train.run(llama_train.parse_args(argv), r)
    row = {"model": plan.moe, "losses": first + out["losses"], "mesh": out["mesh"],
           "step_s": out["window_seconds"] / max(out["window_steps"], 1),
           "flops_per_token": out["config"].flops_per_token(plan.seq), **counters(plan, 2)}
    row["tokens_per_s"] = out["tokens_per_step"] / row["step_s"]
    log(f"[n] rank {dist.get_rank()}: DCP save blocked {blocked:.3f} s, persist "
        f"{persist:.3f} s; restore {outcome} in {restore_s:.3f} s (setup included), "
        f"byte-equal {mine}")
    gather(row, f"{plan.moe} ep={n} DCP resume", restore_equal=equal, restore=outcome,
           resumed_against=ep["losses"])
    ok = all(equal) and outcome == ("storage", "ok", 2)
    worst = max(cs.rel(a, b) for a, b in zip(row["losses"], ep["losses"]))
    row["dcp_ok"] = ok and worst <= cs.LOSS_TOL
    if dist.get_rank() == 0:
        log(f"[n] DCP resume: losses {row['losses']} against the ep={n} run's {ep['losses']}: "
            f"worst rel {worst:.3e}; restore {outcome}, byte-equal on every rank {equal}")


if __name__ == "__main__":
    sys.exit(main())
