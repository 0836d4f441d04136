"""The port's recovery plane, head to head: the twin of
``scripts/measure_control_plane.py --mode recovery`` (``recovery_main``) on
a torch train state, through the port's ``CheckpointManager``,
``start_shard_server`` and ``restore_with_fallback``.

    python3 scripts/measure_recovery_torch.py [--trials 3] [--smoke]
    python3 scripts/measure_recovery_torch.py --device cpu --smoke [--baseline FILE]

By default on the card, at llama-400m's train state at full width and
depth (2.24 GB): its bf16 parameters from the model's seeded init and its
AdamW moments, in the parameters' dtype as the port (and optax) keeps
them, drawn from a seeded generator, at step 7. ``--device cpu`` uses
llama-tiny's (``SETTINGS``). The legs, each as the JAX script's:

- A: storage against peer restore of one durable checkpoint, byte-equal
  both ways; storage also against the same modelled remote read
  (``RECOVERY_REMOTE_*``: each stored object one round trip, its bytes at
  a sustained object-store rate);
- B: the seeded fault ladder (a peer down mid-fetch, a truncated shard, a
  stale snapshot), each ending on storage at the durable step, replayed
  byte-identically;
- C: operator-side peer discovery exercises the operator alone, which the
  port does not replace: it stays in the JAX script (said in the output);
- D: kill, restart, first step resumed: ``python -m tf_operator_tpu_torch.
  train.llama_train`` in a fresh interpreter on a copy of the checkpoint,
  once from storage and once from the live peer, timed from its spawn to
  its first resumed step's line;
- E: scatter-gather from two survivors against the whole state from one,
  each charged its served bytes at ``RECOVERY_PEER_NIC_BPS``. On the CPU
  it runs on a state of its own (:func:`wide_sharded_leg`), larger than
  the JAX script's 48 MB;
- F: the sharded fault ladder (die-mid-transfer, stale-manifest,
  partial-owner), replayed byte-identically;
- G: a warm start restores from live peers with zero storage reads;
- H: delta persists (four layers changed) against a full persist, and the
  have-list pull of a survivor that holds the previous step against a
  cold pull, each byte-equal.

Every restore prints its seconds split (``RestoreOutcome.split``) and
every persist its own (``last_persist_info["split"]``). ``--smoke``
applies the JAX script's gates and ratchets against the last green run in
``build/recovery_torch_smoke_last.json`` (or ``--baseline``). The last line is one JSON
object; a device run names its card, and its nvidia-smi line comes
before it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BASELINE_PATH = os.path.join(ROOT, "build", "recovery_torch_smoke_last.json")
RECOVERY_STEP = 7
RECOVERY_TRIALS = 3
# Per device: the state's model, and leg D's batch and sequence (phase e's
# on the card).
SETTINGS = {"cuda": ("llama-400m", 8, 2048), "cpu": ("llama-tiny", 2, 32)}
# The JAX script's models (measure_control_plane.py): a stored object's
# remote-GET round trip and a single-stream object-store read rate; a
# serving peer's NIC; the ratchet's tolerance; the delta legs' ceiling.
RECOVERY_REMOTE_RTT_S = 0.015
RECOVERY_REMOTE_BW_BPS = 250e6
RECOVERY_PEER_NIC_BPS = 200e6
RECOVERY_REGRESSION = 2.0
RECOVERY_DELTA_CHANGED_LAYERS = 4
RECOVERY_DELTA_MAX_FRACTION = 0.5
FAULT_SCENARIOS = (
    ("peer-down-mid-fetch", {"kind": "refuse", "op": "shard", "at_call": 1, "count": 999},
     "peer-unreachable"),
    ("truncated-shard", {"kind": "truncate", "op": "shard-body", "at_call": 1, "count": 1},
     "checksum-mismatch"),
    ("stale-snapshot", {"kind": "stale-meta", "op": "meta-body", "at_call": 1, "count": 1},
     "stale-snapshot"),
)
SHARDED_FAULT_SCENARIOS = (
    ("die-mid-transfer", {"kind": "die-mid-transfer", "op": "shard", "peer": 0, "at_call": 1},
     ("peer-sharded", "ok")),
    ("stale-manifest", {"kind": "stale-manifest", "op": "manifest-body", "at_call": 1,
                        "count": 2}, ("storage", "stale-snapshot")),
    ("partial-owner", {"kind": "partial-owner", "op": "manifest-body", "at_call": 1,
                       "count": 2}, ("peer-sharded", "ok")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def rounded(split) -> dict:
    return {k: round(v, 4) for k, v in (split or {}).items()}


def make_state(config, device: str, step: int, seed: int):
    """A train state of the llama ``config`` on ``device``: the seeded
    init's parameters and seeded moments, at ``step``."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.train_step import init_train_state, make_optimizer

    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(llama.Llama(config, device=device, generator=gen),
                             make_optimizer())
    with torch.no_grad():
        for mu, nu in zip(state.opt_state.mu, state.opt_state.nu):
            mu.copy_(torch.randn(mu.shape, generator=gen, device=device))
            nu.copy_(torch.randn(nu.shape, generator=gen, device=device).abs_())
    state.step = state.opt_state.count = step
    return state


def fingerprint(state) -> dict:
    """{shard: its bytes on the host}: what byte equality compares."""
    from tf_operator_tpu_torch.runtime.shard_server import flatten_state

    return {name: t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).clone()
            for name, t in flatten_state(state).items()}


def equal(state, saved: dict) -> bool:
    got = fingerprint(state)
    return got.keys() == saved.keys() and all(torch.equal(got[n], saved[n]) for n in got)


def load(state, saved: dict) -> None:
    """Write ``fingerprint`` bytes back into a state of the same shapes."""
    from tf_operator_tpu_torch.runtime.shard_server import flatten_state

    with torch.no_grad():
        for name, t in flatten_state(state).items():
            if t.dim():
                t.reshape(-1).view(torch.uint8).copy_(saved[name])


def blank(state) -> None:
    """Zero a state in place (the restores' target)."""
    from tf_operator_tpu_torch.runtime.shard_server import flatten_state

    with torch.no_grad():
        for t in flatten_state(state).values():
            if t.dim():
                t.zero_()
    state.step = state.opt_state.count = 0


def outcome_row(o) -> dict:
    return {"path": o.path, "cause": o.cause, "step": o.step, "seconds": round(o.seconds, 4),
            "split": rounded(o.split), "bytes_moved": o.bytes_moved}


def wait_meta(address: str) -> None:
    """Until the server's snapshot view is built (the durability hook
    warms it; a survivor's steady state)."""
    from tf_operator_tpu_torch.train.restore import http_fetch

    for _ in range(600):
        try:
            if http_fetch(address, "/v1/meta", 30.0)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.05)
    raise RuntimeError(f"{address} served no snapshot")


def storage_objects(ckpt_dir: str, step: int) -> tuple:
    """(objects, bytes) the storage restore of ``step`` reads: its
    manifest and every payload it references."""
    path = os.path.join(ckpt_dir, "delta", f"manifest-{step}.json")
    with open(path) as f:
        manifest = json.load(f)
    return 1 + len(manifest["shards"]), os.path.getsize(path) + sum(
        e["bytes"] for e in manifest["shards"].values())


# ------------------------------------------------------------------ the legs
def latency_leg(saved, fresh, ckpt_dir, server, trials, regressions) -> dict:
    """Leg A: storage against peer on one durable checkpoint."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.restore import restore_with_fallback

    wait_meta(server.address)
    storage, peer = [], []
    mgr = CheckpointManager(ckpt_dir)
    try:
        for trial in range(trials):
            blank(fresh)
            o_storage = restore_with_fallback(fresh, mgr, [])
            ok_storage = trial or equal(fresh, saved)
            blank(fresh)
            o_peer = restore_with_fallback(fresh, mgr, [server.address])
            ok_peer = trial or equal(fresh, saved)
            storage.append(o_storage)
            peer.append(o_peer)
            if (o_storage.path, o_storage.step) != ("storage", RECOVERY_STEP) or not ok_storage:
                regressions.append(f"storage restore landed on {o_storage.path}/"
                                   f"{o_storage.step} (byte-equal {ok_storage})")
            if (o_peer.path, o_peer.cause, o_peer.step) != ("peer", "ok", RECOVERY_STEP) \
                    or not ok_peer:
                regressions.append(f"peer restore landed on {o_peer.path}/{o_peer.cause}/"
                                   f"{o_peer.step} (byte-equal {ok_peer})")
    finally:
        mgr.close()
    objects, nbytes = storage_objects(ckpt_dir, RECOVERY_STEP)
    raw = statistics.median(o.seconds for o in storage)
    penalty = objects * RECOVERY_REMOTE_RTT_S + nbytes / RECOVERY_REMOTE_BW_BPS
    return {"storage_raw_s": round(raw, 4), "storage_modeled_s": round(raw + penalty, 4),
            "storage_objects": objects, "storage_bytes": nbytes,
            "remote_model": {"rtt_s": RECOVERY_REMOTE_RTT_S, "bw_bps": RECOVERY_REMOTE_BW_BPS},
            "peer_s": round(statistics.median(o.seconds for o in peer), 4), "trials": trials,
            "storage": [outcome_row(o) for o in storage], "peer": [outcome_row(o) for o in peer]}


def replay(fresh, mgr, addrs, fault_kwargs, sharded=False):
    """One seeded scenario twice: (outcomes, fault logs)."""
    from tf_operator_tpu_torch.testing.restore_faults import (
        RestoreFaultInjector,
        ScheduledRestoreFault,
    )
    from tf_operator_tpu_torch.train.restore import restore_with_fallback

    outcomes, logs = [], []
    for _ in range(2):
        injector = RestoreFaultInjector((ScheduledRestoreFault(**fault_kwargs),))
        blank(fresh)
        outcomes.append(restore_with_fallback(fresh, mgr, addrs, sharded=sharded,
                                              fault_injector=injector,
                                              sleep=lambda _s: None))
        logs.append(list(injector.fault_log))
    return outcomes, logs


def fault_leg(fresh, ckpt_dir, server, regressions) -> list:
    """Leg B: the seeded ladder, each scenario ending on storage."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    results = []
    mgr = CheckpointManager(ckpt_dir)
    try:
        for label, kwargs, want in FAULT_SCENARIOS:
            outcomes, logs = replay(fresh, mgr, [server.address], kwargs)
            o = outcomes[-1]
            if (o.path, o.cause, o.step) != ("storage", want, RECOVERY_STEP):
                regressions.append(f"fault scenario {label}: got {o.path}/{o.cause}/{o.step}, "
                                   f"wanted storage/{want}/{RECOVERY_STEP}")
            if logs[0] != logs[1]:
                regressions.append(f"fault scenario {label}: seeded replay diverged")
            if not logs[0]:
                regressions.append(f"fault scenario {label}: no fault fired")
            results.append({"scenario": label, "fault_log": logs[0], **outcome_row(o)})
    finally:
        mgr.close()
    return results


def restart_leg(device: str, ckpt_dir, workdir, peer_address, regressions) -> dict:
    """Leg D: a fresh interpreter runs the entry point on a copy of the
    checkpoint (hard links: its own saves replace files, never write into
    them) to its first resumed step, from storage and from the peer."""
    model, batch, seq = SETTINGS[device]
    child_args = ["--device", device, "--model", model, "--steps", str(RECOVERY_STEP + 1),
                  "--batch", str(batch), "--seq", str(seq), "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"

    def one(label: str, peers: str) -> dict:
        copy = os.path.join(workdir, f"restart-{label}")
        shutil.copytree(ckpt_dir, copy, copy_function=os.link)
        run_env = {**env, "TPU_PEER_RESTORE_ADDRS": peers}
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", *child_args,
             "--checkpoint-dir", copy], cwd=ROOT, env=run_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        resumed_at = None
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if resumed_at is None and line.startswith(f"[llama] step {RECOVERY_STEP} "):
                    resumed_at = time.perf_counter() - t0
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        text = "".join(lines)
        done = [json.loads(line[len("[llama] done "):]) for line in lines
                if line.startswith("[llama] done ")]
        if proc.returncode != 0 or not done or resumed_at is None:
            regressions.append(f"restart {label} child exited {proc.returncode}: "
                               f"{text[-2000:]}")
            return {}
        restore = done[0]["restore"]
        if (restore["path"], restore["step"]) != (label, RECOVERY_STEP):
            regressions.append(f"restart {label} resumed via {restore['path']} at step "
                               f"{restore['step']}, wanted {label}/{RECOVERY_STEP}")
        return {"restart_to_resumed_s": round(resumed_at, 3),
                "restore_s": round(restore["seconds"], 4), "path": restore["path"],
                "cause": restore["cause"], "split": rounded(restore["split"]),
                "process_s": round(time.perf_counter() - t0, 3)}

    runs = (("storage", ""), ("peer", peer_address))
    if device == "cpu":
        # Side by side, a core each: the CPU smoke stays inside its time.
        # On the card one after the other, each with the card to itself.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(runs)) as pool:
            storage, peer = pool.map(lambda run: one(*run), runs)
    else:
        storage, peer = (one(*run) for run in runs)
    return {"storage": storage, "peer": peer}


def sharded_leg(saved, fresh, ckpt_dir, servers, trials, regressions) -> dict:
    """Leg E: scatter-gather from two survivors against one survivor."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.restore import http_fetch, restore_with_fallback

    addrs = [s.address for s in servers]
    for a in addrs:
        wait_meta(a)
    meta = json.loads(http_fetch(addrs[0], "/v1/meta", 30.0)[2])
    shards = len(meta["shards"])
    total = sum(s["bytes"] for s in meta["shards"].values())
    single, sharded, share = [], [], 1.0
    mgr = CheckpointManager(ckpt_dir)
    try:
        for trial in range(trials):
            blank(fresh)
            single.append(restore_with_fallback(fresh, mgr, [addrs[0]]))
            blank(fresh)
            o = restore_with_fallback(fresh, mgr, addrs, sharded=True)
            sharded.append(o)
            if trial == 0:
                if (o.path, o.cause, o.step) != ("peer-sharded", "ok", RECOVERY_STEP) \
                        or not equal(fresh, saved):
                    regressions.append(f"sharded restore landed on {o.path}/{o.cause}/"
                                       f"{o.step}, or not byte-equal")
                if sorted(o.sources or {}) != sorted(addrs):
                    regressions.append(f"scatter-gather did not split: {o.sources}")
                else:
                    share = max(o.sources.values()) / max(shards, 1)
    finally:
        mgr.close()
    single_raw = statistics.median(o.seconds for o in single)
    sharded_raw = statistics.median(o.seconds for o in sharded)
    return {"single_survivor_raw_s": round(single_raw, 4),
            "single_survivor_s": round(single_raw + total / RECOVERY_PEER_NIC_BPS, 4),
            "sharded_raw_s": round(sharded_raw, 4),
            "sharded_restore_s": round(sharded_raw + share * total / RECOVERY_PEER_NIC_BPS, 4),
            "max_peer_share": round(share, 4), "shards": shards, "bytes": total,
            "nic_model_bps": RECOVERY_PEER_NIC_BPS, "trials": trials,
            "single": [outcome_row(o) for o in single],
            "sharded": [outcome_row(o) for o in sharded]}


def wide_sharded_leg(device: str, workdir, trials, regressions) -> dict:
    """Leg E on the CPU, on a state of its own: llama-400m's widths at one
    layer with llama-tiny's vocabulary (77 MB, above the JAX script's 48 MB
    of 24 layers of 512x512 fp32, two leaves each). At llama-tiny's 0.65 MB
    the second survivor's round trips cost more than the split saves of
    modelled NIC time."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.runtime.shard_server import start_shard_server
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    config = dataclasses.replace(llama.CONFIGS["llama-400m"], n_layers=1,
                                 vocab_size=llama.CONFIGS["llama-tiny"].vocab_size)
    state = make_state(config, device, RECOVERY_STEP, seed=2)
    fresh = copy.deepcopy(state)
    ckpt_dir = os.path.join(workdir, "wide-ckpt")
    mgr = CheckpointManager(ckpt_dir, model_meta=config.geometry())
    servers = [start_shard_server(mgr, slice_index=i, num_slices=2) for i in range(2)]
    try:
        mgr.save(state, force=True)
        mgr.wait()
        return {"state": "llama-400m's widths, 1 layer, vocabulary 256",
                **sharded_leg(fingerprint(state), fresh, ckpt_dir, servers, trials,
                              regressions)}
    finally:
        for server in servers:
            server.stop()
        mgr.close()


def sharded_fault_leg(fresh, ckpt_dir, servers, regressions) -> list:
    """Leg F: the sharded ladder's seeded faults."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    results = []
    mgr = CheckpointManager(ckpt_dir)
    try:
        for label, kwargs, want in SHARDED_FAULT_SCENARIOS:
            outcomes, logs = replay(fresh, mgr, [s.address for s in servers], kwargs,
                                    sharded=True)
            o = outcomes[-1]
            if (o.path, o.cause) != want or o.step != RECOVERY_STEP:
                regressions.append(f"sharded fault scenario {label}: got {o.path}/{o.cause}/"
                                   f"{o.step}, wanted {want[0]}/{want[1]}/{RECOVERY_STEP}")
            if logs[0] != logs[1]:
                regressions.append(f"sharded fault scenario {label}: seeded replay diverged")
            if not logs[0]:
                regressions.append(f"sharded fault scenario {label}: no fault fired")
            results.append({"scenario": label, "fault_log": logs[0], **outcome_row(o)})
    finally:
        mgr.close()
    return results


class StorageReadCounter:
    """A CheckpointManager proxy counting the ladder's storage reads."""

    def __init__(self, mgr):
        self._mgr = mgr
        self.storage_reads = 0

    def latest_step(self):
        self.storage_reads += 1
        return self._mgr.latest_step()

    def restore_latest(self, state):
        self.storage_reads += 1
        return self._mgr.restore_latest(state)

    def __getattr__(self, name):
        return getattr(self._mgr, name)


def warm_start_leg(saved, fresh, ckpt_dir, servers, regressions) -> dict:
    """Leg G: a warm-start restore reads nothing from storage."""
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.restore import restore_with_fallback

    mgr = CheckpointManager(ckpt_dir)
    counter = StorageReadCounter(mgr)
    try:
        blank(fresh)
        o = restore_with_fallback(fresh, counter, [s.address for s in servers], sharded=True,
                                  warm_start=True)
    finally:
        mgr.close()
    if (o.path, o.cause, o.step) != ("peer-sharded", "ok", RECOVERY_STEP) \
            or not equal(fresh, saved):
        regressions.append(f"warm start landed on {o.path}/{o.cause}/{o.step}, or not "
                           "byte-equal")
    if counter.storage_reads:
        regressions.append(f"warm start read storage {counter.storage_reads} times")
    return {"storage_reads": counter.storage_reads, "sources": o.sources, **outcome_row(o)}


def changed_layers(state) -> None:
    """The next step in place: the parameters of the first
    RECOVERY_DELTA_CHANGED_LAYERS layers moved, everything else as it was."""
    marks = tuple(f"layers.{i}." for i in range(RECOVERY_DELTA_CHANGED_LAYERS))
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.startswith(marks):
                p.add_(1.0)
    state.step = state.opt_state.count = RECOVERY_STEP + 1


def delta_leg(state, fresh, workdir, regressions) -> dict:
    """Leg H: delta persist bytes and the have-list pull."""
    from tf_operator_tpu_torch.runtime.shard_server import start_shard_server
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
    from tf_operator_tpu_torch.train.restore import restore_with_fallback

    delta_dir = os.path.join(workdir, "delta-ckpt")
    mgr = CheckpointManager(delta_dir, delta_persist=True)
    server = None
    previous = fingerprint(state)
    try:
        mgr.save(state, force=True)
        mgr.wait()
        full = dict(mgr.last_persist_info or {})
        changed_layers(state)
        changed = fingerprint(state)
        mgr.save(state, force=True)
        mgr.wait()
        delta = dict(mgr.last_persist_info or {})
        if (full.get("kind"), delta.get("kind")) != ("full", "delta"):
            regressions.append(f"delta leg persist kinds {full.get('kind')}/"
                               f"{delta.get('kind')}, wanted full/delta")
        reader = CheckpointManager(delta_dir)
        try:
            blank(fresh)
            chain = restore_with_fallback(fresh, reader, [])
            if chain.step != RECOVERY_STEP + 1 or not equal(fresh, changed):
                regressions.append("delta-chain restore is not byte-equal to the saved state")
        finally:
            reader.close()
        server = start_shard_server(mgr)
        wait_meta(server.address)
        rmgr = CheckpointManager(os.path.join(workdir, "delta-dst"))
        try:
            blank(fresh)
            cold = restore_with_fallback(fresh, rmgr, [server.address])
            cold_ok = equal(fresh, changed)
            # A survivor that holds the previous step: the state before the
            # change, bit for bit.
            load(fresh, previous)
            fresh.step = fresh.opt_state.count = RECOVERY_STEP
            warm = restore_with_fallback(fresh, rmgr, [server.address], have=True)
            warm_ok = equal(fresh, changed)
        finally:
            rmgr.close()
        for label, o, ok in (("cold", cold, cold_ok), ("warm", warm, warm_ok)):
            if (o.path, o.cause, o.step) != ("peer", "ok", RECOVERY_STEP + 1) or not ok:
                regressions.append(f"delta leg {label} pull landed on {o.path}/{o.cause}/"
                                   f"{o.step} (byte-equal {ok})")
    finally:
        if server is not None:
            server.stop()
        mgr.close()
    full_bytes, delta_bytes = int(full.get("bytes_written") or 0), int(
        delta.get("bytes_written") or 0)
    cold_bytes, warm_bytes = int(cold.bytes_moved or 0), int(warm.bytes_moved or 0)
    if not cold_bytes:
        regressions.append("delta leg cold pull moved no bytes")
    return {"full_persist_bytes": full_bytes, "delta_persist_bytes": delta_bytes,
            "delta_persist_fraction": round(delta_bytes / max(full_bytes, 1), 4),
            "delta_shards_written": delta.get("shards_written"),
            "delta_shards_skipped": delta.get("shards_skipped"),
            "delta_chain_depth": delta.get("chain_depth"),
            "full_persist": persist_row(full), "delta_persist": persist_row(delta),
            "chain_restore": outcome_row(chain), "cold_pull_bytes": cold_bytes,
            "warm_pull_bytes": warm_bytes,
            "have_list_fraction": round(warm_bytes / max(cold_bytes, 1), 4),
            "cold": outcome_row(cold), "warm": outcome_row(warm),
            "changed_layers": RECOVERY_DELTA_CHANGED_LAYERS}


def persist_row(info: dict) -> dict:
    return {k: (rounded(v) if k == "split" else v) for k, v in (info or {}).items()}


# ------------------------------------------------------------------ the gates
def gates(out: dict, regressions: list, baseline: str) -> dict:
    """The JAX script's smoke gates and its ratchet; returns the baseline
    updates."""
    latency, sharded, delta = out["latency"], out["sharded"], out["delta"]
    if latency["peer_s"] >= latency["storage_modeled_s"]:
        regressions.append(f"peer restore ({latency['peer_s']} s) did not beat modelled "
                           f"remote storage ({latency['storage_modeled_s']} s)")
    if out["snapshot_stall_s"] >= out["persist_s"]:
        regressions.append(f"snapshot stall ({out['snapshot_stall_s']} s) not below the "
                           f"persist ({out['persist_s']} s)")
    if sharded["sharded_restore_s"] >= sharded["single_survivor_s"]:
        regressions.append(f"sharded restore ({sharded['sharded_restore_s']} s) did not beat "
                           f"the single-survivor pull ({sharded['single_survivor_s']} s)")
    if delta["delta_persist_bytes"] > delta["full_persist_bytes"] * RECOVERY_DELTA_MAX_FRACTION:
        regressions.append(f"delta persist wrote {delta['delta_persist_bytes']} B, above "
                           f"{RECOVERY_DELTA_MAX_FRACTION:.0%} of the full persist")
    if delta["warm_pull_bytes"] > delta["cold_pull_bytes"] * RECOVERY_DELTA_MAX_FRACTION:
        regressions.append(f"have-list pull moved {delta['warm_pull_bytes']} B, above "
                           f"{RECOVERY_DELTA_MAX_FRACTION:.0%} of the cold pull")
    prev = read_baseline(baseline)
    ratchets = (("peer_restore_s", latency["peer_s"], 1), ("speedup", out["speedup"], -1),
                ("sharded_restore_s", sharded["sharded_restore_s"], 1),
                ("delta_persist_fraction", delta["delta_persist_fraction"], 1),
                ("have_list_fraction", delta["have_list_fraction"], 1))
    for key, value, sign in ratchets:
        before = prev.get(key)
        if not before:
            continue
        if (value > before * RECOVERY_REGRESSION if sign > 0
                else value < before / RECOVERY_REGRESSION):
            regressions.append(f"{key} {value} regressed >{RECOVERY_REGRESSION}x against the "
                               f"last green run ({before})")
    return {key: value for key, value, _ in ratchets} | {
        "snapshot_stall_s": out["snapshot_stall_s"],
        "restart_to_resumed_peer_s": (out["restart"].get("peer") or {}).get(
            "restart_to_resumed_s"),
        "warm_start_storage_reads": out["warm_start"]["storage_reads"]}


def read_baseline(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def write_baseline(path: str, updates: dict) -> None:
    merged = {**read_baseline(path), **updates}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="measure_recovery_torch")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--trials", type=int, default=RECOVERY_TRIALS)
    parser.add_argument("--smoke", action="store_true", help="gate and ratchet")
    parser.add_argument("--baseline", default=BASELINE_PATH,
                        help="the ratchet's file of the last green run")
    args = parser.parse_args(argv)
    from tf_operator_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cpu = device.type == "cpu"
    model = SETTINGS[device.type][0]
    if cpu:
        kind = "cpu"
    else:
        import chip_smoke
        from tf_operator_tpu_torch.ops import build

        kind = torch.cuda.get_device_name(0)
        log(f"[recovery] {chip_smoke.smi_line()}")
        build.load()  # leg D's children find the kernels built
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.runtime.shard_server import start_shard_server
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    regressions: list = []
    t_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="recovery-torch-")
    ckpt_dir = os.path.join(workdir, "ckpt")
    config = llama.CONFIGS[model]
    state = make_state(config, device.type, RECOVERY_STEP, seed=0)
    fresh = make_state(config, device.type, 0, seed=1)
    saved = fingerprint(state)
    nbytes = sum(t.numel() for t in saved.values())
    log(f"[recovery] {model} train state on {kind}: {len(saved)} shards, {nbytes:,} bytes")
    mgr = CheckpointManager(ckpt_dir, model_meta=config.geometry())
    server = start_shard_server(mgr)
    survivors = [start_shard_server(mgr, slice_index=i, num_slices=2) for i in range(2)]
    try:
        t0 = time.perf_counter()
        mgr.save(state, force=True)
        stall = time.perf_counter() - t0
        mgr.wait()
        persist = dict(mgr.last_persist_info or {})
        if mgr.last_durable_step() != RECOVERY_STEP:
            regressions.append(f"the save is not durable at step {RECOVERY_STEP}")
        log(f"[recovery] save: stall {stall:.4f} s, persist {persist_row(persist)}")
        out = {"mode": "recovery", "device": {"kind": kind, "count": (
            0 if cpu else torch.cuda.device_count())}, "model": model, "smoke": args.smoke,
            "state_bytes": nbytes, "snapshot_stall_s": round(stall, 4),
            "persist_s": round(persist.get("seconds", 0.0), 4),
            "persist": persist_row(persist)}
        legs = (("latency", lambda: latency_leg(saved, fresh, ckpt_dir, server, args.trials,
                                                regressions)),
                ("faults", lambda: fault_leg(fresh, ckpt_dir, server, regressions)),
                ("operator", lambda: {"skipped": "leg C, operator-side peer discovery, runs "
                                      "the operator alone, which the port does not replace: "
                                      "scripts/measure_control_plane.py --mode recovery"}),
                ("restart", lambda: restart_leg(device.type, ckpt_dir, workdir,
                                                server.address, regressions)),
                ("sharded", lambda: (
                    wide_sharded_leg(device.type, workdir, args.trials, regressions) if cpu
                    else sharded_leg(saved, fresh, ckpt_dir, survivors, args.trials,
                                     regressions))),
                ("sharded_faults", lambda: sharded_fault_leg(fresh, ckpt_dir, survivors,
                                                             regressions)),
                ("warm_start", lambda: warm_start_leg(saved, fresh, ckpt_dir, survivors,
                                                      regressions)),
                ("delta", lambda: delta_leg(state, fresh, workdir, regressions)))
        for name, leg in legs:
            t0 = time.perf_counter()
            out[name] = leg()
            log(f"[recovery] leg {name} in {time.perf_counter() - t0:.2f} s: "
                f"{json.dumps(out[name])}")
    finally:
        server.stop()
        for s in survivors:
            s.stop()
        mgr.close()
        shutil.rmtree(workdir, ignore_errors=True)
    out["speedup"] = round(out["latency"]["storage_modeled_s"]
                           / max(out["latency"]["peer_s"], 1e-9), 3)
    out["sharded_speedup"] = round(out["sharded"]["single_survivor_s"]
                                   / max(out["sharded"]["sharded_restore_s"], 1e-9), 3)
    updates = gates(out, regressions, args.baseline) if args.smoke else {}
    out["regressions"] = regressions
    out["seconds"] = round(time.perf_counter() - t_start, 2)
    rc = 1 if regressions and args.smoke else 0
    if args.smoke and not regressions:
        write_baseline(args.baseline, updates)
    for r in regressions:
        log(f"[recovery] REGRESSION {r}")
    if not cpu:
        log(chip_smoke.smi_line())
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
