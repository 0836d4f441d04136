"""The port's recovery telemetry, the seconds splits, the local-rank peer
addressing and the sharded world's restore, on the CPU.

- The seven recovery families (``tf_operator_tpu_torch/metrics.py``): the
  same observe calls into the JAX package's ``Metrics`` and into the
  port's registry render the same lines; the port's checkpoint and
  restore observe them once a persist and once a restore, and a
  telemetry error fails neither.
- The splits: every part non-negative, summing to the persist's or the
  restore's seconds within 5%, for a manifest persist, a DCP save and
  every rung.
- Local-rank addressing: local rank l of a restoring pod asks each
  survivor's published port plus l (``local_peer_addresses``) and takes
  only the shards of its own rank (``shard_of``): a missing or a
  misaddressed peer falls to storage with its cause, the state untouched
  by the peer. The sharded world's votes (``WorldGate``).
- One fixture of processes: two slice-local worlds of 2 gloo ranks each
  through the launcher (llama-tiny, fsdp=2, ``TPU_SHARD_SERVER``): slice
  1 killed once its own DCP stream holds a durable step, however late
  (``kill_at_durable``, pinned with a fake slice), then started again
  three ways:
  with slice 0's address (every rank restores its own shards from its
  peer, at one step, and trains on with slice 0's losses); misaddressed
  (``port + 1``: rank 0 is offered rank 1's shards, rank 1 nothing; both
  restore from storage with rank 0's cause); and after slice 0 ended
  (every peer gone: storage, ``peer-unreachable``). Beside them,
  ``scripts/measure_recovery_torch.py --device cpu --smoke``.
"""

import argparse
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from tf_operator_tpu.metrics import Metrics as JaxMetrics
from tf_operator_tpu_torch import metrics
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.runtime import launch
from tf_operator_tpu_torch.runtime.shard_server import (
    flatten_state,
    local_peer_addresses,
    start_shard_server,
)
from tf_operator_tpu_torch.train import checkpoint, data, restore
from tf_operator_tpu_torch.train.checkpoint import PERSIST_PARTS, CheckpointManager
from tf_operator_tpu_torch.train.restore import RESTORE_PARTS, WorldGate, restore_with_fallback
from tf_operator_tpu_torch.train.train_step import init_train_state, make_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = set(metrics.COUNTERS) | set(metrics.HISTOGRAMS) | {metrics.CHAIN_DEPTH}


# ---------------------------------------------------------------- telemetry
def family(line: str) -> str:
    name = line.split()[2] if line.startswith("#") else line.split("{")[0].split(" ")[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[:-len(suffix)] in FAMILIES:
            return name[:-len(suffix)]
    return name


def recovery_lines(text: str) -> list:
    return [line for line in text.splitlines() if family(line) in FAMILIES]


SEQUENCES = {
    "none": [],
    "restores": [("observe_restore", "peer", "ok", 0.31), ("observe_restore", "storage",
                 "peer-unreachable", 7.5), ("observe_restore", "peer", "ok", 400.0),
                 ("observe_restore_bytes", "peer", 4096), ("observe_restore", "none",
                 'odd "cause"\n', 0.0)],
    "persists": [("observe_checkpoint_persist", 3.7), ("observe_checkpoint_persist", 0.05),
                 ("observe_checkpoint_persist_bytes", "full", 3_740_000_000, 0),
                 ("observe_checkpoint_persist_bytes", "delta", 12_000, 290),
                 ("set_delta_chain_depth", 1), ("set_delta_chain_depth", 0)],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_the_families_render_as_the_jax_packages(name):
    jax, port = JaxMetrics(), metrics.Metrics()
    for method, *args in SEQUENCES[name]:
        getattr(jax, method)(*args)
        getattr(port, method)(*args)
    got = port.render()
    assert recovery_lines(got) == recovery_lines(jax.render())
    assert got.splitlines() == recovery_lines(got)  # the seven families alone


def tiny_state(seed=0, step=0):
    state = init_train_state(llama.Llama(llama.CONFIGS["llama-tiny"], device="cpu",
                                         generator=torch.Generator().manual_seed(seed)),
                             make_optimizer())
    state.step = state.opt_state.count = step
    return state


def test_checkpoint_and_restore_observe_once_each(tmp_path, monkeypatch):
    registry = metrics.Metrics()
    monkeypatch.setattr(checkpoint, "METRICS", registry)
    monkeypatch.setattr(restore, "METRICS", registry)
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        server = start_shard_server(mgr)
        try:
            mgr.save(tiny_state(step=3))
            mgr.wait()
            info = mgr.last_persist_info
            out = restore_with_fallback(tiny_state(seed=1), mgr, [server.address])
        finally:
            server.stop()
    assert registry.histogram_count("training_checkpoint_persist_seconds") == 1
    assert registry.counter_value("training_checkpoint_persist_bytes_total", "full") == \
        info["bytes_written"]
    assert registry.counter_value("training_restore_total", "peer", "ok") == 1
    assert registry.counter_value("training_restore_bytes_total", "peer") == out.bytes_moved
    assert "training_checkpoint_delta_chain_depth 0" in registry.render()


def test_a_telemetry_error_fails_no_persist_and_no_restore(tmp_path, monkeypatch):
    class Broken(metrics.Metrics):
        def __getattribute__(self, name):
            if name.startswith(("observe", "set_")):
                raise RuntimeError("telemetry down")
            return super().__getattribute__(name)

    monkeypatch.setattr(checkpoint, "METRICS", Broken())
    monkeypatch.setattr(restore, "METRICS", Broken())
    durable = []
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.add_durability_listener(durable.append)
        mgr.save(tiny_state(step=2))
        mgr.wait()
        out = restore_with_fallback(tiny_state(seed=1), mgr, [])
    assert durable == [2] and (out.path, out.cause, out.step) == ("storage", "ok", 2)


# ------------------------------------------------------------------- splits
def check_split(seconds, split, parts):
    assert set(split) <= set(parts), split
    assert all(v >= 0 for v in split.values()), split
    assert abs(sum(split.values()) - seconds) <= 0.05 * seconds, (seconds, split)


def test_the_persist_and_restore_seconds_split(tmp_path):
    state = tiny_state(step=4)
    with CheckpointManager(str(tmp_path / "c"), delta_persist=True) as mgr:
        server = start_shard_server(mgr)
        survivors = [start_shard_server(mgr, slice_index=i, num_slices=2) for i in range(2)]
        try:
            for step in (4, 5):
                state.step = state.opt_state.count = step
                mgr.save(state)
                mgr.wait()
                info = mgr.last_persist_info
                assert info["seconds"] == mgr.last_persist_seconds
                check_split(info["seconds"], info["split"], PERSIST_PARTS)
            assert {"d2h_issue", "queue", "encode", "sha256", "write"} <= set(info["split"])
            outcomes = [restore_with_fallback(tiny_state(seed=1), mgr, [server.address]),
                        restore_with_fallback(tiny_state(seed=1), mgr,
                                              [s.address for s in survivors], sharded=True),
                        restore_with_fallback(tiny_state(seed=1), mgr, []),
                        restore_with_fallback(tiny_state(seed=1), mgr, [server.address],
                                              have=True)]
        finally:
            for s in [server, *survivors]:
                s.stop()
    empty = CheckpointManager(str(tmp_path / "empty"))
    outcomes.append(restore_with_fallback(tiny_state(seed=1), empty, []))
    empty.close()
    assert [o.path for o in outcomes] == ["peer", "peer-sharded", "storage", "peer", "none"]
    for o in outcomes:
        check_split(o.seconds, o.split, RESTORE_PARTS)
    assert {"fetch", "sha256", "decode", "h2d", "geometry"} <= set(outcomes[0].split)


def test_stopping_a_server_waits_for_the_view_it_builds(tmp_path, monkeypatch):
    """A durable save warms the server's view on a thread; a process that
    exits while that thread still encodes tensors aborts (exit 134 on the
    card), so stop() waits for it."""
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        server = start_shard_server(mgr)
        build = server._current_view

        def slow_view():
            time.sleep(0.5)
            return build()

        monkeypatch.setattr(server, "_current_view", slow_view)
        mgr.save(tiny_state(step=1))
        mgr.wait()  # the listener has started the warm thread
        assert any(t.is_alive() for t in server._warmers)
        server.stop()
        assert not any(t.is_alive() for t in server._warmers)


# ------------------------------------------------------ local-rank addressing
def test_local_peer_addresses():
    assert local_peer_addresses(["10.0.0.1:8470", "h:9"], 3) == ["10.0.0.1:8473", "h:12"]
    assert local_peer_addresses([], 1) == []


def bits(state):
    return {n: t.reshape(-1).view(torch.uint8).clone() for n, t in flatten_state(state).items()}


def test_each_rank_takes_only_its_own_shards(tmp_path, monkeypatch):
    """Two ranks of a survivor serve their shards on consecutive ports;
    the restoring ranks' identities are set by hand (a sharded state needs
    a process group, which the fixture below has)."""
    who = {"rank": 0}
    monkeypatch.setattr(checkpoint, "shard_identity",
                        lambda state: {"rank": who["rank"], "world": 2, "mesh": {"fsdp": 2}})
    monkeypatch.setattr(checkpoint, "is_sharded", lambda state: False)
    base = launch.free_port_block(2)
    managers, servers, saved = [], [], []
    for rank in range(2):
        who["rank"] = rank
        mgr = CheckpointManager(str(tmp_path / f"survivor{rank}"))
        state = tiny_state(seed=10 + rank, step=6)
        managers.append(mgr)
        servers.append(start_shard_server(mgr, port=base + rank))
        mgr.save(state)
        # A sharded save's snapshot, as serve_local_shards keeps it.
        mgr._snapshot = checkpoint.take_snapshot(state, 6, None, checkpoint.shard_identity(state))
        mgr.wait()
        saved.append(bits(state))
    own = CheckpointManager(str(tmp_path / "own"))
    own.save(tiny_state(seed=20, step=2))
    own.wait()
    try:
        published = [f"127.0.0.1:{base}"]
        for rank in range(2):
            who["rank"] = rank
            target = tiny_state(seed=30)
            out = restore_with_fallback(target, own, local_peer_addresses(published, rank))
            assert (out.path, out.cause, out.step) == ("peer", "ok", 6)
            assert bits(target).keys() == saved[rank].keys() and all(
                torch.equal(bits(target)[n], saved[rank][n]) for n in saved[rank])
        # Misaddressed: rank 0 is offered rank 1's shards and refuses them.
        who["rank"] = 0
        out = restore_with_fallback(tiny_state(seed=30), own, [f"127.0.0.1:{base + 1}"],
                                    retries=0, timeout=1.0)
        assert (out.path, out.cause, out.step) == ("storage", "peer-shard-mismatch", 2)
        # Rank 1's peer is gone: storage, with the cause.
        servers[1].stop()
        who["rank"] = 1
        out = restore_with_fallback(tiny_state(seed=30), own,
                                    local_peer_addresses(published, 1), retries=0,
                                    timeout=1.0, sleep=lambda s: None)
        assert (out.path, out.cause, out.step) == ("storage", "peer-unreachable", 2)
    finally:
        servers[0].stop()
        for mgr in [*managers, own]:
            mgr.close()


def test_a_taken_port_degrades_only_the_peer_path(tmp_path, monkeypatch):
    """Another process takes the port the launcher gave a rank before the
    rank's server binds it: the rank restores and goes on, serving and
    publishing nothing, and a peer that asks that port falls to storage."""
    from tf_operator_tpu_torch.runtime import gpu_init, heartbeat
    from tf_operator_tpu_torch.train import llama_train

    published = []
    monkeypatch.setattr(heartbeat, "record_peer_address", published.append)
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    port = taken.getsockname()[1]
    for key in (heartbeat.ENV_PEER_RESTORE_ADDRS, heartbeat.ENV_SHARDED_RESTORE,
                heartbeat.ENV_WARM_START, heartbeat.ENV_DELTA_PERSIST):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv(heartbeat.ENV_SHARD_SERVER, "1")
    monkeypatch.setenv(heartbeat.ENV_SHARD_SERVER_PORT, str(port))
    args = argparse.Namespace(checkpoint_dir=str(tmp_path / "ckpt"))
    state = tiny_state(seed=3, step=4)
    ckpt, server, outcome = llama_train.recover(args, state, gpu_init.Topology(),
                                                llama.CONFIGS["llama-tiny"])
    try:
        assert server is None and published == []
        assert outcome.step is None
        ckpt.save(state, force=True)
        ckpt.wait()
        out = restore_with_fallback(tiny_state(seed=4), ckpt, [f"127.0.0.1:{port}"],
                                    retries=0, timeout=1.0, sleep=lambda s: None)
        assert (out.path, out.cause, out.step) == ("storage", "peer-unreachable", 4)
    finally:
        ckpt.close()
        taken.close()


@pytest.mark.parametrize("rotations,want", [(1, ("peer", "ok", 8)),
                                             (3, ("none", "peer-unreachable", None))])
def test_a_survivor_that_saves_between_its_meta_and_the_bundle(tmp_path, rotations, want):
    """A survivor trains on and saves while a rank restores from it: its
    snapshot rotates after the rank read its meta, and the bundle answers
    409. The rank asks the meta again and takes the newer snapshot, as
    often as its retries (2) allow."""
    survivor = CheckpointManager(str(tmp_path / "survivor"))
    server = start_shard_server(survivor)
    own = CheckpointManager(str(tmp_path / "own"))
    newer = tiny_state(seed=2, step=4)
    bundles = []

    def rotating(peer, path, timeout):
        if path.startswith("/v1/bundle"):
            if len(bundles) < rotations:
                newer.step = newer.opt_state.count = 8 + 4 * len(bundles)
                survivor.save(newer)
                survivor.wait()
            bundles.append(path)
        return restore.http_fetch(peer, path, timeout)

    try:
        survivor.save(tiny_state(seed=1, step=4))
        survivor.wait()
        target = tiny_state(seed=3)
        out = restore_with_fallback(target, own, [server.address], fetcher=rotating,
                                    sleep=lambda s: None)
        assert (out.path, out.cause, out.step) == want
        assert len(bundles) == min(rotations + 1, 3)
        if out.path == "peer":
            assert all(torch.equal(bits(target)[n], b) for n, b in bits(newer).items())
    finally:
        server.stop()
        survivor.close()
        own.close()


@pytest.mark.parametrize("votes,answer", [
    ([(True, 5, "ok"), (True, 5, "ok")], (True, "ok")),
    ([(True, 5, "ok"), (False, None, "peer-unreachable")], (False, "peer-unreachable")),
    ([(False, None, "peer-shard-mismatch"), (False, None, "no-peers")],
     (False, "peer-shard-mismatch")),
    ([(True, 5, "ok"), (True, 6, "ok")], (False, "peer-step-mismatch")),
])
def test_the_world_vote(votes, answer, monkeypatch):
    gate = WorldGate()
    monkeypatch.setattr(gate, "_gather", lambda item: votes)
    assert gate(*votes[0]) == answer
    monkeypatch.setattr(gate, "_gather", lambda item: pytest.fail("voted twice"))
    assert gate(False, None, "later") == answer  # one vote a ladder


@pytest.mark.parametrize("steps,want", [
    ([(5, "ok"), (5, "ok")], (5, "ok", False)),
    ([(5, "ok"), (None, "peer-unreachable")], (None, "peer-unreachable", False)),
    ([(5, "ok"), (7, "ok")], (None, "peer-step-mismatch", True)),
])
def test_the_world_agrees_on_a_step_before_it_fetches(steps, want, monkeypatch):
    gate = WorldGate()
    monkeypatch.setattr(gate, "_gather", lambda item: steps)
    assert gate.agree(*steps[0]) == want


# ------------------------------------------ two slice-local worlds of 2 ranks
STEPS, EVERY = 400, 20


def launched(tmp, tag, slice_index, port, peers="", ckpt="", steps=STEPS):
    env = chip_smoke.slice_env(slice_index, port, os.path.join(tmp, f"beat-{tag}.json"), peers,
                               gpus=2)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    command = chip_smoke.launch_argv(2, [
        sys.executable, "-m", "tf_operator_tpu_torch.train.llama_train", "--device", "cpu",
        "--model", "llama-tiny", "--seq", "32", "--batch", "4", "--steps", str(steps),
        "--log-every", "100", "--checkpoint-every", str(EVERY), "--checkpoint-dir", ckpt,
        "--data", os.path.join(tmp, "tokens.bin")])
    out = open(os.path.join(tmp, f"{tag}.log"), "w")
    return subprocess.Popen(command, cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True)


def kill_at_durable(proc, stream, poll=0.05):
    """SIGKILL ``proc``'s process group once ``stream`` holds a durable
    step (or once ``proc`` has ended): the newest durable step the stream
    holds after the kill, which a restart's storage rung restores; None
    only when the process ended without one. The wait is on that
    condition, however long the slice takes under load; the beat file is
    not read, as a step can be finalized on storage and not yet published
    when the kill lands."""
    while proc.poll() is None and not chip_smoke.durable_steps(stream):
        time.sleep(poll)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    steps = chip_smoke.durable_steps(stream)
    return steps[-1] if steps else None


# A slice that finalizes DCP steps on its own clock: its first after
# FIRST seconds, then one every NEXT seconds, each directory complete
# before its .metadata appears (as DCP writes it); its beat file never
# shows a step.
FAKE_SLICE = r"""
import os, sys, time
stream, first, every = sys.argv[1], float(sys.argv[2]), float(sys.argv[3])
time.sleep(first)
for step in range(2, 400, 2):
    os.makedirs(os.path.join(stream, str(step)))
    open(os.path.join(stream, str(step), ".metadata"), "w").close()
    time.sleep(every)
"""


@pytest.mark.parametrize("first,every", [(1.0, 60.0), (0.5, 0.01)])
def test_a_slice_is_killed_at_a_step_its_stream_holds(tmp_path, first, every):
    """The worlds fixture's kill: a slice whose first durable step comes
    late is killed after it, never before (no killed_at of None), and the
    step recorded is the newest one its stream holds after the kill,
    however fast the steps follow each other."""
    stream = str(tmp_path / "dcp")
    proc = subprocess.Popen([sys.executable, "-c", FAKE_SLICE, stream, str(first), str(every)],
                            start_new_session=True)
    t0 = time.monotonic()
    killed_at = kill_at_durable(proc, stream)
    assert proc.returncode == -signal.SIGKILL and time.monotonic() - t0 >= first
    assert killed_at is not None and killed_at == chip_smoke.durable_steps(stream)[-1]
    time.sleep(0.2)
    assert chip_smoke.durable_steps(stream)[-1] == killed_at  # nothing after the kill


def finish(procs, timeout=240):
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("slice-worlds"))
    data.write_token_file(os.path.join(tmp, "tokens.bin"),
                          np.random.default_rng(0).integers(0, 256, 100_000).astype(np.int32))
    ckpt = os.path.join(tmp, "ckpt")
    # Slice s's coordinator listens on the port plus s.
    port = launch.free_port_block(2)
    zero, one = launched(tmp, "slice0", 0, port, ckpt=ckpt), launched(tmp, "slice1", 1, port,
                                                                       ckpt=ckpt)
    procs = [zero, one]
    out = {}
    try:
        # Slice 1 dies at a step its own stream made durable: the step its
        # restarts resume from (through the peer, at or after it; through
        # storage, that step).
        out["killed_at"] = kill_at_durable(one, os.path.join(ckpt, "slice-1", "dcp"))
        survivor = chip_smoke.published_peer(os.path.join(tmp, "beat-slice0.json"), zero, 120)
        out["survivor_alive"] = zero.poll() is None
        address = survivor["peer_addr"]
        # A copy of slice 1's stream for the two other restarts (hard links:
        # a save replaces files, never writes into them).
        for tag in ("misaddressed", "orphaned"):
            shutil.copytree(os.path.join(ckpt, "slice-1"),
                            os.path.join(tmp, tag, "slice-1"), copy_function=os.link)
        host, _, base = address.rpartition(":")
        restarted = launched(tmp, "restarted", 1, port, address, ckpt=ckpt)
        misaddressed = launched(tmp, "misaddressed", 1, launch.free_port_block(2),
                                f"{host}:{int(base) + 1}", os.path.join(tmp, "misaddressed"),
                                steps=1)
        procs += [restarted, misaddressed]
        finish([restarted, misaddressed, zero])
        orphaned = launched(tmp, "orphaned", 1, launch.free_port_block(2), address,
                            os.path.join(tmp, "orphaned"), steps=1)
        procs.append(orphaned)
        finish([orphaned])
        # The recovery legs, once the worlds have ended (its seconds are
        # its own, not shared with theirs).
        smoke = subprocess.run(
            [sys.executable, "scripts/measure_recovery_torch.py", "--device", "cpu", "--smoke",
             "--baseline", os.path.join(tmp, "baseline.json")], cwd=ROOT,
            env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=240)
        out["smoke_log"], out["smoke_rc"] = smoke.stdout, smoke.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    p.kill()
                p.wait()
    out["codes"] = {tag: p.returncode for tag, p in
                    zip(("slice0", "restarted", "misaddressed", "orphaned"),
                        (zero, restarted, misaddressed, orphaned))}
    out["logs"] = {tag: open(os.path.join(tmp, f"{tag}.log")).read() for tag in out["codes"]}
    out["runs"] = {tag: chip_smoke.done_lines(text) for tag, text in out["logs"].items()}
    return out


def test_each_rank_restores_its_own_shards_from_its_peer(worlds):
    assert worlds["killed_at"] is not None, worlds["logs"]["restarted"][-3000:]
    assert worlds["survivor_alive"] and worlds["codes"]["slice0"] == 0
    assert worlds["codes"]["restarted"] == 0, worlds["logs"]["restarted"][-3000:]
    runs, zero = worlds["runs"]["restarted"], worlds["runs"]["slice0"]
    assert sorted(runs) == [0, 1]
    restores = [runs[r]["restore"] for r in (0, 1)]
    assert {(x["path"], x["cause"]) for x in restores} == {("peer", "ok")}, restores
    step = restores[0]["step"]
    assert step == restores[1]["step"] >= worlds["killed_at"] and step % EVERY == 0
    assert restores[0]["digest"] != restores[1]["digest"]  # each its own shards
    for r in (0, 1):
        assert runs[r]["start_step"] == step
        # The same rows from the same state: slice 0's losses, bit for bit.
        assert runs[r]["losses"] == zero[r]["losses"][step:]
        check_split(runs[r]["restore"]["seconds"], runs[r]["restore"]["split"], RESTORE_PARTS)
        assert runs[r]["restore"]["split"]["vote"] >= 0


def test_a_misaddressed_world_restores_nothing_of_another_rank(worlds):
    assert worlds["codes"]["misaddressed"] == 0, worlds["logs"]["misaddressed"][-3000:]
    runs = worlds["runs"]["misaddressed"]
    assert [runs[r]["restore"]["path"] for r in (0, 1)] == ["storage", "storage"]
    # Rank 0 was offered rank 1's shards, rank 1 nothing: one cause, the
    # lowest rank's, and the slice's own newest step.
    assert [runs[r]["restore"]["cause"] for r in (0, 1)] == ["peer-shard-mismatch"] * 2
    assert runs[0]["restore"]["step"] == worlds["killed_at"]


def test_with_every_peer_gone_the_world_restores_from_storage(worlds):
    assert worlds["codes"]["orphaned"] == 0, worlds["logs"]["orphaned"][-3000:]
    runs = worlds["runs"]["orphaned"]
    assert [(runs[r]["restore"]["path"], runs[r]["restore"]["cause"]) for r in (0, 1)] == [
        ("storage", "peer-unreachable")] * 2


def test_a_dcp_persist_splits_its_seconds(worlds):
    for tag in ("slice0", "restarted"):
        for r in (0, 1):
            persist = worlds["runs"][tag][r]["persist"]
            assert persist["kind"] == "dcp"
            check_split(persist["seconds"], persist["split"], PERSIST_PARTS)
            assert {"dcp_stage", "dcp_future", "finalize"} <= set(persist["split"])


def test_the_recovery_legs_pass_their_gates_on_the_cpu(worlds):
    log = worlds["smoke_log"]
    assert worlds["smoke_rc"] == 0, log[-3000:]
    result = json.loads(log.strip().splitlines()[-1])
    assert result["regressions"] == [] and result["model"] == "llama-tiny"
    assert result["device"] == {"kind": "cpu", "count": 0}
    assert result["seconds"] < 30
    # Leg E on a state above the JAX script's 48 MB, its gate on.
    assert result["sharded"]["bytes"] > 48 * 2**20
    assert result["sharded"]["sharded_restore_s"] < result["sharded"]["single_survivor_s"]
    assert [f["scenario"] for f in result["faults"]] == [
        "peer-down-mid-fetch", "truncated-shard", "stale-snapshot"]
    assert result["restart"]["peer"]["path"] == "peer"
    assert "skipped" in result["operator"]
