"""The port's snapshot-then-persist checkpoints
(``tf_operator_tpu_torch/train/checkpoint.py``) on the CPU, held to the
JAX package's contract (``tests/test_checkpoint_recovery.py``): the
durability listener fires once and only after the finalize, a gated or
crashed persist leaves the step non-durable, the snapshot is a finished
private copy (AdamW updates in place), the manifest store writes, skips,
chains and collects as the JAX delta store does, the geometry sidecar
refuses a mixed directory, and bf16 states round-trip byte-equal to the
JAX package's encoding."""

import json
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tf_operator_tpu.runtime import shard_server as jax_wire
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.runtime.shard_server import decode_shard, flatten_state
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.train_step import (
    OptState,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)


class One(torch.nn.Module):
    def __init__(self, fill, dtype=torch.float32):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 4), float(fill), dtype=dtype))


def make_state(step=5, scale=1.0, dtype=torch.float32):
    """The JAX tests' toy state, as a torch TrainState: w = scale, the
    moments 2 and 3 times it."""
    return TrainState(step=step, model=One(scale, dtype), opt_state=OptState(
        count=step, mu=[torch.full((4, 4), 2.0 * scale, dtype=dtype)],
        nu=[torch.full((4, 4), 3.0 * scale, dtype=dtype)]))


def values(state):
    return {n: t.clone() for n, t in flatten_state(state).items()}


def same(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[n].reshape(-1).view(torch.uint8), b[n].reshape(-1).view(torch.uint8))
        for n in a)


def persisted(mgr, step, like):
    """The tensors of a manifest, decoded by ``like``'s dtypes."""
    manifest = mgr._read_delta_manifest(step)
    out = {}
    for name, entry in manifest["shards"].items():
        with open(os.path.join(mgr._delta_shards_dir, f"{entry['checksum']}.npy"), "rb") as f:
            out[name] = decode_shard(f.read(), like[name].dtype).clone()
    return out


def tiny_state(seed=0):
    model = llama.Llama(llama.CONFIGS["llama-tiny"], device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return init_train_state(model, make_optimizer(learning_rate=1e-2, warmup_steps=1))


# ------------------------------------------------------- durability barrier
class TestDurabilityBarrier:
    def test_listener_fires_once_and_only_after_the_finalize(self, tmp_path):
        durable = []
        gate = threading.Event()
        with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
            mgr.add_durability_listener(durable.append)
            mgr._persist_gate = lambda step: gate.wait(timeout=30)
            assert mgr.save(make_state(step=5), force=True)
            # The snapshot exists and is servable...
            assert mgr.host_snapshot().step == 5
            # ...but the step is NOT durable, NOT on disk, NOT published.
            assert durable == [] and mgr.last_durable_step() is None
            assert mgr.latest_step() is None
            gate.set()
            mgr.wait()
            assert durable == [5]
            assert mgr.last_durable_step() == 5 and mgr.latest_step() == 5
            assert mgr.last_persist_seconds > 0
            mgr.wait()
        assert durable == [5]  # exactly once, close included

    def test_crash_in_the_persist_window_resumes_on_the_previous_step(self, tmp_path):
        durable = []
        d = str(tmp_path / "ckpt")
        with CheckpointManager(d) as mgr:
            mgr.add_durability_listener(durable.append)
            assert mgr.save(make_state(step=5, scale=1.0), force=True)
            mgr.wait()

            def crash(step):
                raise OSError("simulated crash in the persist window")

            mgr._persist_gate = crash
            assert mgr.save(make_state(step=10, scale=9.0), force=True)
            mgr.wait()
            assert durable == [5] and mgr.last_durable_step() == 5
            assert mgr.latest_step() == 5 and mgr._persist_errors == 1
        with CheckpointManager(d) as fresh:
            state = make_state(step=0, scale=0.0)
            restored, step = fresh.restore_latest(state)
            assert step == 5 and restored is state
            assert same(values(state), values(make_state(step=5, scale=1.0)))

    def test_sync_mode_is_durable_on_return(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TF_OPERATOR_SYNC_CHECKPOINT", "1")
        durable = []
        with CheckpointManager(str(tmp_path / "c")) as mgr:
            mgr.add_durability_listener(durable.append)
            assert not mgr.async_persist
            assert mgr.save(make_state(step=3), force=True)
            assert durable == [3] and mgr.last_durable_step() == 3

    def test_save_no_op_rules(self, tmp_path):
        with CheckpointManager(str(tmp_path / "c")) as mgr:
            assert mgr.save(make_state(step=4))
            assert not mgr.save(make_state(step=4), force=True)  # snapshotted
            mgr.wait()
            assert not mgr.save(make_state(step=4), force=True)  # on disk
            assert mgr.save(make_state(step=5))

    def test_close_drains_is_idempotent_and_runs_on_error_paths(self, tmp_path):
        durable = []
        mgr = CheckpointManager(str(tmp_path / "a"))
        mgr.add_durability_listener(durable.append)
        mgr.save(make_state(step=7), force=True)
        mgr.close()  # no wait() first: close owns the drain
        mgr.close()
        assert durable == [7] and mgr.latest_step() == 7
        with pytest.raises(RuntimeError, match="crash"):
            with CheckpointManager(str(tmp_path / "b")) as mgr:
                mgr.save(make_state(step=9), force=True)
                raise RuntimeError("mid-training crash")
        assert mgr.latest_step() == 9  # the in-flight write was not torn


# ------------------------------------------------------------- the snapshot
def test_snapshot_is_the_state_at_the_save_not_after_the_next_step(tmp_path):
    """AdamW updates parameters and moments in place. Save at step 1 with
    the persist held, run one more step, release: the persisted bytes are
    the state at the save, though every tensor has changed since."""
    state = tiny_state()
    step = make_train_step(make_optimizer(learning_rate=1e-2, warmup_steps=1))
    batches = iter(np.random.default_rng(0).integers(0, 256, (3, 2, 17)))
    state, _ = step(state, next(batches))
    gate = threading.Event()
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr._persist_gate = lambda _step: gate.wait(timeout=30)
        at_save = values(state)
        assert mgr.save(state)
        state, _ = step(state, next(batches))
        state, _ = step(state, next(batches))
        now = values(state)
        changed = [n for n in at_save if not torch.equal(now[n], at_save[n])]
        assert len(changed) == len(at_save)
        gate.set()
        mgr.wait()
        assert same(persisted(mgr, 1, at_save), at_save)
        assert same(mgr.host_snapshot().tree, at_save)


def test_bf16_round_trip_is_byte_equal_and_matches_the_jax_encoding(tmp_path):
    state = tiny_state(seed=3)
    step = make_train_step(make_optimizer(learning_rate=1e-2, warmup_steps=1))
    for batch in np.random.default_rng(1).integers(0, 256, (2, 2, 17)):
        state, _ = step(state, batch)
    saved = values(state)
    assert saved["model/output.weight"].dtype == torch.bfloat16
    with CheckpointManager(str(tmp_path / "c")) as mgr:
        mgr.save(state)
    manifest = mgr._read_delta_manifest(2)
    for name in ("model/output.weight", "opt/nu/layers.1.attention.wq.weight", "step"):
        as_jax = saved[name].view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if saved[name].dtype == torch.bfloat16 else saved[name].numpy()
        checksum = jax_wire.shard_checksum(jax_wire.encode_shard(jnp.asarray(as_jax)))
        assert manifest["shards"][name]["checksum"] == checksum
    fresh = tiny_state(seed=4)
    assert not same(values(fresh), saved)
    with CheckpointManager(str(tmp_path / "c")) as again:
        restored, at = again.restore_latest(fresh)
    assert at == 2 and restored.step == 2 and restored.opt_state.count == 2
    assert same(values(fresh), saved)


def test_bf16_delta_chain_round_trip(tmp_path):
    """A bf16 state through a delta persist: the carried-forward payloads
    and the rewritten ones restore byte-equal."""
    state = tiny_state(seed=5)
    with CheckpointManager(str(tmp_path / "c"), delta_persist=True) as mgr:
        mgr.save(state)
        with torch.no_grad():
            state.model.norm.scale.mul_(2.0)
        state.step = state.opt_state.count = 1
        mgr.save(state)
        mgr.wait()
        info = mgr.last_persist_info
    assert (info["kind"], info["shards_written"]) == ("delta", 3)
    assert info["shards_skipped"] == len(flatten_state(state)) - 3
    saved = values(state)
    fresh = tiny_state(seed=6)
    with CheckpointManager(str(tmp_path / "c")) as again:
        _, at = again.restore_latest(fresh)
    assert at == 1 and same(values(fresh), saved)


# ------------------------------------------------------------ manifest store
class TestManifestStore:
    def test_without_delta_every_persist_is_full(self, tmp_path):
        with CheckpointManager(str(tmp_path / "c")) as mgr:
            for s in (1, 2):
                mgr.save(make_state(step=s), force=True)
                mgr.wait()
                info = mgr.last_persist_info
                assert (info["kind"], info["chain_depth"], info["shards_skipped"]) == \
                    ("full", 0, 0)
                assert info["shards_written"] == 5
        assert os.listdir(tmp_path / "c" / "delta" / "shards")

    def test_second_persist_is_delta_with_skips_and_fewer_bytes(self, tmp_path):
        with CheckpointManager(str(tmp_path / "c"), delta_persist=True) as mgr:
            mgr.save(make_state(step=1, scale=1.0), force=True)
            mgr.wait()
            first = dict(mgr.last_persist_info)
            changed = make_state(step=2, scale=1.0)
            with torch.no_grad():
                changed.model.w.fill_(9.0)
            mgr.save(changed, force=True)
            mgr.wait()
            second = mgr.last_persist_info
        assert first["kind"] == "full" and first["shards_written"] == 5
        # step, count and w changed; the two moments carry forward.
        assert (second["kind"], second["chain_depth"]) == ("delta", 1)
        assert (second["shards_written"], second["shards_skipped"]) == (3, 2)
        assert second["bytes_written"] < first["bytes_written"]
        assert mgr.delta_chain_depth() == 1
        assert len(mgr.persisted_shard_names()) == 5
        fresh = make_state(step=0, scale=0.0)
        with CheckpointManager(str(tmp_path / "c")) as flag_off:  # reads any layout
            _, step = flag_off.restore_latest(fresh)
        assert step == 2 and float(fresh.model.w.detach()[0, 0]) == 9.0
        assert float(fresh.opt_state.mu[0][0, 0]) == 2.0

    def test_chain_bound_gc_keeps_the_newest_full(self, tmp_path):
        kinds = []
        with CheckpointManager(str(tmp_path / "c"), delta_persist=True,
                               delta_full_every=3, max_to_keep=2) as mgr:
            for s in range(1, 8):
                mgr.save(make_state(step=s, scale=float(s)), force=True)
                mgr.wait()
                kinds.append(mgr.last_persist_info["kind"])
            steps = mgr._delta_manifest_steps()
        assert kinds == ["full", "delta", "delta", "full", "delta", "delta", "full"]
        assert steps == [6, 7]  # the newest two; 7 is full
        referenced = {e["checksum"] for s in steps
                      for e in mgr._read_delta_manifest(s)["shards"].values()}
        on_disk = {f[:-4] for f in os.listdir(tmp_path / "c" / "delta" / "shards")}
        assert on_disk == referenced

    def test_gc_retains_a_full_manifest_outside_the_window(self, tmp_path):
        with CheckpointManager(str(tmp_path / "c"), delta_persist=True,
                               delta_full_every=5, max_to_keep=1) as mgr:
            for s in (1, 2, 3):
                mgr.save(make_state(step=s, scale=float(s)), force=True)
                mgr.wait()
            assert mgr._delta_manifest_steps() == [1, 3]  # 1 is the full one
            assert mgr.delta_chain_depth() == 2

    def test_geometry_sidecar_refuses_a_mixed_directory(self, tmp_path):
        d = str(tmp_path / "c")
        with CheckpointManager(d, model_meta={"n_heads": 16, "head_dim": 64}) as mgr:
            mgr.save(make_state(step=1), force=True)
        with open(os.path.join(d, "model_meta.json")) as f:
            assert json.load(f) == {"head_dim": 64, "n_heads": 16}
        other = CheckpointManager(d, model_meta={"n_heads": 8, "head_dim": 128})
        with pytest.raises(ValueError, match="geometry mismatch"):
            other.restore_latest(make_state(step=0))
        with pytest.raises(ValueError, match="geometry mismatch"):
            other.save(make_state(step=2), force=True)
        other.close()
