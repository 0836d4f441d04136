"""The port's restore ladder (``tf_operator_tpu_torch/train/restore.py``) on
the CPU.

The seeded scenarios of ``tests/test_recovery_chaos.py`` (the ladder, the
sharded ladder and the torn delta chain) run twice under the same
schedule: once through the JAX package with a JAX state and its
``ChaosSpec``'s injector, once through the port with a torch state holding
the same values in the same number of tensors (step, w, count and two
moments) and the port's copy of the injector
(``tf_operator_tpu_torch/testing/restore_faults.py``). Each must give the
same ``(path, cause, step)``, the same shard sources, the same fault log
and the same ``training_restore_total{path,cause}`` counts in its
package's registry, and replay it byte-identically; the port's restored
values are checked too. Then the ladder's
edges on the port alone: exact bf16 bytes over the bundle and the
per-shard wire, the have-list, geometry refusals that leave the state
untouched, warm start, per-shard storage fill and its step rule."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.cluster.chaos import (
    ChaosCluster,
    ChaosSpec,
    RestoreFaultInjector,
    ScheduledRestoreFault,
)
from tf_operator_tpu.cluster.memory import InMemoryCluster
from tf_operator_tpu.metrics import METRICS as JAX_METRICS
from tf_operator_tpu.runtime.shard_server import start_shard_server as jax_start_shard_server
from tf_operator_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from tf_operator_tpu.train.restore import restore_with_fallback as jax_restore
from tf_operator_tpu.train.train_step import TrainState as JaxTrainState
from tf_operator_tpu_torch.metrics import METRICS as PORT_METRICS
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.runtime.shard_server import flatten_state, start_shard_server
from tf_operator_tpu_torch.testing import restore_faults
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager
from tf_operator_tpu_torch.train.restore import (
    GeometryMismatch,
    have_list,
    http_fetch,
    restore_with_fallback,
)
from tf_operator_tpu_torch.train.train_step import (
    OptState,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

STEP = 5


class One(torch.nn.Module):
    def __init__(self, fill):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 4), float(fill)))


def torch_state(step=STEP, scale=1.0, w=None):
    return TrainState(step=step, model=One(scale if w is None else w), opt_state=OptState(
        count=step, mu=[torch.full((4, 4), 2.0 * scale)], nu=[torch.full((4, 4), 3.0 * scale)]))


def jax_state(step=STEP, scale=1.0, w=None):
    return JaxTrainState(
        step=jnp.asarray(step, jnp.int32),
        params={"w": jnp.full((4, 4), scale if w is None else w, jnp.float32)},
        opt_state={"count": jnp.asarray(step, jnp.int32),
                   "mu": {"w": jnp.full((4, 4), 2.0 * scale, jnp.float32)},
                   "nu": {"w": jnp.full((4, 4), 3.0 * scale, jnp.float32)}})


# ------------------------------------------------- the seeded scenarios
@dataclasses.dataclass
class Side:
    """One package's half of a scenario."""

    manager: type
    server: object
    restore: object
    state: object
    injector: object  # the seeded faults' injector, from a schedule
    registry: object  # the package's process-wide metrics


def jax_injector(faults):
    return ChaosCluster(InMemoryCluster(), ChaosSpec(
        seed=11, restore_faults=tuple(faults))).restore_fault_injector()


def port_injector(faults):
    return restore_faults.RestoreFaultInjector(tuple(
        restore_faults.ScheduledRestoreFault(**dataclasses.asdict(f)) for f in faults))


JAX = Side(JaxCheckpointManager, jax_start_shard_server, jax_restore, jax_state, jax_injector,
           JAX_METRICS)
PORT = Side(CheckpointManager, start_shard_server, restore_with_fallback, torch_state,
            port_injector, PORT_METRICS)


def restore_counts(registry) -> dict:
    """``{(path, cause): n}`` of ``training_restore_total`` in ``registry``."""
    counts = {}
    for line in registry.render().splitlines():
        if line.startswith("training_restore_total{"):
            labels, value = line[len("training_restore_total{"):].rsplit("} ", 1)
            path, cause = (part.split("=", 1)[1].strip('"') for part in labels.split('",'))
            counts[(path, cause.strip('"'))] = int(value)
    return counts


def refuse(op, at=1, count=1, **kw):
    return ScheduledRestoreFault(kind="refuse", op=op, at_call=at, count=count, **kw)


def fault(kind, op, at=1, count=1, **kw):
    return ScheduledRestoreFault(kind=kind, op=op, at_call=at, count=count, **kw)


# name: (layout, faults, the JAX outcome the test file pins, w after)
SCENARIOS = {
    "transient-refusal": ("peer", [refuse("meta")], ("peer", "ok", STEP), 3.0),
    "hard-refusal": ("peer", [refuse("*", count=999)],
                     ("storage", "peer-unreachable", STEP), 3.0),
    "peer-hang": ("peer", [fault("hang", "shard", count=999)],
                  ("storage", "peer-unreachable", STEP), 3.0),
    "stale-meta": ("peer", [fault("stale-meta", "meta-body")],
                   ("storage", "stale-snapshot", STEP), 3.0),
    "refuse-mid-fetch": ("peer", [refuse("shard", at=2, count=999)],
                         ("storage", "peer-unreachable", STEP), 3.0),
    "truncate": ("peer", [fault("truncate", "shard-body")],
                 ("storage", "checksum-mismatch", STEP), 3.0),
    "meta-hang": ("peer", [fault("hang", "meta", count=999)],
                  ("storage", "peer-unreachable", STEP), 3.0),
    "delta-fault-inert": ("peer", [fault("delta-missing-shard", "delta-shard", count=999)],
                          ("peer", "ok", STEP), 3.0),
    "die-mid-transfer": ("sharded", [fault("die-mid-transfer", "shard", peer=0)],
                         ("peer-sharded", "ok", STEP), 3.0),
    "stale-manifest": ("sharded", [fault("stale-manifest", "manifest-body", count=2)],
                       ("storage", "stale-snapshot", STEP), 3.0),
    "partial-owner": ("sharded", [fault("partial-owner", "manifest-body", count=2)],
                      ("peer-sharded", "ok", STEP), 3.0),
    "delta-clean": ("delta", [], ("storage", "ok", 2), 9.0),
    "delta-missing-shard": ("delta", [fault("delta-missing-shard", "delta-shard")],
                            ("storage", "delta-chain-broken", 1), 1.0),
    "delta-corrupt-shard": ("delta", [fault("delta-corrupt-shard", "delta-shard")],
                            ("storage", "delta-checksum-mismatch", 1), 1.0),
}


def run_scenario(side: Side, layout: str, faults, tmp_path):
    """Build the layout with ``side``'s package, restore twice under the
    same spec; returns [(outcome, fault log, sources by peer index)] and
    the restored state of the first run."""
    servers = []
    if layout == "delta":
        mgr = side.manager(str(tmp_path / "src"), delta_persist=True)
        mgr.save(side.state(step=1, scale=1.0), force=True)
        # Step 2 changes w, step and count; the moments carry forward.
        mgr.save(side.state(step=2, scale=1.0, w=9.0), force=True)
    else:
        mgr = side.manager(str(tmp_path / "src"))
        if layout == "sharded":
            servers = [side.server(mgr, slice_index=i, num_slices=2) for i in range(2)]
        else:
            servers = [side.server(mgr)]
        mgr.save(side.state(step=STEP, scale=3.0), force=True)
    mgr.wait()
    runs, first = [], None
    before = restore_counts(side.registry)
    try:
        for _ in range(2):
            injector = side.injector(faults)
            out = side.restore(side.state(step=0, scale=0.0), mgr, [s.address for s in servers],
                               retries=2, sharded=layout == "sharded",
                               fault_injector=injector, sleep=lambda _s: None)
            index = {s.address: i for i, s in enumerate(servers)}
            sources = {index.get(k, k): n for k, n in (out.sources or {}).items()}
            runs.append(((out.path, out.cause, out.step), list(injector.fault_log), sources))
            first = first or out.state
    finally:
        for s in servers:
            s.stop()
        mgr.close()
    after = restore_counts(side.registry)
    counted = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    return runs, first, counted


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_seeded_scenario_matches_the_jax_package(name, tmp_path):
    layout, faults, outcome, w = SCENARIOS[name]
    jax_runs, _, jax_counted = run_scenario(JAX, layout, faults, tmp_path / "jax")
    port_runs, state, port_counted = run_scenario(PORT, layout, faults, tmp_path / "port")
    assert jax_runs[0][0] == outcome
    assert port_runs[0] == jax_runs[0]  # outcome, fault log, sources
    assert port_counted == jax_counted == {outcome[:2]: 2}  # training_restore_total
    assert port_runs[1] == port_runs[0]  # replays byte-identically
    if faults and name != "delta-fault-inert":
        assert port_runs[0][1]
    assert state.step == outcome[2] and state.opt_state.count == outcome[2]
    assert torch.equal(state.model.w.detach(), torch.full((4, 4), w))
    scale = 3.0 if layout != "delta" else 1.0
    assert torch.equal(state.opt_state.nu[0], torch.full((4, 4), 3.0 * scale))


# ------------------------------------------------------------ port edges
def tiny_state(seed=0, steps=0):
    model = llama.Llama(llama.CONFIGS["llama-tiny"], device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(learning_rate=1e-2, warmup_steps=1)
    state, step = init_train_state(model, opt), make_train_step(opt)
    for batch in np.random.default_rng(seed).integers(0, 256, (steps, 2, 17)):
        state, _ = step(state, batch)
    return state


def bits(state):
    return {n: t.reshape(-1).view(torch.uint8).clone() for n, t in flatten_state(state).items()}


def same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


@pytest.fixture()
def served(tmp_path):
    """A bf16 llama-tiny state at step 2, durable and served."""
    mgr = CheckpointManager(str(tmp_path / "src"), model_meta={"heads": 4})
    server = start_shard_server(mgr)
    state = tiny_state(steps=2)
    mgr.save(state)
    mgr.wait()
    yield mgr, server, bits(state)
    server.stop()
    mgr.close()


@pytest.mark.parametrize("wire", ["bundle", "per-shard"])
def test_peer_restore_of_bf16_is_byte_exact(served, tmp_path, wire):
    mgr, server, want = served
    fresh = tiny_state(seed=9)
    # An injector with no faults selects the sequential per-shard wire.
    injector = RestoreFaultInjector(()) if wire == "per-shard" else None
    out = restore_with_fallback(fresh, CheckpointManager(str(tmp_path / "dst")),
                                [server.address], fault_injector=injector)
    assert (out.path, out.cause, out.step, out.peer) == ("peer", "ok", 2, server.address)
    assert out.state is fresh and same(bits(fresh), want)
    assert out.bytes_moved == sum(e["bytes"] for e in
                                  mgr._read_delta_manifest(2)["shards"].values())


def test_storage_and_scatter_gather_are_byte_exact(served, tmp_path):
    mgr, server, want = served
    fresh = tiny_state(seed=9)
    out = restore_with_fallback(fresh, mgr, [])
    assert (out.path, out.cause, out.step) == ("storage", "ok", 2) and same(bits(fresh), want)
    second = start_shard_server(mgr, slice_index=1, num_slices=2)
    try:
        fresh = tiny_state(seed=9)
        out = restore_with_fallback(fresh, CheckpointManager(str(tmp_path / "dst")),
                                    [server.address, second.address], sharded=True)
    finally:
        second.stop()
    assert (out.path, out.cause, out.step) == ("peer-sharded", "ok", 2)
    assert same(bits(fresh), want)
    assert sorted(out.sources) == sorted([server.address, second.address])


def test_have_list_moves_fewer_bytes_and_stays_byte_exact(served, tmp_path):
    mgr, server, want = served
    warm = tiny_state(steps=2)
    with torch.no_grad():
        warm.model.norm.scale.add_(1.0)  # one shard differs from the peer's
    warm.step = warm.opt_state.count = 0
    have = have_list(warm)
    assert len(have) == len(want)
    out = restore_with_fallback(warm, CheckpointManager(str(tmp_path / "dst")),
                                [server.address], have=True)
    assert (out.path, out.cause) == ("peer", "ok") and same(bits(warm), want)
    full = sum(e["bytes"] for e in mgr._read_delta_manifest(2)["shards"].values())
    assert 0 < out.bytes_moved < full / 10


def test_geometry_refusals_leave_the_state_untouched(served, tmp_path):
    _mgr, server, _ = served
    dst = CheckpointManager(str(tmp_path / "dst"))
    fresh = tiny_state(seed=9)
    before = bits(fresh)
    with pytest.raises(GeometryMismatch, match="heads"):
        restore_with_fallback(fresh, dst, [server.address], model_meta={"heads": 8})
    wide = llama.Llama(dataclasses.replace(llama.CONFIGS["llama-tiny"], ffn_dim=192),
                       device="cpu", generator=torch.Generator().manual_seed(9))
    wrong = init_train_state(wide, make_optimizer())
    wrong_before = bits(wrong)
    with pytest.raises(GeometryMismatch, match="shape"):
        restore_with_fallback(wrong, dst, [server.address])
    assert same(bits(fresh), before) and same(bits(wrong), wrong_before)


def test_unreachable_peer_and_first_boot(served, tmp_path):
    mgr, _server, want = served
    fresh = tiny_state(seed=9)
    out = restore_with_fallback(fresh, mgr, ["127.0.0.1:1"], timeout=0.2, retries=1,
                                backoff=0.0)
    assert (out.path, out.cause, out.step) == ("storage", "peer-unreachable", 2)
    assert same(bits(fresh), want)
    empty = CheckpointManager(str(tmp_path / "empty"))
    initial = tiny_state(seed=9)
    out = restore_with_fallback(initial, empty, [])
    assert (out.path, out.cause, out.step) == ("none", "no-peers", None)
    assert out.state is initial and initial.step == 0


def test_warm_start_reads_no_storage(served, tmp_path):
    _mgr, server, want = served

    class Counting(CheckpointManager):
        reads = 0

        def latest_step(self):
            Counting.reads += 1
            return super().latest_step()

        def restore_latest(self, state):
            Counting.reads += 1
            return super().restore_latest(state)

    fresh = tiny_state(seed=9)
    out = restore_with_fallback(fresh, Counting(str(tmp_path / "dst")), [server.address],
                                sharded=True, warm_start=True)
    assert (out.path, out.cause, out.step) == ("peer-sharded", "ok", 2)
    assert Counting.reads == 0 and same(bits(fresh), want)


def test_storage_shard_fill_and_its_step_rule(served, tmp_path):
    mgr, server, want = served
    both_die = (fault("die-mid-transfer", "shard", peer=0),
                fault("die-mid-transfer", "shard", peer=1))
    second = start_shard_server(mgr, slice_index=1, num_slices=2)
    peers = [server.address, second.address]
    try:
        fresh = tiny_state(seed=9)
        out = restore_with_fallback(fresh, mgr, peers, sharded=True,
                                    fault_injector=RestoreFaultInjector(both_die),
                                    sleep=lambda _s: None)
        assert (out.path, out.cause, out.step) == ("peer-sharded", "storage-shard-fill", 2)
        assert out.sources["storage"] > 0 and same(bits(fresh), want)
        # Storage a step behind the plan: no mixed-step fill, the whole
        # state comes from storage.
        behind = CheckpointManager(str(tmp_path / "behind"), model_meta={"heads": 4})
        older = tiny_state(steps=1)
        behind.save(older)
        behind.wait()
        fresh = tiny_state(seed=9)
        out = restore_with_fallback(fresh, behind, peers, sharded=True, warm_start=True,
                                    fault_injector=RestoreFaultInjector(both_die),
                                    sleep=lambda _s: None)
        assert (out.path, out.cause, out.step) == ("storage", "shard-fill-step-mismatch", 1)
        assert same(bits(fresh), bits(older))
    finally:
        second.stop()


def test_corrupt_bundle_is_rejected_by_checksum(served, tmp_path):
    mgr, server, want = served

    def corrupting(peer, path, timeout):
        status, headers, body = http_fetch(peer, path, timeout)
        if path.startswith("/v1/bundle"):
            body = body[:300] + bytes([body[300] ^ 0xFF]) + body[301:]
        return status, headers, body

    fresh = tiny_state(seed=9)
    out = restore_with_fallback(fresh, mgr, [server.address], fetcher=corrupting)
    assert (out.path, out.cause, out.step) == ("storage", "checksum-mismatch", 2)
    assert same(bits(fresh), want)
