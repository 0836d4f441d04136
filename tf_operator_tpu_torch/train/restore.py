"""Restore ladder: peer-to-peer shard fetch with degraded storage fallback;
the port's counterpart of ``tf_operator_tpu/train/restore.py``.

A recreated slice or a grown gang restores from, in order of preference:

1. **peer** — a survivor rank's host-resident snapshot, fetched over the
   ``runtime/shard_server.py`` wire (discovered via the heartbeat-lease
   peer-address rider, injected by the operator as
   ``TPU_PEER_RESTORE_ADDRS``). Skips the storage round-trip entirely.
2. **storage** — the checkpoint directory
   (``CheckpointManager.restore_latest``), whenever the peer path degrades.
3. **none** — fresh state (first boot: no peers AND no checkpoint).

Every rung restores INTO the live state: each fetched shard is validated
against its target (name, shape, element type) before any is copied, then
copied in place under ``torch.no_grad()``, and ``state.step`` and the
optimizer count are set from the ``step`` and ``opt/count`` shards. A
failure before the copy leaves the state as it was.

With ``sharded=True`` the peer rung becomes a **scatter-gather**: every
peer's ``/v1/manifest`` is probed, each shard is planned onto the
least-loaded claiming owner (ties to the lowest discovery index — a pure
function of the manifests in discovery order and the sorted names, so
seeded runs replay byte-identically), transfers run in parallel across
survivors, and a peer dying mid-transfer re-plans its unfetched shards
against the survivors left. Shards with no surviving source are filled
from storage — only when storage holds exactly the plan step (a
mixed-step fill would be torn state). A peer that predates the manifest
endpoint (404) is treated as a full owner. The sharded happy path reports
``path="peer-sharded"``.

With ``warm_start=True`` (the elastic-grow contract, ``TPU_WARM_START``)
the happy path never touches storage: no ``latest_step()`` probe, no
staleness arbitration. Peers all failing still degrades to storage with
the cause named.

With ``have=True`` the restoring rank hashes its CURRENT state into a
have-list ``{shard: checksum}``: the scatter-gather planner takes every
shard whose checksum matches the winning peer's meta from the local state
(source ``"local"``), and the bundle wire passes the list as
``/v1/bundle?have=`` so the server omits those frames.
``RestoreOutcome.bytes_moved`` counts the payload bytes that crossed the
wire on the peer path.

The STORAGE rung reads manifest layouts (``train/checkpoint.py``); a
broken chain degrades the whole state to the newest full step with the
named cause — ``delta-chain-broken`` / ``delta-checksum-mismatch`` —
surfaced on the outcome here.

Degradations and their recorded causes:

- ``no-peers``           — no addresses advertised (peer path not enabled,
                           or every survivor died with the slice)
- ``peer-unreachable``   — connect refused / per-peer timeout after
                           retry-with-backoff on every peer, or a peer
                           that rotated its snapshot (409) between its
                           meta and the bundle more times than the
                           retries (a rank alone asks the meta again
                           after each rotation; a sharded world does not)
- ``partial-snapshot``   — a peer answered but holds no servable snapshot
                           (a sharded state, or pre-first-save)
- ``stale-snapshot``     — the best peer's step is strictly older than
                           storage's newest checkpoint; storage wins
- ``checksum-mismatch``  — a shard failed sha256 verification (truncated
                           or corrupted in flight) and retries didn't heal
- ``storage-shard-fill`` — scatter-gather completed, but some shards lost
                           every surviving owner and were filled from
                           same-step storage (path stays "peer-sharded")
- ``shard-fill-step-mismatch`` — shards needed a storage fill but storage
                           does not hold the plan step; the whole state
                           degrades to storage (torn-state refusal)
- ``peer-shard-mismatch`` — a peer answered but serves another rank's
                           shards (its ``shard_of`` is not this rank's,
                           ``checkpoint.shard_identity``); never restored
- ``peer-step-mismatch`` — a sharded world's ranks each restored from a
                           peer, but not at one step (:class:`WorldGate`)

One failure is NOT a degradation: a ``model_meta`` geometry mismatch on
the peer path, or a shard whose shape differs from its target, hard-fails
(:class:`GeometryMismatch`): a peer serving another geometry is a config
error, and falling back to storage would mask it.

**A sharded world** (a DTensor state over several ranks, such as a
slice-local world of G cards a node) restores rank by rank: each rank asks
the peer that holds its own shards, the same rank of another replica
(``runtime/shard_server.local_peer_addresses``), and its storage rung is a
collective DCP load. ``commit`` (:class:`WorldGate`) makes every rank's
ladder vote once, before any rank copies a fetched byte into its state:
the fetched shards are copied only when every rank fetched and verified
its own at the same step; else every rank takes the storage rung together,
with one cause, and a scatter-gather fills no shard from storage alone.

**Seconds.** ``RestoreOutcome.split`` divides ``seconds`` into
:data:`RESTORE_PARTS`. It rides no heartbeat: the Lease's restore rider
stays the JAX package's ``path:cause:seconds[:bytes]``. Each outcome is
observed into the port's registry (``tf_operator_tpu_torch/metrics.py``),
best-effort, as the JAX module does at the end of the ladder.

Everything network-shaped goes through the ``fetcher`` seam, and the
``fault_injector`` (anything with ``fault_for(op, peer_index)``, such as
the operator's seeded ``RestoreFaultInjector``) can fault the path
deterministically without sockets.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote

import torch
import torch.distributed as dist

from ..metrics import METRICS
from ..runtime.shard_server import (
    decode_shard,
    encode_shard,
    flatten_state,
    parse_bundle,
    shard_checksum,
)

log = logging.getLogger(__name__)

# The parts of a restore's seconds: sha256 verification (and the
# have-list's hashing); decoding payloads into tensors; the copies into
# the state (host to device on the card); the geometry checks
# (model_meta, shapes, dtypes, the sidecar); a DCP load, which reads,
# decodes and copies in one call; a sharded world's vote (WorldGate),
# which waits for the slowest rank; and fetch, the rest: probes, fetches
# and file reads with their retries, and the ladder's bookkeeping (in a
# parallel scatter-gather, each group's sha256 too).
RESTORE_PARTS = ("fetch", "sha256", "decode", "h2d", "geometry", "dcp_load", "vote")
# A sharded world's probes: how often its ranks probe again when their
# peers' snapshots stand at different steps (a save between the probes).
AGREE_TRIES = 5
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("restore_split", default=None)


@contextlib.contextmanager
def charged(part: str):
    """Charge the block's seconds to ``part`` of the running ladder's
    split (nothing outside a ladder, or on another thread). Blocks do not
    nest."""
    split = _SPLIT.get()
    t = time.perf_counter()
    try:
        yield
    finally:
        if split is not None:
            split[part] = split.get(part, 0.0) + time.perf_counter() - t


class GeometryMismatch(ValueError):
    """Peer snapshot was trained under a different model geometry — a
    config error, never recoverable by falling back (see module doc)."""


@dataclass
class RestoreOutcome:
    """What the ladder decided, for the log line and the restore rider."""

    state: Any
    step: Optional[int]
    path: str          # "peer" | "peer-sharded" | "storage" | "none"
    cause: str         # "ok" on the happy paths, degradation cause otherwise
    seconds: float
    peer: Optional[str] = None  # winning peer address, peer path only
    # Scatter-gather attribution: shard counts per source ("<host:port>",
    # "storage" for per-shard fills, "local" for have-list matches).
    # None outside the sharded path.
    sources: Optional[Dict[str, int]] = None
    # Payload bytes that crossed the wire on the peer path; None on the
    # storage and none paths.
    bytes_moved: Optional[int] = None
    # ``seconds`` by RESTORE_PARTS (module doc); not on the heartbeat.
    split: Optional[Dict[str, float]] = None
    # The peer rungs' {shard: sha256 of its payload}, each verified before
    # the copy: what the state now holds. None on the other paths.
    checksums: Optional[Dict[str, str]] = None


def have_list(state) -> Dict[str, str]:
    """``{shard name: sha256 of its encoded payload}`` of a local state —
    the have-list a restoring rank advertises. The shard server's own
    encode-then-hash, so a match PROVES the local bytes equal the peer's."""
    with charged("sha256"):
        return {name: shard_checksum(encode_shard(t))
                for name, t in flatten_state(state).items()}


# ---------------------------------------------------------------- transport
def http_fetch(peer: str, path: str, timeout: float) -> Tuple[int, Dict[str, str], bytes]:
    """Default fetcher: one GET against ``http://<peer><path>``. Returns
    (status, headers, body); raises OSError/TimeoutError on transport
    failure — exactly what the retry loop classifies."""
    import urllib.error
    import urllib.request

    url = f"http://{peer}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:  # non-2xx still has a status
        return err.code, dict(err.headers or {}), err.read() or b""


def _fetch_with_retry(fetcher, peer: str, peer_index: int, path: str, *,
                      op: str, timeout: float, retries: int, backoff: float,
                      fault_injector=None, sleep=time.sleep):
    """Retry-with-backoff around one logical fetch. Seeded faults are
    consulted per attempt, so an ``at_call``-windowed fault can refuse the
    first attempt and let the retry through (transient-fault shape) or
    out-live the retry budget (hard-fault shape)."""
    last_err: Optional[BaseException] = None
    for attempt in range(retries + 1):
        if fault_injector is not None:
            kind = fault_injector.fault_for(op, peer_index)
            if kind == "refuse":
                last_err = ConnectionRefusedError("injected: connection refused")
                sleep(backoff * (2 ** attempt))
                continue
            if kind == "hang":
                # A hang IS a timeout from the client's point of view (no
                # real sleep — tests stay fast and deterministic).
                last_err = TimeoutError("injected: peer hang (timeout)")
                sleep(backoff * (2 ** attempt))
                continue
            if kind == "die-mid-transfer":
                # The peer died partway through this transfer: no retry —
                # retrying a dead peer burns budget the re-planner should
                # spend on survivors.
                raise ConnectionResetError(
                    "injected: peer died mid-transfer")
        try:
            status, headers, body = fetcher(peer, path, timeout)
        except (OSError, TimeoutError) as err:
            last_err = err
            sleep(backoff * (2 ** attempt))
            continue
        if fault_injector is not None and op == "shard":
            kind = fault_injector.fault_for("shard-body", peer_index)
            if kind == "truncate" and body:
                body = body[: max(0, len(body) // 2)]
        return status, headers, body
    raise last_err if last_err is not None else OSError("fetch failed")


# ------------------------------------------------------------------ ladder
class Vetoed(OSError):
    """This rank verified its shards, but another rank of its world did
    not (or not at the same step): nothing was copied (:class:`WorldGate`)."""

    def __init__(self, cause: str) -> None:
        super().__init__(f"a rank of the world voted against the peer restore ({cause})")
        self.cause = cause


def _decode_all(flat: Dict[str, torch.Tensor],
                shards: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every shard of ``flat`` (a state's ``flatten_state``) decoded and
    checked against its target (:func:`_assemble`), nothing copied."""
    values = {}
    for name, target in flat.items():
        if name not in shards:
            raise KeyError(name)
        value = shards[name]
        if not isinstance(value, torch.Tensor):
            # The dtype comes from the target: a bf16 payload's header
            # says only "2-byte void".
            with charged("decode"):
                value = decode_shard(value, target.dtype)
        with charged("geometry"):
            if tuple(value.shape) != tuple(target.shape):
                raise GeometryMismatch(
                    f"peer shard {name} has shape {tuple(value.shape)} but the "
                    f"local state expects {tuple(target.shape)} — refusing a "
                    "mixed-geometry restore"
                )
            if value.dtype != target.dtype:
                raise ValueError(f"shard {name} is {value.dtype}, the state holds "
                                 f"{target.dtype}")
        values[name] = value
    return values


def _assemble(state, shards: Dict[str, Any], commit=None):
    """Copy a restored state into ``state`` in place. ``shards`` maps every
    name of ``flatten_state(state)`` to a ``.npy`` payload or a tensor.
    Every shard is decoded and checked first, so a missing name
    (KeyError), an element type that is not the target's (ValueError) or
    a shape mismatch (GeometryMismatch) leaves the state untouched; then,
    when ``commit`` (a sharded world's :class:`WorldGate`) lets every rank
    go (else :class:`Vetoed`), each is copied into its target, and the step
    and count are set."""
    flat = flatten_state(state)
    try:
        values = _decode_all(flat, shards)
    except Exception:
        if commit is not None:
            with charged("vote"):
                commit(False, None, "geometry-mismatch")
        raise
    if commit is not None:
        with charged("vote"):
            go, cause = commit(True, int(values["step"]), "ok")
        if not go:
            raise Vetoed(cause)
    with torch.no_grad(), charged("h2d"):
        for name, target in flat.items():
            if name not in ("step", "opt/count") and values[name] is not target:
                target.copy_(values[name])
        # A copy into the card may still be queued; the restore ends when
        # the copies have run.
        if any(t.device.type == "cuda" for t in flat.values()):
            torch.cuda.synchronize()
    state.step = int(values["step"])
    state.opt_state.count = int(values["opt/count"])
    return state


class WorldGate:
    """The votes of a sharded world's ladder (module doc), collectives
    over ``group`` that every rank reaches at the same points of its
    ladder. :meth:`agree` settles the step the ranks fetch before any
    fetch; calling the gate, ``gate(ok, step, cause)``, once a rank, after
    its fetch and checks or instead of them, answers ``(go, cause)``: go
    only when every rank verified its own shards at one step, else the
    cause of the lowest rank that failed, or ``peer-step-mismatch`` (a
    later call returns the first answer)."""

    def __init__(self, group=None):
        self.group = group
        self._answer: Optional[Tuple[bool, str]] = None

    def _gather(self, item) -> list:
        items: List[Any] = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(items, item, group=self.group)
        return items

    def agree(self, step: Optional[int], cause: str) -> Tuple[Optional[int], str, bool]:
        """Each rank's newest usable peer step (None: none, for ``cause``):
        ``(step, cause, again)``, the step every rank's peer serves, or
        None with the lowest such rank's cause, and whether to probe again
        (every rank has a peer, at different steps: a snapshot rotated
        between the probes)."""
        votes = self._gather((step, cause))
        missing = [c for s, c in votes if s is None]
        if missing:
            return None, missing[0], False
        if len({s for s, _ in votes}) > 1:
            return None, "peer-step-mismatch", True
        return votes[0][0], "ok", False

    def __call__(self, ok: bool, step: Optional[int], cause: str) -> Tuple[bool, str]:
        if self._answer is None:
            votes = self._gather((bool(ok), step, cause))
            failed = [c for good, _, c in votes if not good]
            if failed:
                self._answer = (False, failed[0])
            elif len({s for _, s, _ in votes}) > 1:
                self._answer = (False, "peer-step-mismatch")
            else:
                self._answer = (True, "ok")
        return self._answer


def _restore_from_peer(state, ckpt, peer: str, peer_index: int, meta: dict, *,
                       fetcher, timeout: float, retries: int, backoff: float,
                       fault_injector, sleep,
                       have: Optional[Dict[str, str]] = None, commit=None,
                       ) -> Tuple[Any, int]:
    """Fetch + verify + copy one peer's snapshot into ``state``; returns
    (state, payload bytes moved). Raises on any failure; the caller owns
    fallback. ``have`` prunes the transfer: shards whose local checksum
    matches the peer meta are taken from the local state."""
    step = int(meta["step"])
    bytes_moved = 0

    def fetch_one(name: str):
        nonlocal bytes_moved
        expect = meta["shards"][name]["checksum"]
        status, _, body = _fetch_with_retry(
            fetcher, peer, peer_index,
            f"/v1/shard/{quote(name)}?step={step}",
            op="shard", timeout=timeout, retries=retries, backoff=backoff,
            fault_injector=fault_injector, sleep=sleep,
        )
        if status != 200:
            raise OSError(f"peer {peer} returned {status} for shard {name}")
        with charged("sha256"):
            good = shard_checksum(body) == expect
        if not good:
            raise ChecksumMismatch(
                f"shard {name} from {peer} failed sha256 verification"
            )
        bytes_moved += len(body)
        return body

    names = sorted(meta["shards"])
    shards: Dict[str, Any] = {}
    needed = names
    if have:
        local_flat = flatten_state(state)
        needed = []
        for name in names:
            if have.get(name) == meta["shards"][name]["checksum"] \
                    and name in local_flat:
                # Byte-identical locally (same encode, same sha256): the
                # warm tensor IS the restored value.
                shards[name] = local_flat[name]
            else:
                needed.append(name)
    if fault_injector is not None:
        # Sorted, sequential, per-shard: the seeded fault injector counts
        # calls, and byte-equal replay needs the same request sequence
        # every run.
        for name in needed:
            shards[name] = fetch_one(name)
        return _assemble(state, shards, commit), bytes_moved

    # Production path: one bundle request for the whole state. Every
    # framed payload is still verified against the meta checksum.
    bundle_path = f"/v1/bundle?step={step}"
    if have and len(needed) < len(names):
        matched = [n for n in names if n not in needed]
        bundle_path += "&have=" + ",".join(
            f"{quote(n, safe='')}:{have[n]}" for n in matched)
    status, _, body = _fetch_with_retry(
        fetcher, peer, peer_index, bundle_path,
        op="bundle", timeout=timeout, retries=retries, backoff=backoff,
        fault_injector=fault_injector, sleep=sleep,
    )
    if status == 404:
        # Older peer without the bundle endpoint: per-shard wire.
        for name in needed:
            shards[name] = fetch_one(name)
        return _assemble(state, shards, commit), bytes_moved
    if status == 409:
        raise StepRotated(f"peer {peer} rotated past step {step} before the bundle")
    if status != 200:
        raise OSError(f"peer {peer} returned {status} for bundle")
    frames = parse_bundle(body)
    del body
    for name in needed:
        payload = frames.get(name)
        if payload is None:
            raise OSError(f"peer {peer} bundle missing shard {name}")
        with charged("sha256"):
            good = shard_checksum(payload) == meta["shards"][name]["checksum"]
        if not good:
            raise ChecksumMismatch(
                f"shard {name} from {peer} failed sha256 verification"
            )
        bytes_moved += len(payload)
        shards[name] = payload
    return _assemble(state, shards, commit), bytes_moved


class ChecksumMismatch(OSError):
    """A fetched shard's bytes don't hash to the advertised checksum."""


class StepRotated(OSError):
    """The peer took a newer snapshot between its meta and the bundle
    (409): its meta is asked again (:func:`_ladder`)."""


class ShardFillStepMismatch(OSError):
    """Shards lost every surviving peer source and storage does not hold
    the plan step — a per-shard fill from a different step would assemble
    torn state, so the whole state must degrade to storage instead."""


# ---------------------------------------------------------- scatter-gather
def plan_scatter(shard_names: Sequence[str],
                 owners: Dict[int, set]) -> Dict[str, int]:
    """Assign each shard to a peer: among the peers claiming ownership
    (falling back to ALL live peers for orphaned names — ownership is a
    planning hint, every survivor serves every shard), pick the one with
    the fewest shards assigned so far, ties to the lowest discovery
    index. Pure function of (sorted names, owners map) so a seeded run
    plans — and replays — identically."""
    assignments: Dict[str, int] = {}
    load = {index: 0 for index in owners}
    all_indices = sorted(owners)
    for name in sorted(shard_names):
        claiming = [i for i in all_indices if name in owners[i]]
        candidates = claiming or all_indices
        pick = min(candidates, key=lambda i: (load[i], i))
        assignments[name] = pick
        load[pick] += 1
    return assignments


def _fetch_one_shard(fetcher, peer: str, peer_index: int, name: str,
                     step: int, expect: str, *, timeout, retries, backoff,
                     fault_injector, sleep):
    """One shard's payload off one peer, verified. Raises on any failure;
    the scatter-gather loop owns re-planning."""
    status, _, body = _fetch_with_retry(
        fetcher, peer, peer_index, f"/v1/shard/{quote(name)}?step={step}",
        op="shard", timeout=timeout, retries=retries, backoff=backoff,
        fault_injector=fault_injector, sleep=sleep,
    )
    if status != 200:
        raise OSError(f"peer {peer} returned {status} for shard {name}")
    with charged("sha256"):
        good = shard_checksum(body) == expect
    if not good:
        raise ChecksumMismatch(
            f"shard {name} from {peer} failed sha256 verification"
        )
    return body, len(body)


def _storage_shard_fill(state, ckpt, step: int, names: Sequence[str]):
    """The per-shard degraded rung: the named shards' values from storage —
    legal solely when storage holds exactly the plan step (module doc: a
    mixed-step fill is torn state). Storage restores the whole state in
    place at that step; the caller's assembly then copies the fetched
    shards over it."""
    latest = ckpt.latest_step()
    if latest != step:
        raise ShardFillStepMismatch(
            f"storage holds step {latest} but the scatter-gather plan is "
            f"step {step}; refusing a mixed-step shard fill"
        )
    restored, _ = ckpt.restore_latest(state)
    flat = flatten_state(restored)
    out = {}
    for name in names:
        if name not in flat:
            raise KeyError(name)
        out[name] = flat[name]
    return out


def _restore_sharded(state, ckpt, candidates, step: int, *, fetcher,
                     timeout: float, retries: int, backoff: float,
                     fault_injector, sleep,
                     have: Optional[Dict[str, str]] = None, commit=None):
    """Scatter-gather restore against every candidate peer at ``step``.

    ``candidates`` is ``[(peer_index, peer, manifest)]`` in discovery
    order. Loops plan -> fetch -> re-plan: any peer failure marks that
    peer dead for the rest of the restore and its unfetched shards are
    re-planned against the survivors; shards that run out of peers are
    filled from same-step storage. ``have`` prunes the plan BEFORE any
    fetch. Returns ``(state, sources, bytes_moved)`` where sources counts
    shards per serving address (plus "storage" and "local")."""
    live = {}
    all_names = None
    reference_manifest = None
    for index, peer, manifest in candidates:
        names = sorted(manifest["shards"])
        if all_names is None:
            all_names = names
            reference_manifest = manifest
        owned = manifest.get("owned")
        live[index] = {
            "peer": peer,
            "manifest": manifest,
            # A manifest-less (bundle-era) peer claims everything.
            "owned": set(owned) if owned is not None else set(names),
        }
    shards: Dict[str, Any] = {}
    sources: Dict[str, int] = {}
    bytes_moved = 0
    remaining = list(all_names or ())
    if have and reference_manifest is not None:
        local_flat = flatten_state(state)
        pruned = []
        for name in remaining:
            expect = reference_manifest["shards"][name]["checksum"]
            if have.get(name) == expect and name in local_flat:
                shards[name] = local_flat[name]
                sources["local"] = sources.get("local", 0) + 1
            else:
                pruned.append(name)
        remaining = pruned

    def fetch_group(index: int, names: Sequence[str]):
        """Sequentially pull one peer's assigned shards. Returns
        (fetched, unfetched, group_bytes) — a failure abandons the rest
        of the group (the peer is presumed dead; the re-planner owns its
        shards)."""
        entry = live[index]
        fetched: Dict[str, Any] = {}
        unfetched: List[str] = []
        group_bytes = 0
        for pos, name in enumerate(names):
            try:
                fetched[name], nbytes = _fetch_one_shard(
                    fetcher, entry["peer"], index, name, step,
                    entry["manifest"]["shards"][name]["checksum"],
                    timeout=timeout, retries=retries, backoff=backoff,
                    fault_injector=fault_injector, sleep=sleep,
                )
                group_bytes += nbytes
            except (OSError, TimeoutError, ValueError, KeyError) as err:
                log.warning("peer %s lost mid-scatter (%s); re-planning "
                            "%d shard(s)", entry["peer"], err,
                            len(names) - pos)
                unfetched = list(names[pos:])
                break
        return fetched, unfetched, group_bytes

    while remaining:
        if not live:
            if commit is not None:
                # A sharded world's storage rung is a collective load.
                raise ShardFillStepMismatch(
                    "a rank of a sharded world fills no shard from storage alone")
            fill = _storage_shard_fill(state, ckpt, step, remaining)
            shards.update(fill)
            sources["storage"] = sources.get("storage", 0) + len(fill)
            break
        plan = plan_scatter(
            remaining, {i: e["owned"] for i, e in live.items()})
        groups: Dict[int, List[str]] = {}
        for name in sorted(plan):
            groups.setdefault(plan[name], []).append(name)
        failed: List[str] = []
        dead: List[int] = []
        if fault_injector is not None or len(groups) <= 1:
            # Deterministic sequential wire: peers in discovery order,
            # each group in sorted shard order — the consult-counter
            # sequence the seeded injector replays byte-identically.
            results = [(i, fetch_group(i, groups[i])) for i in sorted(groups)]
        else:
            from concurrent.futures import ThreadPoolExecutor

            # The pool's threads run outside the ladder's split: its wall
            # time is charged to fetch, sha256 included.
            with ThreadPoolExecutor(max_workers=len(groups)) as pool:
                futures = [
                    (i, pool.submit(fetch_group, i, groups[i]))
                    for i in sorted(groups)
                ]
                results = [(i, f.result()) for i, f in futures]
        for index, (fetched, unfetched, group_bytes) in results:
            shards.update(fetched)
            bytes_moved += group_bytes
            if fetched:
                peer = live[index]["peer"]
                sources[peer] = sources.get(peer, 0) + len(fetched)
            if unfetched:
                failed.extend(unfetched)
                dead.append(index)
        for index in dead:
            live.pop(index, None)
        remaining = failed
    return _assemble(state, shards, commit), sources, bytes_moved


def restore_with_fallback(
    state,
    ckpt,
    peers: Sequence[str] = (),
    *,
    model_meta: Optional[dict] = None,
    timeout: float = 5.0,
    retries: int = 2,
    backoff: float = 0.2,
    fetcher: Callable[[str, str, float], Tuple[int, Dict[str, str], bytes]] = http_fetch,
    fault_injector=None,
    sleep: Callable[[float], None] = time.sleep,
    sharded: bool = False,
    warm_start: bool = False,
    have: bool = False,
    commit=None,
) -> RestoreOutcome:
    """Run the restore ladder (module doc) into ``state`` and return the
    outcome (``outcome.state`` is ``state``), its seconds split, observed
    into the registry.

    ``peers`` are ``host:port`` strings in discovery order; ``model_meta``
    is the local geometry to validate peer metas against (defaults to the
    checkpoint manager's); ``fetcher``/``fault_injector``/``sleep`` are the
    determinism seams. ``sharded`` turns the peer rung into the
    scatter-gather plan; ``warm_start`` skips the storage staleness probe
    so the happy path performs zero storage reads; ``have`` advertises the
    current state's per-shard checksums so the peer rung transfers only
    the shards that differ; ``commit`` is a sharded world's
    :class:`WorldGate` (module doc).
    """
    split: Dict[str, float] = {}
    token = _SPLIT.set(split)
    t0 = time.perf_counter()
    try:
        outcome = _ladder(state, ckpt, peers, model_meta=model_meta, timeout=timeout,
                          retries=retries, backoff=backoff, fetcher=fetcher,
                          fault_injector=fault_injector, sleep=sleep, sharded=sharded,
                          warm_start=warm_start, have=have, commit=commit)
    finally:
        _SPLIT.reset(token)
    outcome.seconds = time.perf_counter() - t0
    split["fetch"] = max(outcome.seconds - sum(split.values()), 0.0)  # the rest
    outcome.split = split
    _observe(outcome)
    return outcome


def _checksums(meta: dict) -> Dict[str, str]:
    return {name: entry["checksum"] for name, entry in meta["shards"].items()}


def checksum_digest(checksums: Dict[str, str]) -> str:
    """One sha256 over ``{shard: checksum}`` in name order: equal digests
    mean equal bytes in every shard (a restore's ``checksums``, or a
    manifest's)."""
    text = "".join(f"{name}:{checksums[name]}\n" for name in sorted(checksums))
    return hashlib.sha256(text.encode()).hexdigest()


def _observe(outcome: RestoreOutcome) -> None:
    try:
        METRICS.observe_restore(outcome.path, outcome.cause, outcome.seconds)
        if outcome.bytes_moved is not None:
            METRICS.observe_restore_bytes(outcome.path, outcome.bytes_moved)
    except Exception:  # noqa: BLE001 — telemetry never gates a restore
        pass


def _probe(peers, *, fetcher, timeout, retries, backoff, fault_injector, sleep, sharded,
           storage_step, model_meta, mine):
    """Every peer's meta (or manifest), in discovery order: ``(best,
    probed, cause)``, the newest usable peer ``(index, peer, meta)`` or
    None, every usable one, and the cause of the last one that was not."""
    from .checkpoint import geometry_mismatch

    cause = "no-peers"
    best: Optional[Tuple[int, str, dict]] = None  # (peer_index, peer, meta)
    probed: List[Tuple[int, str, dict]] = []
    for index, peer in enumerate(peers):
        probe_path = "/v1/manifest" if sharded else "/v1/meta"
        probe_op = "manifest" if sharded else "meta"
        try:
            status, _, body = _fetch_with_retry(
                fetcher, peer, index, probe_path, op=probe_op,
                timeout=timeout, retries=retries, backoff=backoff,
                fault_injector=fault_injector, sleep=sleep,
            )
            if sharded and status == 404:
                # Bundle-era peer that predates /v1/manifest: probe the
                # meta endpoint instead and treat the peer as a full owner.
                status, _, body = _fetch_with_retry(
                    fetcher, peer, index, "/v1/meta", op="meta",
                    timeout=timeout, retries=retries, backoff=backoff,
                    fault_injector=fault_injector, sleep=sleep,
                )
        except (OSError, TimeoutError):
            cause = "peer-unreachable"
            log.warning("peer %s unreachable for restore meta", peer)
            continue
        if status == 503:
            cause = "partial-snapshot"
            continue
        if status != 200:
            cause = "peer-unreachable"
            continue
        try:
            meta = json.loads(body)
        except ValueError:
            cause = "peer-unreachable"
            continue
        if fault_injector is not None and sharded:
            kind = fault_injector.fault_for("manifest-body", index)
            if kind == "stale-manifest":
                # The manifest a real straggler would serve: one step
                # behind whatever storage has finalized.
                meta = dict(meta)
                meta["step"] = (storage_step if storage_step is not None
                                else int(meta["step"])) - 1
            elif kind == "partial-owner" and meta.get("owned"):
                # A survivor that lost half its claimed stride: claims only
                # the front half, leaving orphans for the planner's
                # all-peers fallback.
                meta = dict(meta)
                owned = list(meta["owned"])
                meta["owned"] = owned[: (len(owned) + 1) // 2]
        elif fault_injector is not None:
            kind = fault_injector.fault_for("meta-body", index)
            if kind == "stale-meta":
                meta = dict(meta)
                meta["step"] = (storage_step if storage_step is not None
                                else int(meta["step"])) - 1
        with charged("geometry"):
            mismatched = geometry_mismatch(meta.get("model_meta"), model_meta)
        if mismatched:
            raise GeometryMismatch(
                "peer checkpoint model geometry mismatch (peer vs local): "
                f"{mismatched} from {peer} — a mixed-geometry gang is a "
                "config error; refusing to fall back silently"
            )
        if meta.get("shard_of") != mine:
            # Another rank's shards (or a whole state for a sharded one):
            # never restored, whatever the shapes say.
            cause = "peer-shard-mismatch"
            log.warning("peer %s serves shards of %s; this rank holds %s", peer,
                        meta.get("shard_of"), mine)
            continue
        probed.append((index, peer, meta))
        if best is None or int(meta["step"]) > int(best[2]["step"]):
            best = (index, peer, meta)
    return best, probed, cause


def _ladder(state, ckpt, peers, *, model_meta, timeout, retries, backoff, fetcher,
            fault_injector, sleep, sharded, warm_start, have, commit) -> RestoreOutcome:
    from .checkpoint import shard_identity

    t0 = time.perf_counter()
    if model_meta is None:
        model_meta = getattr(ckpt, "_model_meta", None)
    if fault_injector is not None and \
            hasattr(ckpt, "restore_fault_injector"):
        # Hand the seeded injector to the storage rung too: delta-chain
        # fault kinds fire inside CheckpointManager's manifest resolution.
        ckpt.restore_fault_injector = fault_injector
    have_map: Optional[Dict[str, str]] = have_list(state) if have else None
    # Warm start: don't even ask storage what it has (the latest_step()
    # probe is itself a storage read the zero-read contract forbids).
    storage_step = None if warm_start else ckpt.latest_step()
    mine = shard_identity(state)

    for attempt in range(AGREE_TRIES):
        best, probed, cause = _probe(peers, fetcher=fetcher, timeout=timeout,
                                     retries=retries, backoff=backoff,
                                     fault_injector=fault_injector, sleep=sleep,
                                     sharded=sharded, storage_step=storage_step,
                                     model_meta=model_meta, mine=mine)
        if commit is None:
            break
        # A sharded world fetches at one step or not at all.
        with charged("vote"):
            step, world_cause, again = commit.agree(
                int(best[2]["step"]) if best is not None else None, cause)
        if step is not None or not again or attempt == AGREE_TRIES - 1:
            if step is None:
                best, cause = None, world_cause
            break
        sleep(backoff)

    if best is not None and sharded:
        best_step = int(best[2]["step"])
        if storage_step is not None and best_step < storage_step:
            cause = "stale-snapshot"
            log.warning(
                "peer snapshot step %d staler than storage step %d; "
                "falling back to storage", best_step, storage_step,
            )
        else:
            # Every peer serving the winning step joins the scatter plan;
            # stragglers on an older step are excluded.
            candidates = [
                entry for entry in probed
                if int(entry[2]["step"]) == best_step
            ]
            try:
                restored, sources, moved = _restore_sharded(
                    state, ckpt, candidates, best_step,
                    fetcher=fetcher, timeout=timeout, retries=retries,
                    backoff=backoff, fault_injector=fault_injector,
                    sleep=sleep, have=have_map, commit=commit,
                )
            except GeometryMismatch:
                raise
            except Vetoed as err:
                cause = err.cause
            except ShardFillStepMismatch as err:
                cause = "shard-fill-step-mismatch"
                log.warning("sharded restore degraded: %s", err)
            except ChecksumMismatch as err:
                cause = "checksum-mismatch"
                log.warning("sharded restore degraded: %s", err)
            except (OSError, TimeoutError, KeyError, ValueError) as err:
                cause = "peer-unreachable"
                log.warning("sharded restore degraded: %s", err)
            else:
                return RestoreOutcome(
                    state=restored, step=best_step, path="peer-sharded",
                    cause=("storage-shard-fill" if "storage" in sources
                           else "ok"),
                    seconds=time.perf_counter() - t0, peer=best[1],
                    sources=sources, bytes_moved=moved,
                    checksums=_checksums(candidates[0][2]),
                )
    elif best is not None:
        index, peer, meta = best
        peer_step = int(meta["step"])
        if storage_step is not None and peer_step < storage_step:
            cause = "stale-snapshot"
            log.warning(
                "peer snapshot step %d staler than storage step %d; "
                "falling back to storage", peer_step, storage_step,
            )
        else:
            for rotation in range(retries + 1):
                try:
                    restored, moved = _restore_from_peer(
                        state, ckpt, peer, index, meta,
                        fetcher=fetcher, timeout=timeout, retries=retries,
                        backoff=backoff, fault_injector=fault_injector,
                        sleep=sleep, have=have_map, commit=commit,
                    )
                except GeometryMismatch:
                    raise
                except Vetoed as err:
                    cause = err.cause
                except ChecksumMismatch as err:
                    cause = "checksum-mismatch"
                    log.warning("peer restore degraded: %s", err)
                except (OSError, TimeoutError, KeyError, ValueError) as err:
                    cause = "peer-unreachable"
                    log.warning("peer restore degraded: %s", err)
                    if isinstance(err, StepRotated) and commit is None \
                            and rotation < retries:
                        # A survivor that trains on saves while a restore
                        # asks it: its newer snapshot is as good.
                        best, _, cause = _probe(
                            peers, fetcher=fetcher, timeout=timeout, retries=retries,
                            backoff=backoff, fault_injector=fault_injector, sleep=sleep,
                            sharded=False, storage_step=storage_step,
                            model_meta=model_meta, mine=mine)
                        if best is not None:
                            index, peer, meta = best
                            peer_step = int(meta["step"])
                            continue
                else:
                    return RestoreOutcome(
                        state=restored, step=peer_step, path="peer", cause="ok",
                        seconds=time.perf_counter() - t0, peer=peer,
                        bytes_moved=moved, checksums=_checksums(meta),
                    )
                break

    if commit is not None:
        # Every rank of the world takes the storage rung together, with
        # the world's cause (a no-op answer for a rank that already voted).
        with charged("vote"):
            _, cause = commit(False, None, cause)
    restored, step = ckpt.restore_latest(state)
    # A manifest chain that degraded to an older full step names its cause;
    # surface it over the generic peer-rung cause.
    delta_cause = getattr(ckpt, "last_delta_degradation", None)
    if step is None:
        return RestoreOutcome(
            state=state, step=None, path="none", cause=delta_cause or cause,
            seconds=time.perf_counter() - t0,
        )
    return RestoreOutcome(
        state=restored, step=step, path="storage",
        cause=delta_cause or (
            "ok" if cause == "no-peers" and not peers else cause),
        seconds=time.perf_counter() - t0,
    )
