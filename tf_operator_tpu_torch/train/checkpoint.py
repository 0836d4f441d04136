"""Checkpoint and resume, snapshot-then-persist: the port's counterpart of
``tf_operator_tpu/train/checkpoint.py``.

The operator keeps checkpointing out of itself: a replica that the
ExitCode restart policy recreates resumes from the framework's own
checkpoints, and the checkpoint-gated elastic shrink waits for the step a
rank publishes as durable. This module is the workload half of that
contract. A save has two phases:

- **snapshot**, a copy of the state taken at the step boundary. Training
  resumes when it returns; the copy is also kept in host memory as the
  shard source of peer restore (``runtime/shard_server.py``).
- **persist**, a background write of that copy. A step is DURABLE only
  once the persist is finalized, and only then do the durability
  listeners fire. ``record_checkpoint`` must be registered as a listener
  and never called after ``save()`` returns: the return proves only the
  snapshot, and a step published while its persist is in flight lets the
  autoscaler shrink against a checkpoint that a crash can still erase.

**Storage.** The JAX package writes orbax directories; the port has no
orbax, so its layout differs:

- A state that this process holds whole (one rank, or one rank per
  replica) is always persisted into the manifest store under
  ``<dir>/delta/``: ``shards/<sha256>.npy`` payload files (the wire's
  ``.npy`` encoding) and one ``manifest-<step>.json`` per durable step,
  ``{step, kind, chain_depth, model_meta, shards: {name: {checksum,
  bytes}}}``. With ``delta_persist`` off every persist is ``kind:
  "full"`` and rewrites every payload, so one resolver reads everything
  the port writes.
- A state sharded across ranks (FSDP2/TP DTensors over a world of more
  than one rank) has no host snapshot: no process holds it whole, and a
  DTensor's local tensor is its shard only. It is saved with
  ``torch.distributed.checkpoint.async_save`` into ``<dir>/dcp/<step>/``,
  is durable once the save's future completes and DCP's ``.metadata``
  exists, and is restored in place with ``torch.distributed.checkpoint.
  load``. Its storage restores go to DCP. At most one DCP save is in
  flight: each ``async_save`` runs its planning, writes and metadata
  gather on a thread of its own over the manager's gloo group, and two
  such threads would let the ranks run their collectives in different
  orders (a hang). A save waits for the one before it, as orbax's manager
  does. DCP writes ``.metadata`` on the coordinator after every rank's
  data is written and before any rank's future completes (its final
  all-reduce), so the step a rank publishes as durable is one that every
  rank of its world can restore. ``host_snapshot()`` stays None unless a
  shard server serves this manager (``serve_local_shards``): then a
  sharded save also keeps a host snapshot of this rank's own shards,
  tagged with the rank that holds them (:func:`shard_identity`), for a
  peer restore by the same rank of another replica.

**Delta persists** (``delta_persist=True``): between durable steps most
shards may be byte-identical, so the persist writes only payloads whose
checksum is new and carries the others forward by reference. Every
``delta_full_every``-th persist is full (``chain_depth`` back to 0), and
GC after each persist keeps the newest ``max_to_keep`` manifests plus the
newest full one and deletes unreferenced payloads. Payloads are renamed
into place before the manifest that references them, so a crash anywhere
leaves the previous manifest the newest durable step. A restore verifies
every payload's sha256; a missing payload (``delta-chain-broken``) or a
hash mismatch (``delta-checksum-mismatch``) degrades the WHOLE state to
the newest full manifest that verifies, with the cause kept on
``last_delta_degradation``.

**Telemetry.** A manifest persist observes its bytes, skipped shards and
chain depth, and every durability edge its seconds, into the port's
registry (``tf_operator_tpu_torch/metrics.py``) at the JAX module's
points, best-effort: a telemetry error never gates durability.
``last_persist_info`` carries the newest durable persist's numbers and its
``seconds`` split into ``split`` (:data:`PERSIST_PARTS`), which sums to
them.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..metrics import METRICS
from ..runtime.shard_server import encode_parts, flatten_state

log = logging.getLogger(__name__)

# The parts of a persist's seconds (save() to the durability edge), in
# ``last_persist_info["split"]``. A manifest persist: the snapshot's
# device-to-host copies issued in save() (host time: the pinned buffers
# and the enqueue) and, in the worker, waited for; the wait behind earlier
# persists; encoding (the .npy header and the bytes' view); sha256; the
# payload and manifest writes and renames; the retention GC. A DCP save:
# the wait for the previous save, async_save's own call (its CPU staging
# and planning), the wait behind earlier persists, its future, and the
# .metadata check and retention. Each persist has the parts of its kind.
PERSIST_PARTS = ("d2h_issue", "wait_previous", "dcp_stage", "queue", "d2h_wait", "encode",
                 "sha256", "write", "gc", "dcp_future", "finalize")


def geometry_mismatch(saved: Optional[dict], current: Optional[dict]) -> dict:
    """Keys whose recorded and current model geometry disagree: the guard
    against configs with identical flattened kernel shapes but different
    head grouping loading each other's checkpoints. Shared by the storage
    sidecar check and the peer-restore meta check."""
    if not saved or not current:
        return {}
    return {
        k: (saved[k], current[k])
        for k in saved.keys() & current.keys()
        if saved[k] != current[k]
    }


@dataclass
class HostSnapshot:
    """One step's host-resident copy of the state: the peer-restore shard
    source. ``tree`` is ``{name: host tensor}`` (``flatten_state``'s names),
    immutable once published: the shard server may be serving it. ``ready``
    is the CUDA event after the device-to-host copies (``started`` the one
    before them), None for a copy made on the host; nothing may read
    ``tree`` before :meth:`wait`. ``shard_of`` is :func:`shard_identity` of
    the state: None for a whole state."""

    step: int
    tree: Dict[str, torch.Tensor]
    model_meta: Optional[dict] = None
    ready: Optional[Any] = None
    started: Optional[Any] = None
    shard_of: Optional[dict] = None

    def wait(self) -> "HostSnapshot":
        if self.ready is not None:
            self.ready.synchronize()
        return self

    def copy_seconds(self) -> Optional[float]:
        """The device time of the copies (after :meth:`wait`), None on the
        host."""
        if self.ready is None:
            return None
        return self.started.elapsed_time(self.ready) / 1e3


def is_sharded(state) -> bool:
    """True when some parameter is a DTensor over more than one rank, or
    the model is one stage of a pipeline: no process holds the state whole
    (module doc, storage)."""
    return getattr(state.model, "stages", 1) > 1 or any(
        isinstance(p, DTensor) and p.device_mesh.size() > 1
        for p in state.model.parameters())


def shard_identity(state) -> Optional[dict]:
    """Which piece of the state this process holds: None for a whole
    state, else ``{"rank", "world", "mesh"}``, its rank in its world and
    the mesh of its DTensors (``{axis: size}``). Two processes hold the
    same shards of equal states only when these are equal."""
    if not is_sharded(state):
        return None
    mesh = next((p.device_mesh for p in state.model.parameters() if isinstance(p, DTensor)),
                None)
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {}
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "mesh": axes}


def take_snapshot(state, step: int, model_meta: Optional[dict] = None,
                  shard_of: Optional[dict] = None) -> HostSnapshot:
    """A finished, private host copy of a whole state.

    AdamW updates the parameters and moments IN PLACE (``train_step.py``),
    so the copy must own its storage and be complete before the next
    update runs:

    - On the CPU, ``t.cpu()`` and ``t.to("cpu")`` return the SAME storage,
      which the next step would overwrite while the persist thread is
      still writing it: every tensor is cloned.
    - On CUDA, each tensor is copied into a pinned host buffer by a
      non-blocking copy on the tensor's current stream, the stream that
      also runs the next step. Stream order makes the copy read the state
      before the next ``update_`` writes it, without blocking the host;
      the event recorded after the copies is what every reader of the
      buffers waits on (``HostSnapshot.wait``). A copy on a side stream
      would need the compute stream to wait on it, or the update races it.
    - The pinned buffers come from PyTorch's caching host allocator: a
      snapshot's buffers return to it only when nothing refers to the
      snapshot any more (the manager has published a newer one, the
      persist worker is done with it, the shard server has re-encoded),
      and the allocator reuses them for a later snapshot only after the
      copies recorded on them have completed. A served snapshot's buffers
      are therefore never overwritten, and only the first snapshots of a
      process pay for pinning (about 2.4 GB for llama-400m).
    """
    tree: Dict[str, torch.Tensor] = {}
    flat = flatten_state(state)
    devices = {t.device for t in flat.values() if t.device.type == "cuda"}
    if len(devices) > 1:
        raise ValueError(f"state spans {sorted(map(str, devices))}; one device per process")
    started = ready = None
    if devices:
        stream = torch.cuda.current_stream(next(iter(devices)))
        started, ready = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        started.record(stream)
    with torch.no_grad():
        for name, t in flat.items():
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.clone()
            tree[name] = host
    if devices:
        ready.record(stream)
    return HostSnapshot(step=step, tree=tree, model_meta=model_meta, ready=ready,
                        started=started, shard_of=shard_of)


def _dcp_state_dict(state) -> dict:
    """The DCP view of a sharded state. The moments are plain tensors
    shaped like their parameter's local shard; DCP would take a plain
    tensor for a replicated one and keep one rank's copy, so each is
    wrapped as a DTensor with its parameter's mesh and placements (a view:
    a load writes through it into the moment)."""
    named = [(n, p.detach()) for n, p in state.model.named_parameters()]

    def as_dtensor(t, p):
        if not isinstance(p, DTensor):
            return t
        return DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape,
                                  stride=p.stride(), run_check=False)

    opt = state.opt_state
    return {
        "step": torch.tensor(int(state.step), dtype=torch.int32),
        "model": dict(named),
        "opt": {
            "count": torch.tensor(int(opt.count), dtype=torch.int32),
            "mu": {n: as_dtensor(m, p) for (n, p), m in zip(named, opt.mu)},
            "nu": {n: as_dtensor(v, p) for (n, p), v in zip(named, opt.nu)},
        },
    }


class _DeltaBroken(Exception):
    """A manifest could not be fully resolved. ``cause`` is the named
    degradation ("delta-chain-broken" for a missing or unreadable payload,
    "delta-checksum-mismatch" for bytes that no longer hash to the
    manifest's record): the whole state degrades, never a shard at a
    time."""

    def __init__(self, cause: str, detail: str) -> None:
        super().__init__(detail)
        self.cause = cause


class CheckpointManager:
    """Snapshot-then-persist checkpoints of one ``TrainState`` in one
    directory, with the durability barrier and the manifest store (module
    doc). ``TF_OPERATOR_SYNC_CHECKPOINT=1`` persists inside ``save``."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        model_meta: Optional[dict] = None,
        delta_persist: bool = False,
        delta_full_every: int = 5,
    ):
        self.directory = os.path.abspath(directory)
        # Model-geometry sidecar: recorded at the first save, validated at
        # every restore and save (geometry_mismatch).
        self._model_meta = model_meta
        self._meta_path = os.path.join(self.directory, "model_meta.json")
        self.async_persist = os.environ.get(
            "TF_OPERATOR_SYNC_CHECKPOINT", "") not in ("1", "true", "yes")
        # Durability plumbing. The worker thread owns the persist tail: it
        # writes (or waits for) the bytes, THEN advances last_durable_step
        # and fires the listeners — the only place either ever happens,
        # so a listener never observes a step whose bytes are not there.
        self._listeners: List[Callable[[int], None]] = []
        self._durable_lock = threading.Lock()
        self._last_durable: Optional[int] = None
        self._last_snapshot_step: Optional[int] = None
        self._snapshot: Optional[HostSnapshot] = None
        self._persist_queue: "queue.Queue[tuple]" = queue.Queue()
        self._persist_thread: Optional[threading.Thread] = None
        self._persist_errors = 0
        self._closed = False
        self._cpu_group = None
        self._dcp_future = None  # the newest DCP save's (see the module doc)
        # Set by runtime/shard_server.start_shard_server: a sharded save
        # also keeps a host snapshot of this rank's shards (module doc).
        self.serve_local_shards = False
        # Test seam: called in the persist worker between the snapshot and
        # the storage write; a test blocks or raises here to hold a step
        # non-durable deterministically.
        self._persist_gate: Optional[Callable[[int], None]] = None
        self.delta_persist = bool(delta_persist)
        self.delta_full_every = max(1, int(delta_full_every))
        self._max_to_keep = max(1, int(max_to_keep))
        self._delta_dir = os.path.join(self.directory, "delta")
        self._delta_shards_dir = os.path.join(self._delta_dir, "shards")
        self._dcp_dir = os.path.join(self.directory, "dcp")
        self._delta_persist_count = 0
        # Stats of the newest persist this process finalized: a manifest
        # persist's {"kind", "step", "chain_depth", "bytes_written",
        # "shards_written", "shards_skipped"}, a DCP save's {"kind": "dcp",
        # "step"}; both with "seconds", its "split" (PERSIST_PARTS) and,
        # for a snapshot copied from the card, "d2h_device_seconds".
        self.last_persist_info: Optional[dict] = None
        # Seconds from save() to the durability edge of the newest durable
        # step.
        self.last_persist_seconds: Optional[float] = None
        # The named cause when the newest restore_latest() degraded off a
        # manifest; None on clean restores (train/restore.py reads it).
        self.last_delta_degradation: Optional[str] = None
        # Seeded-chaos seam (a RestoreFaultInjector, duck-typed: only its
        # fault_for is called): consulted once per manifest payload read,
        # op "delta-shard", peer index 0 — in a store of delta chains only
        # (_holds_chains). Its fault kinds are torn chains; a full-only
        # store is the JAX package's orbax rung, which has no consults, so
        # a seeded spec replays the same fault log in both packages.
        self.restore_fault_injector = None

    # ----------------------------------------------------------- sidecar
    def _write_meta(self) -> None:
        if self._model_meta is None or os.path.exists(self._meta_path):
            return
        tmp = f"{self._meta_path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self._meta_path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self._model_meta, f, sort_keys=True)
        os.replace(tmp, self._meta_path)

    def _validate_meta(self) -> None:
        if self._model_meta is None or not os.path.exists(self._meta_path):
            return
        with open(self._meta_path) as f:
            on_disk = json.load(f)
        mismatched = geometry_mismatch(on_disk, self._model_meta)
        if mismatched:
            raise ValueError(
                "checkpoint model geometry mismatch (saved vs current): "
                f"{mismatched} — refusing to mix checkpoints trained "
                "under different head/layer geometries in one directory"
            )

    # ----------------------------------------------------- manifest store
    def _delta_manifest_path(self, step: int) -> str:
        return os.path.join(self._delta_dir, f"manifest-{int(step)}.json")

    def _delta_manifest_steps(self) -> List[int]:
        """Sorted steps with a (finalized) manifest on disk."""
        try:
            entries = os.listdir(self._delta_dir)
        except OSError:
            return []
        steps = []
        for entry in entries:
            if entry.startswith("manifest-") and entry.endswith(".json"):
                try:
                    steps.append(int(entry[len("manifest-"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(steps)

    def _read_delta_manifest(self, step: int) -> Optional[dict]:
        try:
            with open(self._delta_manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _delta_latest_step(self) -> Optional[int]:
        steps = self._delta_manifest_steps()
        return steps[-1] if steps else None

    def persisted_shard_names(self):
        """Sorted shard names the newest manifest references: what this
        manager's checkpoint stream physically holds, the slice-derived
        ownership source of ``/v1/manifest``. A whole state's stream holds
        every name. Empty without a manifest, which tells the shard server
        to fall back to striding."""
        step = self._delta_latest_step()
        if step is None:
            return ()
        manifest = self._read_delta_manifest(step)
        if not manifest:
            return ()
        return tuple(sorted(manifest.get("shards", ())))

    def delta_chain_depth(self) -> Optional[int]:
        """Chain depth of the newest manifest (0 = full persist); None
        without a manifest."""
        step = self._delta_latest_step()
        if step is None:
            return None
        manifest = self._read_delta_manifest(step)
        if not manifest:
            return None
        return int(manifest.get("chain_depth", 0))

    @staticmethod
    def _write_file_atomic(path: str, *parts) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            for part in parts:
                f.write(part)
        os.replace(tmp, path)

    def _persist_delta(self, step: int, tree: Dict[str, torch.Tensor],
                       parts: Dict[str, float]) -> None:
        """One manifest persist, on the worker thread (or inline in sync
        mode). Ordering IS the durability contract: every payload the
        manifest references is renamed into place before the manifest
        itself is. The caller fires _mark_durable after this returns.
        Adds its encode, sha256, write and gc seconds to ``parts``."""
        clock = time.perf_counter
        encode = digest_s = write = 0.0
        t = clock()
        os.makedirs(self._delta_shards_dir, exist_ok=True)
        prev_step = self._delta_latest_step()
        prev = (self._read_delta_manifest(prev_step)
                if prev_step is not None else None)
        self._delta_persist_count += 1
        # Without delta_persist every persist is full. The chain bound: the
        # first persist of a lineage (or of a restarted process that
        # inherited one at the bound) and every delta_full_every-th
        # persist rewrite EVERYTHING.
        full = (
            not self.delta_persist
            or prev is None
            or (self._delta_persist_count - 1) % self.delta_full_every == 0
            or int(prev.get("chain_depth", 0)) + 1 >= self.delta_full_every
        )
        prev_sums = ({} if full or not prev
                     else {n: e["checksum"]
                           for n, e in prev.get("shards", {}).items()})
        entries: Dict[str, dict] = {}
        written = skipped = bytes_written = 0
        write += clock() - t  # the manifest reads above
        for name in sorted(tree):
            # Header and data are hashed and written in turn: no joined
            # second copy of a multi-GB state.
            t = clock()
            header, data = encode_parts(tree[name])
            t1 = clock()
            digest = hashlib.sha256(header)
            digest.update(data)
            checksum = digest.hexdigest()
            t2 = clock()
            encode += t1 - t
            digest_s += t2 - t1
            size = len(header) + data.nbytes
            entries[name] = {"checksum": checksum, "bytes": size}
            if prev_sums.get(name) == checksum:
                # Unchanged since the last durable step: carried forward
                # by reference — the payload file already exists.
                skipped += 1
                continue
            path = os.path.join(self._delta_shards_dir, f"{checksum}.npy")
            if full or not os.path.exists(path):
                self._write_file_atomic(path, header, data)
            write += clock() - t2
            written += 1
            bytes_written += size
        t = clock()
        chain_depth = 0 if full else int(prev.get("chain_depth", 0)) + 1
        manifest = {
            "step": int(step),
            "kind": "full" if full else "delta",
            "chain_depth": chain_depth,
            "model_meta": self._model_meta,
            "shards": entries,
        }
        manifest_bytes = json.dumps(manifest, sort_keys=True).encode()
        self._write_file_atomic(self._delta_manifest_path(step), manifest_bytes)
        t1 = clock()
        self._delta_gc()
        self.last_persist_info = {
            "kind": manifest["kind"],
            "step": int(step),
            "chain_depth": chain_depth,
            "bytes_written": bytes_written + len(manifest_bytes),
            "shards_written": written,
            "shards_skipped": skipped,
        }
        try:
            METRICS.observe_checkpoint_persist_bytes(
                manifest["kind"], bytes_written + len(manifest_bytes), skipped)
            METRICS.set_delta_chain_depth(chain_depth)
        except Exception:  # noqa: BLE001 — telemetry never gates durability
            pass
        parts.update(encode=encode, sha256=digest_s, write=write + t1 - t, gc=clock() - t1)

    def _delta_gc(self) -> None:
        """Retention: the newest max_to_keep manifests, PLUS the newest
        full manifest if none of those is full (the degradation target
        must survive), then every payload file no retained manifest
        references is deleted."""
        steps = self._delta_manifest_steps()
        if not steps:
            return
        manifests = {s: self._read_delta_manifest(s) for s in steps}
        keep = set(steps[-self._max_to_keep:])
        if not any((manifests[s] or {}).get("kind") == "full"
                   for s in keep):
            fulls = [s for s in steps
                     if (manifests[s] or {}).get("kind") == "full"]
            if fulls:
                keep.add(fulls[-1])
        referenced = set()
        for s in keep:
            for entry in (manifests[s] or {}).get("shards", {}).values():
                referenced.add(entry["checksum"])
        for s in steps:
            if s not in keep:
                try:
                    os.remove(self._delta_manifest_path(s))
                except OSError:
                    pass
        try:
            for entry in os.listdir(self._delta_shards_dir):
                if entry.endswith(".npy") and \
                        entry[:-len(".npy")] not in referenced:
                    os.remove(os.path.join(self._delta_shards_dir, entry))
        except OSError:
            pass

    def _holds_chains(self) -> bool:
        """True when this store is written in delta mode: this manager
        persists deltas, or a retained manifest is a delta."""
        return self.delta_persist or any(
            (self._read_delta_manifest(s) or {}).get("kind") == "delta"
            for s in self._delta_manifest_steps())

    def _resolve_delta(self, state, step: int):
        """Read, sha256-verify and copy one manifest's whole state into
        ``state``. Raises :class:`_DeltaBroken` on ANY shortfall before a
        byte of the state changes — the caller owns degradation to an
        older full manifest, never a partial mix."""
        from ..runtime.shard_server import shard_checksum
        from .restore import _assemble, charged

        manifest = self._read_delta_manifest(step)
        if not manifest or "shards" not in manifest:
            raise _DeltaBroken(
                "delta-chain-broken",
                f"manifest for step {step} unreadable")
        injector = self.restore_fault_injector if self._holds_chains() else None
        shards = {}
        for name in sorted(manifest["shards"]):
            entry = manifest["shards"][name]
            kind = (injector.fault_for("delta-shard", 0)
                    if injector is not None else None)
            if kind == "delta-missing-shard":
                raise _DeltaBroken(
                    "delta-chain-broken",
                    f"injected: payload for {name} missing from the store")
            path = os.path.join(
                self._delta_shards_dir, f"{entry['checksum']}.npy")
            try:
                with open(path, "rb") as f:
                    payload = f.read()
            except OSError as err:
                raise _DeltaBroken(
                    "delta-chain-broken",
                    f"shard {name} payload {entry['checksum']} missing "
                    f"from the store ({err})") from err
            if kind == "delta-corrupt-shard":
                payload = payload[: max(0, len(payload) // 2)]
            with charged("sha256"):
                good = shard_checksum(payload) == entry["checksum"]
            if not good:
                raise _DeltaBroken(
                    "delta-checksum-mismatch",
                    f"shard {name} failed sha256 verification against "
                    f"the step-{step} manifest")
            shards[name] = payload
        missing = sorted(set(flatten_state(state)) - set(shards))
        if missing:
            raise _DeltaBroken(
                "delta-chain-broken",
                f"manifest for step {step} lacks shard {missing[0]}")
        # bf16 payloads decode by the target's dtype (_assemble), never by
        # the header's, which says only "2-byte void".
        return _assemble(state, shards)

    # -------------------------------------------------------- DCP store
    def _dcp_path(self, step: int) -> str:
        return os.path.join(self._dcp_dir, str(int(step)))

    def _dcp_steps(self) -> List[int]:
        """Sorted steps whose DCP save finished (``.metadata`` exists)."""
        try:
            entries = os.listdir(self._dcp_dir)
        except OSError:
            return []
        return sorted(int(e) for e in entries if e.isdigit() and
                      os.path.exists(os.path.join(self._dcp_dir, e, ".metadata")))

    def _dcp_group(self):
        """This manager's own gloo group for DCP, made at its first sharded
        save or restore (every rank saves and restores at the same steps,
        so every rank makes it). DCP's async save needs a CPU backend, and
        its collectives run on the save's thread while the training
        thread's run on the default group: one group for both would let
        the ranks interleave them in different orders."""
        if self._cpu_group is None:
            self._cpu_group = dist.new_group(backend="gloo")
        return self._cpu_group

    def _wait_dcp(self) -> None:
        """Wait for the newest DCP save's thread to end (its failure is
        the persist worker's to report)."""
        if self._dcp_future is not None:
            concurrent.futures.wait([self._dcp_future])

    def _finalize_dcp(self, step: int, future, parts: Dict[str, float]) -> None:
        t = time.perf_counter()
        future.result()
        t1 = time.perf_counter()
        if not os.path.exists(os.path.join(self._dcp_path(step), ".metadata")):
            raise OSError(f"DCP save of step {step} finished without its .metadata")
        if dist.get_rank() == 0:
            for old in self._dcp_steps()[:-self._max_to_keep]:
                shutil.rmtree(self._dcp_path(old), ignore_errors=True)
        parts.update(dcp_future=t1 - t, finalize=time.perf_counter() - t1)
        self.last_persist_info = {"kind": "dcp", "step": int(step)}

    # ------------------------------------------------------ durability
    def add_durability_listener(self, cb: Callable[[int], None]) -> None:
        """Register cb(step), fired once per step AFTER its persist is
        finalized on storage — the only correct place to publish the
        checkpoint-step heartbeat rider (``record_checkpoint``)."""
        self._listeners.append(cb)

    def last_durable_step(self) -> Optional[int]:
        """Newest step this manager has FINALIZED on storage in this
        process's lifetime (None before the first persist completes —
        distinct from latest_step(), which also sees pre-existing
        checkpoints in the directory)."""
        with self._durable_lock:
            return self._last_durable

    def _mark_durable(self, step: int, persist_seconds: float, parts: Dict[str, float],
                      copy_seconds: Optional[float] = None) -> None:
        info = self.last_persist_info
        if info is not None and info.get("step") == step:
            info.update(seconds=persist_seconds, split=dict(parts))
            if copy_seconds is not None:
                info["d2h_device_seconds"] = copy_seconds
        with self._durable_lock:
            if self._last_durable is None or step > self._last_durable:
                self._last_durable = step
            self.last_persist_seconds = persist_seconds
        try:
            METRICS.observe_checkpoint_persist(persist_seconds)
        except Exception:  # noqa: BLE001 — telemetry never gates durability
            pass
        for cb in list(self._listeners):
            try:
                cb(step)
            except Exception:  # noqa: BLE001 — a broken listener must not
                # wedge the persist worker (later steps still need it).
                log.exception("checkpoint durability listener failed")

    def _persist(self, kind: str, step: int, payload,
                 parts: Dict[str, float]) -> Optional[float]:
        """Write (or finalize) one save; its parts' seconds go into
        ``parts``. Returns the device seconds of a snapshot's copies."""
        if kind == "delta":
            # Host-snapshot path: the bytes are read only after the
            # snapshot's copies have finished.
            t = time.perf_counter()
            payload.wait()
            parts["d2h_wait"] = time.perf_counter() - t
            self._persist_delta(step, payload.tree, parts)
            return payload.copy_seconds()
        self._finalize_dcp(step, payload, parts)
        return None

    def _persist_loop(self) -> None:
        while True:
            item = self._persist_queue.get()
            try:
                if item[0] == "stop":
                    return
                kind, step, payload, t0, parts, enqueued = item
                try:
                    if self._persist_gate is not None:
                        self._persist_gate(step)
                    parts["queue"] = time.perf_counter() - enqueued
                    copy_seconds = self._persist(kind, step, payload, parts)
                except Exception:  # noqa: BLE001
                    self._persist_errors += 1
                    log.exception(
                        "checkpoint persist for step %s failed — the step "
                        "is NOT durable and will never be published", step
                    )
                    continue
                finally:
                    del payload, item  # the snapshot's buffers may go back
                self._mark_durable(step, time.perf_counter() - t0, parts, copy_seconds)
            finally:
                self._persist_queue.task_done()

    def _ensure_worker(self) -> None:
        if self._persist_thread is None:
            self._persist_thread = threading.Thread(
                target=self._persist_loop, name="ckpt-persist", daemon=True
            )
            self._persist_thread.start()

    def host_snapshot(self) -> Optional[HostSnapshot]:
        """The newest host-resident snapshot (the peer-restore shard
        source), its copies finished, or None when no whole-state save
        (or, with ``serve_local_shards``, no sharded one) happened yet.
        May be ahead of last_durable_step(): a snapshot is servable the
        moment it exists."""
        snapshot = self._snapshot
        return snapshot.wait() if snapshot is not None else None

    # ------------------------------------------------------------ save
    def save(self, state, force: bool = False) -> bool:
        """Snapshot now, persist in the background. Returns True iff the
        step was accepted (snapshot taken + persist scheduled); the step
        is durable only when the durability listeners fire. A step that is
        already on disk, or already snapshotted, is a no-op (a final flush
        after a periodic save lands on the same step). The caller sets the
        cadence: every other step is saved, forced or not (``force`` is
        the JAX module's signature, whose orbax manager has an interval)."""
        step = int(state.step)
        if self.latest_step() == step or self._last_snapshot_step == step:
            return False
        # Save-only runs reusing a directory must not mix geometries under
        # one sidecar: validate against any existing record before writing.
        self._validate_meta()
        clock = time.perf_counter
        t0 = clock()
        parts: Dict[str, float] = {}
        if is_sharded(state):
            import torch.distributed.checkpoint as dcp

            if self.serve_local_shards:
                self._snapshot = take_snapshot(state, step, self._model_meta,
                                               shard_identity(state))
            t1 = clock()
            # async_save stages a CPU copy of every tensor before it
            # returns, so the next step's in-place update cannot reach the
            # bytes being written; the worker turns the future's end into
            # the durability edge. The previous save's collectives end
            # before this one's start (module doc).
            self._wait_dcp()
            t2 = clock()
            kind, payload = "finalize", dcp.async_save(
                _dcp_state_dict(state), checkpoint_id=self._dcp_path(step),
                process_group=self._dcp_group())
            self._dcp_future = payload
            issued = clock()
            parts.update(d2h_issue=t1 - t0, wait_previous=t2 - t1, dcp_stage=issued - t2)
        else:
            kind = "delta"
            payload = self._snapshot = take_snapshot(state, step, self._model_meta)
            issued = clock()
            parts["d2h_issue"] = issued - t0
        self._last_snapshot_step = step
        if self.async_persist:
            self._ensure_worker()
            self._persist_queue.put((kind, step, payload, t0, parts, issued))
        else:
            copy_seconds = self._persist(kind, step, payload, parts)
            self._mark_durable(step, clock() - t0, parts, copy_seconds)
        self._write_meta()
        return True

    # --------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = self._delta_manifest_steps()[-1:] + self._dcp_steps()[-1:]
        return max(steps) if steps else None

    def restore_latest(self, state) -> Tuple[Any, Optional[int]]:
        """Restore the newest checkpoint INTO ``state`` (its tensors, step
        and count, in place); returns (state, step) — (state unchanged,
        None) when no checkpoint exists yet. This is the STORAGE leg of
        the restore ladder; train/restore.py composes it with the peer
        path.

        A manifest at least as new as the newest DCP save resolves first;
        a broken resolution degrades the whole state to the newest full
        manifest that verifies, then to DCP, with the first named cause
        kept on ``last_delta_degradation``."""
        from .restore import charged

        self.last_delta_degradation = None
        delta_step = self._delta_latest_step()
        dcp_steps = self._dcp_steps()
        dcp_step = dcp_steps[-1] if dcp_steps else None
        if delta_step is not None and (dcp_step is None or delta_step >= dcp_step):
            with charged("geometry"):
                self._validate_meta()
            try:
                return self._resolve_delta(state, delta_step), delta_step
            except _DeltaBroken as err:
                self.last_delta_degradation = err.cause
                log.warning(
                    "delta restore of step %s degraded (%s: %s); falling "
                    "back to the newest full manifest", delta_step,
                    err.cause, err)
            fulls = [
                s for s in self._delta_manifest_steps()
                if s != delta_step
                and (self._read_delta_manifest(s) or {}).get("kind") == "full"
            ]
            for s in reversed(fulls):
                try:
                    return self._resolve_delta(state, s), s
                except _DeltaBroken as err:
                    log.warning(
                        "full manifest at step %s also broken (%s); "
                        "continuing down", s, err.cause)
        if dcp_step is None:
            return state, None
        with charged("geometry"):
            self._validate_meta()
        import torch.distributed.checkpoint as dcp

        self._wait_dcp()
        with torch.no_grad(), charged("dcp_load"):
            sd = _dcp_state_dict(state)
            dcp.load(sd, checkpoint_id=self._dcp_path(dcp_step),
                     process_group=self._dcp_group() if dist.is_initialized() else None)
        state.step = int(sd["step"])
        state.opt_state.count = int(sd["opt"]["count"])
        return state, dcp_step

    # -------------------------------------------------------- shutdown
    def wait(self) -> None:
        """Drain: every scheduled persist is finalized (and its listeners
        fired) when this returns."""
        if self._persist_thread is not None:
            self._persist_queue.join()

    def close(self) -> None:
        """Drain the persist queue and stop the worker: a completing (or
        failing) job must never exit with a write in flight. Idempotent;
        the host snapshot stays servable."""
        if self._closed:
            return
        self._closed = True
        if self._persist_thread is not None:
            self._persist_queue.join()
            self._persist_queue.put(("stop",))
            self._persist_thread.join(timeout=60.0)
            self._persist_thread = None
        self._wait_dcp()
        if self._cpu_group is not None and dist.is_initialized():
            dist.destroy_process_group(self._cpu_group)
        self._cpu_group = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
