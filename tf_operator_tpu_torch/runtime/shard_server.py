"""Peer-restore shard server: the port's copy of
``tf_operator_tpu/runtime/shard_server.py``, over torch tensors.

Each rank runs a small read-only HTTP server over its newest host snapshot
(``train/checkpoint.py``) and advertises ``host:port`` on the heartbeat
lease's peer-address rider; a restoring rank fetches shards from any
advertised survivor and falls back to storage only when no peer can serve
(``train/restore.py`` owns that ladder). The endpoints, status codes and
framing are the JAX module's, byte for byte:

- ``GET /v1/meta`` -> ``{step, model_meta, shards: {name: {checksum,
  bytes, dtype, shape}}}``; 503 when no snapshot exists.
- ``GET /v1/shard/<name>?step=N`` -> the shard's ``.npy`` payload with
  ``X-Step`` / ``X-Checksum`` headers; 409 when the snapshot rotated past
  N mid-fetch (a mixed-step reassembly would be torn state), 404 for an
  unknown name.
- ``GET /v1/bundle?step=N[&have=<name>:<checksum>,...]`` -> every shard
  in one response, framed ``[u32 name-len][name][u64 payload-len]
  [payload]`` in sorted name order, less the frames whose (name,
  checksum) the client already holds (the have-list; matched per name,
  never per bare checksum, since all-zero moments share one).
- ``GET /v1/manifest`` -> the meta plus ``owned``: the names this
  survivor claims under the slice-scoped partition, a planning hint for
  scatter-gather clients, never an ACL (``/v1/shard`` serves any name).

The port adds one key to the meta of a snapshot that holds one rank's
shards of a sharded state: ``shard_of``, the rank, world and mesh of the
process that holds them (``train/checkpoint.shard_identity``). A whole
state's meta has none, as the JAX module's. A restoring rank takes shards
only from a peer whose ``shard_of`` is its own (``train/restore.py``).

**One address a pod, G servers.** The operator publishes one address a
pod, the one its heartbeat (local rank 0's) carries. Under the per-node
launcher each local rank serves its own shards on the port the launcher
gave it (``TPU_SHARD_SERVER_PORT``), the pod's base port plus its local
rank, so local rank l of a restoring pod finds the shards of local rank l
of a survivor at the survivor's published port plus l
(:func:`local_peer_addresses`). The servers bind the loopback by
default, as the JAX module's do.

**Names.** :func:`flatten_state` names every tensor of a ``TrainState``
by a ``state_dict``-style key (``step``, ``model/<parameter>``,
``opt/count``, ``opt/mu/<parameter>``, ``opt/nu/<parameter>``), with the
parameter names of ``model.named_parameters()``: the same definition of
the state gives the same names on both ends of the wire.

**bf16 on the wire.** numpy has no bfloat16 without ``ml_dtypes``, which
the port does not import. A bf16 tensor is written as its 2-byte words
under the header ``'descr': '<V2'``, which is what ``np.save`` writes for
an ``ml_dtypes.bfloat16`` array, so the payload (and its sha256) equals
the JAX package's for the same values; ``np.save`` of a plain ``V2`` view
would write ``'|V2'`` instead. The ``.npy`` header cannot tell bf16 from
any other 2-byte void, so :func:`decode_shard` takes the dtype from the
restoring side's tensor and refuses a payload whose element type, byte
size or shape does not fit it.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import struct
import threading
import urllib.parse
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

log = logging.getLogger(__name__)


# ------------------------------------------------------------- wire format
def flatten_state(state) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a ``TrainState``: ``step`` and ``opt/count`` as
    0-d int32 tensors (the JAX ``TrainState.step`` dtype), the parameters
    and both AdamW moments by parameter name. The tensors are the state's
    own (a parameter's detached alias; a DTensor's local shard), not
    copies."""
    named = list(state.model.named_parameters())
    opt = state.opt_state
    flat: Dict[str, torch.Tensor] = {"step": torch.tensor(int(state.step), dtype=torch.int32)}
    for name, p in named:
        flat[f"model/{name}"] = (p.to_local() if isinstance(p, DTensor) else p).detach()
    flat["opt/count"] = torch.tensor(int(opt.count), dtype=torch.int32)
    for (name, _), mu in zip(named, opt.mu):
        flat[f"opt/mu/{name}"] = mu
    for (name, _), nu in zip(named, opt.nu):
        flat[f"opt/nu/{name}"] = nu
    return flat


def dtype_name(dtype: torch.dtype) -> str:
    """The meta's dtype string: numpy's name ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _descr(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "<V2"
    return np.lib.format.dtype_to_descr(torch.empty((), dtype=dtype).numpy().dtype)


def encode_parts(tensor: torch.Tensor) -> Tuple[bytes, np.ndarray]:
    """The ``.npy`` payload of ``tensor`` as (header, data bytes): what
    ``np.save`` writes for the same values, without joining the two (a
    persist hashes and writes them in turn)."""
    t = tensor.detach().cpu().contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    data = raw.numpy().reshape(-1).view(np.uint8)
    header = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        header, {"descr": _descr(t.dtype), "fortran_order": False, "shape": tuple(t.shape)})
    return header.getvalue(), data


def encode_shard(tensor: torch.Tensor) -> bytes:
    """The ``.npy`` serialization of one tensor (module doc: bf16 rule)."""
    header, data = encode_parts(tensor)
    return header + data.tobytes()


def decode_shard(payload: bytes, dtype: torch.dtype, shape=None) -> torch.Tensor:
    """The tensor of a ``.npy`` payload, as ``dtype`` (the restoring side's).
    Raises ValueError when the payload's element type is not ``dtype``'s,
    when its byte size disagrees with its header, or when ``shape`` is
    given and differs. The result is a read-only view of ``payload``:
    copy it into its target."""
    fp = io.BytesIO(payload)
    try:
        version = np.lib.format.read_magic(fp)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        got_shape, fortran, got = read(fp)
    except (ValueError, SyntaxError) as err:
        raise ValueError(f"not a .npy payload: {err}") from err
    want = _descr(dtype)
    if want == "<V2":
        fits = got.kind == "V" and got.itemsize == 2
    else:
        fits = np.lib.format.dtype_to_descr(got) == want
    if not fits or fortran:
        raise ValueError(f"payload holds {got.str} (fortran {fortran}); the target is {dtype}")
    if shape is not None and tuple(got_shape) != tuple(shape):
        raise ValueError(f"payload shape {tuple(got_shape)}, the target is {tuple(shape)}")
    data = memoryview(payload)[fp.tell():]
    numel = int(np.prod(got_shape, dtype=np.int64))
    if len(data) != numel * got.itemsize:
        raise ValueError(f"payload carries {len(data)} bytes for {numel} elements of "
                         f"{got.itemsize}")
    if numel == 0:
        return torch.empty(tuple(got_shape), dtype=dtype)
    with warnings.catch_warnings():
        # frombuffer warns on a read-only buffer; the view is only read.
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(data, dtype=torch.uint8)
    return flat.view(dtype).reshape(tuple(got_shape))


def shard_checksum(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def partition_shard_names(names, slice_index: int, num_slices: int):
    """The slice-scoped ownership partition: slice k of n owns every nth
    name of the SORTED shard namespace starting at k. Strided (not
    contiguous blocks) so parameter and optimizer leaves — which sort
    adjacently per layer — spread evenly across owners by bytes, and pure
    (both ends of the wire, and the restore planner, derive the identical
    partition from the same inputs)."""
    if num_slices <= 1:
        return sorted(names)
    return sorted(names)[slice_index % num_slices::num_slices]


def parse_bundle(body: bytes) -> Dict[str, bytes]:
    """Split a ``/v1/bundle`` body back into ``{name: payload}``. Raises
    OSError on any framing damage (truncation mid-frame) so the restore
    ladder classifies it like any other transport failure."""
    out: Dict[str, bytes] = {}
    off = 0
    try:
        while off < len(body):
            (nlen,) = struct.unpack_from(">I", body, off)
            off += 4
            name = body[off:off + nlen].decode("utf-8")
            off += nlen
            (plen,) = struct.unpack_from(">Q", body, off)
            off += 8
            if off + plen > len(body):
                raise OSError("bundle truncated mid-payload")
            out[name] = body[off:off + plen]
            off += plen
    except (struct.error, UnicodeDecodeError) as err:
        raise OSError(f"bundle framing damaged: {err}") from err
    return out


class _SnapshotView:
    """One snapshot, encoded and checksummed once and cached: meta requests
    and shard fetches from several restoring peers must not re-hash a
    multi-GB state per request. ``snapshot.tree`` is the flat
    ``{name: host tensor}`` of :func:`flatten_state`."""

    def __init__(self, snapshot) -> None:
        self.step = int(snapshot.step)
        self.model_meta = snapshot.model_meta
        flat = snapshot.tree
        self.payloads: Dict[str, bytes] = {name: encode_shard(t) for name, t in flat.items()}
        self.checksums = {name: shard_checksum(data) for name, data in self.payloads.items()}
        shard_of = getattr(snapshot, "shard_of", None)
        self.meta = {
            "step": self.step,
            "model_meta": self.model_meta,
            "shards": {
                name: {
                    "checksum": self.checksums[name],
                    "bytes": len(self.payloads[name]),
                    "dtype": dtype_name(t.dtype),
                    "shape": list(t.shape),
                }
                for name, t in flat.items()
            },
        }
        if shard_of is not None:
            self.meta["shard_of"] = shard_of


class SnapshotShardServer:
    """Read-only shard server over a snapshot source callable.

    ``source()`` returns the newest HostSnapshot (or None); the view cache
    re-encodes only when the step advances. ``address`` is the
    ``host:port`` string to advertise via the heartbeat rider.

    ``owned`` is the slice-scoped ownership seam for ``/v1/manifest``: a
    pure function from the full sorted shard-name list to the subset this
    survivor claims (None = claims everything). It shapes only the
    manifest's ``owned`` list; serving is never restricted by it."""

    def __init__(self, source: Callable[[], Optional[Any]],
                 host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None,
                 owned: Optional[Callable[[Any], Any]] = None) -> None:
        self._source = source
        self._owned = owned
        self._lock = threading.Lock()
        self._view: Optional[_SnapshotView] = None
        self._warmers: list = []
        self._advertise_host = advertise_host
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                log.debug("shard-server %s", fmt % args)

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/json",
                      headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib name
                try:
                    server._handle(self)
                except BrokenPipeError:
                    pass  # the restoring peer gave up mid-transfer; its
                    # retry logic owns the consequence
                except Exception:  # noqa: BLE001 — one bad request must
                    # not take down the serving thread pool
                    log.exception("shard-server request failed")
                    try:
                        self._send(500, b"{}")
                    except Exception:  # noqa: BLE001
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="shard-server", daemon=True
        )

    # ------------------------------------------------------------ control
    def start(self) -> "SnapshotShardServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving, and wait for a view being built: a thread still
        encoding tensors when the interpreter exits aborts the process."""
        self._httpd.shutdown()
        self._httpd.server_close()
        for thread in self._warmers:
            thread.join()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host = self._advertise_host or self._httpd.server_address[0]
        return f"{host}:{self.port}"

    def warm(self) -> None:
        """Build the view of the current snapshot off the request path
        (wired to the durability listener), so that the first restoring
        peer does not pay the encode and hash inline."""
        thread = threading.Thread(
            target=self._current_view, name="shard-server-warm", daemon=True)
        self._warmers = [t for t in self._warmers if t.is_alive()] + [thread]
        thread.start()

    # ------------------------------------------------------------ serving
    def _current_view(self) -> Optional[_SnapshotView]:
        snapshot = self._source()
        if snapshot is None:
            return None
        with self._lock:
            if self._view is None or self._view.step != int(snapshot.step):
                self._view = _SnapshotView(snapshot)
            return self._view

    def _handle(self, request) -> None:
        parsed = urllib.parse.urlparse(request.path)
        view = self._current_view()
        if parsed.path == "/v1/meta":
            if view is None:
                request._send(503, json.dumps(
                    {"error": "no-snapshot"}).encode())
                return
            request._send(200, json.dumps(view.meta).encode())
            return
        if parsed.path == "/v1/manifest":
            if view is None:
                request._send(503, json.dumps(
                    {"error": "no-snapshot"}).encode())
                return
            names = sorted(view.payloads)
            owned = names if self._owned is None else sorted(
                self._owned(names))
            manifest = dict(view.meta)
            manifest["owned"] = owned
            request._send(200, json.dumps(manifest).encode())
            return
        if parsed.path.startswith("/v1/shard/"):
            if view is None:
                request._send(503, json.dumps(
                    {"error": "no-snapshot"}).encode())
                return
            name = urllib.parse.unquote(parsed.path[len("/v1/shard/"):])
            query = urllib.parse.parse_qs(parsed.query)
            want_step = query.get("step", [None])[0]
            if want_step is not None and int(want_step) != view.step:
                # Snapshot rotated while the client iterated its shard
                # list; a mixed-step reassembly would be silent corruption.
                request._send(409, json.dumps(
                    {"error": "step-rotated", "step": view.step}).encode())
                return
            payload = view.payloads.get(name)
            if payload is None:
                request._send(404, json.dumps(
                    {"error": "unknown-shard"}).encode())
                return
            request._send(
                200, payload, content_type="application/octet-stream",
                headers={"X-Step": str(view.step),
                         "X-Checksum": view.checksums[name]},
            )
            return
        if parsed.path == "/v1/bundle":
            if view is None:
                request._send(503, json.dumps(
                    {"error": "no-snapshot"}).encode())
                return
            query = urllib.parse.parse_qs(parsed.query)
            want_step = query.get("step", [None])[0]
            if want_step is not None and int(want_step) != view.step:
                request._send(409, json.dumps(
                    {"error": "step-rotated", "step": view.step}).encode())
                return
            names = sorted(view.payloads)
            have_raw = query.get("have", [None])[0]
            if have_raw:
                # Have-list filter (module doc): skip frames the client
                # already holds byte-identically. Unparseable entries are
                # ignored (never a reason to fail the transfer); parse_qs
                # already URL-decoded the value.
                have: Dict[str, str] = {}
                for item in have_raw.split(","):
                    name, sep, checksum = item.rpartition(":")
                    if sep and name:
                        have[name] = checksum
                names = [
                    n for n in names
                    if have.get(n) != view.checksums[n]
                ]
            total = sum(
                4 + len(n.encode("utf-8")) + 8 + len(view.payloads[n])
                for n in names
            )
            request.send_response(200)
            request.send_header("Content-Type", "application/octet-stream")
            request.send_header("Content-Length", str(total))
            request.send_header("X-Step", str(view.step))
            request.end_headers()
            for n in names:
                encoded = n.encode("utf-8")
                request.wfile.write(struct.pack(">I", len(encoded)))
                request.wfile.write(encoded)
                request.wfile.write(struct.pack(">Q", len(view.payloads[n])))
                request.wfile.write(view.payloads[n])
            return
        request._send(404, json.dumps({"error": "unknown-path"}).encode())


def local_peer_addresses(addresses, local_rank: int):
    """Where local rank ``local_rank`` of a pod finds its own shards: each
    survivor pod's published ``host:port`` (its local rank 0's server)
    with ``local_rank`` added to the port (module doc)."""
    out = []
    for address in addresses:
        host, _, port = address.rpartition(":")
        out.append(f"{host}:{int(port) + local_rank}")
    return out


def start_shard_server(checkpoint_manager, host: str = "127.0.0.1",
                       port: int = 0, slice_index: Optional[int] = None,
                       num_slices: Optional[int] = None) -> SnapshotShardServer:
    """Start a shard server over a CheckpointManager's host snapshot and
    return it (``.address`` is the rider payload for record_peer_address).
    Each durable save warms the view cache, and a sharded save keeps this
    rank's shards on the host to serve (``serve_local_shards``). With a
    slice topology the manifest's owned set is what the manager's own
    checkpoint stream holds durable (``persisted_shard_names``), falling
    back to the name stride (partition_shard_names); either way a planning
    hint, never an ACL."""
    owned = None
    if slice_index is not None and num_slices is not None and num_slices > 1:
        idx, n = int(slice_index), int(num_slices)

        def owned(names, _idx=idx, _n=n, _mgr=checkpoint_manager):  # noqa: F811
            persisted = getattr(_mgr, "persisted_shard_names", None)
            if persisted is not None:
                try:
                    held = set(persisted())
                except Exception:  # noqa: BLE001 — a broken derivation
                    # must degrade to the stride, not kill the manifest
                    held = set()
                derived = [name for name in sorted(names) if name in held]
                if derived:
                    return derived
            return partition_shard_names(names, _idx, _n)

    server = SnapshotShardServer(checkpoint_manager.host_snapshot,
                                 host=host, port=port, owned=owned).start()
    if hasattr(checkpoint_manager, "serve_local_shards"):
        checkpoint_manager.serve_local_shards = True
    try:
        checkpoint_manager.add_durability_listener(lambda _step: server.warm())
    except AttributeError:
        pass  # bare snapshot sources (tests) have no listener seam
    return server
