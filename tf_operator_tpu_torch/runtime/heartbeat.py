"""In-container gang-liveness heartbeat: the port's copy of
``tf_operator_tpu/runtime/heartbeat.py``, with that package's env names
(``bootstrap/heartbeat.py``) and lease annotation names
(``core/constants.py``), so that the operator reads the port's beats as it
reads the JAX workload's.

A daemon thread started by ``gpu_init.initialize`` (before the rendezvous
blocks) renews a per-pod heartbeat, and training loops call
:func:`record_progress` at their log cadence to publish the step and the
measured tokens/s. The recovery plane's riders ride the same beat:
:func:`record_checkpoint` (a step is durable; called only from the
checkpoint manager's durability listener), :func:`record_peer_address`
(this rank's shard server) and :func:`record_restore` (which rung of the
restore ladder won, and why). Sinks, most specific first:

- ``TPU_HEARTBEAT_FILE``: the file bridge of the process e2e tier, one JSON
  object replaced wholesale each beat;
- an explicit ``cluster``: Lease renewals through the Cluster seam
  (``get_lease``/``create_lease``/``update_lease``), full-object
  optimistic-concurrency writes;
- in a pod (``KUBERNETES_SERVICE_HOST``): the same renewals through the
  port's own Lease client, ``cluster/kube.py``, with the pod's service
  account.

Absent env means no thread at all: a dev-box run is unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

log = logging.getLogger(__name__)

ENV_HEARTBEAT_LEASE = "TPU_HEARTBEAT_LEASE"
ENV_HEARTBEAT_NAMESPACE = "TPU_HEARTBEAT_NAMESPACE"
ENV_HEARTBEAT_INTERVAL = "TPU_HEARTBEAT_INTERVAL_SECONDS"
ENV_HEARTBEAT_FILE = "TPU_HEARTBEAT_FILE"
# The recovery plane's env, each absent unless the operator enables it:
# start a shard server over the host snapshot and advertise it; the
# comma-joined survivor addresses to restore from; plan a scatter-gather
# across them; restore from live peers with no storage read (elastic
# grow); persist only the shards that changed.
ENV_SHARD_SERVER = "TPU_SHARD_SERVER"
ENV_PEER_RESTORE_ADDRS = "TPU_PEER_RESTORE_ADDRS"
ENV_SHARDED_RESTORE = "TPU_SHARDED_RESTORE"
ENV_WARM_START = "TPU_WARM_START"
ENV_DELTA_PERSIST = "TPU_DELTA_PERSIST"
# Not the operator's: the port local rank l's shard server binds, which the
# per-node launcher (runtime/launch.py) sets to the pod's base port plus l,
# so that the one address the pod publishes (local rank 0's) locates every
# rank's server.
ENV_SHARD_SERVER_PORT = "TPU_SHARD_SERVER_PORT"
ANNOTATION_HEARTBEAT_STEP = "tpu.kubeflow.org/progress-step"
ANNOTATION_HEARTBEAT_TPS = "tpu.kubeflow.org/tokens-per-sec"
ANNOTATION_HEARTBEAT_CKPT = "tpu.kubeflow.org/checkpoint-step"
ANNOTATION_HEARTBEAT_PEER = "tpu.kubeflow.org/peer-restore-addr"
ANNOTATION_HEARTBEAT_RESTORE = "tpu.kubeflow.org/restore-outcome"


def _format_microtime(epoch: float) -> str:
    """RFC3339 with microseconds: the wire format of Lease spec.renewTime."""
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(epoch)) + (
        ".%06dZ" % int((epoch % 1) * 1e6)
    )


def _is(exc: BaseException, name: str) -> bool:
    """The Cluster seam's NotFound/Conflict, matched by class name: the port
    imports nothing of the package that defines them."""
    return any(cls.__name__ == name for cls in type(exc).__mro__)


def _progress_annotations(step: Optional[int], tokens_per_sec: Optional[float],
                          checkpoint_step: Optional[int] = None,
                          peer_addr: Optional[str] = None,
                          restore: Optional[str] = None) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if step is not None:
        out[ANNOTATION_HEARTBEAT_STEP] = str(step)
    if tokens_per_sec is not None:
        out[ANNOTATION_HEARTBEAT_TPS] = f"{float(tokens_per_sec):.1f}"
    if checkpoint_step is not None:
        out[ANNOTATION_HEARTBEAT_CKPT] = str(int(checkpoint_step))
    if peer_addr is not None:
        out[ANNOTATION_HEARTBEAT_PEER] = str(peer_addr)
    if restore is not None:
        out[ANNOTATION_HEARTBEAT_RESTORE] = str(restore)
    return out


def publish_heartbeat(cluster, namespace: str, name: str, identity: str,
                      step: Optional[int] = None,
                      tokens_per_sec: Optional[float] = None,
                      checkpoint_step: Optional[int] = None,
                      peer_addr: Optional[str] = None,
                      restore: Optional[str] = None,
                      clock=time.time) -> bool:
    """One renewal through the Cluster seam. True iff the beat landed; False
    on a lost optimistic-concurrency round or an API error (the next tick
    retries: the operator's staleness clock spans several intervals)."""
    now = clock()
    annotations = _progress_annotations(step, tokens_per_sec, checkpoint_step, peer_addr,
                                        restore)
    try:
        lease = cluster.get_lease(namespace, name)
    except Exception as exc:  # noqa: BLE001 — a beat never raises
        if not _is(exc, "NotFound"):
            log.debug("heartbeat read failed", exc_info=True)
            return False
        lease = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"namespace": namespace, "name": name},
            "spec": {
                "holderIdentity": identity,
                "acquireTime": _format_microtime(now),
                "renewTime": _format_microtime(now),
                "leaseDurationSeconds": 0,
            },
        }
        if annotations:
            lease["metadata"]["annotations"] = annotations
        try:
            cluster.create_lease(lease)
            return True
        except Exception:  # noqa: BLE001 — a racing first beat, or an API error
            log.debug("heartbeat create failed", exc_info=True)
            return False

    spec = lease.setdefault("spec", {})
    spec["holderIdentity"] = identity
    spec["renewTime"] = _format_microtime(now)
    if annotations:
        meta = lease.setdefault("metadata", {})
        meta["annotations"] = {**(meta.get("annotations") or {}), **annotations}
    try:
        cluster.update_lease(lease)
        return True
    except Exception:  # noqa: BLE001 — a Conflict, or an API error
        log.debug("heartbeat renew failed", exc_info=True)
        return False


def write_heartbeat_file(path: str, seq: int, step: Optional[int],
                         tokens_per_sec: Optional[float] = None,
                         checkpoint_step: Optional[int] = None,
                         peer_addr: Optional[str] = None,
                         restore: Optional[str] = None) -> None:
    """The file half of the process-tier bridge: one JSON object, replaced
    wholesale each beat (write to a temporary file, then rename, so that the
    reader never sees a torn write). ``seq`` strictly increases."""
    tmp = f"{path}.tmp"
    payload = {"seq": seq, "step": step, "ts": time.time()}
    if tokens_per_sec is not None:
        payload["tokens_per_sec"] = float(tokens_per_sec)
    if checkpoint_step is not None:
        payload["checkpoint_step"] = int(checkpoint_step)
    if peer_addr is not None:
        payload["peer_addr"] = str(peer_addr)
    if restore is not None:
        payload["restore"] = str(restore)
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


class HeartbeatPublisher:
    """Daemon renewal loop around one sink ``(seq, step, tokens_per_sec,
    checkpoint_step, peer_addr, restore)``. Each ``record_*`` call updates
    the payload and wakes the loop, so that a long sleep never delays the
    proof of the step that just completed."""

    def __init__(self, sink: Callable[..., None], interval: float):
        self._sink = sink
        self.interval = max(0.05, float(interval))
        self._step: Optional[int] = None
        self._tokens_per_sec: Optional[float] = None
        self._checkpoint_step: Optional[int] = None
        self._peer_addr: Optional[str] = None
        self._restore: Optional[str] = None
        self._seq = 0
        self._beat = threading.Lock()  # the loop's beat and a flush never interleave
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatPublisher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="gpu-heartbeat",
                                            daemon=True)
            self._thread.start()
        return self

    def record_progress(self, step: Optional[int] = None,
                        tokens_per_sec: Optional[float] = None) -> None:
        if step is not None:
            self._step = int(step)
        if tokens_per_sec is not None:
            self._tokens_per_sec = float(tokens_per_sec)
        self._wake.set()

    def record_checkpoint(self, step: int) -> None:
        """``step`` is DURABLE: the checkpoint-step annotation, which the
        autoscaler's checkpoint-gated shrink waits on."""
        self._checkpoint_step = int(step)
        self._wake.set()

    def record_peer_address(self, addr: Optional[str]) -> None:
        """This rank's shard-server ``host:port``: the peer-restore
        annotation. None clears nothing."""
        if addr is not None:
            self._peer_addr = str(addr)
        self._wake.set()

    def record_restore(self, path: str, cause: str, seconds: float,
                       bytes_moved: Optional[int] = None) -> None:
        """The restore ladder's outcome, as the compact
        ``path:cause:seconds[:bytes]`` annotation."""
        rider = f"{path}:{cause}:{float(seconds):.3f}"
        if bytes_moved is not None:
            rider += f":{int(bytes_moved)}"
        self._restore = rider
        self._wake.set()

    def beat_once(self) -> None:
        """One synchronous beat (also the loop body). Never raises: a broken
        sink must not take the training process down with it."""
        with self._beat:
            self._seq += 1
            try:
                self._sink(self._seq, self._step, self._tokens_per_sec,
                           self._checkpoint_step, self._peer_addr, self._restore)
            except Exception:  # noqa: BLE001 — liveness must never kill training
                log.debug("heartbeat sink failed", exc_info=True)

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()

    def _run(self) -> None:
        while not self._stopped.is_set():
            self.beat_once()
            self._wake.wait(self.interval)
            self._wake.clear()


_active: Optional[HeartbeatPublisher] = None
_lock = threading.Lock()


def start_from_env(cluster=None,
                   env: Optional[Dict[str, str]] = None) -> Optional[HeartbeatPublisher]:
    """Start (once) the heartbeat thread the injected env describes; the
    active publisher, or None when the env opts out or names no sink.
    Sinks in the JAX package's order: the file bridge, then an explicit
    ``cluster``, then in a pod (``KUBERNETES_SERVICE_HOST``) the port's
    Lease client on the service account, else none. A client that cannot
    be set up logs at debug level and starts nothing: a run outside a
    cluster trains all the same."""
    global _active
    env = os.environ if env is None else env
    lease = env.get(ENV_HEARTBEAT_LEASE)
    if not lease:
        return None
    with _lock:
        if _active is not None:
            return _active
        namespace = env.get(ENV_HEARTBEAT_NAMESPACE, "default")
        try:
            interval = float(env.get(ENV_HEARTBEAT_INTERVAL, "5"))
        except ValueError:
            interval = 5.0
        identity = env.get("HOSTNAME") or lease
        file_path = env.get(ENV_HEARTBEAT_FILE)
        if file_path:
            def sink(seq, step, tokens_per_sec, checkpoint_step, peer_addr, restore,
                     _path=file_path):
                write_heartbeat_file(_path, seq, step, tokens_per_sec, checkpoint_step,
                                     peer_addr, restore)
        else:
            if cluster is None and "KUBERNETES_SERVICE_HOST" in env:
                try:
                    from ..cluster.kube import KubeCluster

                    cluster = KubeCluster(env=env)
                except Exception:  # noqa: BLE001 — no credentials: no beat
                    log.debug("in-cluster heartbeat setup failed", exc_info=True)
                    return None
            if cluster is None:
                return None

            def sink(seq, step, tokens_per_sec, checkpoint_step, peer_addr, restore,
                     _c=cluster):
                publish_heartbeat(_c, namespace, lease, identity, step=step,
                                  tokens_per_sec=tokens_per_sec,
                                  checkpoint_step=checkpoint_step, peer_addr=peer_addr,
                                  restore=restore)
        _active = HeartbeatPublisher(sink, interval).start()
        return _active


def record_progress(step: Optional[int] = None,
                    tokens_per_sec: Optional[float] = None) -> None:
    """Training-loop API: prove liveness now, with the step and the measured
    tokens/s. A no-op without an active publisher, so that a workload calls
    it unconditionally."""
    publisher = _active
    if publisher is not None:
        publisher.record_progress(step, tokens_per_sec=tokens_per_sec)


def record_checkpoint(step: int) -> None:
    """Training-loop API: a checkpoint for ``step`` is durable. Register it
    as the checkpoint manager's durability listener; never call it after
    ``save()`` returns. A no-op without an active publisher."""
    publisher = _active
    if publisher is not None:
        publisher.record_checkpoint(step)


def record_peer_address(addr: Optional[str]) -> None:
    """Training-loop API: this rank serves peer-restore shards at ``addr``
    ("host:port"). A no-op without an active publisher."""
    publisher = _active
    if publisher is not None:
        publisher.record_peer_address(addr)


def record_restore(path: str, cause: str, seconds: float,
                   bytes_moved: Optional[int] = None) -> None:
    """Training-loop API: this rank restored via ``path`` for ``cause`` in
    ``seconds``, moving ``bytes_moved`` wire bytes where the peer path
    metered them. A no-op without an active publisher."""
    publisher = _active
    if publisher is not None:
        publisher.record_restore(path, cause, seconds, bytes_moved)


def flush() -> None:
    """One synchronous beat of what was recorded last, for a run about to
    exit: the renewal thread is a daemon and may not get to it. A no-op
    without an active publisher."""
    publisher = _active
    if publisher is not None:
        publisher.beat_once()


def stop() -> None:
    """Tear down the active publisher (tests; graceful shutdown)."""
    global _active
    with _lock:
        if _active is not None:
            _active.stop()
            _active = None
