"""Seeded restore faults: the port's copy of ``ScheduledRestoreFault`` and
``RestoreFaultInjector`` from ``tf_operator_tpu/cluster/chaos.py``, so that
code that runs on the card (``scripts/measure_recovery_torch.py``) can
replay the restore ladder's fault scenarios without the JAX package.

The restore ladder (``train/restore.py``) consults ``fault_for(op,
peer_index)`` at every fetch attempt and mutation point and applies the
kind it returns. Consult counters are pure functions of the call sequence
(peers in discovery order, shards in sorted order), so a scenario logs,
and replays, byte-identically, and the same schedule logs the same faults
through either package's injector.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class ScheduledRestoreFault:
    """One fault: ``kind`` (refuse, hang, truncate, stale-meta,
    die-mid-transfer, stale-manifest, partial-owner, delta-missing-shard,
    delta-corrupt-shard) at the ``at_call``-th to ``at_call + count - 1``-th
    consults of ``op`` (meta, manifest, shard, meta-body, manifest-body,
    shard-body, delta-shard or ``*``), for the peer of discovery index
    ``peer`` (None: any)."""

    kind: str
    op: str = "*"
    peer: Optional[int] = None
    at_call: int = 1
    count: int = 1


class RestoreFaultInjector:
    """The consult oracle: ``fault_for`` returns a fault kind or None and
    logs each fault fired to ``fault_log``. A peer that a
    ``die-mid-transfer`` fault killed refuses every later consult, logged
    once and counting nothing."""

    def __init__(self, faults: Tuple[ScheduledRestoreFault, ...] = (),
                 log: Optional[List[str]] = None) -> None:
        self.faults = tuple(faults)
        self.fault_log = log if log is not None else []
        self._lock = threading.Lock()
        self._consults: Dict[int, int] = {}
        self._dead: set = set()

    def fault_for(self, op: str, peer_index: int) -> Optional[str]:
        fired: Optional[str] = None
        with self._lock:
            if peer_index in self._dead:
                return "refuse"
            for i, fault in enumerate(self.faults):
                if fault.op not in ("*", op):
                    continue
                if fault.peer is not None and fault.peer != peer_index:
                    continue
                n = self._consults.get(i, 0) + 1
                self._consults[i] = n
                if fired is None and fault.at_call <= n < fault.at_call + fault.count:
                    self.fault_log.append(f"restore:{op}#{n}:{fault.kind}:peer{peer_index}")
                    fired = fault.kind
            if fired == "die-mid-transfer":
                self._dead.add(peer_index)
        return fired
