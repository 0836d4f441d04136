"""The recovery plane's Prometheus families: the port's copy of the seven
that ``tf_operator_tpu/metrics.py`` defines for the workload's checkpoint
and restore, under the same names, label names, help texts and buckets,
rendered in the same text exposition format.

The registry is process-local, as the JAX package's ``METRICS`` is, and has
no HTTP endpoint: the workload tier serves none in either package. The
operator learns of a restore through the heartbeat Lease's restore rider.
``train/checkpoint.py`` and ``train/restore.py`` observe into
:data:`METRICS` at the JAX package's points, best-effort: a telemetry
error never fails a persist or a restore.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

# name -> (label names, help), in the JAX registry's order.
COUNTERS = {
    "training_restore_total": (
        ("path", "cause"),
        "Restore-ladder outcomes (train/restore.py; workload-reported "
        "via the restore-outcome lease rider when observed by the "
        "operator, recorded directly in-process otherwise), by winning "
        "path (peer|storage|none) and cause (ok on the happy paths; "
        "peer-unreachable / stale-snapshot / checksum-mismatch / "
        "partial-snapshot / no-peers when the peer path degraded). A "
        "sustained storage share with peer restore enabled means the "
        "fast path is not winning — check the degradation causes",
    ),
    "training_checkpoint_persist_bytes_total": (
        ("kind",),
        "Bytes the background persist worker actually wrote to the "
        "checkpoint store, by persist kind (full = every shard "
        "rewritten; delta = only changed shards + the step manifest, "
        "EngineOptions.delta_persist). delta/full per-persist ratio "
        "is the bytes-proportional-to-change number; a delta rate "
        "near the full rate means nearly every shard changes every "
        "step and delta persists are pure overhead (delta-ineffective "
        "alert, docs/monitoring/README.md)",
    ),
    "training_checkpoint_delta_shards_skipped_total": (
        ("kind",),
        "Shards a persist carried forward BY REFERENCE instead of "
        "rewriting (per-shard checksum unchanged since the last "
        "durable step), by persist kind. Always 0 for kind=full "
        "(a full rewrites everything); for kind=delta this is the "
        "savings counter — skipped/(skipped+written) is the fraction "
        "of the tree that sat still between durable steps",
    ),
    "training_restore_bytes_total": (
        ("source",),
        "Payload bytes the restore ladder moved, by winning path "
        "(source=peer|peer-sharded; storage/none restores don't "
        "report wire bytes). With have-list transfer "
        "(restore_with_fallback(have=True)) a warm restore moves "
        "only changed shards, so bytes-per-restore here against "
        "training_restore_total's rate is the "
        "recovery-bytes-proportional-to-change number",
    ),
}
# name -> (label names, bucket bounds).
HISTOGRAMS = {
    # Snapshot enqueued -> the durability edge.
    "training_checkpoint_persist_seconds": (
        (), (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15, 60, 300),
    ),
    "training_restore_seconds": (
        ("path", "cause"), (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15, 60, 300),
    ),
}
CHAIN_DEPTH = "training_checkpoint_delta_chain_depth"


def escape_label_value(value) -> str:
    """Prometheus text-format escaping of a label value."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Histogram:
    """Per-bucket counts, sum and count of one series."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # the last is the +Inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1

    def cumulative(self) -> List[int]:
        out, running = [], 0
        for c in self.counts[:-1]:
            running += c
            out.append(running)
        return out


class Metrics:
    """The seven recovery families, with the JAX ``Metrics``' observe
    methods for them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[Tuple[str, ...], int]] = {
            name: defaultdict(int) for name in COUNTERS}
        self._histograms: Dict[str, Dict[Tuple[str, ...], _Histogram]] = {
            name: defaultdict(lambda bounds=bounds: _Histogram(bounds))
            for name, (_, bounds) in HISTOGRAMS.items()}
        self._chain_depth = None

    def _add(self, name: str, amount: int, *labels: str) -> None:
        with self._lock:
            self._counters[name][tuple(labels)] += int(amount)

    def counter_value(self, name: str, *labels: str) -> int:
        with self._lock:
            return self._counters[name].get(tuple(labels), 0)

    def histogram_count(self, name: str, *labels: str) -> int:
        with self._lock:
            hist = self._histograms[name].get(tuple(labels))
            return hist.count if hist is not None else 0

    def observe_checkpoint_persist(self, seconds: float) -> None:
        """One persist finalized: snapshot enqueued to the durability edge."""
        with self._lock:
            self._histograms["training_checkpoint_persist_seconds"][()].observe(seconds)

    def observe_restore(self, path: str, cause: str, seconds: float) -> None:
        """One restore-ladder run: the winning path, the cause, its seconds."""
        self._add("training_restore_total", 1, path, cause)
        with self._lock:
            self._histograms["training_restore_seconds"][(path, cause)].observe(seconds)

    def observe_checkpoint_persist_bytes(self, kind: str, nbytes: int,
                                         shards_skipped: int) -> None:
        """One manifest persist's bytes written and shards carried forward."""
        self._add("training_checkpoint_persist_bytes_total", nbytes, kind)
        if shards_skipped:
            self._add("training_checkpoint_delta_shards_skipped_total", shards_skipped, kind)

    def set_delta_chain_depth(self, depth: int) -> None:
        """The newest persist's manifest-chain depth (0 = full)."""
        with self._lock:
            self._chain_depth = float(depth)

    def observe_restore_bytes(self, source: str, nbytes: int) -> None:
        """Wire bytes one restore moved, by winning path (peer rungs only)."""
        self._add("training_restore_bytes_total", nbytes, source)

    def render(self) -> str:
        """The families in the JAX ``Metrics.render`` text format."""
        esc = escape_label_value
        lines: List[str] = []
        with self._lock:
            for name, (label_names, help_text) in COUNTERS.items():
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} counter")
                for values, count in sorted(self._counters[name].items()):
                    label = ",".join(f'{ln}="{esc(lv)}"' for ln, lv in zip(label_names, values))
                    lines.append(f"{name}{{{label}}} {count}")
            for name, (label_names, _) in HISTOGRAMS.items():
                lines.append(f"# HELP {name} {name.replace('_', ' ')}")
                lines.append(f"# TYPE {name} histogram")
                for values, hist in sorted(self._histograms[name].items()):
                    label = ",".join(f'{ln}="{esc(lv)}"' for ln, lv in zip(label_names, values))
                    sep = "," if label else ""
                    for bound, cum in zip(hist.bounds, hist.cumulative()):
                        lines.append(f'{name}_bucket{{{label}{sep}le="{bound}"}} {cum}')
                    lines.append(f'{name}_bucket{{{label}{sep}le="+Inf"}} {hist.count}')
                    lines.append(f"{name}_sum{{{label}}} {hist.total}")
                    lines.append(f"{name}_count{{{label}}} {hist.count}")
            if self._chain_depth is not None:
                lines.append(f"# HELP {CHAIN_DEPTH} {CHAIN_DEPTH.replace('_', ' ')}")
                lines.append(f"# TYPE {CHAIN_DEPTH} gauge")
                lines.append(f"{CHAIN_DEPTH} {self._chain_depth:g}")
        return "\n".join(lines) + "\n"


# The process's registry, as the JAX package's METRICS.
METRICS = Metrics()
