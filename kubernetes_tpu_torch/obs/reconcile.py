"""Reconcile-loop recorder: per-loop telemetry for every controller.

The counterpart of `kubernetes_tpu/obs/reconcile.py`. The flight recorder
measures the scheduler half of "watch, reconcile, write status"; an
unmeasured controller or a backlogged watcher under priority-mixed churn
silently eats the SLO. This module gives the controllers (controllers/base.py)
the same machinery the scheduler has, built on the SAME RingRecorder base
(obs/recorder.py):

  ReconcileRecorder       — bounded ring of per-LOOP records (one record per
                            non-empty process() drain, one histogram
                            observation per pump that ingested events —
                            never per key or per event), with the p50/p99
                            stage table and running counters.
  registry                — weak registry of live controllers (the configz
                            pattern, same as flightrec's scheduler registry)
                            behind GET /debug/controlstats
                            (server/rest.py) and `ktl controller stats`
                            (ROADMAP.md queue 1 item 7g2).
  workqueue_depth_samples — render-time feed for the
                            controller_workqueue_depth GaugeFunc.

Taps are O(1) per loop: two perf_counter reads around the key drain, one
shared clock read per pump for first-marked timestamps, one record append.
The oldest-dirty-age scan is O(depth) and therefore THROTTLED to 1/s with a
cached value (the scheduler's queue-telemetry idiom).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

from .recorder import RingRecorder

# per-loop stages: "pump" = watch drain + dirty marking, "sync" = the
# process() drain through sync(key)
RECONCILE_STAGES = ("pump", "sync")


class ReconcileRecorder(RingRecorder):
    """Per-controller reconcile-loop recorder (one instance per controller,
    created by controllers/base.py)."""

    def __init__(self, name: str,
                 capacity: int = RingRecorder.DEFAULT_CAPACITY,
                 enabled: bool = True):
        super().__init__(capacity=capacity, enabled=enabled)
        self.name = name
        self.loops = 0          # non-empty process() drains
        self.keys_total = 0     # keys handed to sync() across all loops
        self.errors_total = 0   # sync() exceptions (each also requeues)
        self.requeues_total = 0
        self.events_total = 0   # watch events ingested by pump()

    def pump(self, events: int, seconds: float) -> None:
        """One pump() drain: ONE histogram observation when events were
        ingested (empty polls are not ring-worthy — at daemon cadence they
        would be 95% of the ring)."""
        if not self.enabled or events <= 0:
            return
        with self._lock:
            self.events_total += events
            self._outside["pump"] = self._outside.get("pump", 0.0) + seconds
            self._hist_observe("pump", seconds)

    def loop(self, *, keys: int, errors: int, requeues: int,
             seconds: float, depth: int) -> Optional[Dict]:
        """One process() drain through sync() — per LOOP, never per key.
        Returns the appended record (None when disabled/empty)."""
        if not self.enabled or keys <= 0:
            return None
        from ..server import metrics as m

        m.controller_reconcile_duration.observe(seconds, self.name)
        if errors:
            m.controller_sync_errors.inc(errors, controller=self.name)
        with self._lock:
            self.loops += 1
            self.keys_total += keys
            self.errors_total += errors
            self.requeues_total += requeues
            rec = {
                "controller": self.name,
                "keys": keys,
                "errors": errors,
                "requeues": requeues,
                "depth": depth,
                "total_ms": round(seconds * 1000, 3),
            }
            return self._append_record(rec, {"sync": seconds})

    def _clear_extra(self) -> None:
        self.loops = 0
        self.keys_total = 0
        self.errors_total = 0
        self.requeues_total = 0
        self.events_total = 0

    def snapshot(self) -> Dict:
        """The per-controller /debug/controlstats payload."""
        table = self.stage_table(order=RECONCILE_STAGES)
        with self._lock:
            out = {
                "controller": self.name,
                "enabled": self.enabled,
                "loops": self.loops,
                "keys": self.keys_total,
                "errors": self.errors_total,
                "requeues": self.requeues_total,
                "events": self.events_total,
                "records": len(self._records),
                "capacity": self.capacity,
                "self_seconds": round(self._self_s, 6),
                "last": self._records[-1] if self._records else None,
            }
        out["stages"] = table
        sync = table.get("sync") or {}
        out["reconcile_p50_ms"] = sync.get("p50_ms")
        out["reconcile_p99_ms"] = sync.get("p99_ms")
        return out


# -- live-controller registry (the configz pattern, like flightrec's) -----------

_registry_lock = threading.Lock()
_controllers: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def register_controller(name: str, controller) -> None:
    """Register a live controller for /debug/controlstats. Weak + latest
    wins per name: a stopped and collected controller drops out without an
    unregister call, and the daemon's singletons keep stable names."""
    with _registry_lock:
        _controllers[name] = controller


def controlstats_snapshot() -> Dict[str, Dict]:
    """{controller name: reconcile_stats()} over every live registered
    controller — what GET /debug/controlstats and `ktl controller stats`
    serve."""
    with _registry_lock:
        live = dict(_controllers)
    out = {}
    for name, c in sorted(live.items()):
        stats = getattr(c, "reconcile_stats", None)
        if stats is None:
            continue
        try:
            out[name] = stats()
        except Exception as e:  # a wedged controller must not 500 the endpoint
            out[name] = {"error": str(e)}
    return out


def reconcile_rollup(snapshot: Optional[Dict[str, Dict]] = None) -> Dict:
    """The cross-controller rollup the reconcile_p99_ms SLO key gates: the
    WORST per-controller sync p99 (a single dark-slow controller must fail
    the ceiling, not be averaged away), plus totals."""
    snap = controlstats_snapshot() if snapshot is None else snapshot
    worst = None
    worst_name = None
    loops = keys = errors = 0
    for name, st in snap.items():
        if "error" in st and len(st) == 1:
            continue
        loops += st.get("loops", 0)
        keys += st.get("keys", 0)
        errors += st.get("errors", 0)
        p99 = st.get("reconcile_p99_ms")
        if p99 is not None and (worst is None or p99 > worst):
            worst, worst_name = p99, name
    return {"p99_ms": worst, "worst_controller": worst_name,
            "controllers": len(snap), "loops": loops, "keys": keys,
            "errors": errors}


def workqueue_depth_samples() -> List[Tuple[Dict[str, str], float]]:
    """Render-time samples for the controller_workqueue_depth GaugeFunc."""
    with _registry_lock:
        live = dict(_controllers)
    out = []
    for name, c in live.items():
        depth = getattr(c, "workqueue_depth", None)
        if depth is None:
            continue
        try:
            out.append(({"controller": name}, float(depth())))
        except Exception:
            continue
    return out
