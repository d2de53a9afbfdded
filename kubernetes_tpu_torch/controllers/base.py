"""Controller base: the informer -> workqueue -> sync(key) reconcile pattern.

The counterpart of `kubernetes_tpu/controllers/base.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller (e.g. replicaset/replica_set.go:116,150,677) and
client-go's SharedIndexInformer + rate-limited workqueue. One reconcile loop
per resource kind; level-triggered: sync() reads desired+actual from the store
and converges, so replays and missed events are harmless.

Reconcile-loop telemetry: every subclass inherits a
ReconcileRecorder (obs/reconcile.py — the flight recorder's ring/stage
machinery) with per-LOOP spans: one histogram observation per pump that
ingested events, one record per process() drain, requeue/error counters, and
workqueue depth/oldest-age. Instrumentation is per LOOP, never per key or
per event inside the drain loops;
first-marked timestamps use ONE shared clock read per pump, and the
oldest-age scan is throttled to 1/s (the scheduler queue's telemetry idiom).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, Optional

from ..obs import tracebuf as _tracebuf
from ..obs.reconcile import ReconcileRecorder, register_controller
from ..store import APIStore
from ..utils import Clock


class Controller:
    """Subclasses define `watch_kinds`, `key_of(event) -> sync key or None`,
    and `sync(key)`. Drive with pump()+process() (tests) or start() (daemon)."""

    watch_kinds: tuple = ()

    def __init__(self, store: APIStore, clock: Optional[Clock] = None,
                 telemetry: bool = True):
        self.store = store
        self.clock = clock or Clock()
        self._watch = None
        # dirty key -> first-marked timestamp (the workqueue; the timestamp
        # feeds the oldest-age gauge and costs a dict slot, not a clock
        # read — markers pass ONE shared per-drain timestamp)
        self._dirty: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the daemon loop's thread, kept past stop(): only its drains end
        # early when the controller stops
        self._loop_thread: Optional[threading.Thread] = None
        self.sync_errors = 0
        # per-loop reconcile recorder. telemetry=False keeps the
        # recorder fully inert AND unregistered — the parity oracle for the
        # recorder-on/off byte-identical tests.
        self.recorder = ReconcileRecorder(type(self).__name__,
                                          enabled=telemetry)
        # oldest-dirty-age scan throttle (O(depth) under the lock)
        self._age_next = 0.0
        self._age_last = 0.0
        if telemetry:
            register_controller(type(self).__name__, self)

    # -- event intake ----------------------------------------------------------

    def sync_all(self) -> None:
        """Initial LIST: mark every existing object of the primary kind dirty."""
        lists, rv = self.store.list_many(self.watch_kinds)
        now = self.clock.now()  # ONE shared first-marked stamp for the seed
        for kind in self.watch_kinds:
            for obj in lists[kind]:
                key = self.key_of_object(kind, obj)
                if key:
                    self._mark(key, now)
        # kind-filtered subscription: high-volume kinds this controller
        # ignores (e.g. events) never consume its watch buffer
        self._watch = self.store.watch(kind=set(self.watch_kinds), since_rv=rv)

    def pump(self, max_events: int = 10_000) -> int:
        if self._watch is None:
            return 0
        if self._watch.terminated:
            # evicted as a slow watcher: relist + rewatch (Reflector contract)
            self._watch.stop()
            self.sync_all()
            return 0
        t0 = time.perf_counter()
        n = 0
        now = self.clock.now()  # shared first-marked stamp for this drain
        # bounded drain: events beyond the cap stay buffered for the next
        # pump (breaking out of a full drain() would DISCARD them — the bug
        # that truncated the scheduler's 100k backlog)
        for ev in self._watch.drain(max_events):
            if ev.kind in self.watch_kinds:
                key = self.key_of_object(ev.kind, ev.obj)
                if key:
                    self._mark(key, now)
                n += 1
        self.recorder.pump(n, time.perf_counter() - t0)
        return n

    def _mark(self, key: str, ts: Optional[float] = None) -> None:
        with self._lock:
            # first-marked time sticks across re-marks: the age gauge
            # measures how long the oldest key has been waiting, and a
            # retry re-mark must not reset the meter
            self._dirty.setdefault(
                key, ts if ts is not None else self.clock.now())

    # -- processing ------------------------------------------------------------

    def process(self, max_keys: int = 10_000) -> int:
        """Drain the dirty set through sync(). Returns #keys processed.
        Instrumented per LOOP (never per key): two perf_counter reads and
        one recorder.loop() around the whole drain."""
        now = self.clock.now()
        with self._lock:
            keys = list(self._dirty)[:max_keys]
            for k in keys:
                self._dirty.pop(k, None)
        if not keys:
            return 0
        t0 = time.perf_counter()
        errors0 = self.sync_errors
        # the daemon loop's drain ends at stop(), its unsynced keys left
        # dirty: a stopping replica writes for one more sync at most, not
        # for its whole backlog (the JAX package drains it)
        stopping = self._stop if threading.current_thread() is self._loop_thread else None
        done = 0
        for key in keys:
            if stopping is not None and stopping.is_set():
                with self._lock:
                    for k in keys[done:]:
                        self._dirty.setdefault(k, now)
                break
            done += 1
            try:
                self.sync(key)
            except Exception:
                self.sync_errors += 1
                traceback.print_exc()
                self._mark(key, now)  # retry (rate limiting elided)
        keys = keys[:done]
        if not keys:
            return 0
        errs = self.sync_errors - errors0
        t1 = time.perf_counter()
        self.recorder.loop(keys=len(keys), errors=errs, requeues=errs,
                           seconds=t1 - t0, depth=len(self._dirty))
        # trace timeline: one slice per reconcile DRAIN (never
        # per key) on this controller's track
        if _tracebuf.ACTIVE is not None:
            _tracebuf.ACTIVE.note_span(
                "ctl-%s" % type(self).__name__, "reconcile", t0, t1,
                cat="reconcile", args={"keys": len(keys), "errors": errs})
        return len(keys)

    def reconcile_once(self) -> int:
        self.pump()
        return self.process()

    def run_until_stable(self, max_rounds: int = 50) -> None:
        for _ in range(max_rounds):
            if self.reconcile_once() == 0:
                return

    # -- telemetry -------------------------------------------------------------

    def workqueue_depth(self) -> int:
        return len(self._dirty)  # len() is atomic; a gauge read, not a sync

    def oldest_dirty_age_s(self) -> float:
        """Age of the oldest still-dirty key. The scan is O(depth) under the
        workqueue lock, so it is throttled to 1/s with a cached value — a
        dashboard read, not a control input."""
        now = self.clock.now()
        if now < self._age_next:
            return self._age_last
        self._age_next = now + 1.0
        with self._lock:
            oldest = min(self._dirty.values(), default=None)
        self._age_last = (now - oldest) if oldest is not None else 0.0
        return self._age_last

    def reconcile_stats(self) -> Dict:
        """The /debug/controlstats payload for this controller."""
        out = self.recorder.snapshot()
        out["depth"] = self.workqueue_depth()
        out["oldest_dirty_age_s"] = round(self.oldest_dirty_age_s(), 3)
        out["watch_kinds"] = list(self.watch_kinds)
        return out

    # -- daemon mode -----------------------------------------------------------

    def start(self, interval: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self.reconcile_once() == 0:
                    self.clock.sleep(interval)

        self._thread = self._loop_thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._watch is not None:
            self._watch.stop()
            self._watch = None

    # -- to implement ----------------------------------------------------------

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        raise NotImplementedError

    def sync(self, key: str) -> None:
        raise NotImplementedError
