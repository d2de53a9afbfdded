"""Resource & GIL sampler — RSS, GC, live-object, and per-thread CPU time
for the long-running control plane.

The counterpart of `kubernetes_tpu/obs/resource.py`.

A background thread samples at a fixed interval (default 1s):

  rss_mb        resident set from /proc/self/statm (one read + split);
  alloc_blocks  sys.getallocatedblocks() — the deterministic live-object
                signal the leak gates fit a slope over (RSS is noisy: the
                allocator keeps arenas; leaked OBJECTS always grow this);
  gc            gen counts (gc.get_count), collections/collected since
                start, and measured pause seconds via gc.callbacks
                (start/stop pairs around each collection);
  threads       per-REGISTERED-thread CPU seconds — the scheduling, bind,
                and partition drive threads register themselves so the
                partition A/B can be JUDGED when the rig regrows cores:
                overlap_cpu_s below measures CPU beyond wall, which only
                exists when one thread's GIL-releasing work (a kernel
                launch's wait, the g++ engines) truly overlaps another's
                GIL-held host work.

Per-thread clock (time.thread_time() has ticked at 10ms in some
containers, and it can only read the CALLING thread anyway): where the
platform allows it we read other threads' CPU clocks through the Linux per-thread clockid encoding
(CPUCLOCK_SCHED | CPUCLOCK_PERTHREAD for a kernel tid: ``(~tid << 3) | 6``)
via time.clock_gettime; the fallback is /proc/self/task/<tid>/schedstat
(nanosecond-granular on CFS). Whichever source wins, the sampler MEASURES
its effective tick at startup and publishes it as an honesty flag
(clock_source / clock_resolution_s) right next to the attribution columns —
a 10ms-tick container cannot quietly publish microsecond claims.

Everything is bounded (sample ring, registered-thread map) and the
sampler's own cost is measured (self_seconds + overhead_frac vs elapsed),
so the <2% instrumentation budget covers it from a measurement.
"""

from __future__ import annotations

import gc
import itertools
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from . import tracebuf as _tracebuf

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 600  # 10 min of 1s samples

_PAGE_MB = os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0) \
    if hasattr(os, "sysconf") else 4096 / (1024.0 * 1024.0)


def _thread_clock_id(native_id: int) -> int:
    """Linux kernel clockid encoding for another thread's CPU clock:
    CPUCLOCK_PERTHREAD | CPUCLOCK_SCHED over the kernel tid. An ABI detail,
    so probe_thread_clock() validates it once before the sampler trusts it."""
    return (~native_id << 3) | 6


def read_thread_cpu_s(native_id: int, source: str) -> Optional[float]:
    """One thread's cumulative CPU seconds via the probed source; None when
    the thread is gone or the source fails (a dead tid is normal churn)."""
    try:
        if source == "clockid":
            return time.clock_gettime(_thread_clock_id(native_id))
        if source == "schedstat":
            with open(f"/proc/self/task/{native_id}/schedstat") as f:
                return int(f.read().split()[0]) / 1e9
    except (OSError, ValueError, IndexError):
        return None
    return None


def probe_thread_clock() -> Dict:
    """Pick the per-thread CPU clock source and MEASURE its effective tick
    (the honesty flag): spin-read the chosen clock on this thread briefly
    and report the smallest observed positive increment. clock_getres lies
    on some containers (reports 1ns for a 10ms-tick clock), so the
    published resolution is measured, never queried."""
    tid = threading.get_native_id()
    source = None
    for cand in ("clockid", "schedstat"):
        if read_thread_cpu_s(tid, cand) is not None:
            source = cand
            break
    if source is None:
        return {"source": "unavailable", "resolution_s": None}
    seen = set()
    deadline = time.perf_counter() + 0.02
    while time.perf_counter() < deadline and len(seen) < 64:
        v = read_thread_cpu_s(tid, source)
        if v is not None:
            seen.add(v)
    vals = sorted(seen)
    deltas = [b - a for a, b in zip(vals, vals[1:]) if b > a]
    return {"source": source,
            "resolution_s": min(deltas) if deltas else None}


# weak registry of live samplers so /metrics GaugeFuncs can read the latest
# sample without per-instance wiring (the watch-source registry pattern)
_samplers_lock = threading.Lock()
_samplers: List = []
_sampler_seq = itertools.count()


def _register_sampler(sampler: "ResourceSampler") -> None:
    with _samplers_lock:
        _samplers[:] = [r for r in _samplers if r() is not None]
        _samplers.append(weakref.ref(sampler))


def live_samplers() -> List["ResourceSampler"]:
    with _samplers_lock:
        refs = list(_samplers)
    return [s for s in (r() for r in refs) if s is not None]


class ResourceSampler:
    """Bounded-ring resource/GIL sampler (see module docstring).

    Threads register by threading.Thread (native id resolves lazily — a
    not-yet-started worker registers fine) or by explicit native id. The
    sampling thread is daemon + stop()-able; sample_once() works without
    the thread for tests and one-shot reads."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY, clock_probe: bool = True):
        self.interval_s = float(interval_s)
        self.capacity = capacity
        # stable identity for the /metrics series: several samplers can be
        # alive at once (tests, one per coordinator) and unlabeled
        # duplicate samples would corrupt the exposition
        self.id = f"sampler-{next(_sampler_seq)}"
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        # name -> Thread (weakly held) or resolved native id
        self._threads: Dict[str, object] = {}
        self._cpu0: Dict[str, float] = {}  # first-seen cumulative, per name
        self._cpu_last: Dict[str, float] = {}
        # seconds accumulated under this name by PREVIOUS thread
        # registrations (a restarted bind worker / per-round drive thread
        # keeps one monotonic column instead of resetting it)
        self._cpu_carry: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.clock = (probe_thread_clock() if clock_probe
                      else {"source": "unavailable", "resolution_s": None})
        # gc pause accounting via gc.callbacks (registered on start())
        self._gc_cb_installed = False
        self._gc_t0 = 0.0
        self._gc_pause_s = 0.0
        self._gc_pause_max_s = 0.0
        self._gc_collections = 0
        self.samples_taken = 0
        self.self_seconds = 0.0
        self._t_start = time.perf_counter()
        self._rss0_mb = self._read_rss_mb()
        self._alloc0 = sys.getallocatedblocks()
        _register_sampler(self)

    # -- thread registration ---------------------------------------------------

    def register_thread(self, name: str, thread=None,
                        native_id: Optional[int] = None) -> None:
        """Track one thread's CPU time under `name`. Re-registering a name
        replaces the target thread but KEEPS the column monotonic: the old
        thread's accumulated seconds carry over (restarted bind workers and
        per-round partition drive threads are one logical column)."""
        with self._lock:
            if name in self._cpu_last:
                self._cpu_carry[name] = (
                    self._cpu_carry.get(name, 0.0)
                    + self._cpu_last[name]
                    - self._cpu0.get(name, self._cpu_last[name]))
            if native_id is not None:
                self._threads[name] = native_id
            elif thread is not None:
                self._threads[name] = weakref.ref(thread)
            else:
                self._threads[name] = threading.get_native_id()
            self._cpu0.pop(name, None)
            self._cpu_last.pop(name, None)

    def _resolve_tid(self, target) -> Optional[int]:
        if isinstance(target, int):
            return target
        t = target() if isinstance(target, weakref.ref) else target
        if t is None:
            return None
        return getattr(t, "native_id", None)

    # -- gc pause hooks --------------------------------------------------------

    def _gc_callback(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif phase == "stop" and self._gc_t0:
            dt = time.perf_counter() - self._gc_t0
            self._gc_pause_s += dt
            if dt > self._gc_pause_max_s:
                self._gc_pause_max_s = dt
            self._gc_collections += 1

    def _install_gc_cb(self) -> None:
        if not self._gc_cb_installed:
            gc.callbacks.append(self._gc_callback)
            self._gc_cb_installed = True

    def _remove_gc_cb(self) -> None:
        if self._gc_cb_installed:
            try:
                gc.callbacks.remove(self._gc_callback)
            except ValueError:
                pass
            self._gc_cb_installed = False

    # -- sampling --------------------------------------------------------------

    def _read_rss_mb(self) -> float:
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * _PAGE_MB
        except (OSError, ValueError, IndexError):
            return 0.0

    def rss_mb(self) -> float:
        """One fresh RSS read (no ring append): a warmup loop polls this
        until the allocator plateaus before a measured soak."""
        return self._read_rss_mb()

    def sample_once(self) -> Dict:
        """Take one sample, append it to the ring, return it. The per-call
        cost is measured into self_seconds (the budget feed)."""
        t0 = time.perf_counter()
        source = self.clock["source"]
        with self._lock:
            threads: Dict[str, Dict] = {}
            for name, target in self._threads.items():
                tid = self._resolve_tid(target)
                cpu = (read_thread_cpu_s(tid, source)
                       if tid is not None else None)
                if cpu is None:
                    continue
                base = self._cpu0.setdefault(name, cpu)
                prev = self._cpu_last.get(name, cpu)
                self._cpu_last[name] = cpu
                threads[name] = {
                    "cpu_s": round(self._cpu_carry.get(name, 0.0)
                                   + cpu - base, 6),
                    "cpu_delta_s": round(cpu - prev, 6),
                }
            counts = gc.get_count()
            rec = {
                "ts": t0,
                "rss_mb": round(self._read_rss_mb(), 3),
                "alloc_blocks": sys.getallocatedblocks(),
                "gc": {
                    "gen_counts": list(counts),
                    "collections": self._gc_collections,
                    "pause_s": round(self._gc_pause_s, 6),
                    "pause_max_s": round(self._gc_pause_max_s, 6),
                },
                "process_cpu_s": round(time.process_time(), 6),
                "threads": threads,
            }
            self._ring.append(rec)
            self.samples_taken += 1
        # trace timeline: one counter event per sample TICK —
        # the RSS / GC-pause / alloc tracks under the scheduling slices
        if _tracebuf.ACTIVE is not None:
            _tracebuf.ACTIVE.counter(
                "resource", "memory", {
                    "rss_mb": rec["rss_mb"],
                    "alloc_blocks": rec["alloc_blocks"]}, t=t0)
            _tracebuf.ACTIVE.counter(
                "resource", "gc", {
                    "pause_ms": rec["gc"]["pause_s"] * 1000.0,
                    "collections": rec["gc"]["collections"]}, t=t0)
        self.self_seconds += time.perf_counter() - t0
        return rec

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # a torn /proc read or dying thread must not kill the
                # sampler; the next tick tries again
                continue

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._install_gc_cb()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="resource-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        self._remove_gc_cb()

    def reset(self) -> None:
        """Drop history and re-baseline (the warmup-exclusion idiom): the
        soak rung's measured window must not inherit warmup RSS growth."""
        with self._lock:
            self._ring.clear()
            self._cpu0.clear()
            self._cpu_last.clear()
            self._cpu_carry.clear()
            self._gc_pause_s = 0.0
            self._gc_pause_max_s = 0.0
            self._gc_collections = 0
            self.samples_taken = 0
            self.self_seconds = 0.0
            self._t_start = time.perf_counter()
            self._rss0_mb = self._read_rss_mb()
            self._alloc0 = sys.getallocatedblocks()

    # -- read side -------------------------------------------------------------

    def samples(self, last: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last else out

    def latest(self) -> Optional[Dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def summary(self) -> Dict:
        """The columns sched_stats / the soak rung / window probes publish:
        latest absolutes, growth since baseline, per-thread CPU totals, the
        overlap measurement, and the honesty flags (clock source/resolution,
        measured sampler overhead)."""
        with self._lock:
            ring = list(self._ring)
            threads = {name: round(self._cpu_carry.get(name, 0.0)
                                   + self._cpu_last[name]
                                   - self._cpu0.get(name,
                                                    self._cpu_last[name]), 6)
                       for name in self._cpu_last}
            elapsed = time.perf_counter() - self._t_start
            gc_col = {
                "collections": self._gc_collections,
                "pause_s": round(self._gc_pause_s, 6),
                "pause_max_s": round(self._gc_pause_max_s, 6),
            }
        last = ring[-1] if ring else None
        # overlap: CPU beyond wall inside one sampling interval can only
        # come from threads truly running in parallel (GIL released) — the
        # direction-3 A/B's "measured, not inferred from bind_wait" number
        overlap = 0.0
        for a, b in zip(ring, ring[1:]):
            wall = b["ts"] - a["ts"]
            cpu = sum(t["cpu_delta_s"] for t in b["threads"].values())
            if cpu > wall > 0:
                overlap += cpu - wall
        return {
            "enabled": self._thread is not None or bool(ring),
            "interval_s": self.interval_s,
            "samples": self.samples_taken,
            "rss_mb": last["rss_mb"] if last else None,
            "rss_growth_mb": (round(last["rss_mb"] - self._rss0_mb, 3)
                              if last else None),
            "alloc_blocks": last["alloc_blocks"] if last else None,
            "alloc_growth_blocks": (last["alloc_blocks"] - self._alloc0
                                    if last else None),
            "gc": gc_col,
            "thread_cpu_s": threads,
            "overlap_cpu_s": round(overlap, 6),
            "clock_source": self.clock["source"],
            "clock_resolution_s": self.clock["resolution_s"],
            "self_seconds": round(self.self_seconds, 6),
            "overhead_frac": (round(self.self_seconds / elapsed, 6)
                              if elapsed > 0 else 0.0),
        }
