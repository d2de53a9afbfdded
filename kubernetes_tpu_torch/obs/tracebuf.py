"""Unified trace timeline: a bounded trace-event ring exported as Chrome
trace-event JSON, loadable in Perfetto / chrome://tracing.

The counterpart of `kubernetes_tpu/obs/tracebuf.py`. The pipeline already
times everything (flight-recorder stage clocks, sampled podtrace spans,
watch-propagation stamps, the reconcile recorder, the resource sampler,
rebalancer/gang/breaker stats), but each source renders its own table. This
module is the join: existing per-BATCH / per-window / per-cycle
instrumentation forwards ONE extra tap into a shared ring, and export()
emits the standard trace-event JSON (name/ph/ts/pid/tid) so a capture window
opens as a single causal timeline. Each pipeline lands on its own track
(tid = pipeline label: ``sched`` / ``bind``; ``p<i>-sched`` / ``p<i>-bind``
for partition i of the partitioned scheduler and ``p-1-*`` for its residual
pass; ``w<i>-sched`` for worker process i of the multi-process scheduler,
stamped in the owner from the worker's own perf_counter), so overlap of the
bind worker with the next solve, and of one partition with another, is
visible as overlapping slices.

Discipline (the reference's HP001 rule):

  * taps are per-batch / per-chunk / per-cycle / per-window ONLY, never
    per pod outside a sampled-set check;
  * disabled cost is ONE module-attribute check — hot sites guard with
    ``if tracebuf.ACTIVE is not None:`` exactly like chaos/faultinject.py;
    disabled_check_cost_ns() measures that guard so the budget is asserted
    from a measurement, not by differencing noisy runs;
  * armed cost is measured: every tap accumulates perf_counter time into
    self_seconds (chip_smoke.py prints it as a share of the leg's wall time).

Event vocabulary (Chrome trace-event format, ts in MICROseconds):

  X  complete slice (dur)      — stage slices, bind chunks, rebalance cycles
  B/E duration begin/end       — the enclosing per-batch envelope
  i  instant                   — breaker transitions, FaultInject firings,
                                 gang-preemption attempts, rebalance waves
  C  counter                   — RSS / GC-pause / alloc-blocks tracks
  s/f flow arrows              — evict→replace causal chains, synthesized at
                                 export time from podtrace span links (the
                                 links are sampled-only, so no per-pod tap)
  M  metadata                  — process/thread names for the Perfetto UI

Time domains: ring timestamps are time.perf_counter()-anchored (the
StageClock/Trace domain). Podtrace spans stamp the scheduler clock
(time.monotonic / FakeClock); attach_clock() captures the offset once so
export() can place span-derived flow anchors on the same axis.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TraceBuffer", "ACTIVE", "LAST", "arm", "disarm", "enabled",
    "current", "status", "disabled_check_cost_ns", "validate_export",
]

DEFAULT_CAPACITY = 65536
_PID = 1  # single-process orchestrator: one trace process, many tracks


class TraceBuffer:
    """Bounded ring of trace events with per-track (tid) bookkeeping.

    All taps are O(events emitted) with one lock acquisition per tap; a full
    ring drops the OLDEST event per append (deque maxlen) and counts the
    drop, so a long capture keeps the most recent window and the drop total
    is observable in sched_stats()["tracebuf"] (`trace_events_dropped_total`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._tids: Dict[str, int] = {}
        self._last_breaker: Dict[str, str] = {}
        self._t0 = time.perf_counter()
        self._clock_off: Optional[float] = None
        self._flow_seq = 0
        self.events_total = 0
        self.dropped_total = 0
        self.self_seconds = 0.0

    # -- plumbing --------------------------------------------------------------

    def attach_clock(self, clock) -> None:
        """Capture the scheduler-clock → perf_counter offset (once; later
        calls are no-ops) so export() can place podtrace-span anchors on the
        ring's time axis. Cheap: two clock reads."""
        if self._clock_off is None and clock is not None:
            try:
                self._clock_off = time.perf_counter() - clock.now()
            except Exception:
                self._clock_off = None

    def _ts(self, t_perf: float) -> float:
        return (t_perf - self._t0) * 1e6  # µs

    def _tid_locked(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def _push_locked(self, ev: Dict) -> None:
        if len(self._ring) == self.capacity:
            self.dropped_total += 1
        self._ring.append(ev)
        self.events_total += 1

    def events(self) -> List[Dict]:
        """A copy of the ring, oldest first (without export's metadata and
        flow arrows)."""
        with self._lock:
            return list(self._ring)

    # -- taps (one call per batch / chunk / cycle / window) --------------------

    def note_batch(self, track: str, *, t_end: float,
                   stages: Dict[str, float], pods: int, scheduled: int,
                   outcome: str, solver: str,
                   breaker: Optional[str] = None) -> None:
        """One schedule_batch envelope: a B/E pair spanning the batch's
        serial stage time, with each stage as a back-to-back X slice inside
        it (StageClock insertion order = pipeline order). Breaker state is
        diffed against the track's last-seen state; a transition lands as an
        instant event. `t_end` is the perf_counter stamp at the tap site;
        stage values are SECONDS."""
        t0 = time.perf_counter()
        total = 0.0
        for sec in stages.values():
            total += sec
        begin = t_end - total
        state = breaker or "closed"
        with self._lock:
            tid = self._tid_locked(track)
            self._push_locked({
                "name": "batch", "cat": "sched", "ph": "B",
                "ts": self._ts(begin), "pid": _PID, "tid": tid,
                "args": {"pods": pods, "scheduled": scheduled,
                         "outcome": outcome, "solver": solver}})
            at = begin
            for name, sec in stages.items():
                dur = sec * 1e6
                if dur <= 0.0:
                    continue
                self._push_locked({
                    "name": name, "cat": "stage", "ph": "X",
                    "ts": self._ts(at), "dur": round(dur, 3),
                    "pid": _PID, "tid": tid})
                at += sec
            self._push_locked({
                "name": "batch", "cat": "sched", "ph": "E",
                "ts": self._ts(t_end), "pid": _PID, "tid": tid})
            prev = self._last_breaker.get(track, "closed")
            if state != prev:
                self._last_breaker[track] = state
                self._push_locked({
                    "name": "breaker:%s->%s" % (prev, state),
                    "cat": "breaker", "ph": "i", "s": "p",
                    "ts": self._ts(t_end), "pid": _PID, "tid": tid})
        self.self_seconds += time.perf_counter() - t0

    def note_span(self, track: str, name: str, t_begin: float, t_end: float,
                  cat: str = "span", args: Optional[Dict] = None) -> None:
        """One complete slice (X): bind-worker chunk, rebalance cycle,
        reconcile drain, watch settlement, a slow-Trace step. Timestamps are
        perf_counter values."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts(t_begin),
              "dur": round(max(t_end - t_begin, 0.0) * 1e6, 3),
              "pid": _PID}
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid_locked(track)
            self._push_locked(ev)
        self.self_seconds += time.perf_counter() - t0

    def instant(self, track: str, name: str, cat: str = "event",
                t: Optional[float] = None, args: Optional[Dict] = None,
                scope: str = "t") -> None:
        """One instant event (i): FaultInject firing, gang-preemption
        attempt, rebalance wave boundary."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": cat, "ph": "i", "s": scope,
              "ts": self._ts(t if t is not None else t0), "pid": _PID}
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid_locked(track)
            self._push_locked(ev)
        self.self_seconds += time.perf_counter() - t0

    def counter(self, track: str, name: str, values: Dict[str, float],
                t: Optional[float] = None) -> None:
        """One counter sample (C): RSS, GC pause, alloc blocks, per-window
        queue depth. `values` maps series name -> value (one C event renders
        them stacked in Perfetto)."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": "counter", "ph": "C",
              "ts": self._ts(t if t is not None else t0), "pid": _PID,
              "args": dict(values)}
        with self._lock:
            ev["tid"] = self._tid_locked(track)
            self._push_locked(ev)
        self.self_seconds += time.perf_counter() - t0

    # -- export ----------------------------------------------------------------

    def _span_anchor_us(self, span: Dict, stage_ms: Optional[float]) -> \
            Optional[float]:
        """µs position of a span's stage offset on the ring's axis, or None
        when the clock offset or span anchor is unknown."""
        t0 = span.get("t0")
        if t0 is None or self._clock_off is None or stage_ms is None:
            return None
        return self._ts(t0 + self._clock_off + stage_ms / 1000.0)

    def _flow_events(self, spans: List[Dict]) -> List[Dict]:
        """Synthesize evict→replace flow arrows (s/f pairs anchored to small
        X slices on a `lifecycle` track) from podtrace span links. Runs at
        EXPORT time over the sampled span set only — never on a hot path."""
        out: List[Dict] = []
        by_pod = {sp.get("pod"): sp for sp in spans}
        with self._lock:
            tid = self._tid_locked("lifecycle")
        for sp in spans:
            evicted_key = sp.get("replaces")
            if not evicted_key:
                continue
            src = by_pod.get(evicted_key)
            # source anchor: the evicted pod's last stamp (its death);
            # fall back to the replacement's own enqueue minus a tick so a
            # ring-evicted source span still draws an arrow
            src_us = None
            if src is not None:
                stamps = src.get("stamps_ms") or {}
                last_ms = max(stamps.values()) if stamps else 0.0
                src_us = self._span_anchor_us(src, last_ms)
            dst_us = self._span_anchor_us(sp, 0.0)
            if dst_us is None:
                continue
            if src_us is None or src_us >= dst_us:
                src_us = dst_us - 50.0
            self._flow_seq += 1
            fid = self._flow_seq
            dur = max((sp.get("submit_to_bound_ms") or 0.05) * 1000.0, 50.0)
            out.append({"name": "evicted:%s" % evicted_key,
                        "cat": "lifecycle", "ph": "X", "ts": src_us,
                        "dur": 50.0, "pid": _PID, "tid": tid})
            out.append({"name": "replace", "cat": "lifecycle", "ph": "s",
                        "id": fid, "ts": src_us, "pid": _PID, "tid": tid})
            out.append({"name": "replaced-by:%s" % sp.get("pod"),
                        "cat": "lifecycle", "ph": "X", "ts": dst_us,
                        "dur": round(dur, 3), "pid": _PID, "tid": tid,
                        "args": {"replaces": evicted_key}})
            out.append({"name": "replace", "cat": "lifecycle", "ph": "f",
                        "bp": "e", "id": fid, "ts": dst_us, "pid": _PID,
                        "tid": tid})
        return out

    def export(self, spans: Optional[List[Dict]] = None) -> Dict:
        """Chrome trace-event JSON: {"traceEvents": [...]} — metadata first,
        then every ring event plus span-derived flow arrows, sorted by ts.
        Load the serialized form in https://ui.perfetto.dev or
        chrome://tracing."""
        with self._lock:
            body = list(self._ring)
            tracks = dict(self._tids)
        if spans:
            body.extend(self._flow_events(spans))
        body.sort(key=lambda ev: (ev["ts"], ev.get("tid", 0)))
        meta: List[Dict] = [{
            "name": "process_name", "ph": "M", "ts": 0.0, "pid": _PID,
            "tid": 0, "args": {"name": "tpu-sched"}}]
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": _PID, "tid": tid, "args": {"name": track}})
            meta.append({"name": "thread_sort_index", "ph": "M", "ts": 0.0,
                         "pid": _PID, "tid": tid,
                         "args": {"sort_index": tid}})
        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    def status(self) -> Dict:
        with self._lock:
            return {
                "armed": ACTIVE is self,
                "capacity": self.capacity,
                "trace_events_total": self.events_total,
                "trace_events_dropped_total": self.dropped_total,
                "tracks": len(self._tids),
                "self_seconds": round(self.self_seconds, 6),
            }


# THE hot-path flag: None when disabled. Every instrumented site guards with
# `if tracebuf.ACTIVE is not None:` — one attribute load, no call (the
# chaos/faultinject.py pattern; measured by disabled_check_cost_ns).
ACTIVE: Optional[TraceBuffer] = None
# The last disarmed buffer: a finished capture stays readable after disarm()
# (flightrec.trace_export serves it).
LAST: Optional[TraceBuffer] = None


def arm(capacity: int = DEFAULT_CAPACITY) -> TraceBuffer:
    """Install a fresh trace buffer (replacing any armed one), return it."""
    global ACTIVE
    ACTIVE = TraceBuffer(capacity=capacity)
    return ACTIVE


def disarm() -> Optional[TraceBuffer]:
    """Stop collection; the buffer stays readable as tracebuf.LAST."""
    global ACTIVE, LAST
    buf, ACTIVE = ACTIVE, None
    if buf is not None:
        LAST = buf
    return buf


def enabled() -> bool:
    return ACTIVE is not None


def current() -> Optional[TraceBuffer]:
    """The armed buffer, else the last disarmed one (read surfaces)."""
    return ACTIVE if ACTIVE is not None else LAST


def status() -> Dict:
    """Arm/drop counters for schedtrace_snapshot / /debug/schedstats —
    a full ring is observable without exporting anything."""
    buf = current()
    if buf is None:
        return {"armed": False, "trace_events_total": 0,
                "trace_events_dropped_total": 0}
    return buf.status()


def disabled_check_cost_ns(n: int = 50_000, passes: int = 5) -> float:
    """Measured per-check cost of the disabled-tracer guard (the exact
    expression hot paths use), in nanoseconds — the number chip_smoke.py
    prints so the overhead budget is asserted from a measurement instead of
    differencing two noisy runs. Best-of-`passes`: the minimum
    filters harness co-scheduling spikes on a contended rig."""
    best = float("inf")
    hits = 0
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            if ACTIVE is not None:  # the hot-path guard, verbatim
                hits += 1
        best = min(best, time.perf_counter() - t0)
    assert hits == 0 or ACTIVE is not None
    return best / n * 1e9


# -- export validation (shared by the tests and chip_smoke.py) ------------------------

def validate_export(doc: Dict) -> Dict:
    """Structural check of a Chrome trace-event export: required keys on
    every event, B/E balanced per (pid, tid) with stack discipline,
    non-decreasing ts per tid, matched s/f flow pairs. Returns
    {valid, errors, events, tracks, flow_pairs, counters, instants}."""
    errors: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return {"valid": False, "errors": ["traceEvents missing"],
                "events": 0, "tracks": 0, "flow_pairs": 0,
                "counters": 0, "instants": 0}
    depth: Dict[Tuple[int, int], int] = {}
    last_ts: Dict[int, float] = {}
    flows_s: Dict[object, int] = {}
    flows_f: Dict[object, int] = {}
    track_names = set()
    counters = instants = 0
    for ev in evs:
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                errors.append("missing %s: %r" % (field, ev))
                break
        else:
            ph = ev["ph"]
            if ph == "M":
                if ev["name"] == "thread_name":
                    track_names.add(ev.get("args", {}).get("name"))
                continue
            tid = ev["tid"]
            prev = last_ts.get(tid)
            if prev is not None and ev["ts"] < prev - 1e-6:
                errors.append("ts regressed on tid %s: %.3f < %.3f"
                              % (tid, ev["ts"], prev))
            last_ts[tid] = ev["ts"]
            if ph == "B":
                depth[(ev["pid"], tid)] = depth.get((ev["pid"], tid), 0) + 1
            elif ph == "E":
                d = depth.get((ev["pid"], tid), 0) - 1
                if d < 0:
                    errors.append("E without B on tid %s at ts %.3f"
                                  % (tid, ev["ts"]))
                    d = 0
                depth[(ev["pid"], tid)] = d
            elif ph == "X":
                if "dur" not in ev:
                    errors.append("X without dur: %r" % ev.get("name"))
            elif ph == "s":
                flows_s[ev.get("id")] = flows_s.get(ev.get("id"), 0) + 1
            elif ph == "f":
                flows_f[ev.get("id")] = flows_f.get(ev.get("id"), 0) + 1
            elif ph == "i":
                instants += 1
            elif ph == "C":
                counters += 1
    for key, d in depth.items():
        if d != 0:
            errors.append("unbalanced B/E on %s: depth %d" % (key, d))
    flow_pairs = 0
    for fid, n_s in flows_s.items():
        n_f = flows_f.get(fid, 0)
        if n_f != n_s:
            errors.append("flow id %r: %d starts, %d finishes"
                          % (fid, n_s, n_f))
        flow_pairs += min(n_s, n_f)
    for fid in flows_f:
        if fid not in flows_s:
            errors.append("flow id %r: finish without start" % fid)
    return {
        "valid": not errors,
        "errors": errors[:20],
        "events": len(evs),
        "tracks": len(track_names),
        "flow_pairs": flow_pairs,
        "counters": counters,
        "instants": instants,
    }
