"""Declarative latency SLOs over the observability stack — regression GATES.

The counterpart of `kubernetes_tpu/scheduler/slo.py`: it turns the flight
recorder and the pod tracer from a dashboard into assertions. A spec is a
plain dict (JSON-serializable, loadable from a file for `ktl sched slo
--spec`, which comes with ROADMAP.md queue 1 item 7g2):

    {
      "stage_p99_ms":         {"solve": 5000, "bind": 8000, ...},
      "submit_to_bound_p99_s": 30.0,
      "solver_compiles":       0,
      "instrumentation_frac":  0.02
    }

  stage_p99_ms           per-stage p99 ceilings in ms, checked against the
                         flight recorder's stage table (flightrec.py). A
                         stage absent from the stats is a SKIP, not a pass —
                         except that a FAILED check it would have produced is
                         exactly what the consumer must decide about, so
                         skips are reported separately.
  submit_to_bound_p99_s  ceiling on the all-pods submit->bound p99
                         (scheduler/podtrace.py latency histogram).
  watch_propagation_p99_s  ceiling on the store watch bus's commit->dequeue
                         p99 across all kinds (the "watch" section
                         of a stats payload — sched_stats() or the bench's
                         assembled dict — carries the settled summary).
  reconcile_p99_ms       ceiling on the WORST controller's per-loop sync
                         p99 (obs/reconcile.py rollup: one dark-slow
                         controller must fail the ceiling, not be averaged
                         away). SKIPs on a payload with no "reconcile"
                         section — a live `ktl sched slo` has one scheduler,
                         not the controller registry.
  solver_compiles        max jit compiles inside the measured window (the
                         retrace guard as an SLO; needs the caller to supply
                         the count via `extra` — bench.py does, a live `ktl
                         sched slo` cannot and the check reports SKIP).
  instrumentation_frac   recorder+tracer self-time / wall ceiling (the <2%
                         budget as a first-class SLO; also `extra`-supplied).

Steady-state trend/leak gates — these consume the "windows"
section (obs/timeseries.py window records, each carrying per-stage p50/p99
and the resource-sampler probe columns), so they see the SHAPE of a run over
time where the whole-run keys above only see its aggregate:

  stage_p99_ms_per_window  per-stage ceiling checked against EVERY window's
                         p99 (actual = the worst window) — a single stalled
                         window fails even when the whole-run p99 absorbs it.
  rss_slope_mb_per_min   least-squares slope over the windows' rss_mb in
                         MB/minute — the heap-pin detector (a parked bind
                         worker pinning a stopped scheduler's heap). FAILS on sustained
                         growth; a flat-but-high RSS passes (capacity is a
                         different spec).
  alloc_block_slope_per_s  slope over sys.getallocatedblocks() per second —
                         the deterministic live-OBJECT leak signal (RSS is
                         allocator-noisy; leaked objects always grow this).
  p99_drift_ratio        worst over stages of median(last third of window
                         p99s) / median(first third) — "is the tail creeping
                         under steady load". Sub-millisecond stages are
                         excluded (pure noise); monotonic growth reads >1.

Trend checks SKIP (reported, never silently passed) under
TREND_MIN_WINDOWS windows — a slope over two points is an opinion.

evaluate_slo() consumes a sched_stats()-shaped payload (the /debug/schedstats
document, or the dict bench.py assembles) and returns
{"pass", "checks": [{name, limit, actual, ok}], "failed", "skipped"} where
ok is True/False/None(=skipped). The reference's bench rungs gate on "pass",
so its series tracks tails, not just pods/s.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

# The NorthStar_100k_10k_endtoend gate. Ceilings are sized for the FULL
# 100k-pod run on the noisy 2-core CI rig (one batch, so per-stage p99 ==
# that batch's wall share) with ~4x headroom over BENCH_r07 — the gate
# catches order-of-magnitude tail regressions (a stalled chunk, a retrace,
# a serialization bug), not scheduling jitter.
NORTH_STAR_SLO: Dict = {
    "stage_p99_ms": {
        "ingest": 6000.0,
        "queue_add": 4000.0,
        "pop": 2000.0,
        "tensorize": 3000.0,
        "build_pod_batch": 5000.0,
        "solve": 8000.0,
        "assume": 6000.0,
        "dispatch": 2000.0,
        "bind": 8000.0,
        "bind_wait": 8000.0,
    },
    "submit_to_bound_p99_s": 30.0,
    "solver_compiles": 0,
    "instrumentation_frac": 0.02,
}

# The ChaosChurn_20k gate: under injected solver faults, bind faults, a
# worker kill, and a mid-run resync, the p99 is SUPPOSED to show an excursion
# (breaker cooldown + backoff tiers) — the SLO asserts the excursion stays
# BOUNDED and the tracer keeps working, not that chaos is latency-free.
CHAOS_SLO: Dict = {
    "submit_to_bound_p99_s": 120.0,
}

# The ControlPlane_churn gate: deployment rollout + node drain +
# eviction/replace driven through the controllers on the noisy 2-core rig.
# Ceilings catch order-of-magnitude regressions (a backlogged watcher, a
# controller gone quadratic), not scheduling jitter: propagation is
# microseconds in-process, reconcile loops are single-digit ms.
CONTROL_PLANE_SLO: Dict = {
    "watch_propagation_p99_s": 10.0,
    "reconcile_p99_ms": 2000.0,
}

# The NorthStar_1M soak gate: sustained create/bind/delete churn
# at steady state. The windowed keys assert the run's SHAPE — no stalled
# window, no monotonic RSS/live-object growth, no creeping tail — with
# ceilings sized for the noisy co-scheduled CI rig (order-of-magnitude
# detectors; the leak fixture in tests/test_timeseries.py proves they bite).
# bench.py quick mode loosens the slope ceilings: a time-compressed run
# divides the same absolute noise by a much shorter baseline.
SOAK_SLO: Dict = {
    "stage_p99_ms_per_window": {
        "solve": 8000.0,
        "assume": 6000.0,
        "bind": 8000.0,
    },
    "rss_slope_mb_per_min": 30.0,
    "alloc_block_slope_per_s": 100_000.0,
    "p99_drift_ratio": 10.0,
}

# a trend over fewer windows than this is a SKIP, not a verdict
TREND_MIN_WINDOWS = 4
# stages whose first-third median p99 sits under this are excluded from the
# drift check — a 0.02ms dispatch stage doubling is noise, not a regression
DRIFT_FLOOR_MS = 1.0

# what `ktl sched slo` checks when no --spec file is given
DEFAULT_SLO = NORTH_STAR_SLO

KNOWN_SPEC_KEYS = frozenset((
    "stage_p99_ms", "submit_to_bound_p99_s", "solver_compiles",
    "instrumentation_frac", "watch_propagation_p99_s", "reconcile_p99_ms",
    "stage_p99_ms_per_window", "rss_slope_mb_per_min",
    "alloc_block_slope_per_s", "p99_drift_ratio"))


def load_slo_spec(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _trend_checks(windows: List[Dict], spec: Dict, checks: List[Dict]) -> None:
    """The steady-state gates over the "windows" section."""
    from ..obs.timeseries import drift_ratio, extract_series, fit_slope

    for stage, limit in sorted(
            (spec.get("stage_p99_ms_per_window") or {}).items()):
        pts = extract_series(windows, "stages", stage, "p99_ms")
        worst = max((v for _t, v in pts), default=None)
        checks.append(_check(f"stage_p99_ms_per_window:{stage}", limit,
                             worst))
    if "rss_slope_mb_per_min" in spec:
        pts = extract_series(windows, "resource", "rss_mb")
        slope = (fit_slope(pts) if len(pts) >= TREND_MIN_WINDOWS else None)
        checks.append(_check(
            "rss_slope_mb_per_min", spec["rss_slope_mb_per_min"],
            slope * 60.0 if slope is not None else None))
    if "alloc_block_slope_per_s" in spec:
        pts = extract_series(windows, "resource", "alloc_blocks")
        slope = (fit_slope(pts) if len(pts) >= TREND_MIN_WINDOWS else None)
        checks.append(_check(
            "alloc_block_slope_per_s", spec["alloc_block_slope_per_s"],
            slope))
    if "p99_drift_ratio" in spec:
        stages = sorted({s for rec in windows
                         for s in (rec.get("stages") or {})})
        worst = None
        if len(windows) >= TREND_MIN_WINDOWS:
            for stage in stages:
                vals = [v for _t, v in
                        extract_series(windows, "stages", stage, "p99_ms")]
                if len(vals) < TREND_MIN_WINDOWS:
                    continue
                third = max(1, len(vals) // 3)
                head = sorted(vals[:third])
                if head[len(head) // 2] < DRIFT_FLOOR_MS:
                    continue  # sub-ms stage: drift is noise, not regression
                d = drift_ratio(vals)
                if d is not None and (worst is None or d > worst):
                    worst = d
        checks.append(_check("p99_drift_ratio", spec["p99_drift_ratio"],
                             worst))


def _check(name: str, limit, actual) -> Dict:
    ok: Optional[bool]
    if actual is None:
        ok = None  # data unavailable: SKIP (reported, never silently passed)
    else:
        ok = actual <= limit  # every spec value is a ceiling
    return {"name": name, "limit": limit,
            "actual": round(actual, 6) if isinstance(actual, float) else actual,
            "ok": ok}


def evaluate_slo(stats: Dict, spec: Dict,
                 extra: Optional[Dict] = None) -> Dict:
    """Evaluate one scheduler's stats payload against a spec.

    stats: sched_stats()-shaped — needs "stages" (stage table rows with
    p99_ms) for stage ceilings and "latency" (podtrace latency_stats) for the
    submit->bound ceiling. extra: out-of-band numbers only the harness knows
    (solver_compiles, instrumentation_frac)."""
    extra = extra or {}
    checks: List[Dict] = []
    # a typoed spec key ("stage_p99ms") must not yield a vacuous PASS that
    # checks nothing: unknown keys are FAILING checks, visible in the table
    for key in sorted(set(spec) - KNOWN_SPEC_KEYS):
        checks.append({"name": f"unknown_spec_key:{key}", "limit": None,
                       "actual": spec[key], "ok": False})
    stages = stats.get("stages") or {}
    for stage, limit in sorted((spec.get("stage_p99_ms") or {}).items()):
        row = stages.get(stage) or {}
        checks.append(_check(f"stage_p99_ms:{stage}", limit,
                             row.get("p99_ms")))
    if "submit_to_bound_p99_s" in spec:
        lat = stats.get("latency") or {}
        checks.append(_check("submit_to_bound_p99_s",
                             spec["submit_to_bound_p99_s"],
                             lat.get("p99_s")))
    if "watch_propagation_p99_s" in spec:
        prop = (stats.get("watch") or {}).get("propagation") or {}
        checks.append(_check("watch_propagation_p99_s",
                             spec["watch_propagation_p99_s"],
                             prop.get("p99_s")))
    if "reconcile_p99_ms" in spec:
        rec = stats.get("reconcile") or {}
        checks.append(_check("reconcile_p99_ms", spec["reconcile_p99_ms"],
                             rec.get("p99_ms")))
    if ("stage_p99_ms_per_window" in spec or "rss_slope_mb_per_min" in spec
            or "alloc_block_slope_per_s" in spec
            or "p99_drift_ratio" in spec):
        _trend_checks(stats.get("windows") or [], spec, checks)
    if "solver_compiles" in spec:
        checks.append(_check("solver_compiles", spec["solver_compiles"],
                             extra.get("solver_compiles")))
    if "instrumentation_frac" in spec:
        checks.append(_check("instrumentation_frac",
                             spec["instrumentation_frac"],
                             extra.get("instrumentation_frac")))
    failed = [c["name"] for c in checks if c["ok"] is False]
    skipped = [c["name"] for c in checks if c["ok"] is None]
    return {"pass": not failed, "failed": failed, "skipped": skipped,
            "checks": checks}
