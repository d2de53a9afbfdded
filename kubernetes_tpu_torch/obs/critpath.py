"""Critical-path attribution: decompose sampled pods'
submit→bound latency into additive per-stage components and name the
dominant one per window.

The counterpart of `kubernetes_tpu/obs/critpath.py`. GET /debug/critpath
(server/rest.py) serves it; `ktl sched why` comes with the CLI (ROADMAP.md
queue 1 item 7g2).

Input is the existing podtrace span set (scheduler/podtrace.py): each
sampled span carries absolute-offset stamps (ms from enqueue) for the
lifecycle edges enqueue → pop → solve → assume → dispatch → bind_confirmed
→ watch_delivered. Consecutive-edge differences are additive BY
CONSTRUCTION, so the components sum exactly to the span's measured
submit_to_bound_ms (within 10% at the p50/p99 quantiles, exactly at the
mean).

Components:

  queue_wait  enqueue → pop          time in the scheduling queue
  build       pop → solve, scaled    snapshot + tensorize + build_pod_batch
  solve       pop → solve, scaled    the solver proper
  assume      solve → assume         cache assume + gang quorum
  dispatch    assume → dispatch      handoff to the bind worker
  bind        dispatch → bind_confirmed   store.bind_many + confirm
  watch       bind_confirmed → watch_delivered   POST-bound propagation,
              reported but excluded from the submit→bound sum

The pop→solve edge covers tensorize+build_pod_batch+solve; podtrace stamps
only its ends (per-stage stamps per pod would be per-pod taps). The split
uses the flight recorder's AGGREGATE stage table — a ratio, not a per-batch
join: flight records are wall-clock stamped while span stamps ride the
scheduler clock, so a per-record time join is not sound. The ratio keeps
the component sum exact (build + solve == the measured edge).

Pure arithmetic over the ≤K-sampled span set, no instrumentation calls, no
per-pod taps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["COMPONENTS", "decompose", "analyze"]

# (component, span stage that closes its edge) in lifecycle order; the
# pop→solve edge lands under "build+solve" and is split by the stage-table
# ratio afterwards.
_EDGES: Tuple[Tuple[str, str], ...] = (
    ("queue_wait", "pop"),
    ("build+solve", "solve"),
    ("assume", "assume"),
    ("dispatch", "dispatch"),
    ("bind", "bind_confirmed"),
)

COMPONENTS = ("queue_wait", "build", "solve", "assume", "dispatch", "bind")


def _nearest_rank(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def build_ratio(stage_table: Optional[Dict]) -> float:
    """Fraction of the pop→solve edge owned by batch construction
    (tensorize + build_pod_batch vs solve), from the aggregate stage table
    ({stage: {"total_ms": ...}}). 0.0 when the table is empty — the whole
    edge then reports as solve."""
    if not stage_table:
        return 0.0
    build_ms = 0.0
    for stage in ("tensorize", "build_pod_batch"):
        row = stage_table.get(stage)
        if row:
            build_ms += float(row.get("total_ms") or 0.0)
    solve_row = stage_table.get("solve") or {}
    solve_ms = float(solve_row.get("total_ms") or 0.0)
    denom = build_ms + solve_ms
    return build_ms / denom if denom > 0 else 0.0


def decompose(span: Dict, ratio: float = 0.0) -> Optional[Dict[str, float]]:
    """One span's additive component breakdown (ms), or None when the span
    never bound. Missing intermediate stamps fold into the next present
    edge, so sum(components) == submit_to_bound_ms always holds. The
    post-bound watch component rides along under "watch" and is NOT part
    of that sum."""
    stamps = span.get("stamps_ms") or {}
    total = span.get("submit_to_bound_ms")
    if total is None or "enqueue" not in stamps:
        return None
    comps: Dict[str, float] = {}
    prev = stamps["enqueue"]
    for comp, stage in _EDGES:
        at = stamps.get(stage)
        if at is None:
            continue
        comps[comp] = max(at - prev, 0.0)
        prev = at
    joint = comps.pop("build+solve", None)
    if joint is not None:
        comps["build"] = joint * ratio
        comps["solve"] = joint * (1.0 - ratio)
    delivered = stamps.get("watch_delivered")
    confirmed = stamps.get("bind_confirmed")
    if delivered is not None and confirmed is not None:
        comps["watch"] = max(delivered - confirmed, 0.0)
    return comps


def _rollup(rows: List[Tuple[Dict[str, float], float]]) -> Dict:
    """Aggregate decomposed rows [(components, total_ms)] into per-component
    p50/p99/mean plus the dominant component and the additivity check
    numbers the acceptance test reads."""
    per: Dict[str, List[float]] = {}
    totals: List[float] = []
    for comps, total in rows:
        totals.append(total)
        for comp, ms in comps.items():
            per.setdefault(comp, []).append(ms)
    totals.sort()
    n = len(totals)
    out_comps: Dict[str, Dict] = {}
    dominant, dominant_mean = None, -1.0
    sum_p50 = sum_p99 = sum_mean = 0.0
    for comp in COMPONENTS + ("watch",):
        vals = per.get(comp)
        if not vals:
            continue
        vals.sort()
        mean = sum(vals) / len(vals)
        row = {"p50_ms": round(_nearest_rank(vals, 0.50), 3),
               "p99_ms": round(_nearest_rank(vals, 0.99), 3),
               "mean_ms": round(mean, 4)}
        out_comps[comp] = row
        if comp == "watch":  # post-bound: excluded from the sum + dominance
            continue
        sum_p50 += row["p50_ms"]
        sum_p99 += row["p99_ms"]
        sum_mean += mean
        if mean > dominant_mean:
            dominant, dominant_mean = comp, mean
    total_mean = sum(totals) / n if n else 0.0
    return {
        "count": n,
        "components": out_comps,
        "dominant": dominant,
        "dominant_share": round(dominant_mean / total_mean, 4)
        if total_mean > 0 and dominant_mean >= 0 else None,
        "sum_p50_ms": round(sum_p50, 3),
        "total_p50_ms": round(_nearest_rank(totals, 0.50), 3),
        "sum_p99_ms": round(sum_p99, 3),
        "total_p99_ms": round(_nearest_rank(totals, 0.99), 3),
        "sum_mean_ms": round(sum_mean, 4),
        "total_mean_ms": round(total_mean, 4),
    }


def analyze(spans: List[Dict], stage_table: Optional[Dict] = None) -> Dict:
    """Group bound spans by rotation window, roll each window (and the
    whole set) up into component quantiles + the dominant component.
    `stage_table` is the flight recorder's aggregate table (stage_table())
    used for the build/solve split ratio."""
    ratio = build_ratio(stage_table)
    by_window: Dict[int, List[Tuple[Dict[str, float], float]]] = {}
    all_rows: List[Tuple[Dict[str, float], float]] = []
    skipped = 0
    for span in spans or ():
        comps = decompose(span, ratio)
        if comps is None:
            skipped += 1
            continue
        row = (comps, float(span.get("submit_to_bound_ms") or 0.0))
        by_window.setdefault(int(span.get("window") or 0), []).append(row)
        all_rows.append(row)
    return {
        "build_ratio": round(ratio, 4),
        "spans_analyzed": len(all_rows),
        "spans_skipped": skipped,
        "windows": {w: _rollup(rows)
                    for w, rows in sorted(by_window.items())},
        "overall": _rollup(all_rows) if all_rows else None,
    }
