"""The port's observability modules against the JAX package, unit by unit:
the stage recorder and flight recorder (obs/recorder.py,
scheduler/flightrec.py), the time series and its trend math
(obs/timeseries.py), the SLO gates (scheduler/slo.py), the critical path
(obs/critpath.py), the trace ring and its Chrome export (obs/tracebuf.py),
the pod tracer (scheduler/podtrace.py), the reconcile recorder
(obs/reconcile.py), the resource sampler (obs/resource.py), the slow-trace
log and configz (utils/tracing.py), the cache debugger
(scheduler/debugger.py), the queue telemetry and the metric series.

The same inputs go through both packages and the outputs are compared
exactly (tolerance 0): these modules are pure arithmetic over their inputs.
Where a module reads time.perf_counter (StageClock, the time series, the
trace ring), its `time` is replaced on BOTH sides by one shared fake
counter; the pod tracer rides a FakeClock and a fixed rng_seed. The
wall-clock gates of the reference's tests/test_timeseries.py (ROADMAP.md
queue 3) are not copied: their cases run here on the fake counter.
"""

import importlib
import io
import json
import threading
import time
from types import SimpleNamespace

import pytest


def _load(port: bool):
    root = "kubernetes_tpu_torch" if port else "kubernetes_tpu"

    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        port=port, rec=imp("obs.recorder"), ts=imp("obs.timeseries"),
        cp=imp("obs.critpath"), tb=imp("obs.tracebuf"), rc=imp("obs.reconcile"),
        rs=imp("obs.resource"), obs=imp("obs"), fr=imp("scheduler.flightrec"),
        pt=imp("scheduler.podtrace"), slo=imp("scheduler.slo"), dbg=imp("scheduler.debugger"),
        tr=imp("utils.tracing"), m=imp("server.metrics"), q=imp("scheduler.queue"),
        utils=imp("utils"), testing=imp("testing"), store=imp("store"))


J, T = _load(False), _load(True)
BOTH = [pytest.param(J, id="jax"), pytest.param(T, id="port")]


def parity(fn, *args, **kw):
    """Run fn on both packages; assert equal results; return the port's."""
    got, want = fn(T, *args, **kw), fn(J, *args, **kw)
    assert got == want
    return got


class FakeTime:
    """A stand-in for a module's `time`: perf_counter advances by `step` a
    read (or jumps with set()), time() is a constant. One instance is shared
    by both packages' modules in a test."""

    def __init__(self, start=1000.0, step=0.001):
        self.t = start
        self.step = step

    def perf_counter(self):
        self.t += self.step
        return self.t

    def set(self, t):
        self.t = t

    def time(self):
        return 1.7e9

    def sleep(self, s):
        self.t += s


@pytest.fixture
def fake_time(monkeypatch):
    ft = FakeTime()
    for P in (J, T):
        for mod in (P.rec, P.ts, P.tb, P.tr):
            monkeypatch.setattr(mod, "time", ft)
    return ft


@pytest.fixture(autouse=True)
def _trace_isolation():
    for P in (J, T):
        P.tb.disarm()
        P.tb.LAST = None
    yield
    for P in (J, T):
        P.tb.disarm()
        P.tb.LAST = None


def _strip(rec, keys=("ts",)):
    return {k: v for k, v in rec.items() if k not in keys}


# -- the stage recorder and the flight recorder ---------------------------------


def _mk_record(P, fr, pods=1, solve=0.01):
    return fr.record(pods=pods, nodes=2, outcome="scheduled", solver="fast",
                     stages={"solve": solve}, total_s=0.02)


def test_flightrec_tables_match_jax():
    assert T.fr.BATCH_STAGES == J.fr.BATCH_STAGES
    assert T.fr.OUTSIDE_STAGES == J.fr.OUTSIDE_STAGES
    assert T.fr.OVERLAPPED_STAGES == J.fr.OVERLAPPED_STAGES
    assert T.rec.STAGE_P_BUCKETS == J.rec.STAGE_P_BUCKETS
    assert T.fr.FlightRecorder.DEFAULT_CAPACITY == J.fr.FlightRecorder.DEFAULT_CAPACITY
    assert T.obs.__all__ if hasattr(T.obs, "__all__") else True
    for name in ("STAGE_P_BUCKETS", "RingRecorder", "StageClock", "nearest_rank",
                 "TimeSeriesRecorder", "drift_ratio", "fit_slope", "ResourceSampler"):
        assert hasattr(T.obs, name) and hasattr(J.obs, name), name


def _ring_eviction(P):
    fr = P.fr.FlightRecorder(capacity=4)
    for i in range(10):
        _mk_record(P, fr, pods=i)
    return [_strip(r) for r in fr.records()], len(fr), fr.last()["seq"]


def test_capacity_bound_evicts_oldest():
    recs, n, last = parity(_ring_eviction)
    assert n == 4 and last == 10
    assert [r["seq"] for r in recs] == [7, 8, 9, 10]


def _aggregates(P):
    fr = P.fr.FlightRecorder(capacity=2)
    for _ in range(5):
        _mk_record(P, fr)
    return fr.stage_table()


def test_aggregates_survive_eviction():
    table = parity(_aggregates)
    assert table["solve"]["batches"] == 5
    assert abs(table["solve"]["total_ms"] - 50.0) < 1e-6


def _disabled(P):
    fr = P.fr.FlightRecorder(enabled=False)
    got = _mk_record(P, fr)
    fr.add_outside("bind", 1.0)
    fr.note_bind_failures([("default/p", "boom")])
    return got, len(fr), fr.stage_table()


def test_disabled_recorder_records_nothing():
    assert parity(_disabled) == (None, 0, {})


def _outside(P):
    fr = P.fr.FlightRecorder()
    _mk_record(P, fr)
    fr.add_outside("bind", 0.5)
    fr.add_outside("bind_wait", 0.25)
    fr.add_outside("queue_add", 0.125)
    fr.note_bind_failures([("default/a", "x"), ("default/b", "y")])
    rec = _mk_record(P, fr)
    return fr.stage_table(), fr.outside_seconds("bind", "bind_wait"), rec["bind_failures"]


def test_outside_buckets_and_overlap_flag():
    table, outside, failures = parity(_outside)
    assert table["bind"]["overlapped"] is True
    assert table["bind_wait"]["overlapped"] is False
    assert abs(table["bind"]["total_ms"] - 500.0) < 1e-6
    assert outside == 0.75
    assert failures == [("default/a", "x"), ("default/b", "y")]


def _clear(P):
    fr = P.fr.FlightRecorder()
    _mk_record(P, fr)
    fr.add_outside("bind", 0.5)
    fr.note_self_time(0.1)
    fr.clear()
    return len(fr), fr.stage_table(), fr.self_seconds


def test_clear_resets_everything():
    assert parity(_clear) == (0, {}, 0.0)


@pytest.mark.parametrize("capacity", [16, 2], ids=["in-ring", "evicted"])
def test_stage_table_percentiles_match_jax(capacity):
    def run(P):
        fr = P.fr.FlightRecorder(capacity=capacity)
        for ms in (10, 20, 30, 40, 50, 7, 90, 15):
            fr.record(pods=1, nodes=1, outcome="scheduled", solver="fast",
                      stages={"solve": ms / 1000, "assume": ms / 4000}, total_s=ms / 1000)
        return fr.stage_table()

    row = parity(run)["solve"]
    assert row["batches"] == 8
    if capacity == 16:
        assert (row["p50_ms"], row["p99_ms"]) == (20.0, 90.0)  # exact nearest-rank
    else:
        assert row["p99_ms"] >= row["p50_ms"]


def _stage_clock(P, ft):
    ft.set(500.0)
    c = P.rec.StageClock()
    c.mark("a")
    c.mark("b")
    c.skip()
    c.mark("c")
    c.add("d", 0.25)
    c.sub("a", 10.0)
    c.sub("b", 0.0005)
    return dict(c.stages), c.total()


def test_stage_clock_marks_match_jax(fake_time):
    stages, total = parity(_stage_clock, fake_time)
    assert set(stages) == {"a", "b", "c", "d"}
    assert stages["a"] == 0.0
    assert sum(v for k, v in stages.items() if k != "d") <= total


def test_nearest_rank_matches_jax():
    vals = sorted([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0])
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert T.rec.nearest_rank(vals, q) == J.rec.nearest_rank(vals, q)


# -- the time series (a shared fake perf_counter on both sides) -----------------


def _ts_quantiles(P):
    ts = P.ts.TimeSeriesRecorder(window_s=10.0)
    for i in range(1, 101):
        ts.note_batch({"solve": i / 1000.0}, pods=1, scheduled=1, now=100.0 + i * 0.01)
    ts.note_batch({}, now=200.0)
    return ts.windows()[0]


def test_windows_settle_nearest_rank_quantiles(fake_time):
    w = parity(_ts_quantiles)
    assert w["batches"] == 100
    assert (w["stages"]["solve"]["p50_ms"], w["stages"]["solve"]["p99_ms"]) == (50.0, 99.0)
    assert w["stages"]["solve"]["total_ms"] == pytest.approx(5050.0, abs=0.5)


def _ts_counts(P):
    ts = P.ts.TimeSeriesRecorder(window_s=2.0)
    ts.note_batch({"solve": 0.001}, pods=100, scheduled=90, failed=10, now=50.0)
    ts.note_batch({"solve": 0.001}, pods=50, scheduled=50, now=51.0)
    ts.note_batch({}, now=53.0)
    return ts.windows()[0]


def test_pods_per_sec_and_counts(fake_time):
    w = parity(_ts_counts)
    assert (w["pods"], w["scheduled"], w["failed"]) == (150, 140, 10)
    assert w["pods_per_sec"] == pytest.approx(70.0, rel=0.01)


def _ts_churn(P, ft):
    ts = P.ts.TimeSeriesRecorder(window_s=1.0, capacity=8)
    for i in range(24):
        ts.note_batch({"solve": 0.001}, pods=1, now=1000.0 + i)
    ts.note_batch({}, now=2000.0)
    ft.set(1500.0)  # the read's clock, inside the open window: no settle
    ws = ts.windows()
    return ws, ts.windows_closed


def test_ring_bounded_under_churn_on_a_fake_counter(fake_time):
    ws, closed = parity(_ts_churn, fake_time)
    assert len(ws) == 8 and closed == 24
    seqs = [w["seq"] for w in ws]
    assert seqs == sorted(seqs) and seqs[-1] == 24


def _ts_idle_gap(P, ft):
    ts = P.ts.TimeSeriesRecorder(window_s=1.0)
    ts.note_batch({"solve": 0.001}, now=10.0)
    ts.note_batch({"solve": 0.001}, now=500.0)
    ft.set(600.0)  # the read closes the open window on the fake counter
    return ts.windows()


def test_idle_gap_emits_no_fabricated_windows_on_a_fake_counter(fake_time):
    ws = parity(_ts_idle_gap, fake_time)
    assert len(ws) == 2 and ws[1]["start_ts"] == 500.0
    assert all(w["batches"] == 1 for w in ws)


def _ts_outside_and_probes(P):
    ts = P.ts.TimeSeriesRecorder(window_s=5.0)
    calls = []
    ts.add_probe("queue", lambda: calls.append(1) or {"depth": len(calls)})
    ts.add_probe("broken", lambda: 1 / 0)
    ts.add_probe("empty", lambda: None)
    ts.note_batch({"solve": 0.002}, pods=1, now=10.0)
    ts.note_stage("bind", 0.004, now=11.0)
    ts.note_stage("bind", 0.008, now=12.0)
    ts.note_batch({"solve": 0.003}, now=16.0)
    ts.note_batch({}, now=30.0)
    return ts.windows(), len(calls), ts.series("stages", "bind", "total_ms")


def test_outside_stages_and_probes(fake_time):
    ws, calls, bind = parity(_ts_outside_and_probes)
    assert calls == len(ws) == 3 and ws[0]["queue"] == {"depth": 1}
    assert all("broken" not in w and "empty" not in w for w in ws)
    assert ws[0]["stages"]["bind"]["batches"] == 2 and ws[0]["batches"] == 1
    assert bind == [(15.0, 12.0)]


def _ts_series_clear_disabled(P):
    ts = P.ts.TimeSeriesRecorder(window_s=1.0)
    val = {"rss_mb": None}
    ts.add_probe("resource", lambda: dict(val) if val["rss_mb"] is not None else None)
    ts.note_batch({"solve": 0.001}, now=10.0)
    val["rss_mb"] = 100.0
    ts.note_batch({"solve": 0.001}, now=11.0)
    val["rss_mb"] = None
    ts.note_batch({"solve": 0.001}, now=12.0)
    ts.note_batch({}, now=100.0)
    pts = ts.series("resource", "rss_mb")
    solve = ts.series("stages", "solve", "p99_ms")
    self_s = ts.self_seconds
    ts.clear()
    off = P.ts.TimeSeriesRecorder(window_s=0.01, enabled=False)
    off.note_batch({"solve": 0.001}, now=10.0)
    off.note_stage("bind", 0.001, now=11.0)
    return (pts, solve, self_s, ts.windows_closed, ts.windows(), off.windows(),
            off.self_seconds)


def test_series_extraction_clear_and_disabled(fake_time):
    pts, solve, self_s, closed, after, off, off_s = parity(_ts_series_clear_disabled)
    assert pts == [(11.0, 100.0)] and len(solve) == 3
    assert self_s > 0 and closed == 0 and after == [] and off == [] and off_s == 0.0


def _ts_sink(P):
    billed = []
    sink = SimpleNamespace(note_self_time=billed.append)
    ts = P.ts.TimeSeriesRecorder(window_s=1.0, stat_sink=sink)
    for i in range(50):
        ts.note_batch({"solve": 0.001}, now=10.0 + i * 0.01)
    return sum(billed), ts.self_seconds


def test_self_time_accrues_and_bills_sink(fake_time):
    billed, self_s = parity(_ts_sink)
    assert self_s > 0 and billed == pytest.approx(self_s)


@pytest.mark.parametrize("series", [
    [(i, 3.0 * i + 7) for i in range(10)],
    [(i, 42.0) for i in range(5)],
    [(0.0, 1.0)], [], [(5.0, 1.0), (5.0, 9.0)],
    [(i, 2.0 * i + (1 if i % 2 else -1)) for i in range(50)],
])
def test_fit_slope_matches_jax(series):
    assert T.ts.fit_slope(series) == J.ts.fit_slope(series)


@pytest.mark.parametrize("values", [
    [5.0] * 9, [float(i) for i in range(1, 10)], [1.0, 2.0], [0.0, 0.0, 0.0],
    [10.0] * 11 + [500.0], [3.0, 1.0, 2.0, 9.0, 8.0, 7.0, 1.0],
])
def test_drift_ratio_matches_jax(values):
    assert T.ts.drift_ratio(values) == J.ts.drift_ratio(values)


def test_extract_series_matches_jax():
    wins = [{"end_ts": 1.0, "a": {"b": 2}}, {"end_ts": 2.0, "a": {}},
            {"end_ts": 3.0, "a": {"b": 4.5}}, {"a": {"b": "x"}}]
    assert T.ts.extract_series(wins, "a", "b") == J.ts.extract_series(wins, "a", "b") \
        == [(1.0, 2.0), (3.0, 4.5)]


# -- the SLO gates ---------------------------------------------------------------


def test_slo_specs_match_jax():
    for name in ("NORTH_STAR_SLO", "CHAOS_SLO", "SOAK_SLO", "CONTROL_PLANE_SLO",
                 "TREND_MIN_WINDOWS", "DRIFT_FLOOR_MS", "DEFAULT_SLO", "KNOWN_SPEC_KEYS"):
        assert getattr(T.slo, name) == getattr(J.slo, name), name


STATS = {"stages": {"solve": {"p99_ms": 100.0}, "bind": {"p99_ms": 50.0}},
         "latency": {"count": 10, "p99_s": 1.5},
         "watch": {"propagation": {"p99_s": 0.02}},
         "reconcile": {"p99_ms": 300.0}}


def _mk_windows(n, rss=None, alloc=None, p99=None, t0=1000.0, dt=5.0):
    out = []
    for i in range(n):
        w = {"end_ts": t0 + i * dt, "stages": {}, "resource": {}}
        if p99 is not None:
            w["stages"]["solve"] = {"p99_ms": p99[i]}
        if rss is not None:
            w["resource"]["rss_mb"] = rss[i]
        if alloc is not None:
            w["resource"]["alloc_blocks"] = alloc[i]
        out.append(w)
    return out


SLO_CASES = {
    "pass_fail_skip": (STATS, {"stage_p99_ms": {"solve": 200.0, "bind": 10.0,
                                                "missing_stage": 5.0},
                               "submit_to_bound_p99_s": 2.0, "solver_compiles": 0}, None),
    "extra_ok": ({}, {"solver_compiles": 0, "instrumentation_frac": 0.02},
                 {"solver_compiles": 0, "instrumentation_frac": 0.004}),
    "extra_fail": ({}, {"solver_compiles": 0, "instrumentation_frac": 0.02},
                   {"solver_compiles": 3, "instrumentation_frac": 0.004}),
    "inclusive": ({"latency": {"p99_s": 2.0}}, {"submit_to_bound_p99_s": 2.0}, None),
    "typo": ({"latency": {"p99_s": 1.0}}, {"submit_to_bound_p99s": 30.0}, None),
    "watch_reconcile": (STATS, {"watch_propagation_p99_s": 0.01, "reconcile_p99_ms": 2000.0},
                        None),
    "north_star": (STATS, "NORTH_STAR_SLO", None),
    "chaos": (STATS, "CHAOS_SLO", None),
    "worst_window": ({"windows": _mk_windows(10, p99=[100.0] * 9 + [9000.0])},
                     {"stage_p99_ms_per_window": {"solve": 5000.0}}, None),
    "rss_flat": ({"windows": _mk_windows(12, rss=[500.0 + (i % 2) * 0.5 for i in range(12)])},
                 {"rss_slope_mb_per_min": 30.0}, None),
    "rss_grow": ({"windows": _mk_windows(12, rss=[500.0 + 10.0 * i for i in range(12)])},
                 {"rss_slope_mb_per_min": 30.0}, None),
    "alloc_grow": ({"windows": _mk_windows(12, alloc=[10**6 + 200_000 * i for i in range(12)])},
                   {"alloc_block_slope_per_s": 10_000.0}, None),
    "short": ({"windows": _mk_windows(3, rss=[500.0] * 3, alloc=[1] * 3, p99=[1e9] * 3)},
              {"rss_slope_mb_per_min": 30.0, "alloc_block_slope_per_s": 1.0,
               "p99_drift_ratio": 2.0}, None),
    "creep": ({"windows": _mk_windows(12, p99=[10.0 * (1.3 ** i) for i in range(12)])},
              {"p99_drift_ratio": 3.0}, None),
    "tiny_creep": ({"windows": _mk_windows(12, p99=[0.01 * (1.3 ** i) for i in range(12)])},
                   {"p99_drift_ratio": 3.0}, None),
    "soak": ({"windows": _mk_windows(12, rss=[1.0] * 12, alloc=[1] * 12, p99=[1.0] * 12)},
             "SOAK_SLO", None),
    "no_windows": ({}, {"rss_slope_mb_per_min": 30.0, "p99_drift_ratio": 2.0,
                        "stage_p99_ms_per_window": {"solve": 1.0}}, None),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_evaluate_slo_matches_jax(case):
    stats, spec, extra = SLO_CASES[case]

    def run(P):
        sp = getattr(P.slo, spec) if isinstance(spec, str) else spec
        return P.slo.evaluate_slo(stats, sp, extra)

    res = parity(run)
    expect = {"pass_fail_skip": ["stage_p99_ms:bind"], "extra_fail": ["solver_compiles"],
              "typo": ["unknown_spec_key:submit_to_bound_p99s"],
              "worst_window": ["stage_p99_ms_per_window:solve"],
              "rss_grow": ["rss_slope_mb_per_min"], "alloc_grow": ["alloc_block_slope_per_s"],
              "creep": ["p99_drift_ratio"], "watch_reconcile": ["watch_propagation_p99_s"]}
    assert res["failed"] == expect.get(case, [])
    if case == "rss_grow":
        assert res["checks"][0]["actual"] == pytest.approx(120.0, rel=0.05)
    if case in ("short", "no_windows"):
        assert len(res["skipped"]) == 3 and res["pass"] is True


def test_load_slo_spec_roundtrip(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text(json.dumps(T.slo.NORTH_STAR_SLO))
    assert T.slo.load_slo_spec(str(p)) == J.slo.load_slo_spec(str(p)) == J.slo.NORTH_STAR_SLO


# -- the critical path -------------------------------------------------------------


def _span(i, window=0, **stamps_ms):
    return {"pod": f"ns/p-{i}", "window": window, "pops": 1, "complete": True, "t0": 100.0,
            "stamps_ms": dict(stamps_ms, enqueue=0.0),
            "submit_to_bound_ms": stamps_ms.get("bind_confirmed"),
            "submit_to_running_ms": None}


CRIT_SPANS = ([_span(i, window=0, pop=50.0 + i, solve=55.0 + i, assume=56.0 + i,
                     dispatch=56.5 + i, bind_commit=58.0 + i, bind_confirmed=60.0 + i,
                     watch_delivered=61.0 + i) for i in range(10)]
              + [_span(10 + i, window=1, pop=1.0, solve=40.0 + i, bind_confirmed=42.0 + 2 * i)
                 for i in range(10)]
              + [{"pod": "ns/unbound", "window": 1, "stamps_ms": {"enqueue": 0.0},
                  "submit_to_bound_ms": None}])
TABLE = {"tensorize": {"total_ms": 10.0}, "build_pod_batch": {"total_ms": 30.0},
         "solve": {"total_ms": 60.0}}


def test_critpath_matches_jax():
    assert T.cp.COMPONENTS == J.cp.COMPONENTS
    assert T.cp.build_ratio(TABLE) == J.cp.build_ratio(TABLE) == pytest.approx(0.4)
    assert T.cp.build_ratio(None) == J.cp.build_ratio(None)
    for sp in CRIT_SPANS:
        assert T.cp.decompose(sp, 0.4) == J.cp.decompose(sp, 0.4)
    got = T.cp.decompose(CRIT_SPANS[0], 0.4)
    core = {k: v for k, v in got.items() if k != "watch"}
    assert sum(core.values()) == pytest.approx(60.0, abs=1e-9)
    assert T.cp.decompose(CRIT_SPANS[-1], 0.0) is None


@pytest.mark.parametrize("table", [None, TABLE], ids=["no-table", "table"])
def test_critpath_analyze_matches_jax(table):
    out = parity(lambda P: P.cp.analyze(CRIT_SPANS, stage_table=table))
    assert out["spans_analyzed"] == 20
    assert out["windows"][0]["dominant"] == "queue_wait"
    assert out["windows"][1]["dominant"] in ("solve", "build")
    for roll in out["windows"].values():
        assert roll["sum_mean_ms"] == pytest.approx(roll["total_mean_ms"], rel=1e-9)
    assert parity(lambda P: P.cp.analyze([])) is not None


# -- the trace ring and its export (a shared fake perf_counter) -------------------


def _tb_churn(P):
    buf = P.tb.TraceBuffer(capacity=100)
    for i in range(300):
        buf.instant("churn", f"e{i}")
    doc = buf.export()
    return buf.status(), doc, P.tb.validate_export(doc)


def test_trace_ring_bounded_under_churn(fake_time):
    st, doc, res = parity(_tb_churn)
    assert st["trace_events_total"] == 300 and st["trace_events_dropped_total"] == 200
    body = [ev for ev in doc["traceEvents"] if ev["ph"] != "M"]
    assert len(body) == 100 and body[-1]["name"] == "e299" and res["valid"]


def _tb_arm(P):
    out = [P.tb.enabled(), P.tb.status()]
    buf = P.tb.arm(capacity=16)
    buf.instant("t", "x")
    out += [P.tb.enabled(), P.tb.ACTIVE is buf, P.tb.status()["trace_events_total"]]
    got = P.tb.disarm()
    out += [got is buf, P.tb.enabled(), P.tb.current() is buf,
            _strip(P.tb.status(), ("self_seconds",))]
    return out


def test_arm_disarm_and_status():
    out = parity(_tb_arm)
    assert out[0] is False and out[2] is True and out[4] == 1


def test_disabled_check_cost_is_measured():
    assert 0.0 < T.tb.disabled_check_cost_ns(n=20_000, passes=3) < 10_000


def _tb_events(P, ft):
    buf = P.tb.TraceBuffer(capacity=1000)
    t = ft.perf_counter()
    for i, state in enumerate((None, "open", "open", None)):
        buf.note_batch("sched", t_end=t + i, pods=50, scheduled=50 - i, outcome="scheduled",
                       solver="fast", breaker=state,
                       stages={"ingest": 0.001, "solve": 0.040, "assume": 0.002,
                               "dispatch": 0.0005, "reject": 0.0})
    buf.instant("chaos", "fault:x", args={"site": "solver.solve"})
    buf.counter("resource", "memory", {"rss_mb": 10.0})
    buf.note_span("bind", "bind_chunk", t, t + 0.001, cat="bind", args={"pods": 4})
    doc = buf.export()
    return doc, P.tb.validate_export(doc), list(buf._ring)


def test_batch_envelopes_breaker_instants_and_export(fake_time):
    doc, res, events = parity(_tb_events, fake_time)
    assert res["valid"] and res["instants"] == 3 and res["counters"] == 1
    assert res["tracks"] == 4
    slices = [ev for ev in doc["traceEvents"] if ev["ph"] == "X" and ev["cat"] == "stage"]
    assert {ev["name"] for ev in slices} == {"ingest", "solve", "assume", "dispatch"}
    names = [ev["name"] for ev in doc["traceEvents"] if ev.get("cat") == "breaker"]
    assert names == ["breaker:closed->open", "breaker:open->closed"]
    for ev in doc["traceEvents"]:
        for field in ("name", "ph", "ts", "pid", "tid"):
            assert field in ev
    assert len(events) == len(doc["traceEvents"]) - 9  # 1 process + 2 a track


BAD_DOCS = [
    {"traceEvents": [{"name": "b", "ph": "B", "ts": 2.0, "pid": 1, "tid": 1},
                     {"name": "i", "ph": "i", "ts": 1.0, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "X"}]}, {},
    {"traceEvents": [{"name": "e", "ph": "E", "ts": 1.0, "pid": 1, "tid": 1},
                     {"name": "x", "ph": "X", "ts": 2.0, "pid": 1, "tid": 1},
                     {"name": "s", "ph": "s", "id": 3, "ts": 2.0, "pid": 1, "tid": 1},
                     {"name": "f", "ph": "f", "id": 4, "ts": 2.0, "pid": 1, "tid": 1}]},
]


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_validate_export_verdicts_match_jax(i):
    res = parity(lambda P: P.tb.validate_export(BAD_DOCS[i]))
    assert res["valid"] is False


def _tb_flows(P, ft):
    clock = P.utils.FakeClock(50.0)
    buf = P.tb.TraceBuffer(capacity=100)
    buf.attach_clock(clock)
    buf.attach_clock(P.utils.FakeClock(99.0))  # later calls are no-ops
    spans = [{"pod": "ns/old", "t0": 50.0, "stamps_ms": {"enqueue": 0.0, "pop": 3.0},
              "submit_to_bound_ms": None, "replaced_by": "ns/new"},
             {"pod": "ns/new", "t0": 51.0, "stamps_ms": {"enqueue": 0.0},
              "submit_to_bound_ms": 4.0, "replaces": "ns/old"},
             {"pod": "ns/orphan", "t0": 52.0, "stamps_ms": {"enqueue": 0.0},
              "submit_to_bound_ms": None, "replaces": "ns/gone"}]
    buf.instant("sched", "x")
    doc = buf.export(spans=spans)
    return doc, P.tb.validate_export(doc)


def test_evict_replace_flow_arrows_match_jax(fake_time):
    doc, res = parity(_tb_flows, fake_time)
    assert res["valid"] and res["flow_pairs"] == 2
    assert all(ev["name"] == "replace" for ev in doc["traceEvents"] if ev["ph"] in ("s", "f"))


# -- the pod tracer (FakeClock, fixed rng_seed) ------------------------------------


def _fake_qps(n, ts=100.0, prefix="s", owner=None):
    return [SimpleNamespace(timestamp=ts, submit_ts=ts, trace_span=None,
                            pod=SimpleNamespace(key=f"default/{prefix}-{i}",
                                                metadata=SimpleNamespace(
                                                    owner_references=list(owner or ()))))
            for i in range(n)]


def _snap(tr):
    s = tr.snapshot()
    s.pop("flush_seconds")
    return s


def test_span_stages_match_jax():
    assert T.pt.SPAN_STAGES == J.pt.SPAN_STAGES
    for name in ("DEFAULT_SAMPLE_K", "DEFAULT_WINDOW_S", "SPAN_RING", "LIVE_CAP_FACTOR",
                 "EVICTED_LINK_CAP", "PENDING_OPS_CAP"):
        assert getattr(T.pt.PodTracer, name) == getattr(J.pt.PodTracer, name)


@pytest.mark.parametrize("seed", range(4))
def test_reservoir_sample_matches_jax(seed):
    def run(P):
        clock = P.utils.FakeClock(0.0)
        tr = P.pt.PodTracer(clock=clock, sample_k=8, window_s=30.0, rng_seed=seed)
        out = []
        for w in range(5):
            tr.admitted(_fake_qps(40 + 37 * w, ts=clock.now(), prefix=f"w{w}"))
            out.append(sorted(tr._sampled))
            clock.step(11.0)  # rotates the window every third wave
        return out, tr.windows_rotated, tr.evicted_incomplete, len(tr._live)

    out, rotated, evicted, live = parity(run)
    assert all(len(s) <= 8 * T.pt.PodTracer.LIVE_CAP_FACTOR for s in out)
    assert rotated == 1


def _lifecycle(P):
    clock = P.utils.FakeClock(10.0)
    tr = P.pt.PodTracer(clock=clock, sample_k=64, rng_seed=0)
    qps = _fake_qps(10, ts=10.0)
    tr.admitted(qps)
    clock.step(0.5)
    tr.batch_popped(qps)
    for stage in ("solve", "assume", "dispatch"):
        clock.step(0.5)
        tr.batch_stage(stage)
    clock.step(0.5)
    t_commit = clock.now()
    clock.step(0.5)
    bad = qps[0].pod.key
    tr.chunk_bound([(qp, "node-0", None) for qp in qps], t_commit, clock.now(),
                   errkeys=frozenset([bad]))
    mid = (tr.completed_total, tr.live_incomplete)
    tr.batch_popped([qps[0]])  # the failed pod's retry pops again
    clock.step(4.0)
    tr.chunk_bound([(qps[0], "n", None)], clock.now(), clock.now())
    return mid, _snap(tr), tr.latency_stats()


def test_lifecycle_spans_and_failed_chunk_match_jax():
    mid, snap, lat = parity(_lifecycle)
    assert mid == (9, 1)
    sched_stages = T.pt.SPAN_STAGES[:T.pt.SPAN_STAGES.index("watch_delivered")]
    assert snap["completed"] == 10 and snap["live_incomplete"] == 0
    for sp in snap["spans"]:
        assert sp["complete"] and list(sp["stamps_ms"]) == list(sched_stages)
        assert sp["submit_to_bound_ms"] == sp["stamps_ms"]["bind_confirmed"]
    assert max(sp["pops"] for sp in snap["spans"]) == 2
    assert lat["count"] == 10


def _serial_and_zombies(P):
    clock = P.utils.FakeClock(10.0)
    tr = P.pt.PodTracer(clock=clock, sample_k=4, rng_seed=1)
    qps = _fake_qps(4, ts=10.0)
    tr.admitted(qps)
    tr.batch_popped(qps)
    clock.step(1.0)
    for qp in qps:
        tr.pod_bound(qp, clock.now())
    tr.admitted(_fake_qps(500, ts=clock.now(), prefix="b"))
    bound = {qp.pod.key for qp in qps}
    return _snap(tr), sorted(set(tr._live) & bound)


def test_serial_bind_and_no_zombie_spans_match_jax():
    snap, zombies = parity(_serial_and_zombies)
    assert zombies == []
    done = [sp for sp in snap["spans"] if sp["complete"]]
    assert len(done) == 4 and all(sp["pops"] == 1 and "pop" in sp["stamps_ms"] for sp in done)


def _known_latency(P):
    tr = P.pt.PodTracer(clock=P.utils.FakeClock(0.0), sample_k=1, rng_seed=0)
    qps = _fake_qps(100, ts=0.0)
    for qp in qps:
        qp.timestamp = qp.submit_ts = 0.0
    tr.admitted(qps)
    tr.batch_popped(qps)
    tr.chunk_bound([(qp, "n", None) for qp in qps[:90]], 0.1, 0.1)
    tr.chunk_bound([(qp, "n", None) for qp in qps[90:]], 9.0, 9.0)
    return tr.latency_stats()


def test_latency_stats_on_known_distribution_match_jax():
    stats = parity(_known_latency)
    assert stats["count"] == 100 and stats["p50_s"] <= 0.25 and stats["p99_s"] >= 5.0


def _self_time(P):
    calls = []
    sink = SimpleNamespace(note_self_time=calls.append)
    tr = P.pt.PodTracer(sample_k=8, rng_seed=0, stat_sink=sink,
                        clock=P.utils.FakeClock(0.0))
    qps = _fake_qps(2000)
    tr.admitted(qps)
    n_admit = len(calls)
    tr.batch_popped(qps)
    tr.batch_stage("solve")
    pending = len(tr._ops)
    for lo in range(0, 2000, 25):  # 80 chunk ops > PENDING_OPS_CAP
        tr.chunk_bound([(qp, "n", None) for qp in qps[lo:lo + 25]], 1.0, 1.0)
    capped = len(tr._ops) <= tr.PENDING_OPS_CAP + 1
    return n_admit, pending, capped, len(calls) > n_admit, tr.latency_stats()["count"]


def test_taps_are_o1_and_the_pending_cap_flushes_inline():
    assert parity(_self_time) == (1, 2, True, True, 2000)


def _evict_replace(P):
    clock = P.utils.FakeClock(0.0)
    tr = P.pt.PodTracer(clock=clock, sample_k=64, rng_seed=0)
    owner = [{"kind": "ReplicaSet", "name": "rs", "uid": ""}]
    old = _fake_qps(3, ts=0.0, prefix="old", owner=owner)
    tr.admitted(old)
    tr.batch_popped(old)
    clock.step(1.0)
    tr.chunk_bound([(qp, "n", None) for qp in old[:2]], clock.now(), clock.now())
    for qp in old[:3]:  # two bound, one still live
        tr.note_deleted(qp.pod)
    clock.step(1.0)
    new = _fake_qps(2, ts=clock.now(), prefix="new", owner=owner)
    tr.admitted(new)
    tr.note_deleted(SimpleNamespace(key="default/unsampled", metadata=None))
    P.pt.note_pod_event("default/old-0", "watch_delivered")
    return _snap(tr)


def test_evict_replace_links_match_jax():
    snap = parity(_evict_replace)
    links = {sp["pod"]: sp.get("replaces") for sp in snap["spans"] if sp.get("replaces")}
    assert links == {"default/new-0": "default/old-0", "default/new-1": "default/old-1"}
    assert sum(1 for sp in snap["spans"] if sp.get("deleted")) == 3


def _post_edges_and_drop(P):
    clock = P.utils.FakeClock(0.0)
    tr = P.pt.PodTracer(clock=clock, sample_k=8, rng_seed=0)
    qps = _fake_qps(6, ts=0.0)
    tr.admitted(qps)
    tr.batch_popped(qps)
    clock.step(1.0)
    tr.chunk_bound([(qp, "n", None) for qp in qps[:3]], clock.now(), clock.now())
    for stage in ("watch_delivered", "kubelet_observed", "running"):
        clock.step(0.25)
        P.pt.note_pod_event("default/s-0", stage)
    tr.drop_live()
    snap = _snap(tr)
    tr.clear()
    return snap, tr.evicted_incomplete, _snap(tr)


def test_post_edges_drop_live_and_clear_match_jax():
    snap, evicted, cleared = parity(_post_edges_and_drop)
    s0 = next(sp for sp in snap["spans"] if sp["pod"] == "default/s-0")
    assert s0["submit_to_running_ms"] == 1750.0
    assert snap["evicted_incomplete"] == 3 and snap["live_incomplete"] == 0
    assert cleared["spans"] == [] and evicted == 0


def test_disabled_tracer_is_inert():
    def run(P):
        tr = P.pt.PodTracer(enabled=False, clock=P.utils.FakeClock(0.0))
        qps = _fake_qps(10)
        tr.admitted(qps)
        tr.batch_popped(qps)
        tr.batch_stage("solve")
        tr.chunk_bound([(qp, "n", None) for qp in qps], 1.0, 1.0)
        tr.pod_bound(qps[0], 1.0)
        return _snap(tr)

    snap = parity(run)
    assert snap["spans"] == [] and snap["latency"]["count"] == 0


# -- histogram quantile math -----------------------------------------------------


def test_histogram_quantiles_match_jax():
    def run(P):
        h = P.m.Histogram("t", buckets=(0.25, 0.5, 1.0))
        out = [h.quantile(0.5)]
        h.observe_many([i / 1000 for i in range(1000)])
        out += [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        h2 = P.m.Histogram("t2", buckets=(1.0, 2.0))
        h2.observe(50.0)
        out.append(h2.quantile(0.99))
        counts, total, n = h.bucket_counts([0.1, 0.3, 0.6, 2.0])
        h.observe_counts(counts, total, n)
        out.append(h.snapshot())
        return out

    out = parity(run)
    assert out[0] is None and 0.25 <= out[2] <= 0.55 and out[6] == 2.0


# -- queue telemetry -------------------------------------------------------------


def _queue_tel(P):
    clock = P.utils.FakeClock(100.0)
    q = P.q.SchedulingQueue(clock=clock)
    q.add_batch([P.testing.MakePod(f"qa-{i}").obj() for i in range(3)])
    clock.step(5.0)
    q.add_batch([P.testing.MakePod(f"qb-{i}").obj() for i in range(2)])
    out = [q.telemetry(), q.depths()]
    qp = q.pop(timeout=0.0)
    clock.step(3.0)
    q.add_unschedulable(qp)
    out += [q.telemetry(), q.depths(), (qp.submit_ts, qp.timestamp, qp.trace_span)]
    empty = P.q.SchedulingQueue(clock=P.utils.FakeClock(50.0))
    out.append(empty.telemetry())
    return out


def test_queue_telemetry_matches_jax():
    out = parity(_queue_tel)
    assert out[0]["oldest_pending_age_s"] == pytest.approx(5.0)
    assert out[2]["unschedulable"] == 1
    assert out[2]["oldest_pending_age_s"] == pytest.approx(8.0)
    assert out[4] == (100.0, 108.0, None)
    assert out[5]["oldest_pending_age_s"] == 0.0


def _queue_sinks(P):
    calls = []
    fr = P.fr.FlightRecorder()
    sink = SimpleNamespace(admitted=lambda qps: calls.append([qp.key for qp in qps]))
    q = P.q.SchedulingQueue(clock=P.utils.FakeClock(0.0))
    q.stat_sink = fr
    q.trace_sink = sink
    q.add_batch([P.testing.MakePod(f"p-{i}").obj() for i in range(3)])
    q.add(P.testing.MakePod("single").obj())
    q.add_batch([P.testing.MakePod("p-0").obj()])  # already active: not admitted
    return calls, set(fr.stage_table()), fr.stage_table()["queue_add"]["batches"]


def test_queue_sinks_match_jax():
    calls, stages, n = parity(_queue_sinks)
    assert calls == [["default/p-0", "default/p-1", "default/p-2"], ["default/single"]]
    assert stages == {"queue_add"} and n == 0


# -- the reconcile recorder (a stand-in controller) ------------------------------


class _Controller:
    def __init__(self, P, name, depth):
        self.rec = P.rc.ReconcileRecorder(name)
        self._depth = depth

    def reconcile_stats(self):
        return self.rec.snapshot()

    def workqueue_depth(self):
        return self._depth


def _reconcile(P, tag):
    a = _Controller(P, f"{tag}-a", 3)
    b = _Controller(P, f"{tag}-b", 7)
    for rec, times in ((a.rec, (0.002, 0.004, 0.001)), (b.rec, (0.03, 0.01))):
        for i, s in enumerate(times):
            rec.pump(events=2, seconds=s / 10)
            rec.loop(keys=i + 1, errors=i % 2, requeues=1, seconds=s, depth=i)
    a.rec.loop(keys=0, errors=0, requeues=0, seconds=1.0, depth=0)  # empty drain: no record
    P.rc.register_controller(f"{tag}-a", a)
    P.rc.register_controller(f"{tag}-b", b)
    snap = {k: v for k, v in P.rc.controlstats_snapshot().items() if k.startswith(tag)}
    for st in snap.values():
        st["last"] = _strip(st["last"])
        st.pop("self_seconds")
    roll = P.rc.reconcile_rollup(snap)
    depths = sorted((lbl["controller"], v) for lbl, v in P.rc.workqueue_depth_samples()
                    if lbl["controller"].startswith(tag))
    return snap, roll, depths, (a, b)


def test_reconcile_recorder_matches_jax():
    got, want = _reconcile(T, "ctl"), _reconcile(J, "ctl")
    assert got[:3] == want[:3]
    snap, roll, depths, _keep = got
    assert roll["worst_controller"] == "ctl-b" and roll["loops"] == 5 and roll["errors"] == 2
    assert depths == [("ctl-a", 3.0), ("ctl-b", 7.0)]
    assert snap["ctl-a"]["keys"] == 6 and snap["ctl-a"]["events"] == 6


def test_reconcile_metrics_count_like_jax():
    def run(P):
        m = P.m
        b0 = m.controller_sync_errors.value(controller="rc-metric")
        n0 = m.controller_reconcile_duration.child("rc-metric").snapshot()[1]
        rec = P.rc.ReconcileRecorder("rc-metric")
        rec.loop(keys=3, errors=2, requeues=2, seconds=0.01, depth=1)
        rec.loop(keys=1, errors=0, requeues=0, seconds=0.02, depth=0)
        return (m.controller_sync_errors.value(controller="rc-metric") - b0,
                m.controller_reconcile_duration.child("rc-metric").snapshot()[1] - n0)

    assert parity(run) == (2.0, 2)


# -- the resource sampler --------------------------------------------------------


def _sampler(P):
    s = P.rs.ResourceSampler(interval_s=0.05, capacity=4)
    done = threading.Event()
    worker = threading.Thread(target=done.wait, daemon=True)
    worker.start()
    s.register_thread("worker", worker)
    recs = [s.sample_once() for _ in range(6)]
    summary = s.summary()
    done.set()
    worker.join()
    dead = s.sample_once()  # a dead thread's column goes quiet, not fatal
    kept = len(s.samples())
    s.reset()
    return (sorted(recs[0]), sorted(recs[0]["gc"]), sorted(summary), kept, len(s.samples()),
            recs[-1]["rss_mb"] > 0, recs[-1]["alloc_blocks"] > 0,
            "worker" in recs[0]["threads"], sorted(dead))


def test_resource_sampler_columns_match_jax():
    got = parity(_sampler)
    assert got[3:8] == (4, 0, True, True, True)


def _gc_pauses(P):
    import gc

    s = P.rs.ResourceSampler(interval_s=1.0)
    s._install_gc_cb()
    try:
        gc.collect()
        gc.collect()
        rec = s.sample_once()
    finally:
        s._remove_gc_cb()
    return rec["gc"]["collections"] >= 2, rec["gc"]["pause_s"] >= 0.0


def test_gc_pause_accounting_matches_jax():
    assert parity(_gc_pauses) == (True, True)


def test_thread_clock_probe_and_bad_source_match_jax():
    assert sorted(T.rs.probe_thread_clock()) == sorted(J.rs.probe_thread_clock())
    assert T.rs.read_thread_cpu_s(1, "bogus") is None is J.rs.read_thread_cpu_s(1, "bogus")


def test_sampler_thread_starts_and_stops():
    s = T.rs.ResourceSampler(interval_s=0.02)
    s.start()
    deadline = time.monotonic() + 10.0
    while s.samples_taken < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    s.stop()
    assert s.samples_taken >= 1 and s._thread is None and s in T.rs.live_samplers()


# -- the slow-trace log and configz ------------------------------------------------


def _trace_log(P, ft):
    stream = io.StringIO()
    log = P.tr.StructuredLogger("sched", stream=stream, level="info")
    quick = P.tr.Trace("Quick", logger=log)
    quick.step("a")
    out = [quick.log_if_long(10.0)]
    ft.step = 0.05
    slow = P.tr.Trace("Scheduling", logger=log, pod="default/p")
    slow.step("Snapshotting scheduler cache done")
    slow.step("Computing predicates done", evaluated=3, feasible=2)
    out.append(slow.log_if_long(0.1))
    ft.step = 0.001
    log.debug("hidden")
    log.warning("shown", n=1)
    P.tr.register_config("torch-parity", {"profiles": 1})
    out.append(P.tr.configz_snapshot()["torch-parity"])
    return out, [json.loads(line) for line in stream.getvalue().splitlines()]


def test_trace_log_and_logger_match_jax(fake_time):
    out, lines = parity(_trace_log, fake_time)
    assert out[:2] == [False, True] and out[2] == {"profiles": 1}
    assert [ln["msg"] for ln in lines] == ["Trace 'Scheduling' exceeded threshold", "shown"]
    assert lines[0]["pod"] == "default/p" and len(lines[0]["steps"]) == 2


def _slow_trace_on_ring(P, ft):
    buf = P.tb.arm(capacity=100)
    tr = P.tr.Trace("SlowPath", pods=3, logger=P.tr.StructuredLogger("x", stream=io.StringIO()))
    tr.step("first")
    tr.step("second", n=2)
    tr.log_if_long(0.0)
    P.tb.disarm()
    return [(ev["name"], ev.get("args")) for ev in buf._ring]


def test_log_if_long_lands_on_the_armed_ring(fake_time):
    assert parity(_slow_trace_on_ring, fake_time) == [("SlowPath:first", None),
                                                      ("SlowPath:second", {"n": 2})]


# -- the cache debugger ------------------------------------------------------------


def _debugger(P):
    from kubernetes_tpu.scheduler import Framework as JFramework
    from kubernetes_tpu.scheduler.plugins import default_plugins as jplugins

    serial = importlib.import_module(
        ("kubernetes_tpu_torch" if P.port else "kubernetes_tpu") + ".scheduler.serial")
    store = P.store.APIStore()
    store.create("nodes", P.testing.MakeNode("n1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    store.create("pods", P.testing.MakePod("p").req({"cpu": "1"}).obj())
    if P.port:
        from kubernetes_tpu_torch.scheduler.plugins import default_plugins
        from kubernetes_tpu_torch.scheduler.runtime import Framework

        fw = Framework(default_plugins())
    else:
        fw = JFramework(jplugins())
    sched = serial.Scheduler(store, fw, clock=P.utils.FakeClock())
    sched.sync()
    sched.schedule_one()
    sched.pump_events()
    dump, ok = P.dbg.dump(sched), P.dbg.compare(sched)
    store.create("pods", P.testing.MakePod("ghost").node("n1").obj())
    return dump, ok, P.dbg.compare(sched)


def test_cache_debugger_matches_jax():
    dump, ok, problems = parity(_debugger)
    assert dump["nodes"]["n1"]["pods"] == ["default/p"]
    assert dump["nodes"]["n1"]["requested"]["milliCPU"] == 1000
    assert ok == [] and any("ghost" in p and "missing from cache" in p for p in problems)


# -- the metric series ---------------------------------------------------------------


SERIES = ["scheduling_attempts", "scheduling_attempt_duration", "pending_pods",
          "batch_solve_duration", "batch_size_gauge", "batch_stage_duration",
          "solver_breaker_state", "batch_retries_total", "queue_depth", "queue_oldest_age",
          "pod_e2e_latency", "store_bind_many_duration", "store_watch_dropped",
          "store_watch_propagation", "store_watch_queue_length", "store_watch_rv_lag",
          "controller_reconcile_duration", "controller_sync_errors",
          "controller_workqueue_depth", "process_rss_mb", "process_alloc_blocks",
          "scheduler_thread_cpu", "constraint_repair_rounds", "constraint_violations_total",
          "gang_staged", "gang_vetoed_total", "gang_orphan_released_total",
          "gang_preempted_total", "gang_quorum_expired_assumes"]


@pytest.mark.parametrize("name", SERIES)
def test_metric_series_match_jax(name):
    t, j = getattr(T.m, name), getattr(J.m, name)
    assert type(t).__name__ == type(j).__name__
    assert t.name == j.name
    for attr in ("buckets", "label"):
        assert getattr(t, attr, None) == getattr(j, attr, None)


def test_bucket_layouts_match_jax():
    assert T.m.E2E_LATENCY_BUCKETS == J.m.E2E_LATENCY_BUCKETS
    assert T.m.STAGE_BUCKETS == J.m.STAGE_BUCKETS
    assert T.m.PROPAGATION_BUCKETS == J.m.PROPAGATION_BUCKETS


def test_label_escaping_matches_jax():
    def run(P):
        c = P.m.Counter("test_escape_total", "h")
        c.inc(pod='we"ird\\name\nx')
        h = P.m.LabeledHistogram("test_hist_seconds", "h", label="stage", buckets=(1,))
        h.observe(0.5, 'a"b\\c')
        reg = P.m.Registry()
        reg.counter("a_total").inc(x="1")
        reg.gauge("b").set(2.0)
        return c.render(), h.render(), reg.render()

    c, h, text = parity(run)
    assert c[-1] == 'test_escape_total{pod="we\\"ird\\\\name\\nx"} 1.0'
    assert 'a_total{x="1"} 1.0' in text


def _slow_cycle(P, monkeypatch):
    """schedule_pod past the 100 ms threshold logs one Trace record (the
    perf_counter of utils/tracing.py stepped by a fake sequence)."""
    store = P.store.APIStore()
    store.create("nodes", P.testing.MakeNode("n1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    if P.port:
        from kubernetes_tpu_torch.scheduler.plugins import default_plugins
        from kubernetes_tpu_torch.scheduler.runtime import Framework
        from kubernetes_tpu_torch.scheduler.serial import Scheduler
    else:
        from kubernetes_tpu.scheduler import Framework
        from kubernetes_tpu.scheduler.plugins import default_plugins
        from kubernetes_tpu.scheduler.serial import Scheduler
    sched = Scheduler(store, Framework(default_plugins()), clock=P.utils.FakeClock())
    sched.sync()
    stream = io.StringIO()
    monkeypatch.setattr(P.tr, "default_logger", P.tr.StructuredLogger("sched", stream=stream))
    ticks = iter([0.0, 0.0, 0.2, 0.25, 0.3, 0.35, 0.4])
    monkeypatch.setattr(P.tr, "time", SimpleNamespace(perf_counter=lambda: next(ticks, 1.0),
                                                      time=lambda: 1.7e9))
    result = sched.schedule_pod(P.testing.MakePod("slow").req({"cpu": "1"}).obj())
    record = json.loads(stream.getvalue().splitlines()[0])
    return result.suggested_host, {k: v for k, v in record.items() if k != "ts"}


def test_slow_cycle_traced_like_jax(monkeypatch):
    host, record = parity(_slow_cycle, monkeypatch)
    assert host == "n1" and record["msg"] == "Trace 'Scheduling' exceeded threshold"
    assert record["pod"] == "default/slow"
    assert [s["msg"] for s in record["steps"]] == ["Snapshotting scheduler cache done",
                                                  "Computing predicates done",
                                                  "Prioritizing done"]
