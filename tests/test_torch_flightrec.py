"""The port's BatchScheduler with its observability wired in, against the
JAX package over identical stores: the flight records (every count field,
the reasons, the gang and repair dicts, the breaker and the error), the
metric increments by label (batch_retries_total at solve, dispatch, bind and
worker; gang vetoes and covers; the stage and outcome histograms), the
sampled pod spans under a FakeClock, the SchedulerError Warning event, the
sched_stats() keys and counts, the critical path over the live spans and the
armed trace export's verdict. Then the recorder on against off: in every
solver mode the port gives the same map, pod RVs and events.

Both sides run pipeline_binds=False where RVs or spans are compared (the
worker's pace would interleave writes), and fewer pods than the tracer's
sample_k, so every pod is sampled on both sides (BatchScheduler builds its
PodTracer with no seed). Stage seconds are compared as keys, never as
values.
"""

import collections

import pytest
from test_torch_commit_pipeline import _batch, _chaos, _pods
from test_torch_fallback import JAX_API, KINDS
from test_torch_gang import Env, Framework, JBatch, TBatch, default_plugins

import kubernetes_tpu.chaos.faultinject as jfi
import kubernetes_tpu.obs.critpath as jcp
import kubernetes_tpu.obs.tracebuf as jtb
import kubernetes_tpu.server.metrics as jm
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.obs.critpath as tcp
import kubernetes_tpu_torch.obs.tracebuf as ttb
import kubernetes_tpu_torch.server.metrics as tm
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.utils.featuregate import feature_gates as jgates
from kubernetes_tpu_torch.scheduler import flightrec as tfr
from kubernetes_tpu_torch.utils.featuregate import feature_gates as tgates

COUNT_FIELDS = ("pods", "nodes", "outcome", "solver", "scheduled", "unschedulable",
                "fallback", "preempted", "reasons", "gang", "repair", "solver_iterations",
                "breaker", "error", "bind_failures")


@pytest.fixture(autouse=True)
def _always_disarm():
    for mod in (jfi, tfi, jtb, ttb):
        mod.disarm()
    yield
    for mod in (jfi, tfi, jtb, ttb):
        mod.disarm()


def make(env, batch_size=1024, **kw):
    """The scheduler of one package over env's store, with the keyword
    arguments passed to both sides as given (pipeline_binds=False unless
    set)."""
    kw.setdefault("pipeline_binds", False)
    if env.port:
        env.sched = TBatch(env.store, device="cpu", batch_size=batch_size, solver=env.solver,
                           clock=env.clock, **kw)
    else:
        env.sched = JBatch(env.store, Framework(default_plugins()), batch_size=batch_size,
                           solver=env.solver, clock=env.clock, **kw)
    env.sched.sync()
    return env.sched


def env_for(port, solver="exact", n_nodes=4, cpu="8", clock=False, **kw):
    env = Env(port, solver, clock=clock)
    env.nodes(n_nodes, cpu=cpu)
    make(env, **kw)
    return env


def records(env):
    """The flight records' count fields, and each record's stage KEYS."""
    return [({k: r[k] for k in COUNT_FIELDS}, sorted(r["stages"]))
            for r in env.sched.flightrec.records()]


def state(env):
    pods = sorted((p.metadata.name, p.spec.node_name, p.metadata.resource_version)
                  for p in env.store.list("pods")[0])
    events = sorted((e.reason, e.type, e.involved_name, e.message, e.count)
                    for e in env.store.list("events")[0])
    return pods, events


def both(fn, *args, **kw):
    got, want = fn(True, *args, **kw), fn(False, *args, **kw)
    assert got == want
    return got


def series_state(m):
    """Every scheduler series' state: label -> value for counters and
    gauges, label -> observation count for histograms."""
    out = {}
    for name in ("scheduling_attempts", "batch_retries_total", "gang_vetoed_total",
                 "gang_preempted_total", "gang_orphan_released_total",
                 "constraint_violations_total", "batch_size_gauge", "solver_breaker_state",
                 "gang_staged", "queue_depth", "pending_pods", "gang_quorum_expired_assumes"):
        s = getattr(m, name)
        with s._lock:
            out[name] = dict(s._values)
    for name in ("batch_solve_duration", "batch_stage_duration"):
        out[name] = {k: v[1] for k, v in getattr(m, name).snapshot().items()}
    for name in ("constraint_repair_rounds", "pod_e2e_latency", "scheduling_attempt_duration"):
        out[name] = getattr(m, name).snapshot()[1]
    return out


def delta(before, after):
    out = {}
    for name, now in after.items():
        was = before[name]
        if isinstance(now, dict):
            d = {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}
        else:
            d = now - was
        if d:
            out[name] = d
    return out


GAUGES = ("batch_size_gauge", "solver_breaker_state", "gang_staged", "queue_depth",
          "pending_pods", "gang_quorum_expired_assumes")


def counted_increments(port, drive):
    m = tm if port else jm
    for g in GAUGES:  # a gauge keeps what earlier tests in the process set
        gauge = getattr(m, g)
        with gauge._lock:
            gauge._values.clear()
    before = series_state(m)
    env = drive(port)
    after = series_state(m)
    d = delta(before, after)
    for g in GAUGES:  # gauges: the final value, not the change
        d.pop(g, None)
        d[g] = {k: v for k, v in after[g].items()}
    return d, env


# -- the flight records ---------------------------------------------------------


def drive_basic(port, solver):
    # a FakeClock: the queue gauges refresh at most once a second of the
    # scheduler clock, so a wall clock would make their last value timing-bound
    env = env_for(port, solver, n_nodes=4, clock=True)
    m = env.m
    env.store.create_many("pods", [m.MakePod(f"p-{i}").req({"cpu": "500m", "memory": "1Gi"})
                                   .obj() for i in range(30)])
    env.store.create("pods", m.MakePod("huge").req({"cpu": "64"}).obj())
    env.sched.run_until_idle()
    env.store.create_many("pods", [
        m.MakePod(f"a-{i}").labels({"grp": "a"}).req({"cpu": "100m"})
        .pod_anti_affinity("kubernetes.io/hostname", {"grp": "a"}).obj() for i in range(6)])
    env.sched.run_until_idle()
    return env


@pytest.mark.parametrize("solver", ["exact", "fast", "auto"])
def test_flight_records_match_jax(solver):
    def run(port):
        d, env = counted_increments(port, lambda p: drive_basic(p, solver))
        return records(env), state(env), d

    recs, st, d = both(run)
    first = recs[0][0]
    assert first["pods"] == 31 and first["nodes"] == 4 and first["scheduled"] == 30
    assert first["unschedulable"] == 1 and first["reasons"] == {"NodeResourcesFit": 1}
    assert first["outcome"] == "scheduled"
    assert {"ingest", "pop", "tensorize", "build_pod_batch", "solve", "assume",
            "dispatch"} <= set(recs[0][1])
    assert recs[-1][0]["unschedulable"] == 2  # 6 anti pods on 4 nodes
    if solver != "exact":
        assert recs[-1][0]["repair"] is not None
        assert "constraint_repair_rounds" in d


def drive_edges(port):
    env = Env(port, "fast")
    make(env)
    m = env.m
    env.batch()  # empty pop: no record
    env.store.create("pods", m.MakePod("p").req({"cpu": "1"}).obj())
    env.batch()  # no nodes: an unschedulable record
    return env


def test_no_nodes_and_empty_pop_match_jax():
    def run(port):
        d, env = counted_increments(port, drive_edges)
        return records(env), d["batch_solve_duration"]

    recs, solves = both(run)
    assert len(recs) == 1 and recs[0][0]["outcome"] == "unschedulable"
    assert recs[0][0]["nodes"] == 0 and solves == {"unschedulable": 1}


def drive_gang_veto(port):
    env = Env(port, "fast")
    env.nodes(2, cpu="1")
    make(env)
    env.pg("big", 3)
    env.store.create_many("pods", env.gang_pods(3, "big", cpu="800m", mem="1Gi"))
    env.batch()
    return env


def test_gang_veto_counter_and_record_match_jax():
    def run(port):
        d, env = counted_increments(port, drive_gang_veto)
        return records(env), d, state(env)

    recs, d, _st = both(run)
    assert d["gang_vetoed_total"] == {(("reason", "solver"),): 1.0}
    assert recs[-1][0]["gang"]["vetoed"] == 1
    assert recs[-1][0]["reasons"].get("GangScheduling") == 3


def drive_orphans(port):
    env = Env(port, "fast", clock=True)
    env.nodes(4)
    make(env)
    env.pg("doomed", 3)
    env.pg("other", 2)
    env.store.create_many("pods", env.gang_pods(2, "doomed", cpu="100m"))
    env.sched.pump_events()
    env.store.delete("podgroups", "default/doomed")
    env.sched.pump_events()
    env.clock.step(31.0)
    env.sched.queue.flush_unschedulable_left_over()
    return env


def test_orphan_release_counter_matches_jax():
    d, _env = counted_increments(True, drive_orphans)
    dj, _envj = counted_increments(False, drive_orphans)
    assert d["gang_orphan_released_total"] == dj["gang_orphan_released_total"] == {(): 2.0}


# -- retries by stage, the breaker and the SchedulerError event ------------------


def drive_solver_fault(port):
    m, fi, store, sched = _chaos("port" if port else "jax", solver="exact",
                                 breaker_threshold=1, pipeline_binds=False)
    store.create_many("pods", _pods(m, 5, "sf"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("solver.solve", "fail", count=1)])
    _batch("port" if port else "jax", sched)
    fi.disarm()
    return SimpleEnv(store, sched, m)


class SimpleEnv:
    def __init__(self, store, sched, m):
        self.store, self.sched, self.m = store, sched, m


def test_solver_fault_record_event_and_retries_match_jax():
    def run(port):
        d, env = counted_increments(port, drive_solver_fault)
        ev = [(e.type, e.reason, e.involved_name, e.message) for e in env.store.list("events")[0]
              if e.reason == "SchedulerError"]
        return records(env), d["batch_retries_total"], d["solver_breaker_state"], ev

    recs, retries, breaker, ev = both(run)
    assert recs[0][0]["outcome"] == "error" and "FaultInjected" in recs[0][0]["error"]
    assert recs[0][0]["reasons"] == {"SolverError": 5}
    assert retries == {(("reason", "FaultInjected"), ("stage", "solve")): 5.0}
    assert breaker == {(): 2}  # open
    assert len(ev) == 1 and "circuit breaker OPEN" in ev[0][3]


def drive_dispatch_fault(port):
    m, fi, store, sched = _chaos("port" if port else "jax", pipeline_binds=False)
    store.create_many("pods", _pods(m, 4, "df"))
    sched.pump_events()

    def broken(*a, **kw):
        raise RuntimeError("account")

    sched._columnar_account = broken
    _batch("port" if port else "jax", sched)
    return SimpleEnv(store, sched, m)


def test_dispatch_rollback_retries_and_event_match_jax():
    def run(port):
        d, env = counted_increments(port, drive_dispatch_fault)
        ev = sorted((e.reason, e.message) for e in env.store.list("events")[0]
                    if e.type == "Warning")
        return records(env), d["batch_retries_total"], ev, env.sched.queue.lengths()

    recs, retries, ev, lengths = both(run)
    assert retries == {(("reason", "RuntimeError"), ("stage", "dispatch")): 4.0}
    assert recs[0][0]["reasons"] == {"DispatchError": 4} and recs[0][0]["outcome"] == "error"
    assert ev[0][0] == "SchedulerError" and lengths[1] == 4


@pytest.mark.parametrize("count", [1, 2])
def test_bind_retries_count_like_jax(count):
    def run(port):
        def drive(p):
            m, fi, store, sched = _chaos("port" if p else "jax", bind_retries=3,
                                         bind_retry_base_s=0.001, pipeline_binds=False)
            store.create_many("pods", _pods(m, 6, "br"))
            sched.pump_events()
            fi.arm([fi.FaultPlan("store.bind_many", "fail", count=count)])
            _batch("port" if p else "jax", sched)
            sched.flush_binds()
            fi.disarm()
            return SimpleEnv(store, sched, m)

        d, env = counted_increments(port, drive)
        return d["batch_retries_total"], records(env), state(env)

    retries, _recs, _st = both(run)
    assert retries == {(("reason", "transient"), ("stage", "bind")): float(count)}


def test_worker_escape_retries_count_like_jax():
    def run(port):
        def drive(p):
            m, fi, store, sched = _chaos("port" if p else "jax")
            store.create_many("pods", _pods(m, 6, "we"))
            sched.pump_events()
            fi.arm([fi.FaultPlan("bind.worker", "fail", count=1)])
            _batch("port" if p else "jax", sched)
            sched.flush_binds()
            fi.disarm()
            sched.stop()
            return SimpleEnv(store, sched, m)

        d, env = counted_increments(port, drive)
        # the port keeps its own per-stage count beside the series
        counts = env.sched.retry_counts if port else {"bind": 0, "worker": 6, "dispatch": 0}
        return d["batch_retries_total"], env.sched.scheduled_count, counts

    retries, n, port_counts = both(run)
    assert retries == {(("reason", "escaped"), ("stage", "worker")): 6.0} and n == 6


# -- the pod tracer under a FakeClock ------------------------------------------


def drive_traced(port):
    env = env_for(port, "exact", n_nodes=4, clock=True)
    m = env.m
    env.store.create_many("pods", [m.MakePod(f"t-{i}").req({"cpu": "250m"}).obj()
                                   for i in range(24)])
    env.sched.pump_events()
    env.clock.step(2.0)
    env.sched.schedule_batch() if port else env.sched.schedule_batch(timeout=0.0)
    env.clock.step(1.0)
    env.store.create_many("pods", [m.MakePod(f"u-{i}").req({"cpu": "250m"}).obj()
                                   for i in range(12)])
    env.sched.pump_events()
    env.clock.step(0.5)
    env.sched.run_until_idle()
    return env


def test_sampled_spans_and_latency_match_jax():
    def run(port):
        env = drive_traced(port)
        snap = env.sched.podtrace.snapshot()
        snap.pop("flush_seconds")
        return snap

    snap = both(run)
    assert snap["completed"] == 36 and snap["live_incomplete"] == 0
    assert len(snap["spans"]) == 36
    t0 = next(sp for sp in snap["spans"] if sp["pod"] == "default/t-0")
    assert t0["stamps_ms"]["pop"] == 2000.0 and t0["submit_to_bound_ms"] == 2000.0
    u0 = next(sp for sp in snap["spans"] if sp["pod"] == "default/u-0")
    assert u0["submit_to_bound_ms"] == 500.0
    assert snap["latency"]["count"] == 36


def test_critpath_over_live_spans_matches_jax():
    def run(port):
        env = drive_traced(port)
        cp = tcp if port else jcp
        spans = env.sched.podtrace.snapshot()["spans"]
        table = {k: {"total_ms": 1.0} for k in ("tensorize", "build_pod_batch", "solve")}
        return cp.analyze(spans, stage_table=table)

    out = both(run)
    overall = out["overall"]
    assert out["spans_analyzed"] == 36 and overall["dominant"] == "queue_wait"
    assert overall["sum_mean_ms"] == pytest.approx(overall["total_mean_ms"], rel=1e-9)


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


def test_sched_stats_keys_and_counts_match_jax():
    def run(port):
        env = drive_traced(port)
        st = env.sched.sched_stats()
        counts = {k: st[k] for k in ("solver", "batch_size", "batches_solved", "scheduled",
                                     "failed", "preemptions", "preempt_victims", "queue",
                                     "latency", "trace", "gang", "repair", "partition",
                                     "rebalance", "bind_worker", "store_columnar")}
        counts["recorder"] = {k: st["recorder"][k] for k in ("enabled", "capacity", "records")}
        counts["stages"] = sorted(st["stages"])
        return _keys(st), counts

    keys, counts = both(run)
    assert counts["scheduled"] == 36 and counts["recorder"]["records"] == 2
    assert {"recorder", "tracebuf", "stages", "timeseries", "windows", "resource",
            "last_batch", "cache_columnar", "watch", "breaker"} <= set(keys)


# -- the armed trace ring ------------------------------------------------------


def test_armed_trace_export_matches_jax():
    def run(port):
        tb = ttb if port else jtb
        buf = tb.arm(capacity=50_000)
        env = env_for(port, "fast", n_nodes=6, pipeline_binds=True)
        env.store.create_many("pods", [env.m.MakePod(f"p-{i}").req({"cpu": "100m"}).obj()
                                       for i in range(96)])
        env.sched.run_until_idle()
        env.sched.flush_binds()
        tb.disarm()
        doc = buf.export(spans=env.sched.podtrace.snapshot()["spans"])
        res = tb.validate_export(doc)
        # a batch past trace_threshold (the JAX side's first compile) adds
        # a slowtrace track: timing, not structure
        tracks = sorted(ev["args"]["name"] for ev in doc["traceEvents"]
                        if ev["name"] == "thread_name" and ev["args"]["name"] != "slowtrace")
        names = collections.Counter((ev["ph"], ev["name"]) for ev in doc["traceEvents"]
                                    if ev["ph"] in ("B", "E"))
        rec_ms = sum(sum(r["stages"].values()) for r in env.sched.flightrec.records())
        slice_ms = sum(ev["dur"] for ev in doc["traceEvents"]
                       if ev["ph"] == "X" and ev.get("cat") == "stage") / 1000.0
        assert slice_ms == pytest.approx(rec_ms, rel=0.02, abs=0.5)
        env.sched.stop()
        return res["valid"], tracks, res["flow_pairs"], names, env.sched.scheduled_count

    valid, tracks, flows, names, bound = both(run)
    assert bound == 96
    assert valid and tracks == ["bind", "sched"] and flows == 0
    assert names[("B", "batch")] == names[("E", "batch")] >= 1


def test_trace_snapshots_read_the_registry():
    env = drive_traced(True)
    name = env.sched._bind_origin
    assert tfr.schedstats_snapshot()[name]["scheduled"] == 36
    assert tfr.timeseries_snapshot()[name]["window_s"] == 5.0
    assert len(tfr.schedtrace_snapshot()[name]["spans"]) == 36
    assert tfr.critpath_snapshot()[name]["spans_analyzed"] == 36
    ttb.LAST = None
    assert tfr.trace_export()["error"] == "trace buffer never armed"
    buf = ttb.arm()
    buf.instant("sched", "x")
    ttb.disarm()
    assert tfr.trace_export()["traceEvents"][-1]["name"] == "x"


# -- recorder on against off: the same outputs in every mode --------------------


def drive_mode(flight_recorder, mode):
    env = Env(True, "exact" if mode == "gang" else mode)
    env.nodes(6, slices=2 if mode == "gang" else 0)
    make(env, batch_size=64, flight_recorder=flight_recorder)
    m = env.m
    if mode == "gang":
        env.pg("train", 4)
        env.store.create_many("pods", env.gang_pods(4, "train", cpu="2"))
        env.pg("big", 40)
        env.store.create_many("pods", env.gang_pods(5, "big", cpu="2", prefix="b"))
    env.store.create_many("pods", [m.MakePod(f"p-{i}").req({"cpu": "300m", "memory": "1Gi"})
                                   .obj() for i in range(50)])
    env.store.create_many("pods", [
        m.MakePod(f"a-{i}").labels({"grp": "a"}).req({"cpu": "100m"})
        .pod_anti_affinity("kubernetes.io/hostname", {"grp": "a"}).obj() for i in range(8)])
    env.store.create("pods", m.MakePod("huge").req({"cpu": "64"}).obj())
    env.sched.run_until_idle()
    return env


@pytest.mark.parametrize("mode", ["exact", "fast", "auto", "native", "auction", "sinkhorn",
                                  "gang"])
def test_recorder_on_off_same_outputs(mode):
    on, off = drive_mode(True, mode), drive_mode(False, mode)
    assert state(on) == state(off)
    assert on.sched.scheduled_count == off.sched.scheduled_count > 0
    assert len(on.sched.flightrec) > 0 and len(off.sched.flightrec) == 0
    st = off.sched.sched_stats()
    assert st["recorder"]["enabled"] is False and st["trace"]["enabled"] is False
    assert off.sched.podtrace.completed_total == 0 and off.sched.timeseries.windows() == []


FALLBACK_SMALL = dict(n_nodes=20, n_device=20, zones=4, tainted=2, slice_every=5,
                      devices_per_slice=2, csi_limit=2, prebound=3, provision=2, static=2,
                      dra_one=3, dra_two=2, spread=3, ephemeral=1, shared_disk=1)


@pytest.fixture
def dra_gate():
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", True)
    yield
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", False)


def drive_fallback(port, flight_recorder=True, seed=3):
    env = Env(port, "auto")
    w = tt.fallback_workload(seed, api=None if port else JAX_API, **FALLBACK_SMALL)
    for kind in KINDS:
        for obj in w[kind]:
            env.store.create(kind, obj)
    kw = {"flight_recorder": flight_recorder} if port else {}
    make(env, batch_size=64, **kw)
    env.store.create_many("pods", w["pods"])
    env.sched.run_until_idle()
    return env


def test_fallback_route_recorder_on_off_and_records_match_jax(dra_gate):
    on, off = drive_fallback(True), drive_fallback(True, flight_recorder=False)
    assert state(on) == state(off)
    got, want = records(on), records(drive_fallback(False))
    assert got == want
    assert sum(r["fallback"] for r, _s in got) == on.sched.fallback_pods > 0
    assert any("fallback" in stages for _r, stages in got)
