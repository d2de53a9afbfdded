"""The port's fault injector (chaos/faultinject.py) and the `solver.solve`
site in BatchScheduler._solve_device against the JAX package.

The TestFaultInject cases of tests/test_chaos.py run on both injectors; the
site table, the seeded rate decisions, the FAULT_INJECT parser and the trace
instants of a firing are equal between the packages. Then the
TestSolverBreaker cases: the breaker's state machine on both breakers, and
the cases that drive a scheduler through the injected `solver.solve` fault
on both packages over identical stores, with the same breaker states,
requeues, solve paths and end placements, and
test_retry_metric_counts_solver_requeues: the batch_retries_total series
counts the requeued pods by stage and reason on both packages, beside the
one SchedulerError Warning event. Like the reference's tests, the module
runs under the mutation detector (`mutation_detector_guard`) of both
packages' stores.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
from test_torch_gang import Env

import kubernetes_tpu.chaos.faultinject as jfi
import kubernetes_tpu.obs.tracebuf as jtb
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.obs.tracebuf as ttb
import kubernetes_tpu.server.metrics as jm
import kubernetes_tpu_torch.server.metrics as tm
from kubernetes_tpu.scheduler.breaker import SolverCircuitBreaker as JBreaker
from kubernetes_tpu.testing import mutation_detector_guard as j_mutation_detector_guard
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.scheduler.breaker import SolverCircuitBreaker as TBreaker
from kubernetes_tpu_torch.testing import mutation_detector_guard as t_mutation_detector_guard
from kubernetes_tpu_torch.utils import FakeClock as TFakeClock

ROOT = Path(__file__).resolve().parent.parent
INJECTORS = [pytest.param(jfi, id="jax"), pytest.param(tfi, id="port")]
BREAKERS = [pytest.param((JBreaker, JFakeClock), id="jax"),
            pytest.param((TBreaker, TFakeClock), id="port")]


@pytest.fixture(autouse=True)
def _force_mutation_detector(monkeypatch):
    """Chaos paths clone and roll back aggressively: every store of either
    package built here runs with the mutation detector on and is checked at
    teardown (tests/test_chaos.py runs the reference's module so)."""
    guards = [j_mutation_detector_guard(monkeypatch), t_mutation_detector_guard(monkeypatch)]
    for g in guards:
        next(g)
    yield
    for g in guards:
        next(g, None)


@pytest.fixture(autouse=True)
def _always_disarm():
    """No test may leak an armed injector or trace buffer into its neighbors."""
    for m in (jfi, tfi, jtb, ttb):
        m.disarm()
    yield
    for m in (jfi, tfi, jtb, ttb):
        m.disarm()


# -- the fault-injection harness, on both injectors --------------------------------


@pytest.mark.parametrize("fi", INJECTORS)
class TestFaultInject:
    def test_fail_next_n_then_passes(self, fi):
        inj = fi.arm([fi.FaultPlan("solver.solve", "fail", count=2)])
        for _ in range(2):
            with pytest.raises(fi.FaultInjected):
                inj.fire("solver.solve")
        inj.fire("solver.solve")  # exhausted: passes
        assert inj.stats()["solver.solve"] == {"fired": 3, "injected": 2}

    def test_rate_plan_is_seeded_deterministic(self, fi):
        def decisions(seed):
            inj = fi.Injector([fi.FaultPlan("store.bind_many", "rate", rate=0.5, seed=seed)])
            out = []
            for _ in range(50):
                try:
                    inj.fire("store.bind_many")
                    out.append(False)
                except fi.FaultInjected:
                    out.append(True)
            return out

        a, b = decisions(7), decisions(7)
        assert a == b
        assert any(a) and not all(a)
        assert decisions(8) != a

    def test_after_offset_skips_early_fires(self, fi):
        inj = fi.arm([fi.FaultPlan("solver.solve", "fail", count=1, after=2)])
        inj.fire("solver.solve")
        inj.fire("solver.solve")
        with pytest.raises(fi.FaultInjected):
            inj.fire("solver.solve")

    def test_delay_plan_sleeps(self, fi):
        inj = fi.arm([fi.FaultPlan("solver.solve", "delay", count=1, delay_s=0.05)])
        t0 = time.perf_counter()
        inj.fire("solver.solve")
        assert time.perf_counter() - t0 >= 0.04
        t0 = time.perf_counter()
        inj.fire("solver.solve")  # count exhausted: no sleep
        assert time.perf_counter() - t0 < 0.04

    def test_match_scopes_to_key(self, fi):
        inj = fi.arm([fi.FaultPlan("kubelet.heartbeat", "fail", count=10, match="hollow-1")])
        assert not inj.should_drop("kubelet.heartbeat", "hollow-0")
        assert inj.should_drop("kubelet.heartbeat", "hollow-1")
        assert not inj.should_drop("kubelet.heartbeat", "hollow-2")

    def test_unknown_site_and_bad_modes_rejected(self, fi):
        with pytest.raises(ValueError):
            fi.Injector([fi.FaultPlan("no.such.site", "fail")])
        with pytest.raises(ValueError):
            fi.Injector([fi.FaultPlan("watch.deliver", "delay", delay_s=1.0)])
        with pytest.raises(ValueError):
            fi.Injector([fi.FaultPlan("kubelet.heartbeat", "kill")])
        with pytest.raises(ValueError):
            fi.Injector([fi.FaultPlan("solver.solve", "explode")])

    def test_env_spec_parsing(self, fi):
        plans = fi.parse_env("solver.solve=fail:count=3;"
                             "store.bind_many=rate:rate=0.1,seed=7;"
                             "bind.worker=kill:after=2")
        by_site = {p.site: p for p in plans}
        assert by_site["solver.solve"].count == 3
        assert by_site["store.bind_many"].rate == 0.1
        assert by_site["store.bind_many"].seed == 7
        assert by_site["bind.worker"].mode == "kill"
        assert by_site["bind.worker"].after == 2
        with pytest.raises(ValueError):
            fi.parse_env("solver.solve=fail:bogus=1")

    def test_disarmed_is_inert(self, fi):
        assert fi.ACTIVE is None
        assert not fi.enabled()
        assert fi.disabled_check_cost_ns(10_000) > 0

    def test_kill_is_a_base_exception(self, fi):
        inj = fi.arm([fi.FaultPlan("rebalance.cycle", "kill", match="midwave")])
        inj.fire("rebalance.cycle", key="cycle")  # no match: untouched
        with pytest.raises(fi.FaultKill) as got:
            try:
                inj.fire("rebalance.cycle", key="midwave")
            except Exception:  # a supervisor's handler must not absorb it
                pytest.fail("FaultKill was caught as an Exception")
        assert got.value.site == "rebalance.cycle"
        assert not issubclass(fi.FaultKill, Exception)


# -- cross-package parity of the injector -------------------------------------------


def test_tables_match_jax():
    assert set(tfi.SITES) == set(jfi.SITES)
    assert tfi.DROP_ONLY_SITES == jfi.DROP_ONLY_SITES
    assert tfi.MODES == jfi.MODES
    # the six sites the port wires say where; the others name their item
    wired = {"solver.solve", "rebalance.cycle", "store.bind_many", "watch.deliver",
             "bind.worker", "native.commit"}
    for site in wired:
        assert "not wired" not in tfi.SITES[site]
    for site in set(tfi.SITES) - wired:
        assert "not wired until" in tfi.SITES[site]


def _decisions(fi, plans, fires):
    inj = fi.Injector(plans)
    out = []
    for site, key, drop in fires:
        if drop:
            out.append(inj.should_drop(site, key))
            continue
        try:
            inj.fire(site, key)
            out.append("ok")
        except fi.FaultInjected:
            out.append("fail")
        except fi.FaultKill:
            out.append("kill")
    return out, inj.stats()


@pytest.mark.parametrize("seed", range(5))
def test_seeded_plans_decide_as_jax(seed):
    import random

    rng = random.Random(seed)
    specs = [("solver.solve", "rate", dict(rate=rng.random(), seed=seed)),
             ("rebalance.cycle", "fail", dict(count=rng.randint(1, 4), after=rng.randint(0, 3),
                                              match="wave")),
             ("rebalance.cycle", "kill", dict(after=rng.randint(0, 6), match="midwave")),
             ("watch.deliver", "fail", dict(count=rng.randint(1, 3)))]
    fires = [(rng.choice(["solver.solve", "rebalance.cycle", "watch.deliver"]),
              rng.choice(["cycle", "wave-0", "wave-3", "midwave", None]), False)
             for _ in range(60)]
    fires = [(s, k, s == "watch.deliver") for s, k, _d in fires]
    got = _decisions(tfi, [tfi.FaultPlan(s, m, **kw) for s, m, kw in specs], fires)
    want = _decisions(jfi, [jfi.FaultPlan(s, m, **kw) for s, m, kw in specs], fires)
    assert got == want
    assert "fail" in got[0]


@pytest.mark.parametrize("spec", [
    "solver.solve=fail:count=3;store.bind_many=rate:rate=0.1,seed=7;bind.worker=kill:after=2",
    "rebalance.cycle=kill:match=midwave;solver.solve=delay:delay_s=0.5,count=2",
    " ; rebalance.cycle=fail ;watch.deliver=rate:rate=0.25,seed=3,message=drop",
])
def test_env_parser_matches_jax(spec):
    def fields(plans):
        return [{f.name: getattr(p, f.name) for f in dataclasses.fields(p)
                 if not f.name.startswith("_")} for p in plans]

    assert fields(tfi.parse_env(spec)) == fields(jfi.parse_env(spec))


def test_fault_inject_env_arms_at_import():
    code = ("import json; import kubernetes_tpu_torch.chaos.faultinject as fi; "
            "print(json.dumps([[p.site, p.mode, p.count, p.match] "
            "for ps in fi.ACTIVE._plans.values() for p in ps]))")
    env = dict(os.environ, FAULT_INJECT="rebalance.cycle=fail:match=midwave;solver.solve=kill")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        ["rebalance.cycle", "fail", 1, "midwave"], ["solver.solve", "kill", 1, None]]


def test_firings_land_on_the_trace_as_in_jax():
    def run(fi, tb):
        buf = tb.arm()
        inj = fi.arm([fi.FaultPlan("solver.solve", "fail", count=1),
                      fi.FaultPlan("watch.deliver", "fail", count=1)])
        with pytest.raises(fi.FaultInjected):
            inj.fire("solver.solve")
        inj.fire("solver.solve")
        assert inj.should_drop("watch.deliver", "w-1")
        buf.counter("sched", "queue", {"active": 3, "backoff": 1})
        fi.disarm()
        tb.disarm()
        tracks = {tid: name for name, tid in buf._tids.items()}
        return ([(tracks[e["tid"]], e["name"], e["cat"], e["ph"], e.get("args"))
                 for e in buf._ring],
                {k: v for k, v in buf.status().items() if k != "self_seconds"})

    assert run(tfi, ttb) == run(jfi, jtb)
    assert ttb.status()["trace_events_total"] == 3 and ttb.LAST is ttb.current()


def test_trace_ring_drops_the_oldest():
    buf = ttb.TraceBuffer(capacity=2)
    for i in range(5):
        buf.instant("t", f"e{i}")
    assert [e["name"] for e in buf.events()] == ["e3", "e4"]
    assert buf.status()["trace_events_dropped_total"] == 3
    with pytest.raises(ValueError):
        ttb.TraceBuffer(capacity=0)


# -- the solver circuit breaker ------------------------------------------------------


@pytest.mark.parametrize("pkg", BREAKERS)
class TestSolverBreakerUnit:
    def test_state_machine_unit(self, pkg):
        breaker, fake_clock = pkg
        clock = fake_clock()
        b = breaker(clock=clock, threshold=2, cooldown_s=10.0)
        assert b.effective_solver("fast") == "fast"
        b.record_failure("fast", "fast")
        assert b.state == "closed"
        b.record_failure("fast", "fast")
        assert b.state == "open" and b.trips == 1
        assert b.effective_solver("fast") == "exact"
        b.record_failure("exact", "fast")  # degraded-solver failure: counted only
        assert b.state == "open" and b.degraded_failures == 1
        clock.step(11)
        assert b.effective_solver("fast") == "fast"  # half-open probe
        assert b.state == "half_open"
        b.record_failure("fast", "fast")  # probe failed: trips open again
        assert b.state == "open" and b.trips == 2
        clock.step(11)
        assert b.effective_solver("fast") == "fast"
        b.record_success("fast", "fast")
        assert b.state == "closed" and b.recoveries == 1
        assert b.consecutive_failures == 0

    def test_path_attribution_not_mode_label(self, pkg):
        breaker, fake_clock = pkg
        clock = fake_clock()
        b = breaker(clock=clock, threshold=2, cooldown_s=10.0)
        b.record_failure("exact", "fast")
        b.record_failure("exact", "fast")
        assert b.state == "closed" and b.trips == 0 and b.degraded_failures == 2
        b.record_failure("fast", "fast")
        b.record_failure("fast", "fast")
        assert b.state == "open"
        clock.step(11)
        assert b.effective_solver("fast") == "fast" and b.state == "half_open"
        b.record_success("exact", "fast")  # a constrained probe proves nothing
        assert b.state == "half_open" and b.recoveries == 0
        b.record_success("fast", "fast")
        assert b.state == "closed" and b.recoveries == 1
        b2 = breaker(clock=clock, threshold=1)
        b2.record_failure("fast", "auto")
        assert b2.state == "open"

    def test_repair_path_counts_as_the_fast_mode(self, pkg):
        breaker, fake_clock = pkg
        clock = fake_clock()
        b = breaker(clock=clock, threshold=2, cooldown_s=10.0)
        b.record_failure("repair", "fast")
        b.record_failure("repair", "fast")
        assert b.state == "open" and b.trips == 1
        clock.step(11)
        assert b.effective_solver("fast") == "fast"
        b.record_success("repair", "fast")
        assert b.state == "closed" and b.recoveries == 1
        b2 = breaker(clock=clock, threshold=1)
        b2.record_failure("repair", "auto")
        assert b2.state == "open"


# -- the solver.solve site, driven through both schedulers ---------------------------


def chaos_env(port, solver, n_nodes=4, labels=False, **kw):
    env = Env(port, solver)
    for i in range(n_nodes):
        mk = env.m.MakeNode(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi", "pods": "110"})
        if labels:
            mk = mk.labels({"kubernetes.io/hostname": f"node-{i}"})
        env.store.create("nodes", mk.obj())
    kw.setdefault("pod_initial_backoff", 0.01)
    kw.setdefault("pod_max_backoff", 0.05)
    env.make_sched(batch_size=64, **kw)
    return env


def pods(env, n, prefix="p", cpu="100m"):
    return [env.m.MakePod(f"{prefix}-{i}").req({"cpu": cpu}).obj() for i in range(n)]


def anti(env, prefix, n):
    return [env.m.MakePod(f"{prefix}-{i}").labels({"grp": prefix})
            .pod_anti_affinity("kubernetes.io/hostname", {"grp": prefix})
            .req({"cpu": "100m"}).obj() for i in range(n)]


def drive(env, want, deadline_s=10.0, prefix=None):
    """Drive (backoff flushes included) until `want` pods are bound or the
    deadline passes. Returns the bound count."""
    t0 = time.monotonic()
    bound = 0
    while time.monotonic() - t0 < deadline_s:
        env.sched.run_until_idle()
        env.sched.queue.flush_backoff_completed()
        env.sched.queue.move_all_to_active_or_backoff()
        bound = sum(1 for p in env.store.list("pods")[0]
                    if p.spec.node_name and (prefix is None or p.metadata.name.startswith(prefix)))
        if bound >= want:
            return bound
        time.sleep(0.01)
    return bound


def placement(env):
    return sorted((p.metadata.name, p.spec.node_name) for p in env.store.list("pods")[0])


def _requeue_then_bind(port):
    env = chaos_env(port, "exact", breaker_threshold=100)
    fi = tfi if port else jfi
    env.store.create_many("pods", pods(env, 10))
    env.sched.pump_events()
    fi.arm([fi.FaultPlan("solver.solve", "fail", count=1)])
    handled = env.batch()
    keys = [f"default/p-{i}" for i in range(10)]
    # nothing scheduled, nothing assumed: the batch sits in backoff as a unit
    after = (handled, env.sched.scheduled_count,
             sum(env.sched.cache.is_assumed(k) for k in keys), env.sched.queue.lengths()[1],
             env.sched.breaker.describe())
    if port:
        assert "FaultInjected" in env.sched.last_solver_error
    else:
        rec = env.sched.flightrec.last()
        assert rec["outcome"] == "error" and "FaultInjected" in rec["error"]
    bound = drive(env, 10)
    cons = env.m.assert_pod_conservation(env.store, env.sched, keys)["counts"]
    return after, bound, cons, placement(env)


def test_solver_exception_requeues_batch_not_lost():
    got, want = _requeue_then_bind(True), _requeue_then_bind(False)
    assert got == want
    assert got[0][:4] == (10, 0, 0, 10) and got[1] == 10


def _trip_and_recover(port):
    env = chaos_env(port, "fast", breaker_threshold=2, breaker_cooldown_s=0.2)
    fi = tfi if port else jfi
    fi.arm([fi.FaultPlan("solver.solve", "fail", count=2)])
    env.store.create_many("pods", pods(env, 8, prefix="a"))
    env.sched.pump_events()
    env.batch()  # failure 1
    env.sched.queue.flush_backoff_completed()
    time.sleep(0.02)
    env.sched.queue.flush_backoff_completed()
    env.batch()  # failure 2 -> OPEN
    opened = env.sched.breaker.describe()
    assert env.sched.breaker.state == "open" and env.sched.breaker.trips == 1
    # while OPEN the batches run the degraded solver, the exact scan
    bound_a = drive(env, 8, prefix="a-")
    path_open = env.sched._solve_path
    time.sleep(0.25)  # the cooldown passes; the next real batch is the probe
    env.store.create_many("pods", pods(env, 4, prefix="b"))
    bound_b = drive(env, 4, prefix="b-")
    assert env.sched.breaker.state == "closed" and env.sched.breaker.recoveries == 1
    keys = [f"default/a-{i}" for i in range(8)] + [f"default/b-{i}" for i in range(4)]
    cons = env.m.assert_pod_conservation(env.store, env.sched, keys)["counts"]
    return (opened, bound_a, path_open, bound_b, env.sched._solve_path,
            env.sched.breaker.describe(), cons, placement(env))


def test_breaker_trips_to_scan_and_recovers():
    got, want = _trip_and_recover(True), _trip_and_recover(False)
    assert got == want
    assert got[2] == "exact" and got[4] == "fast"


def _repair_fault(port):
    env = chaos_env(port, "fast", n_nodes=8, labels=True, breaker_threshold=2,
                    breaker_cooldown_s=0.2)
    fi = tfi if port else jfi
    fi.arm([fi.FaultPlan("solver.solve", "fail", count=2)])
    env.store.create_many("pods", anti(env, "a", 4))
    env.sched.pump_events()
    env.batch()  # failure 1, attributed to the repair path
    path1 = env.sched._solve_path
    env.sched.queue.flush_backoff_completed()
    time.sleep(0.02)
    env.sched.queue.flush_backoff_completed()
    env.batch()  # failure 2 -> OPEN
    opened = env.sched.breaker.describe()
    # while OPEN, the constrained batches run the exact scan and still
    # honor the anti-affinity
    bound_a = drive(env, 4, prefix="a-")
    nodes = [n for _p, n in placement(env) if n]
    assert len(set(nodes)) == 4
    time.sleep(0.25)
    env.store.create_many("pods", anti(env, "b", 4))
    bound_b = drive(env, 4, prefix="b-")
    keys = [f"default/a-{i}" for i in range(4)] + [f"default/b-{i}" for i in range(4)]
    cons = env.m.assert_pod_conservation(env.store, env.sched, keys)["counts"]
    return (path1, opened, bound_a, bound_b, env.sched._solve_path,
            env.sched.breaker.describe(), cons, placement(env))


def test_repair_fault_trips_breaker_to_scan_and_recovers():
    got, want = _repair_fault(True), _repair_fault(False)
    assert got == want
    assert got[0] == "repair" and got[4] == "repair"
    assert got[5]["state"] == "closed" and got[5]["recoveries"] == 1


def _retry_metric(port):
    env = chaos_env(port, "exact", breaker_threshold=100)
    fi, m = (tfi, tm) if port else (jfi, jm)
    before = m.batch_retries_total.value(stage="solve", reason="FaultInjected")
    env.store.create_many("pods", pods(env, 5, prefix="m"))
    env.sched.pump_events()
    fi.arm([fi.FaultPlan("solver.solve", "fail", count=1)])
    env.batch()
    after = m.batch_retries_total.value(stage="solve", reason="FaultInjected")
    events = sorted((e.type, e.reason, e.involved_name, e.message)
                    for e in env.store.list("events")[0] if e.reason == "SchedulerError")
    return after - before, events


def test_retry_metric_counts_solver_requeues():
    got, want = _retry_metric(True), _retry_metric(False)
    assert got == want
    assert got[0] == 5 and len(got[1]) == 1 and got[1][0][0] == "Warning"
    assert "5 pod(s) requeued with backoff" in got[1][0][3]
