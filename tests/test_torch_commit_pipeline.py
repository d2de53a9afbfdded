"""The batched host commit of the port's BatchScheduler — columnar cache
rows, the structural assume with one scatter-add, pipelined binds with
retry, assume expiry, the g++ engines — held against its own object-path
oracle (columnar=False, pipeline_binds=False, APIStore(native_commit=False))
and against the JAX package's default pipeline, on the parity and mixed
workloads of tests/test_torch_batch.py and on seeded cases: equal
{pod: node} maps, bind transitions and conservation reports. Then the parity
targets of the JAX package's own tests (test_columnar_endtoend.py,
test_columnar_pipeline.py, test_chaos.py's TestBindRetry,
TestBindWorkerSupervision and TestCrashResync, test_gang.py's
test_expired_assumes_count_back_out_of_quorum) on both packages where their
surfaces meet, with fake clocks and flush_binds() before every read of the
store. Tolerance 0.
"""

import random
import threading
import time

import numpy as np
import pytest
from test_torch_workloads import MIXED_WORKLOADS, PARITY_WORKLOADS, unpack, wl_seeded_mixed

import kubernetes_tpu.chaos.faultinject as jfi
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler import Framework
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu.store import pod_structural_clone as j_structural_clone
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.queue import QueuedPodInfo
from kubernetes_tpu_torch.snapshot import tensorizer as tz
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.store import pod_structural_clone
from kubernetes_tpu_torch.utils import FakeClock as TFakeClock

ORACLE = dict(columnar=False, pipeline_binds=False)


@pytest.fixture(autouse=True)
def _always_disarm():
    tfi.disarm()
    jfi.disarm()
    yield
    tfi.disarm()
    jfi.disarm()


def _build(pkg, store_kw=None, clock=None, **kw):
    """One scheduler over a fresh store: pkg "port" (defaults), "oracle"
    (the port's object path) or "jax" (the JAX package's defaults)."""
    store_kw = dict(store_kw or {})
    if pkg == "oracle":
        store_kw.setdefault("native_commit", False)
        kw = {**ORACLE, **kw}
    if pkg == "jax":
        store = JStore(**store_kw)
        sched = JBatch(store, Framework(default_plugins()), clock=clock, **kw)
    else:
        store = TStore(**store_kw)
        sched = TBatch(store, device="cpu", clock=clock, **kw)
    return store, sched


def _transitions(store):
    """The unbound -> bound transitions in the store's history, (key, node),
    sorted (a pod bound twice appears twice)."""
    out = []
    for ev in store.history_events():
        if ev.kind != "pods" or ev.type != "MODIFIED":
            continue
        obj, prev = ev.obj, ev.prev
        if obj.spec.node_name and (prev is None or not prev.spec.node_name):
            out.append((obj.key, obj.spec.node_name))
    return sorted(out)


def _report(pkg, store, sched, keys):
    mod = jt if pkg == "jax" else tt
    if pkg == "jax":
        sched.flush_binds()
    return mod.pod_conservation_report(store, sched, keys)["counts"]


def run_workload(pkg, workload, batch_size=4096, rounds=1, solver="exact"):
    mod = jt if pkg == "jax" else tt
    nodes, pods, bound = unpack(workload(mod))
    store, sched = _build(pkg, solver=solver, batch_size=batch_size)
    for n in nodes:
        store.create("nodes", n)
    for p in bound:
        store.create("pods", p)
    sched._preemption_plugin(sched.framework).async_preparation = False
    sched.sync()
    keys = [p.key for p in pods]
    wave = -(-len(pods) // rounds)
    for lo in range(0, len(pods), wave):
        for p in pods[lo:lo + wave]:
            store.create("pods", p)
        sched.run_until_idle()
    sched.flush_binds()
    got = {p.metadata.name: p.spec.node_name for p in store.list("pods")[0]}
    out = (got, _transitions(store), _report(pkg, store, sched, keys),
           sched.preempt_victims_total)
    sched.stop()
    return out, sched


def assert_three_way(workload, **kw):
    (want, jsched), (got, tsched), (oracle, osched) = (
        run_workload(pkg, workload, **kw) for pkg in ("jax", "port", "oracle"))
    assert got[0] == want[0], "\n".join(f"{k}: jax={want[0][k]!r} port={got[0].get(k)!r}"
                                       for k in want[0] if want[0][k] != got[0].get(k))
    assert got == want == oracle
    return tsched, osched


@pytest.mark.parametrize("workload", PARITY_WORKLOADS + MIXED_WORKLOADS,
                         ids=lambda w: w.__name__)
def test_default_pipeline_matches_its_oracle_and_jax(workload):
    """The default pipeline (columnar rows, pipelined binds, native commit)
    places, binds and conserves exactly as the port's object-path oracle and
    as the JAX package's default pipeline."""
    tsched, osched = assert_three_way(workload)
    assert tsched.cache.assumed_count() == osched.cache.assumed_count() == 0
    assert osched.cache.columnar_rows() == 0


@pytest.mark.parametrize("workload", [MIXED_WORKLOADS[0], PARITY_WORKLOADS[1],
                                      PARITY_WORKLOADS[9]], ids=lambda w: w.__name__)
def test_default_pipeline_small_batches_and_waves(workload):
    """Many batches in waves: binds in flight across batches, rows of one
    batch under the next, the tensor cache's assume fast path."""
    assert_three_way(workload, batch_size=7, rounds=3)


@pytest.mark.parametrize("seed", range(3))
def test_default_pipeline_seeded_fast_mode(seed):
    rng = random.Random(seed)
    wl = wl_seeded_mixed(100 + seed, n_nodes=rng.randint(6, 16), n_pods=rng.randint(30, 70))
    assert_three_way(wl, batch_size=rng.choice([16, 32, 4096]), solver="fast")


# -- columnar cache rows (JAX tests/test_columnar_endtoend.py) ------------------------


def _cluster(store, m, n=8, cpu="16"):
    for i in range(n):
        store.create("nodes", m.MakeNode(f"node-{i}").capacity(
            {"cpu": cpu, "memory": "64Gi", "pods": "110"}).obj())


def _pods(m, n, prefix, cpu="100m", prio=None):
    out = []
    for i in range(n):
        mk = m.MakePod(f"{prefix}-{i}").req({"cpu": cpu, "memory": "128Mi"})
        if prio is not None:
            mk = mk.priority(prio)
        out.append(mk.obj())
    return out


def test_steady_state_is_zero_object():
    """A constraint-free wave lands as columnar cache rows: rows == wave,
    none materialized, every pod bound; the rows' pods are the store's
    originals (no clone), and the per-node pod counts include them."""
    store, sched = _build("port", batch_size=64)
    _cluster(store, tt)
    sched.sync()
    store.create_many("pods", _pods(tt, 200, "w"), consume=True)
    sched.run_until_idle()
    assert sched.cache.columnar_rows() == 200
    assert sched.cache.columnar_materialized() == 0
    assert sched.scheduled_count == 200 and sched.cache.assumed_count() == 0
    assert all(p.spec.node_name for p in store.list("pods")[0])
    snap = sched.cache.update_snapshot()
    assert sum(len(ni.pods) + ni.col_count for ni in snap.node_info_list) == 200
    view = sched.cache.pod_columns()
    with pytest.raises(ValueError):
        view.node_id[0] = 1
    assert sched.cache.columnar_stats()["inserted_total"] == 200
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_store_columnar_off_runs_the_object_path(pkg, monkeypatch):
    """STORE_COLUMNAR=0 (read at construction) gives no rows and the same
    placements."""
    placements = {}
    for env in ("1", "0"):
        monkeypatch.setenv("STORE_COLUMNAR", env)
        m = jt if pkg == "jax" else tt
        store, sched = _build(pkg, batch_size=32)
        _cluster(store, m)
        sched.sync()
        store.create_many("pods", _pods(m, 96, "e"), consume=True)
        sched.run_until_idle()
        sched.flush_binds()
        rows = sched.cache.columnar_rows()
        assert (rows == 0) == (env == "0"), (env, rows)
        placements[env] = sorted((p.key, p.spec.node_name) for p in store.list("pods")[0])
        sched.stop()
    assert placements["1"] == placements["0"]


def test_constrained_batch_materializes_rows_first():
    """A spread batch after a constraint-free one collapses the rows into
    PodInfos before its snapshot, so its selector counts see them: the same
    placements and materialization count in both packages."""
    out = {}
    for p in ("port", "jax"):
        m = jt if p == "jax" else tt
        store, sched = _build(p, batch_size=64)
        _cluster(store, m, n=4)
        sched.sync()
        store.create_many("pods", [m.MakePod(f"a-{i}").labels({"app": "s"})
                                   .req({"cpu": "100m"}).obj() for i in range(10)],
                          consume=True)
        sched.run_until_idle()
        rows_before = sched.cache.columnar_rows()
        store.create_many("pods", [m.MakePod(f"b-{i}").labels({"app": "s"}).req({"cpu": "100m"})
                                   .topology_spread(1, "kubernetes.io/hostname",
                                                    "DoNotSchedule", {"app": "s"}).obj()
                                   for i in range(6)], consume=True)
        sched.run_until_idle()
        sched.flush_binds()
        out[p] = (rows_before, sched.cache.columnar_materialized(),
                  sorted((q.key, q.spec.node_name) for q in store.list("pods")[0]))
        sched.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 10 and out["port"][1] == 10


def test_device_reject_preemption_evicts_row_held_placements():
    """Priority preemption after a wave of row-held low-priority pods: the
    rows materialize before the victim walk, the victims are evicted and the
    preemptors bind, the same in both packages (fake clock stepped past the
    backoff)."""
    out = {}
    for p in ("port", "jax"):
        m = jt if p == "jax" else tt
        clock = (JFakeClock if p == "jax" else TFakeClock)()
        store, sched = _build(p, batch_size=64, clock=clock)
        _cluster(store, m, n=2, cpu="2")
        sched._preemption_plugin(sched.framework).async_preparation = False
        sched.sync()
        store.create_many("pods", _pods(m, 4, "low", cpu="1", prio=1), consume=True)
        sched.run_until_idle()
        rows = sched.cache.columnar_rows()
        store.create_many("pods", _pods(m, 2, "high", cpu="1", prio=100), consume=True)
        for _ in range(4):
            sched.run_until_idle()
            sched.flush_binds()
            clock.step(11)
            sched.queue.flush_backoff_completed()
            sched.pump_events()
        sched.run_until_idle()
        sched.flush_binds()
        out[p] = (rows, sched.preempt_victims_total,
                  sorted((q.key, q.spec.node_name) for q in store.list("pods")[0]))
        sched.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 4 and out["port"][1] == 2
    assert all(node for key, node in out["port"][2] if "high" in key)


def _gang_cover_case(pkg, columnar):
    """Low-priority fillers placed by a constraint-free batch (columnar rows
    on the default pipeline), then a higher-priority gang that fits one
    slice only by evicting them (the gang victim cover)."""
    m = jt if pkg == "jax" else tt
    store, sched = _build(pkg, batch_size=256, columnar=columnar)
    for i in range(4):
        store.create("nodes", m.MakeNode(f"node-{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": "110"}).tpu_slice(i // 2).obj())
    sched._preemption_plugin(sched.framework).async_preparation = False
    sched.sync()
    store.create_many("pods", _pods(m, 8, "fill", cpu="1", prio=1), consume=True)
    sched.run_until_idle()
    sched.flush_binds()
    rows = sched.cache.columnar_rows()
    store.create("podgroups", m.make_pod_group("train", 2))
    store.create_many("pods", [m.MakePod(f"g-{i}").gang("train").priority(100)
                               .req({"cpu": "4", "memory": "1Gi"}).obj() for i in range(2)],
                      consume=True)
    for _ in range(3):
        sched.run_until_idle()
        sched.flush_binds()
        sched.pump_events()
    out = (rows, sorted((q.key, q.spec.node_name) for q in store.list("pods")[0]),
           sched.gangpreempt.stats() if sched.gangpreempt is not None else None)
    sched.stop()
    return out


def test_gang_cover_after_a_row_batch_matches_jax():
    """The gang victim cover walks the snapshot's pod lists without
    materializing the columnar rows (JAX gangpreempt.py
    flatten_snapshot_victims). After a constraint-free batch landed the
    fillers as rows, the JAX package's cover finds no victim and the gang
    stays pending, where the object path evicts four fillers and binds it
    (ROADMAP.md queue 3). The port does exactly what the JAX package does on
    each path: placements and cover totals equal."""
    out = {}
    for columnar in (True, False):
        want = _gang_cover_case("jax", columnar)
        got = _gang_cover_case("port", columnar)
        assert got == want
        out[columnar] = got
    assert out[True][0] == 8 and out[True][2]["victims"] == 0
    assert out[False][0] == 0 and out[False][2]["victims"] == 4
    assert [n for k, n in out[False][1] if k.startswith("default/g-")] == ["node-0", "node-1"]
    assert [n for k, n in out[True][1] if k.startswith("default/g-")] == ["", ""]


# -- the tensor cache's assume feed (kernel B's dirty rows) --------------------------


def test_assume_deltas_equal_a_fresh_full_tensorize():
    """After batches through the scatter-add feed (apply_assume_deltas), the
    cluster tensors and the device mirrors kernel B scatters equal a fresh
    full tensorize of the same snapshot; the feed ran (gate: no host ports,
    no foreign mutation)."""
    store, sched = _build("port", batch_size=16)
    _cluster(store, tt, n=6)
    sched.sync()
    fed = []
    orig = sched._tensor_cache.apply_assume_deltas

    def spy(*a, **k):
        ok = orig(*a, **k)
        fed.append(ok)
        return ok

    sched._tensor_cache.apply_assume_deltas = spy
    store.create_many("pods", [tt.MakePod(f"d-{i}").req(
        {"cpu": f"{100 + 17 * i}m", "memory": f"{37 + 3 * i}Mi"}).obj() for i in range(40)],
        consume=True)
    sched.run_until_idle()
    assert fed and all(fed)
    tc = sched._tensor_cache
    snap = sched.cache.update_snapshot()
    cluster, _changed = tc.cluster_tensors(snap)
    views = tc.device_views(cluster, "cpu")
    fresh = tz.build_cluster_tensors(snap)
    for f in tz.TensorCache.DEVICE_FIELDS:
        assert np.array_equal(getattr(cluster, f), getattr(fresh, f)), f
        assert np.array_equal(views[f].numpy(), getattr(fresh, f)), f
    sched.stop()


def test_host_port_batches_skip_the_assume_feed():
    store, sched = _build("port", batch_size=16)
    _cluster(store, tt, n=4)
    sched.sync()
    fed = []
    tc = sched._tensor_cache
    orig = tc.apply_assume_deltas
    tc.apply_assume_deltas = lambda *a, **k: fed.append(1) or orig(*a, **k)
    # one port for all (distinct new ports in one batch hit the JAX package's
    # port-vocabulary fault, ROADMAP.md queue 3)
    store.create_many("pods", [tt.MakePod(f"h-{i}").req({"cpu": "1"}, host_port=8000)
                               .obj() for i in range(4)], consume=True)
    sched.run_until_idle()
    assert not fed and sched.cache.columnar_rows() == 0
    snap = sched.cache.update_snapshot()
    cluster, _ = tc.cluster_tensors(snap)
    fresh = tz.build_cluster_tensors(snap)
    assert np.array_equal(cluster.used, fresh.used)
    sched.stop()


# -- bind retry and the supervised worker (JAX tests/test_chaos.py) -------------------


def _chaos(pkg, n_nodes=4, **kw):
    m = jt if pkg == "jax" else tt
    kw.setdefault("batch_size", 64)
    kw.setdefault("pod_initial_backoff", 0.01)
    kw.setdefault("pod_max_backoff", 0.05)
    store, sched = _build(pkg, **kw)
    for i in range(n_nodes):
        store.create("nodes", m.MakeNode(f"node-{i}").capacity(
            {"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
    sched.sync()
    return m, (jfi if pkg == "jax" else tfi), store, sched


def _batch(pkg, sched):
    return sched.schedule_batch(timeout=0.0) if pkg == "jax" else sched.schedule_batch()


def _drive(store, sched, want, deadline_s=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        sched.run_until_idle()
        sched.queue.flush_backoff_completed()
        sched.queue.move_all_to_active_or_backoff()
        bound = sum(1 for p in store.list("pods")[0] if p.spec.node_name)
        if bound >= want:
            return bound
        time.sleep(0.01)
    return sum(1 for p in store.list("pods")[0] if p.spec.node_name)


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_bind_failures_within_the_retries_are_absorbed(pkg, count):
    """store.bind_many=fail:count=k with k <= bind_retries: every pod binds,
    nothing is logged, no assume is left, k retries are counted."""
    m, fi, store, sched = _chaos(pkg, bind_retries=3, bind_retry_base_s=0.001)
    store.create_many("pods", _pods(m, 6, "tr"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("store.bind_many", "fail", count=count)])
    assert _batch(pkg, sched) == 6
    sched.flush_binds()
    assert sched.take_bind_failures() == []
    assert sched.scheduled_count == 6 and sched.cache.assumed_count() == 0
    m.assert_pod_conservation(store, sched, [f"default/tr-{i}" for i in range(6)])
    if pkg == "port":
        assert sched.retry_counts["bind"] == count
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_bind_retries_exhausted_requeue_and_log(pkg):
    """k > bind_retries: the pods are forgotten, requeued and logged, none
    is lost; disarmed, they all bind."""
    m, fi, store, sched = _chaos(pkg, bind_retries=1, bind_retry_base_s=0.001)
    store.create_many("pods", _pods(m, 4, "ex"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("store.bind_many", "fail", count=50)])
    assert _batch(pkg, sched) == 4
    sched.flush_binds()
    failures = sched.take_bind_failures()
    assert sorted(k for k, _ in failures) == [f"default/ex-{i}" for i in range(4)]
    assert all("injected fault" in msg for _k, msg in failures)
    assert sched.scheduled_count == 0 and sched.cache.assumed_count() == 0
    rep = m.assert_pod_conservation(store, sched, [f"default/ex-{i}" for i in range(4)])
    assert rep["counts"]["pending"] == 4
    fi.disarm()
    assert _drive(store, sched, 4) == 4
    sched.stop()


def test_bind_failure_log_is_bounded():
    m, fi, store, sched = _chaos("port")
    pods = _pods(m, 8, "bl")
    store.create_many("pods", pods)
    sched.pump_events()
    from collections import deque

    from kubernetes_tpu_torch.scheduler.framework import Status

    sched.bind_failures = deque(maxlen=5)
    with sched._bind_err_lock:
        for p in pods:
            sched._bind_errors.append((QueuedPodInfo(pod=p), Status.error("boom")))
    sched._drain_bind_results()
    assert len(sched.bind_failures) == 5 and sched.bind_failures_dropped == 3
    assert [k for k, _m in sched.take_bind_failures()] == [f"default/bl-{i}"
                                                            for i in range(3, 8)]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_escaped_worker_exception_retries_the_chunk_once(pkg):
    m, fi, store, sched = _chaos(pkg)
    store.create_many("pods", _pods(m, 6, "sw"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("bind.worker", "fail", count=1)])
    assert _batch(pkg, sched) == 6
    sched.flush_binds()
    assert sched.take_bind_failures() == []
    assert sched.scheduled_count == 6 and sched.bind_worker_restarts >= 1
    m.assert_pod_conservation(store, sched, [f"default/sw-{i}" for i in range(6)])
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_second_escape_fails_the_pods_without_livelock(pkg):
    m, fi, store, sched = _chaos(pkg)
    store.create_many("pods", _pods(m, 5, "s2"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("bind.worker", "fail", count=2)])
    assert _batch(pkg, sched) == 5
    sched.flush_binds()
    failures = sched.take_bind_failures()
    assert len(failures) == 5 and all("failed twice" in msg for _k, msg in failures)
    assert sched.cache.assumed_count() == 0
    fi.disarm()
    assert _drive(store, sched, 5) == 5
    m.assert_pod_conservation(store, sched, [f"default/s2-{i}" for i in range(5)])
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_killed_worker_is_recovered(pkg):
    """A FaultKill kills the worker with its chunk in flight; the liveness
    check requeues the chunk, settles the join debt and restarts the worker:
    flush_binds returns and every pod binds."""
    m, fi, store, sched = _chaos(pkg)
    store.create_many("pods", _pods(m, 6, "kl"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("bind.worker", "kill")])
    assert _batch(pkg, sched) == 6
    t0 = time.monotonic()
    sched.flush_binds()
    assert time.monotonic() - t0 < 5.0
    sched._drain_bind_results()
    assert sched.bind_worker_restarts >= 1
    assert _drive(store, sched, 6) == 6
    m.assert_pod_conservation(store, sched, [f"default/kl-{i}" for i in range(6)])
    sched.stop()


@pytest.mark.parametrize("enqueue_first", [False, True], ids=["drain", "enqueue"])
def test_dead_worker_detected_on_the_next_drain_or_enqueue(enqueue_first):
    m, fi, store, sched = _chaos("port")
    store.create_many("pods", _pods(m, 5, "dw"))
    sched.pump_events()
    fi.arm([fi.FaultPlan("bind.worker", "kill")])
    assert sched.schedule_batch() == 5
    for _ in range(400):
        w = sched._bind_worker
        if w is not None and not w.is_alive():
            break
        time.sleep(0.005)
    assert not sched._bind_worker.is_alive()
    fi.disarm()
    if enqueue_first:
        sched._bind_q.put([])
        sched._ensure_bind_worker()
        assert sched.bind_worker_restarts >= 1
        done = threading.Event()
        threading.Thread(target=lambda: (sched.flush_binds(), done.set()), daemon=True).start()
        assert done.wait(10.0)
    else:
        sched._drain_bind_results()
        assert sched.bind_worker_restarts >= 1
    assert _drive(store, sched, 5) == 5
    tt.assert_pod_conservation(store, sched, [f"default/dw-{i}" for i in range(5)])
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_native_commit_fault_is_absorbed(pkg):
    m, fi, store, sched = _chaos(pkg, bind_retry_base_s=0.001)
    sched.bind_chunk = 16
    store.create_many("pods", _pods(m, 48, "nc"))
    fi.arm([fi.FaultPlan("native.commit", "fail", count=2)])
    sched.run_until_idle()
    fi.disarm()
    sched.flush_binds()
    assert sched.scheduled_count == 48 and sched.take_bind_failures() == []
    m.assert_pod_conservation(store, sched, [f"default/nc-{i}" for i in range(48)])
    sched.stop()


# -- crash resync (JAX TestCrashResync) ----------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_resync_rebuilds_from_the_store(pkg):
    m, fi, store, sched = _chaos(pkg, n_nodes=4)
    store.create_many("pods", _pods(m, 10, "rb"))
    sched.pump_events()
    assert _batch(pkg, sched) == 10
    sched.flush_binds()
    store.create_many("pods", _pods(m, 5, "pend"))
    store.create("pods", m.MakePod("stale").req({"cpu": "100m"}).obj())
    sched.pump_events()
    qp = None
    for q in sched.queue.pop_batch(64, timeout=0.0) if pkg == "jax" else \
            sched.queue.pop_batch(64):
        if q.pod.metadata.name == "stale":
            qp = q
        else:
            sched.queue.add(q.pod)
    clone = j_structural_clone if pkg == "jax" else pod_structural_clone
    sched.cache.assume_pod(clone(qp.pod), "node-0")
    assert sched.cache.assumed_count() == 1
    counts = sched.resync_from_store()
    assert counts == {"nodes": 4, "bound": 10, "pending": 6, "dropped_assumes": 1}
    assert sched.cache.pod_count() == 10 and sched.cache.assumed_count() == 0
    assert len(sched.queue.tracked_keys()) == 6
    assert _drive(store, sched, 16) == 16
    sched.stop()


# -- assume expiry (JAX test_gang.py test_expired_assumes_count_back_out_of_quorum) ----


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_expired_assumes_count_back_out_of_quorum(pkg):
    """An assumed gang member whose bind never confirms expires on the fake
    clock: out of the cache, out of the gang's placed set, back in the queue
    and re-staged under its gang; the same in both packages."""
    m = jt if pkg == "jax" else tt
    clock = (JFakeClock if pkg == "jax" else TFakeClock)()
    store, sched = _build(pkg, clock=clock, batch_size=1024, solver="fast",
                          **({} if pkg == "port" else {"pipeline_binds": False}))
    for i in range(4):
        store.create("nodes", m.MakeNode(f"node-{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "110"}).obj())
    store.create("podgroups", m.make_pod_group("train", 2))
    sched.sync()
    store.create("pods", m.MakePod("exp-0").gang("train").req({"cpu": "1"}).obj())
    sched.pump_events()
    assumed = store.get("pods", "default/exp-0")
    sched.queue.delete_key("default/exp-0")
    sched.cache.assume_pod(assumed, "node-0")
    sched.cache.finish_binding(assumed)
    sched.gangs.note_assumed(assumed)
    assert sched.gangs.placed_count("default/train") == 1
    clock.step(sched.cache._ttl - 1)
    assert sched.sweep_expired_assumes() == []
    clock.step(2)
    assert sched.sweep_expired_assumes() == ["default/exp-0"]
    assert sched.gangs.placed_count("default/train") == 0
    assert sched.gangs.quorum_expired_count(sched.cache.contains) == 0
    assert "default/exp-0" in sched.queue.tracked_keys()
    assert sched.queue.gang_staged_count() == 1
    assert not sched.cache.contains("default/exp-0")
    sched.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unconfirmed_bind_expires_and_requeues(pkg):
    """A batch whose binds are lost (the store rejects every bind_many and
    the retries are exhausted) leaves nothing assumed; an assume whose
    confirmation never comes (the per-pod oracle path with the watch
    stopped) expires after the TTL and its pod, still pending in the store,
    re-enters the queue: the same keys in both packages."""
    out = {}
    for p in ("port", "jax"):
        m = jt if p == "jax" else tt
        clock = (JFakeClock if p == "jax" else TFakeClock)()
        store, sched = _build(p, clock=clock, batch_size=64, columnar=False,
                              pipeline_binds=False)
        for i in range(2):
            store.create("nodes", m.MakeNode(f"node-{i}").capacity({"cpu": "8"}).obj())
        sched.sync()
        pods = _pods(m, 3, "u")
        store.create_many("pods", pods)
        sched.pump_events()
        # the store binds, but the scheduler never sees the confirmations:
        # assume + finish_binding start the TTL
        qps = sched.queue.pop_batch(64, timeout=0.0) if p == "jax" else sched.queue.pop_batch(64)
        for q in qps:
            a = (pod_structural_clone if p == "port" else j_structural_clone)(q.pod)
            sched.cache.assume_pod(a, "node-1")
            sched.cache.finish_binding(a)
        clock.step(sched.cache._ttl + 1)
        expired = sorted(sched.sweep_expired_assumes())
        out[p] = (expired, sorted(sched.queue.tracked_keys()), sched.cache.assumed_count())
        sched.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == [f"default/u-{i}" for i in range(3)] == out["port"][1]


# -- locks ------------------------------------------------------------------------------


def test_pipeline_under_the_lock_order_checker():
    """The whole default pipeline (the bind worker, the native commit, the
    scatter-add outside every lock) with the store's lock-order checker on:
    no rank inversion."""
    store, sched = _build("port", store_kw={"lock_order_check": True}, batch_size=32,
                          solver="fast")
    _cluster(store, tt)
    sched.sync()
    store.create_many("pods", _pods(tt, 160, "lk"), consume=True)
    sched.run_until_idle()
    assert sum(1 for p in store.list("pods")[0] if p.spec.node_name) == 160
    sched.stop()


def test_defaults_are_the_jax_pipeline_and_the_entry_point_stays_on_the_card():
    """BatchScheduler() defaults to the card (raising without one) and to the
    JAX package's host commit: columnar rows, pipelined binds, three bind
    retries from 0.05 s, the native commit."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            TBatch(TStore())
    sched = TBatch(TStore(), device="cpu")
    assert sched.pipeline_binds and sched.columnar and sched.bind_retries == 3
    assert sched.bind_retry_base_s == 0.05 and sched.watch_coalesce
    assert sched.store._native_commit


def test_bind_workers_under_thread_stress_lose_no_update():
    """More threads than cores and a short switch interval: six schedulers,
    each driven by its own thread with its own bind worker, in small batches
    and small bind chunks. Every pod binds exactly once, every bind is
    counted once, no assume is left (a lost update of the shared counters
    or the cache would break one of these)."""
    import os
    import sys

    n_sched = max(6, (os.cpu_count() or 4) // 2 + 1)
    envs = []
    for k in range(n_sched):
        store, sched = _build("port", batch_size=12, bind_retry_base_s=0.001)
        sched.bind_chunk = 5
        _cluster(store, tt, n=4)
        sched.sync()
        store.create_many("pods", _pods(tt, 90, f"st{k}"), consume=True)
        envs.append((store, sched))
    errors = []

    def drive(sched):
        try:
            sched.run_until_idle()
        except Exception as e:  # reported below: a worker must not die silently
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=drive, args=(s,), daemon=True) for _st, s in envs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        sys.setswitchinterval(old)
    for k, (store, sched) in enumerate(envs):
        keys = [f"default/st{k}-{i}" for i in range(90)]
        rep = tt.assert_pod_conservation(store, sched, keys)
        assert rep["counts"]["bound"] == 90 and sched.scheduled_count == 90
        assert sched.cache.assumed_count() == 0 and len(_transitions(store)) == 90
        sched.stop()
