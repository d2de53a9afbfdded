"""The port's columnar pod-row store (store/columnar.py and
APIStore._bind_many_columnar) against the port's dict store and the JAX
package's store: the same placements, RV sequence and event streams, per
object and coalesced, with the mutation detector forced on (autouse below).
Also: the lazy-row / lazy-event steady state (nothing materializes until
something reads; O(1) len of a coalesced batch), the row lifecycle, the
read-only view, the STORE_COLUMNAR kill switch and the no-numpy fallback,
the bounded history, the nodes shard's rank check, the store.bind_many and
watch.deliver faults with pod conservation, the batch scheduler's placement
parity on columnar and dict stores in both watch-coalesce modes, and the
batch path's signature capture into the store's sig column.
"""

import json

import numpy as np
import pytest

import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.chaos.faultinject as tfi
from kubernetes_tpu.scheduler import Framework
from kubernetes_tpu.scheduler.batch import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.plugins import default_plugins
from kubernetes_tpu.store import APIStore as JStore
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.store import (APIStore, CoalescedEvent, LazyBindBatch,
                                        LockOrderViolation, ResourceVersionTooOldError)
from kubernetes_tpu_torch.store import columnar as columnar_mod
from kubernetes_tpu_torch.store.store import _plain_fields, pod_structural_clone
from kubernetes_tpu_torch.testing import (MakeNode, MakePod, assert_pod_conservation,
                                          mutation_detector_guard, pod_conservation_report)


@pytest.fixture(autouse=True)
def _force_mutation_detector(monkeypatch):
    yield from mutation_detector_guard(monkeypatch)


def _dump(obj):
    return json.dumps(_plain_fields(obj), sort_keys=True, default=repr)


def _pods(n, prefix="p", m=None):
    out = []
    for i in range(n):
        p = (m or MakePod)(f"{prefix}-{i}").req({"cpu": "100m", "memory": "64Mi"}).obj()
        p.metadata.uid = f"uid-{prefix}-{i}"
        out.append(p)
    return out


def _event_sig(ev, dump=_dump):
    return (type(ev).__name__, ev.type, ev.kind, ev.resource_version,
            dump(ev.obj), dump(ev.prev) if ev.prev is not None else None)


def _stream_sig(watch, dump=_dump):
    out = []
    for ev in watch.drain():
        if type(ev).__name__ == "CoalescedEvent":
            out.append(("coalesced", ev.type, ev.kind, ev.resource_version, ev.origin,
                        tuple(_event_sig(e, dump) for e in ev.events)))
        else:
            out.append(_event_sig(ev, dump))
    return out


def _jax_dump(o):
    """A package-neutral summary (the JAX objects have the JAX serializer,
    the port's the field walk): what the two stores must agree on."""
    m = o.metadata
    return json.dumps([type(o).__name__, m.namespace, m.name, m.uid, m.resource_version,
                       sorted(m.labels.items()), o.spec.node_name, o.status.phase])


# -- store-level parity: columnar vs dict vs JAX ---------------------------------------


def _bind_workload(columnar, jax=False, neutral=False):
    """Creates, a bind batch with every error class (missing pod, duplicate
    key within one batch, a full re-bind attempt), a status write and a
    delete on columnar-bound rows, then rows, both event streams and a late
    replay."""
    m = jt.MakePod if jax else MakePod
    store = JStore(columnar=columnar, native_commit=False) if jax else APIStore(columnar=columnar)
    dump = _jax_dump if jax or neutral else _dump
    per_obj = store.watch(kind=("pods",))
    coal = store.watch(kind=("pods",), coalesce=True)
    store.create_many("pods", _pods(64, m=m), consume=True)
    per_obj.drain(), coal.drain()
    rv0 = store.rv
    triples = [("default", f"p-{i}", f"node-{i % 7}") for i in range(64)]
    triples.append(("default", "p-3", "node-9"))  # dup: raced re-check
    triples.append(("default", "ghost", "node-0"))  # missing
    bound, errors = store.bind_many(triples, origin="t")
    bound2, errors2 = store.bind_many(triples[:4], origin="t")  # all bound
    store.update_pod_status("default", "p-5", lambda st: setattr(st, "phase", "Running"))
    n_del, del_errs = store.delete_pods(["default/p-0", "default/p-1", "default/nope"],
                                        origin="t")
    rows = sorted((p.key, dump(p)) for p in store.list("pods")[0])
    late = store.watch(kind=("pods",), since_rv=rv0)
    out = (rv0, store.rv, bound, sorted(errors), bound2, sorted(errors2), n_del,
           sorted(del_errs), rows, _stream_sig(per_obj, dump), _stream_sig(coal, dump),
           _stream_sig(late, dump))
    store.check_mutations()
    return out


def test_bind_many_parity_columnar_vs_dict_vs_jax():
    a = _bind_workload(columnar=True)
    b = _bind_workload(columnar=False)
    assert a == b
    assert a[2] == 64 and len(a[3]) == 2  # bound, the two injected errors
    # against the JAX store: RVs, counts, errors, rows and the three streams
    # in the package-neutral summary
    for columnar in (True, False):
        assert _bind_workload(columnar, neutral=True) == _bind_workload(columnar, jax=True)


@pytest.mark.parametrize("coalesce", [True, False])
def test_event_streams_match_jax_field_for_field(coalesce):
    """The neutral summary of every event (class, type, kind, rv, the
    object's and prev's namespace/name/uid/rv/labels/node/phase) equals the
    JAX store's, columnar and dict, for the per-object or coalesced stream."""
    got = {}
    for jax in (True, False):
        for columnar in (True, False):
            m = jt.MakePod if jax else MakePod
            store = (JStore(columnar=columnar, native_commit=False) if jax
                     else APIStore(columnar=columnar))
            w = store.watch(kind=("pods",), coalesce=coalesce)
            store.create_many("pods", _pods(16, "s", m=m), consume=True, origin="c")
            store.bind_many([("default", f"s-{i}", f"n{i % 3}") for i in range(16)]
                            + [("default", "s-2", "n9")], origin="b")
            store.update_pod_status("default", "s-4", lambda st: setattr(st, "phase", "Running"))
            store.delete_pods(["default/s-1", "default/s-1"])
            late = store.watch(kind=("pods",), since_rv=10, coalesce=coalesce)
            got[(jax, columnar)] = (_stream_sig(w, _jax_dump), _stream_sig(late, _jax_dump))
    assert len({json.dumps(v) for v in got.values()}) == 1


@pytest.mark.parametrize("mode", ["eager", "share"])
def test_non_lazy_stores_fall_back_to_dict_path(mode):
    """The columnar commit is written against the lazy/deep-copy event
    contract: eager and share stores run the dict path end to end."""
    store = APIStore(columnar=True,
                     lazy_pod_events=(False if mode == "eager" else None),
                     deep_copy_on_write=(mode != "share"),
                     mutation_detector=(False if mode == "share" else None))
    assert store.columnar is False
    assert store.pod_columns() is None and store.columnar_stats() is None
    store.create_many("pods", _pods(8, "f"), consume=True)
    bound, errors = store.bind_many([("default", f"f-{i}", "node-0") for i in range(8)])
    assert bound == 8 and not errors


def test_no_numpy_fallback(monkeypatch):
    monkeypatch.setattr(columnar_mod, "np", None)
    store = APIStore(columnar=True)
    assert store.columnar is False
    store.create_many("pods", _pods(4, "nn"), consume=True)
    bound, errors = store.bind_many([("default", f"nn-{i}", "node-1") for i in range(4)])
    assert bound == 4 and not errors
    assert store.get("pods", "default/nn-0").spec.node_name == "node-1"


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("STORE_COLUMNAR", "0")
    assert APIStore().columnar is False and JStore().columnar is False
    monkeypatch.setenv("STORE_COLUMNAR", "1")
    assert APIStore().columnar is True is JStore().columnar


# -- the lazy steady state ---------------------------------------------------------------


def test_steady_state_is_lazy_and_len_is_o1():
    store = APIStore(mutation_detector=False)  # the detector would force-eager
    assert store.columnar
    coal = store.watch(kind=("pods",), coalesce=True)
    store.create_many("pods", _pods(32, "s"), consume=True)
    coal.drain()
    bound, errors = store.bind_many([("default", f"s-{i}", f"node-{i % 3}") for i in range(32)],
                                    origin="me")
    assert bound == 32 and not errors
    (cev,) = [c for c in coal.drain() if c.type == "MODIFIED"]
    assert isinstance(cev, CoalescedEvent) and len(cev.events) == 32
    st = store.columnar_stats()
    assert st["diverged"] == 32 and st["materialized_total"] == 0
    batch = cev.events._batch
    assert isinstance(batch, LazyBindBatch) and batch._mat is None
    evs = list(cev.events)
    assert evs[0].obj.spec.node_name == "node-0"
    assert evs[0].prev is not None and not evs[0].prev.spec.node_name
    assert list(cev.events)[0] is evs[0]
    p = store.get("pods", "default/s-1")
    assert p.spec.node_name == "node-1"
    st = store.columnar_stats()
    assert st["diverged"] == 31 and st["materialized_total"] == 1


def test_rv_watermark_without_materialization():
    store = APIStore(mutation_detector=False)
    coal = store.watch(kind=("pods",), coalesce=True)
    store.create_many("pods", _pods(10, "r"), consume=True)
    coal.drain()
    rv0 = store.rv
    store.bind_many([("default", f"r-{i}", "n") for i in range(10)], origin="me")
    (cev,) = coal.drain()
    assert cev.resource_version == rv0 + 10 == store.rv
    assert cev.events._batch._mat is None
    assert [e.resource_version for e in cev.events] == list(range(rv0 + 1, rv0 + 11))


def test_replay_mid_batch_expands_partially():
    store = APIStore()
    store.create_many("pods", _pods(8, "m"), consume=True)
    rv0 = store.rv
    store.bind_many([("default", f"m-{i}", "n") for i in range(8)], origin="me")
    mid = rv0 + 3
    evs = store.watch(kind=("pods",), since_rv=mid).drain()
    assert [e.resource_version for e in evs] == list(range(mid + 1, rv0 + 9))
    for ev in evs:
        assert ev.obj.spec.node_name == "n"
        assert _dump(ev.obj) == _dump(store.get("pods", ev.obj.key))
    store.check_mutations()


def test_materialized_rows_keep_signature_memo_refs():
    store = APIStore(mutation_detector=False)
    pods = _pods(4, "g")
    sig = ("class", "sig")
    for p in pods:
        p.__dict__["_class_sig"] = (p.spec, p.metadata.labels, sig)
    store.create_many("pods", pods, consume=True)
    view = store.pod_columns()
    assert all(s[0] is not None for s in view.sig[:4])
    store.bind_many([("default", f"g-{i}", "n") for i in range(4)], origin="me")
    assert store.get("pods", "default/g-0").spec.node_name == "n"
    live = store._objects["pods"]["default/g-0"]  # the materialized row
    assert live.spec.node_name == "n" and live.__dict__["_class_sig"][2] is sig


def test_pod_columns_view_is_read_only():
    store = APIStore()
    store.create_many("pods", _pods(3, "v"), consume=True)
    view = store.pod_columns()
    assert view.n == 3 and int((view.node_id >= 0).sum()) == 0
    with pytest.raises(ValueError):
        view.node_id[0] = 3
    with pytest.raises(ValueError):
        view.row_rv[0] = 99
    assert view.keys[:3] == [f"default/v-{i}" for i in range(3)]
    assert list(view.priority[:3]) == [0, 0, 0]


def test_columnar_row_lifecycle_create_update_delete():
    store = APIStore()
    store.create_many("pods", _pods(4, "lc"), consume=True)
    store.bind_many([("default", "lc-0", "n-0")], origin="me")
    cur = store.get("pods", "default/lc-0")  # update on a DIVERGED row
    cur.metadata.labels["x"] = "1"
    store.update("pods", cur)
    view = store.pod_columns()
    row = view.keys.index("default/lc-0")
    assert view.node_id[row] >= 0 and not view.diverged[row]
    store.delete("pods", "default/lc-1")  # frees a row; a create reuses it
    st0 = store.columnar_stats()
    store.create("pods", MakePod("lc-new").req({"cpu": "100m"}).obj())
    st1 = store.columnar_stats()
    assert st1["rows"] == st0["rows"] + 1 and st1["free"] == st0["free"] - 1
    store.bind("default", "lc-new", "n-9")  # the single bind syncs the columns
    view = store.pod_columns()
    row = view.keys.index("default/lc-new")
    assert view.node_names[view.node_id[row]] == "n-9" and not view.diverged[row]
    store.check_mutations()


def test_columnar_stats_match_jax():
    got = {}
    for jax in (True, False):
        store = JStore(native_commit=False) if jax else APIStore()
        m = jt.MakePod if jax else MakePod
        store.create_many("pods", _pods(20, "cs", m=m), consume=True)
        store.bind_many([("default", f"cs-{i}", f"n{i % 4}") for i in range(12)])
        store.get("pods", "default/cs-3")
        store.delete_pods(["default/cs-5", "default/cs-15"])
        store.create("pods", m("cs-new").obj())
        got[jax] = store.columnar_stats()
    assert got[True] == got[False]
    assert got[False]["diverged"] == 10 and got[False]["materialized_total"] == 2


# -- the bounded history and the nodes shard ------------------------------------------


def test_history_limit_bounded_default_and_relist_contract():
    s = APIStore()
    assert s._history_limit == 50_000
    s._history_limit = 64
    s.create_many("pods", _pods(48, "h"), consume=True)
    rv_early = s.rv
    s.bind_many([("default", f"h-{i}", "n") for i in range(48)], origin="me")
    s.delete_pods([f"default/h-{i}" for i in range(48)], origin="me")
    assert s._history_n <= 64 + 1
    with pytest.raises(ResourceVersionTooOldError):
        s.watch(kind=("pods",), since_rv=1)
    _pods_now, rv = s.list("pods")  # the relist contract
    w = s.watch(kind=("pods",), since_rv=rv)
    s.create("pods", MakePod("h-new").obj())
    assert [e.type for e in w.drain()] == ["ADDED"]
    assert rv_early < s._history_floor_rv <= s.rv
    s.check_mutations()


def test_nodes_shard_runtime_rank_check():
    s = APIStore(lock_order_check=True)
    with s._lock:
        with s._pods_lock:
            with s._nodes_lock:
                pass
    with s._pods_lock:
        with s._nodes_lock:
            pass
    with pytest.raises(LockOrderViolation):
        with s._nodes_lock:
            with s._pods_lock:
                pass
    with pytest.raises(LockOrderViolation):
        with s._nodes_lock:
            with s._lock:
                pass


def test_nodes_shard_concurrent_with_pod_bind_phase():
    s = APIStore()
    s.create("nodes", MakeNode("n-0").capacity({"cpu": "8"}).obj())
    s.create_many("pods", _pods(4, "nx"), consume=True)
    assert s.get("nodes", "n-0").metadata.name == "n-0"
    lists, rv = s.list_many(("pods", "nodes"))
    assert len(lists["pods"]) == 4 and len(lists["nodes"]) == 1
    with s.transaction("nodes"):
        s.update("nodes", s.get("nodes", "n-0"))
    with s.transaction():
        s.get("pods", "default/nx-0")
        s.get("nodes", "n-0")
    assert s.rv > rv


# -- faults: store.bind_many and watch.deliver ----------------------------------------


def test_chaos_bind_many_fault_against_columnar_store():
    """The fault fires before any lock: the caller's retry sees an untouched
    store."""
    store = APIStore()
    store.create_many("pods", _pods(8, "bf"), consume=True)
    rv0 = store.rv
    tfi.arm([tfi.FaultPlan("store.bind_many", "fail", count=1)])
    try:
        with pytest.raises(tfi.FaultInjected):
            store.bind_many([("default", f"bf-{i}", "n") for i in range(8)])
        assert store.rv == rv0
        assert store.columnar_stats()["bound"] == 0
        bound, errors = store.bind_many([("default", f"bf-{i}", "n") for i in range(8)])
        assert bound == 8 and not errors
    finally:
        tfi.disarm()


def _cluster(store, n=8, m=MakeNode):
    for i in range(n):
        store.create("nodes", m(f"node-{i}").capacity(
            {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_bind_many_fault_under_the_scheduler_conserves_pods(columnar):
    """An injected store.bind_many failure under the batch scheduler: the
    bind retry absorbs it (one retry counted), every pod binds exactly once
    and none is left assumed; a resync from the store then finds them all
    bound."""
    store = APIStore(columnar=columnar)
    _cluster(store)
    sched = TBatch(store, device="cpu", batch_size=256, solver="fast", bind_retry_base_s=0.001)
    sched.sync()
    pods = _pods(64, "cc")
    keys = [p.key for p in pods]
    store.create_many("pods", pods, consume=True)
    tfi.arm([tfi.FaultPlan("store.bind_many", "fail", count=1)])
    try:
        sched.run_until_idle()
    finally:
        tfi.disarm()
    rep = assert_pod_conservation(store, sched, keys)
    assert rep["counts"]["bound"] == 64 and sched.retry_counts["bind"] == 1
    assert sched.take_bind_failures() == [] and sched.cache.assumed_count() == 0
    counts = sched.resync_from_store()
    assert counts["bound"] == 64 and counts["pending"] == counts["dropped_assumes"] == 0
    sched.run_until_idle()
    rep = assert_pod_conservation(store, sched, keys)
    assert rep["counts"]["bound"] == 64
    store.check_mutations()
    sched.stop()


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_watch_deliver_drops_and_resync_conserve_pods_as_in_jax(columnar):
    """Dropped deliveries starve both schedulers of the ADDED events; both
    count the drops alike, and a resync from the store recovers every pod."""
    import kubernetes_tpu.chaos.faultinject as jfi
    from kubernetes_tpu.testing import assert_pod_conservation as j_conserve
    from kubernetes_tpu.testing import pod_conservation_report as j_report

    out = {}
    for jax in (True, False):
        fi = jfi if jax else tfi
        store = JStore(columnar=columnar, native_commit=False) if jax else APIStore(
            columnar=columnar)
        _cluster(store, m=jt.MakeNode if jax else MakeNode)
        if jax:
            sched = JBatch(store, Framework(default_plugins()), batch_size=256, solver="fast")
        else:
            sched = TBatch(store, device="cpu", batch_size=256, solver="fast")
        sched.sync()
        pods = _pods(12, "drop", m=jt.MakePod if jax else MakePod)
        keys = [p.key for p in pods]
        fi.arm([fi.FaultPlan("watch.deliver", "fail", count=1000)])
        try:
            store.create_many("pods", pods, consume=True)
            sched.pump_events()
            sched.run_until_idle()
        finally:
            fi.disarm()
        rep = (j_report if jax else pod_conservation_report)(store, sched, keys)
        dropped = store.watch_telemetry()["dropped"]
        sched.resync_from_store()
        sched.run_until_idle()
        if jax:
            sched.flush_binds()
            final = j_conserve(store, sched, keys)
        else:
            final = assert_pod_conservation(store, sched, keys)
        out[jax] = (rep["counts"], dropped, final["counts"])
        sched.stop()
    assert out[True] == out[False]
    assert out[False][0]["lost"] == 12 and out[False][1] == {"chaos": 1}
    assert out[False][2]["bound"] == 12



# -- the batch scheduler on columnar and dict stores ----------------------------------


def _run_scheduler(jax, columnar, coalesce):
    m = jt.MakePod if jax else MakePod
    store = (JStore(columnar=columnar, native_commit=False) if jax
             else APIStore(columnar=columnar))
    assert store.columnar is columnar
    _cluster(store, 16, m=jt.MakeNode if jax else MakeNode)
    if jax:
        sched = JBatch(store, Framework(default_plugins()), batch_size=1024, solver="fast",
                       columnar=coalesce)
    else:
        sched = TBatch(store, device="cpu", batch_size=1024, solver="fast")
    sched.watch_coalesce = coalesce
    sched.sync()
    store.create_many("pods", _pods(512, "e", m=m), consume=True)
    sched.run_until_idle()
    if jax:
        sched.flush_binds()
    pods, rv = store.list("pods")
    placements = sorted((p.key, p.spec.node_name) for p in pods)
    pod_rvs = sorted((p.key, p.metadata.resource_version) for p in pods)
    transitions = {}
    for ev in store.history_events():
        if ev.kind == "pods" and ev.type == "MODIFIED" and ev.obj.spec.node_name \
                and (ev.prev is None or not ev.prev.spec.node_name):
            transitions[ev.obj.key] = transitions.get(ev.obj.key, 0) + 1
    dumps = None if jax else sorted(_dump(p) for p in pods)
    store.check_mutations()
    sched.stop()
    return {"placements": placements, "rvs": pod_rvs, "rv": rv, "dumps": dumps,
            "scheduled": sched.scheduled_count, "transitions": transitions}


@pytest.mark.parametrize("coalesce", [True, False])
def test_e2e_placement_parity_columnar_vs_dict_vs_jax(coalesce):
    col = _run_scheduler(False, True, coalesce)
    dic = _run_scheduler(False, False, coalesce)
    assert col == dic
    assert col["scheduled"] == 512 and all(n == 1 for n in col["transitions"].values())
    for columnar in (True, False):
        want = _run_scheduler(True, columnar, coalesce)
        assert col["placements"] == want["placements"]
        assert col["transitions"] == want["transitions"]


# -- the batch path's signature capture ------------------------------------------------


def test_sync_preserves_captured_sig_components():
    """A re-sync from a memo-less parse must not clobber a captured sig ref."""
    store = APIStore()
    _cluster(store, 2)
    p = MakePod("keep").req({"cpu": "1"}).obj()
    store.create("pods", p)
    stored = store.get("pods", p.key)
    sig = (("sig",),)
    stored.__dict__["_req_sig"] = (stored.spec, sig)
    assert store.capture_sig_memos([stored]) == 1
    fresh = pod_structural_clone(stored)
    for k in ("_req_sig", "_class_sig", "_req_cache"):
        fresh.__dict__.pop(k, None)
    fresh.status.phase = "Running"
    store.update("pods", fresh)
    view = store.pod_columns()
    ent = view.sig[view.key2row[p.key]]
    assert ent is not None and ent[1] is not None and ent[1][1] is sig
    assert store.columnar_stats()["sig_captured"] == 1


def test_batch_path_captures_sig_memos():
    store = APIStore()
    _cluster(store, 4)
    pods = [MakePod(f"pend-{i}").req({"cpu": "1"}).obj() for i in range(4)]
    store.create_many("pods", pods, consume=True)
    sched = TBatch(store, device="cpu", solver="fast")
    sched.sync()
    sched.run_until_idle()
    assert store.columnar_stats()["sig_captured"] >= 4
    view = store.pod_columns()
    for p in pods:
        ent = view.sig[view.key2row[p.key]]
        assert ent is not None and ent[1] is not None, p.key


def test_sig_column_reseeds_a_fresh_parse():
    """build_pod_batch re-seeds a memo-less pod from the store's sig column
    when the identity anchors hold (a new Pod shell over the same spec and
    labels, as a watch delivery shares them), and the batch equals one built
    without the column."""
    import copy

    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.snapshot import tensorizer as tz

    store = APIStore()
    cache = Cache()
    for i in range(3):
        cache.add_node(MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj())
    store.create_many("pods", _pods(6, "rs"), consume=True)
    snap = cache.update_snapshot()
    cluster = tz.build_cluster_tensors(snap)
    primed = [store._objects["pods"][f"default/rs-{i}"] for i in range(6)]
    tz.build_pod_batch(primed, snap, cluster)  # primes the memos
    assert store.capture_sig_memos(primed) == 6
    fresh = [copy.copy(p) for p in primed]
    for p in fresh:
        for k in tz.SIG_MEMO_KEYS:
            p.__dict__.pop(k, None)
    seeded = tz.build_pod_batch(fresh, snap, cluster, store_cols=store.pod_columns())
    for p, q in zip(fresh, primed):
        assert p.__dict__["_class_sig"] is q.__dict__["_class_sig"]
        assert p.__dict__["_req_sig"] is q.__dict__["_req_sig"]
    plain = tz.build_pod_batch([pod_structural_clone(p) for p in primed], snap, cluster)
    assert np.array_equal(seeded.class_of_pod, plain.class_of_pod)
    assert np.array_equal(seeded.req, plain.req)
