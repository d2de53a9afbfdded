"""The port's g++ host engines (kubernetes_tpu_torch/native/) against the
port's own Python loops and against the JAX package's engines.

hostcommit.cpp (the C-API loops): each entry is held byte-for-byte against
the port's Python loop it replaces — store rows, the RV sequence, the
per-object and coalesced event streams (field for field, the lazy slot
layout included) and the error lists of bind_many and delete_pods in the
three event modes; the columnar prepare; the cache's structural assume; and
build_pod_batch's fused row loop. hostsched.cpp (the array kernels):
commit_deltas against the numpy scatter-add and JAX's native_commit_deltas
(the out-of-range IndexError included), greedy_assign against JAX's
native_greedy_solve on seeded batches. Then the switches (a selected engine
whose build fails raises; HOSTSCHED_NATIVE_COMMIT=0 / native_commit=False
select the Python loops), the build location, the native.commit fault site,
and the whole pipeline with the engines on and off. Tolerance 0.
"""

import json
import random

import numpy as np
import pytest

import kubernetes_tpu.native as jnative
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.snapshot import tensorizer as jtz
from kubernetes_tpu_torch.api import compute_pod_resource_request
from kubernetes_tpu_torch.api.serialize import to_dict
from kubernetes_tpu_torch.native import hostcommit, hostsched
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.scheduler.cache import Cache
from kubernetes_tpu_torch.snapshot import tensorizer as tz
from kubernetes_tpu_torch.store import APIStore, CoalescedEvent
from kubernetes_tpu_torch.store.store import MODIFIED, pod_bind_clone, pod_structural_clone
from kubernetes_tpu_torch.testing import (MakeNode, MakePod, assert_pod_conservation,
                                          mutation_detector_guard)


@pytest.fixture(autouse=True)
def _force_mutation_detector(monkeypatch):
    yield from mutation_detector_guard(monkeypatch)


@pytest.fixture(autouse=True)
def _always_disarm():
    tfi.disarm()
    yield
    tfi.disarm()


def _dump(obj):
    return json.dumps(to_dict(obj), sort_keys=True, default=repr)


def _pods(n, prefix="p", m=MakePod):
    """Deterministic pods: fixed uids, so two builds are byte-identical."""
    out = []
    for i in range(n):
        p = m(f"{prefix}-{i}").req({"cpu": "100m", "memory": "64Mi"}).obj()
        p.metadata.uid = f"uid-{prefix}-{i}"
        out.append(p)
    return out


def _store(native, lazy=None, deep_copy=True, detector=None, columnar=False):
    store = APIStore(native_commit=native, lazy_pod_events=lazy, deep_copy_on_write=deep_copy,
                     mutation_detector=detector, columnar=columnar)
    return store, store.watch(kind=("pods",)), store.watch(kind=("pods",), coalesce=True)


def _event_sig(ev):
    """An event field for field: the instance dict's layout, the lazy slot's
    shape, the objects' contents, and whether a lazy event shares its obj
    with the commit's prev."""
    lazy = ev.lazy
    return (type(ev).__name__, tuple(ev.__dict__), ev.type, ev.kind, ev.resource_version,
            None if lazy is None else (lazy[0] is None, getattr(lazy[1], "__name__", lazy[1])),
            type(ev.commit_ts).__name__, _dump(ev.obj),
            _dump(ev.prev) if ev.prev is not None else None)


def _stream_sig(watch):
    out = []
    for ev in watch.drain():
        if isinstance(ev, CoalescedEvent):
            out.append(("coalesced", ev.type, ev.kind, ev.resource_version, ev.origin,
                        tuple(_event_sig(e) for e in ev.events)))
        else:
            out.append(_event_sig(ev))
    return out


def _rows(store):
    return sorted((k, _dump(p)) for k, p in store._objects["pods"].items())


# -- store.bind_many / delete_pods (dict rows) ------------------------------------------


@pytest.mark.parametrize("mode", ["lazy", "eager", "share"])
def test_bind_many_rows_rv_events_match_the_python_loop(mode):
    """The same script through the engine and the Python loop: rows, the RV
    sequence, the errors (a missing pod, a duplicate key, which takes the
    commit's re-validation branch, a second all-errors call) and both event
    streams are equal, in the lazy, eager and share modes."""
    results = {}
    for native in (True, False):
        store, per_obj, coal = _store(native, lazy=(mode == "lazy") if mode != "share" else None,
                                      deep_copy=(mode != "share"),
                                      detector=(False if mode == "share" else None))
        store.create_many("pods", _pods(64), consume=True)
        per_obj.drain(), coal.drain()
        rv0 = store.rv
        triples = [("default", f"p-{i}", f"node-{i % 7}") for i in range(64)]
        triples.append(("default", "p-3", "node-9"))
        triples.append(("default", "ghost", "node-0"))
        bound, errors = store.bind_many(triples, origin="t")
        bound2, errors2 = store.bind_many(triples[:4], origin="t")
        batches = coal.drain()
        if mode != "eager":
            # lazy and share events carry the stored object itself
            stored = store._objects["pods"]
            assert all(ev.obj is stored[ev.obj.key] for ev in batches[0].events)
        coal_sig = [("coalesced", c.type, c.kind, c.resource_version, c.origin,
                     tuple(_event_sig(e) for e in c.events)) for c in batches]
        results[native] = (rv0, store.rv, bound, errors, bound2, errors2, _rows(store),
                           _stream_sig(per_obj), coal_sig)
        assert bound == 64 and bound2 == 0 and len(errors) == 2
        if mode != "share":
            store.check_mutations()
    assert results[True] == results[False]


@pytest.mark.parametrize("mode", ["lazy", "eager", "share"])
def test_delete_pods_matches_the_python_loop(mode):
    results = {}
    for native in (True, False):
        store, per_obj, coal = _store(native, lazy=(mode == "lazy") if mode != "share" else None,
                                      deep_copy=(mode != "share"),
                                      detector=(False if mode == "share" else None))
        store.create_many("pods", _pods(20, "v"), consume=True)
        per_obj.drain(), coal.drain()
        n, errors = store.delete_pods([f"default/v-{i}" for i in range(10)]
                                      + ["default/missing", "default/v-2"], origin="t")
        assert n == 10
        results[native] = (store.rv, errors, sorted(store._objects["pods"]),
                           _stream_sig(per_obj), _stream_sig(coal))
        if mode != "share":
            store.check_mutations()
    assert results[True] == results[False]
    assert results[True][1] == [("default/missing", "pods default/missing not found"),
                                ("default/v-2", "pods default/v-2 not found")]


def test_engine_accepts_list_entries_like_the_python_loops():
    store, _w, _c = _store(True)
    store.create_many("pods", _pods(4, "l"), consume=True)
    bound, errors = store.bind_many([["default", f"l-{i}", "node-0"] for i in range(4)])
    assert bound == 4 and not errors
    cache = Cache()
    cache.add_node(MakeNode("node-0").capacity({"cpu": "8", "memory": "8Gi",
                                                 "pods": "110"}).obj())
    pairs = [[pod_bind_clone(p), "node-0"] for p in _pods(3, "lc")]
    assert cache.assume_pods_structural(pairs, check_ports=False) == []
    assert cache.pod_count() == 3


def test_bind_commit_raced_row_keeps_prev_alive():
    """A row replaced between the phases is re-validated and re-cloned from
    the CURRENT object, and the event's prev is that replacement (whose only
    reference the row swap drops): the engine holds its own."""
    hostcommit.load()
    pods = {"default/r-0": _pods(1, "r")[0]}
    prepared, errors, events = [], [], []
    hostcommit.bind_prepare(pods, [("default", "r-0", "node-1")], prepared, errors)
    assert len(prepared) == 1 and not errors
    repl = _pods(1, "r")[0]
    repl.metadata.uid = "uid-replacement"
    pods["default/r-0"] = repl
    del repl
    rv, bound = hostcommit.bind_commit(pods, prepared, events, errors, 10, 1, 0.0,
                                       pod_bind_clone, MODIFIED)
    assert (rv, bound) == (11, 1) and not errors
    ev = events[0]
    assert ev.prev.metadata.uid == "uid-replacement"
    assert ev.obj is pods["default/r-0"] and ev.lazy == [None, pod_bind_clone]
    assert ev.obj.spec.node_name == "node-1" and ev.obj.metadata.resource_version == 11
    prepared2, errors2 = [], []
    hostcommit.bind_prepare(pods, [("default", "r-0", "node-2")], prepared2, errors2)
    assert not prepared2 and errors2 == [("default/r-0",
                                          "pod default/r-0 is already bound to node-1")]


def _owned(pods):
    """Give pods owner references and finalizers, as a ReplicaSet's pods
    carry them."""
    for i, p in enumerate(pods):
        p.metadata.owner_references = [{"kind": "ReplicaSet", "name": f"rs-{i % 3}",
                                        "uid": f"uid-rs-{i % 3}", "controller": True}]
        p.metadata.finalizers = ["example.com/guard"] if i % 2 else []
    return pods


def test_structural_clone_copies_exactly_what_the_port_clones():
    """The engine's DELETED clone is the port's pod_structural_clone: private
    metadata, labels, annotations, owner references, finalizers, spec,
    status and conditions, everything else shared."""
    store, per_obj, _c = _store(True, lazy=False)
    store.create_many("pods", _owned(_pods(2, "s")), consume=True)
    per_obj.drain()
    old = store._objects["pods"]["default/s-1"]
    store.delete_pods(["default/s-1"])
    ev = per_obj.drain()[0]
    ref, obj = pod_structural_clone(old), ev.obj
    assert obj is not old and obj.metadata is not old.metadata
    assert obj.metadata.labels is not old.metadata.labels
    assert obj.metadata.annotations is not old.metadata.annotations
    assert obj.metadata.owner_references is not old.metadata.owner_references
    assert obj.metadata.finalizers is not old.metadata.finalizers
    assert obj.metadata.owner_references == old.metadata.owner_references != []
    assert obj.metadata.finalizers == old.metadata.finalizers == ["example.com/guard"]
    assert ref.metadata.owner_references is not old.metadata.owner_references
    assert obj.spec is not old.spec and obj.status is not old.status
    assert obj.status.conditions is not old.status.conditions
    assert obj.spec.containers is old.spec.containers
    assert sorted(vars(obj.metadata)) == sorted(vars(ref.metadata))
    assert sorted(vars(obj)) == sorted(vars(ref))


@pytest.mark.parametrize("mode", ["lazy", "eager", "share"])
def test_owned_pods_bind_and_delete_match_the_python_loop(mode):
    """Pods with owner references and finalizers through bind_many and
    delete_pods: the engine and the Python loops give equal rows, RVs and
    event streams, and the DELETED objects carry the references."""
    results = {}
    for native in (True, False):
        store, per_obj, coal = _store(native, lazy=(mode == "lazy") if mode != "share" else None,
                                      deep_copy=(mode != "share"),
                                      detector=(False if mode == "share" else None))
        store.create_many("pods", _owned(_pods(24, "o")), consume=True)
        per_obj.drain(), coal.drain()
        bound, errors = store.bind_many([("default", f"o-{i}", f"node-{i % 5}")
                                         for i in range(24)], origin="t")
        n, derr = store.delete_pods([f"default/o-{i}" for i in range(0, 24, 3)], origin="t")
        stream = _stream_sig(per_obj)
        deleted = [e for e in stream if e[2] == "DELETED"]
        assert len(deleted) == n == 8
        assert all('"ownerReferences"' in e[7] for e in deleted)
        results[native] = (store.rv, bound, errors, derr, _rows(store), stream,
                           _stream_sig(coal))
        if mode != "share":
            store.check_mutations()
    assert results[True] == results[False]


def test_delete_pods_equals_per_pod_delete():
    s_bulk, w_bulk, _ = _store(True)
    s_one, w_one, _ = _store(True)
    for s in (s_bulk, s_one):
        s.create_many("pods", _pods(6, "d"), consume=True)
    w_bulk.drain(), w_one.drain()
    keys = [f"default/d-{i}" for i in range(6)]
    s_bulk.delete_pods(keys)
    for k in keys:
        s_one.delete("pods", k)
    assert [_event_sig(e) for e in w_bulk.drain()] == [_event_sig(e) for e in w_one.drain()]


# -- the columnar store's prepare -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_columnar_prepare_matches_the_python_loop(seed):
    """PodColumns.bind_prepare(native=engine) against the Python loop on
    seeded scripts (missing pods, already-bound rows, duplicate keys, new and
    interned node names): the rows, ids, keys, rv snapshots, errors and the
    intern table are equal, and so are the whole stores after the commit."""
    out = {}
    for native in (True, False):
        store, per_obj, coal = _store(native, columnar=True)
        assert store.columnar
        store.create_many("pods", _pods(40, "c"), consume=True)
        per_obj.drain(), coal.drain()
        r = random.Random(seed)
        calls = []
        for _ in range(3):
            trip = [("default", f"c-{r.randrange(45)}", f"node-{r.randrange(6)}")
                    for _ in range(r.randrange(5, 25))]
            cols = store._cols
            errors = []
            with store._pods_lock:
                rows, ids, keys, rv_snap = cols.bind_prepare(
                    list(trip), errors, hostcommit if native else None)
            calls.append((rows.tolist(), ids.tolist(), keys, rv_snap.tolist(), errors,
                          list(cols.node_names)))
            store.bind_many(trip, origin="t")
        out[native] = (calls, store.rv, sorted(_dump(p) for p in store.list("pods")[0]),
                       _stream_sig(per_obj), _stream_sig(coal))
        store.check_mutations()
    assert out[True] == out[False]
    assert any(errors for *_r, errors, _n in out[True][0])


# -- cache and tensorizer loops ---------------------------------------------------------


def _cache_fingerprint(cache):
    out = {}
    for name, ni in cache._nodes.items():
        out[name] = (sorted(pi.pod.key for pi in ni.pods),
                     sorted(pi.pod.key for pi in ni.pods_with_affinity),
                     sorted(pi.pod.key for pi in ni.pods_with_required_anti_affinity),
                     sorted(ni.used_ports), ni.generation)
    return out, dict(cache._pod_nodes), dict(cache._assumed)


def _aff_pod(name, m=MakePod):
    return (m(name).labels({"k": "v"}).req({"cpu": "100m"})
            .pod_anti_affinity("kubernetes.io/hostname", {"k": "v"}).obj())


def test_assume_structural_matches_the_python_loop(monkeypatch):
    """The engine's assume loop against the Python loop: the failure list
    (a duplicate), NodeInfo membership with the affinity sublists, the
    bookkeeping dicts; seeded and cold request memos, a placeholder node."""
    def build(native):
        monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "1" if native else "0")
        cache = Cache()
        for i in range(4):
            cache.add_node(MakeNode(f"node-{i}").capacity(
                {"cpu": "8", "memory": "8Gi", "pods": "110"}).obj())
        pods = _pods(12, "a") + [_aff_pod(f"aff-{i}") for i in range(3)]
        pairs = [(pod_bind_clone(p), f"node-{i % 5}") for i, p in enumerate(pods)]
        for qp, _node in pairs[:6]:
            qp.__dict__["_req_cache"] = (compute_pod_resource_request(qp),
                                         compute_pod_resource_request(qp, non_zero=True))
        failed = cache.assume_pods_structural(list(pairs), check_ports=False)
        failed2 = cache.assume_pods_structural([pairs[0]], check_ports=False)
        pis = [(pi.pod.key, pi.request.milli_cpu, pi.non_zero_request.memory,
                len(pi.required_anti_affinity_terms))
               for ni in cache._nodes.values() for pi in ni.pods]
        return failed, failed2, _cache_fingerprint(cache), sorted(pis)

    got, want = build(True), build(False)
    assert got == want
    assert got[0] == [] and "already in the cache" in got[1][0][1]
    assert sum(len(v[2]) for v in got[2][0].values()) == 3


def test_build_pod_batch_rows_match_the_python_loop(monkeypatch):
    def batch_of(native):
        monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "1" if native else "0")
        cache = Cache()
        for i in range(8):
            cache.add_node(MakeNode(f"node-{i}").capacity(
                {"cpu": "8", "memory": "8Gi", "pods": "110"}).obj())
        pods = []
        for i in range(40):
            p = MakePod(f"b-{i}").req({"cpu": "100m"} if i % 3 else {"cpu": "250m"}).obj()
            p.metadata.uid = f"uid-b-{i}"
            if i % 5 == 0:
                p.metadata.labels = {"grp": f"g{i % 2}"}
            pods.append(p)
        # a pre-primed memo on some pods (the engine's memo-hit path)
        snap = cache.update_snapshot()
        cluster = tz.build_cluster_tensors(snap)
        tz.build_pod_batch(pods[:10], snap, cluster)
        batch = tz.build_pod_batch(pods, snap, cluster)
        return (batch.class_of_pod.tolist(), batch.req.tolist(), batch.req_nz.tolist(),
                batch.raw_req.tolist(), batch.raw_req_nz.tolist(),
                batch.balanced_active.tolist(), batch.class_has_host_ports.tolist(),
                [p.metadata.name for p in batch.tables.rep_pods])

    assert batch_of(True) == batch_of(False)


def test_build_pod_batch_raw_rows_match_jax():
    """The batch's raw request rows and host-port flags equal the JAX
    tensorizer's (the scatter-add's inputs)."""
    def rows(mod, tzm, cache_cls):
        cache = cache_cls()
        for i in range(3):
            cache.add_node(mod.MakeNode(f"n{i}").capacity(
                {"cpu": "8", "memory": "8Gi", "pods": "110"}).obj())
        pods = [mod.MakePod(f"q{i}").req({"cpu": f"{100 + 7 * i}m",
                                           "memory": f"{33 + i}Mi"}).obj() for i in range(9)]
        pods.append(mod.MakePod("hp").req({"cpu": "1"}, host_port=8080).obj())
        snap = cache.update_snapshot()
        b = tzm.build_pod_batch(pods, snap, tzm.build_cluster_tensors(snap))
        return b.raw_req.tolist(), b.raw_req_nz.tolist(), b.class_has_host_ports.tolist()

    assert rows(jt, jtz, JCache) == rows(tt, tz, Cache)


# -- hostsched.cpp ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_commit_deltas_match_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    p_all, p, n, r = 500, 300, 40, 4
    rows = rng.integers(0, p_all, p)
    nodes = rng.integers(0, n, p)
    raw = rng.integers(0, 1 << 40, (p_all, r)).astype(np.int64)
    raw_nz = rng.integers(0, 1 << 40, (p_all, r)).astype(np.int64)
    got = hostsched.native_commit_deltas(rows, nodes, raw, raw_nz, n)
    plain = hostsched.commit_deltas_plain(rows, nodes, raw, raw_nz, n)
    jax_native = jnative.native_commit_deltas(rows, nodes, raw, raw_nz, n)
    for a, b, c in zip(got, plain, jax_native):
        assert a.dtype == np.int64 or a.dtype == b.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("rows,nodes", [([0, 1], [0, 9]), ([0, 7], [0, 1]), ([-1], [0])])
def test_commit_deltas_out_of_range_raises_index_error_like_jax(rows, nodes):
    raw = np.ones((4, 2), dtype=np.int64)
    for fn in (hostsched.native_commit_deltas, jnative.native_commit_deltas):
        with pytest.raises(IndexError):
            fn(np.array(rows), np.array(nodes), raw, raw, 3)
    if min(rows) >= 0:  # numpy's add.at wraps a negative index, as in JAX's oracle
        with pytest.raises(IndexError):
            hostsched.commit_deltas_plain(np.array(rows), np.array(nodes), raw, raw, 3)


def _greedy_case(mod, tzm, cache_cls, seed):
    rng = random.Random(seed)
    cache = cache_cls()
    for i in range(rng.randint(5, 14)):
        mk = mod.MakeNode(f"n{i}").capacity({"cpu": str(rng.choice([2, 4, 8])),
                                             "memory": f"{rng.choice([4, 8, 16])}Gi",
                                             "pods": str(rng.choice([4, 110]))})
        if rng.random() < 0.3:
            mk = mk.labels({"disk": "ssd"})
        cache.add_node(mk.obj())
    pods = []
    for i in range(rng.randint(10, 60)):
        port = 9000 + rng.randrange(3) if rng.random() < 0.1 else 0
        mk = mod.MakePod(f"p{i}").req({"cpu": f"{rng.choice([100, 250, 500, 1000])}m",
                                       "memory": f"{rng.choice([64, 256, 1024])}Mi"},
                                      host_port=port)
        if rng.random() < 0.2:
            mk = mk.node_selector({"disk": "ssd"})
        pods.append(mk.obj())
    snap = cache.update_snapshot()
    cluster = tzm.build_cluster_tensors(snap)
    return cluster, tzm.build_pod_batch(pods, snap, cluster)


@pytest.mark.parametrize("seed", range(6))
def test_greedy_assign_matches_jax_native_solve(seed):
    cluster, batch = _greedy_case(tt, tz, Cache, seed)
    jcluster, jbatch = _greedy_case(jt, jtz, JCache, seed)
    assert hostsched.native_solvable(batch) and jnative.native_solvable(jbatch)
    got, placed = hostsched.native_greedy_solve(cluster, batch)
    want, jplaced = jnative.native_greedy_solve(jcluster, jbatch)
    assert got.dtype == np.int32 and placed == jplaced
    assert np.array_equal(got, np.asarray(want))


def test_greedy_assign_refuses_a_batch_it_does_not_model():
    cache = Cache()
    cache.add_node(tt.MakeNode("n0").capacity({"cpu": "4"}).obj())
    snap = cache.update_snapshot()
    cluster = tz.build_cluster_tensors(snap)
    pod = (tt.MakePod("s").labels({"a": "b"}).req({"cpu": "1"})
           .topology_spread(1, "kubernetes.io/hostname", "DoNotSchedule", {"a": "b"}).obj())
    batch = tz.build_pod_batch([pod], snap, cluster)
    assert not hostsched.native_solvable(batch)
    with pytest.raises(RuntimeError, match="topology-spread"):
        hostsched.native_greedy_solve(cluster, batch)


# -- switches, the build, the fault site ---------------------------------------------------


def test_engines_build_into_the_kernel_build_dir_keyed_on_the_source():
    lib = hostsched.build_so("hostsched")
    assert lib.parent == hostsched.BUILD_DIR and lib.parent.name == "torch_kernels"
    assert lib.name.startswith("libhostsched-") and lib.exists()
    assert hostsched.build_so("hostcommit", python_headers=True).name.startswith(
        "libhostcommit-")


def test_env_switch_selects_the_python_loops(monkeypatch):
    monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "0")
    assert hostcommit.selected() is False
    assert APIStore(native_commit=True)._native_commit_engine() is None
    monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "1")
    assert hostcommit.selected() is True
    monkeypatch.setenv("STORE_NATIVE_COMMIT", "0")
    assert APIStore()._native_commit_engine() is None
    monkeypatch.delenv("STORE_NATIVE_COMMIT")
    assert APIStore()._native_commit_engine() is hostcommit


def test_a_selected_engine_whose_build_fails_raises(monkeypatch):
    """No quiet fallback: where the engine is selected, a failed build
    raises with the compiler's message, at the store, the assume, the
    tensorizer and the scatter-add alike."""
    def broken(name, python_headers=False):
        raise RuntimeError(f"native build of {name}.cpp failed (g++ exit 1):\nerror: boom")

    monkeypatch.setattr(hostcommit, "_lib", None)
    monkeypatch.setattr(hostcommit, "build_so", broken)
    monkeypatch.setattr(hostsched, "_lib", None)
    monkeypatch.setattr(hostsched, "build_so", broken)
    store = APIStore(native_commit=True, columnar=False)
    store.create_many("pods", _pods(2, "f"), consume=True)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit 1"):
        store.bind_many([("default", "f-0", "node-0")])
    assert not store.get("pods", "default/f-0").spec.node_name
    cache = Cache()
    with pytest.raises(RuntimeError, match="boom"):
        cache.assume_pods_structural([(pod_bind_clone(_pods(1)[0]), "n")], check_ports=False)
    with pytest.raises(RuntimeError, match="boom"):
        hostsched.native_commit_deltas(np.zeros(1), np.zeros(1), np.ones((1, 1)),
                                       np.ones((1, 1)), 1)
    # the explicit oracles still run
    monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "0")
    assert APIStore(native_commit=False, columnar=False).bind_many([])[0] == 0
    assert cache.assume_pods_structural([(pod_bind_clone(_pods(1)[0]), "n")],
                                        check_ports=False) == []


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_native_commit_fault_leaves_the_store_untouched(columnar):
    """The native.commit site fires in bind_many's phase gap: nothing is
    committed, no event is emitted, and a plain retry binds every pod."""
    store, per_obj, coal = _store(True, columnar=columnar)
    store.create_many("pods", _pods(16, "c"), consume=True)
    per_obj.drain(), coal.drain()
    rv0 = store.rv
    tfi.arm([tfi.FaultPlan("native.commit", "fail", count=1)])
    with pytest.raises(tfi.FaultInjected):
        store.bind_many([("default", f"c-{i}", "node-0") for i in range(16)])
    assert store.rv == rv0 and not per_obj.drain() and not coal.drain()
    assert all(not p.spec.node_name for p in store.list("pods")[0])
    bound, errors = store.bind_many([("default", f"c-{i}", "node-0") for i in range(16)])
    assert bound == 16 and not errors
    tfi.arm([tfi.FaultPlan("native.commit", "fail", count=1)])
    with pytest.raises(tfi.FaultInjected):
        store.delete_pods(["default/c-0"])
    assert store.get("pods", "default/c-0").spec.node_name == "node-0"


def test_native_commit_site_does_not_fire_on_the_python_loops():
    store, _w, _c = _store(False, columnar=True)
    store.create_many("pods", _pods(4, "o"), consume=True)
    tfi.arm([tfi.FaultPlan("native.commit", "fail", count=5)])
    assert store.bind_many([("default", f"o-{i}", "n") for i in range(4)])[0] == 4
    assert store.delete_pods(["default/o-0"])[0] == 1


# -- the pipeline with the engines on and off ----------------------------------------------


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "oracle"])
def test_pipeline_with_engines_on_and_off_is_identical(columnar, monkeypatch):
    """Ingest, build_pod_batch, solve, assume, bind with every engine on and
    every engine off: the same placements, RVs and stored pods."""
    def run(native):
        monkeypatch.setenv("HOSTSCHED_NATIVE_COMMIT", "1" if native else "0")
        store = APIStore(native_commit=native)
        for i in range(16):
            store.create("nodes", MakeNode(f"node-{i}").capacity(
                {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
        sched = BatchScheduler(store, device="cpu", batch_size=128, solver="fast",
                               columnar=columnar, pipeline_binds=columnar)
        sched.sync()
        store.create_many("pods", _pods(512, "e"), consume=True)
        sched.run_until_idle()
        pods, rv = store.list("pods")
        store.check_mutations()
        sched.stop()
        return (sorted((p.key, p.spec.node_name, p.metadata.resource_version) for p in pods),
                rv, sorted(_dump(p) for p in pods), sched.scheduled_count)

    on, off = run(True), run(False)
    assert on == off and on[3] == 512


def test_native_commit_faults_under_the_bind_worker_conserve_pods():
    """Mid-chunk native.commit faults under the pipelined bind worker: the
    bind retry absorbs them and every pod binds once."""
    store = APIStore(native_commit=True)
    for i in range(8):
        store.create("nodes", MakeNode(f"node-{i}").capacity(
            {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
    sched = BatchScheduler(store, device="cpu", batch_size=256, solver="fast",
                           bind_retry_base_s=0.001)
    sched.bind_chunk = 64
    sched.sync()
    pods = _pods(256, "cc")
    keys = [p.key for p in pods]
    store.create_many("pods", pods, consume=True)
    tfi.arm([tfi.FaultPlan("native.commit", "fail", count=2)])
    sched.run_until_idle()
    tfi.disarm()
    sched.run_until_idle()
    assert_pod_conservation(store, sched, keys)
    assert sched.scheduled_count == 256 and sched.retry_counts["bind"] == 2
    assert sched.take_bind_failures() == []
    sched.stop()


def test_commit_deltas_refuses_mismatched_shapes():
    """The wrapper checks the arrays it hands the C kernel, which reads
    raw_req_nz with raw_req's layout."""
    raw = np.ones((4, 2), dtype=np.int64)
    with pytest.raises(ValueError, match="raw_req_nz"):
        hostsched.native_commit_deltas(np.array([0]), np.array([0]), raw, raw[:, :1], 3)
    with pytest.raises(ValueError, match="rows"):
        hostsched.native_commit_deltas(np.array([0, 1]), np.array([0]), raw, raw, 3)
