"""The port's lock-graph witness (store/lockgraph.py) and the ordered
locks that record into it (store/store.py _OrderedRLock), held against the
JAX package's.

The JAX witness is gated for the whole run by tests/conftest.py; the port's
is its own object, so its gate is a test here: a partitioned run with the
lock-order check on leaves the port's witness clean, with the same edge set
the JAX witness records for the same drive. Seeded inversions and cycles
give the same diff in both packages. Tolerance 0.
"""

import importlib
import json

import pytest

PKGS = ("jax", "port")
HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


def mods(name):
    root = "kubernetes_tpu" if name == "jax" else "kubernetes_tpu_torch"
    return {m: importlib.import_module(f"{root}.{m}")
            for m in ("store", "store.store", "store.lockgraph", "testing",
                      "scheduler.partition", "scheduler.runtime", "scheduler.plugins")}


M = {name: mods(name) for name in PKGS}


@pytest.fixture
def fresh_witnesses(monkeypatch):
    """A fresh witness a package for the test (the ordered locks pick the
    module's WITNESS up at construction)."""
    out = {}
    for name in PKGS:
        lg = M[name]["store.lockgraph"]
        w = lg.LockGraphWitness()
        monkeypatch.setattr(lg, "WITNESS", w)
        out[name] = w
    return out


def drive(name, concurrent):
    """A partitioned run on a lock-order-checked store: hash shards, plain
    pods, and a zone-spread group for the residual pass."""
    m = M[name]
    t = m["testing"]
    store = m["store"].APIStore(lock_order_check=True)
    for i in range(12):
        store.create("nodes", t.MakeNode(f"node-{i}").labels(
            {HOST: f"node-{i}", ZONE: f"zone-{i % 3}"}).capacity(
            {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
    Framework = m["scheduler.runtime"].Framework
    plugins = m["scheduler.plugins"].default_plugins
    kw = {"device": "cpu"} if name == "port" else {}
    ps = m["scheduler.partition"].PartitionedScheduler(
        store, lambda: Framework(plugins()), partitions=2, batch_size=128, solver="fast",
        concurrent=concurrent, **kw)
    ps.sync()
    pods = [t.MakePod(f"p-{i}").req({"cpu": "500m", "memory": "1Gi"}).obj() for i in range(80)]
    pods += [t.MakePod(f"sp-{i}").labels({"app": "s"}).req({"cpu": "100m"})
             .topology_spread(1, ZONE, "DoNotSchedule", {"app": "s"}).obj() for i in range(6)]
    store.create_many("pods", pods, consume=True)
    ps.run_until_idle()
    ps.flush_binds()
    placed = sorted((p.key, p.spec.node_name) for p in store.list("pods")[0])
    ps.stop()
    return placed


def edge_view(w):
    return sorted((e["held"], e["held_rank"], e["acquired"], e["acquired_rank"])
                  for e in w.edges.values())


def diff_view(d):
    return {"edges": d["edges"], "clean": d["clean"], "unknown_edges": d["unknown_edges"],
            # the reason's wording names each package's own ordering table
            "violations": [(v["edge"], v["why"].split(" (")[0], v["reverse_stack"] is not None)
                           for v in d["violations"]],
            "cycles": [(c["cycle"], sorted(c["stacks"])) for c in d["cycles"]]}


@pytest.mark.parametrize("concurrent", [False, True])
def test_partitioned_run_leaves_the_witness_clean_with_jax_edges(fresh_witnesses, concurrent):
    placed = {name: drive(name, concurrent) for name in PKGS}
    assert placed["jax"] == placed["port"]
    assert all(n for _k, n in placed["port"])
    wj, wt = fresh_witnesses["jax"], fresh_witnesses["port"]
    assert edge_view(wt) == edge_view(wj)
    assert ("_lock (global RV)", 0, "_pods_lock (pods shard)", 1) in edge_view(wt)
    d = wt.diff()
    assert d["clean"] and d["violations"] == [] and d["cycles"] == []
    assert diff_view(d) == diff_view(wj.diff())
    assert "CLEAN against the ordering table" in wt.render()


def test_order_tables_match():
    assert M["port"]["store.lockgraph"].ORDER_TABLE == M["jax"]["store.lockgraph"].ORDER_TABLE


def test_seeded_inversion_and_cycle_diff_like_jax():
    got = {}
    for name in PKGS:
        w = M[name]["store.lockgraph"].LockGraphWitness()
        w.record("_lock (global RV)", 0, "_pods_lock (pods shard)", 1)
        w.record("_pods_lock (pods shard)", 1, "_nodes_lock (nodes shard)", 2)
        w.record("_pods_lock (pods shard)", 1, "_lock (global RV)", 0)  # inversion
        w.record("_pods_lock (pods shard)", 1, "_lock (global RV)", 0)
        w.record("scratch-a", -1, "scratch-b", -1)
        w.record("scratch-b", -1, "scratch-a", -1)  # an unranked cycle
        got[name] = (diff_view(w.diff()), w.diff()["acquisitions"], edge_view(w))
        text = w.render()
        assert "INVERSION: _pods_lock (pods shard) -> _lock (global RV)" in text
        assert "CYCLE:" in text
        w.clear()
        assert w.diff()["edges"] == 0 and w.diff()["clean"]
    assert got["jax"] == got["port"]
    d = got["port"][0]
    assert not d["clean"] and len(d["violations"]) == 1 and d["violations"][0][2] is True
    assert len(d["cycles"]) == 2
    assert d["unknown_edges"] == ["scratch-a -> scratch-b", "scratch-b -> scratch-a"]
    assert got["port"][1] == 6


def test_ordered_locks_record_edges_and_raise_on_inversion(fresh_witnesses):
    got = {}
    for name in PKGS:
        ss = M[name]["store.store"]
        store = M[name]["store"].APIStore(lock_order_check=True)
        with store._lock:
            with store._pods_lock:
                with store._pods_lock:  # reentrant: no edge, no raise
                    pass
        with store._pods_lock:
            with pytest.raises(ss.LockOrderViolation):
                store._lock.acquire()
        got[name] = edge_view(fresh_witnesses[name])
    assert got["jax"] == got["port"] == [("_lock (global RV)", 0,
                                          "_pods_lock (pods shard)", 1)]


def test_export_and_as_dict(tmp_path):
    lg = M["port"]["store.lockgraph"]
    w = lg.LockGraphWitness()
    w.record("_lock (global RV)", 0, "_nodes_lock (nodes shard)", 2)
    path = tmp_path / "graph.json"
    w.export(str(path))
    doc = json.loads(path.read_text())
    assert doc["order_table"] == lg.ORDER_TABLE
    assert doc["edges"][0]["acquired"] == "_nodes_lock (nodes shard)"
    assert doc["diff"]["clean"] is True
    assert w.as_dict()["diff"] == doc["diff"]


def test_port_witness_of_this_process_is_clean():
    """The port's run-wide gate: every lock-order-checked store of the port
    built in this process so far (tests/conftest.py turns the check on for
    every store) left the port's WITNESS without an inversion or cycle."""
    w = M["port"]["store.lockgraph"].WITNESS
    d = w.diff()
    assert d["clean"], w.render()
