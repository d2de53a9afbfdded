"""The port's API store against the JAX package's, exactly.

Seeded numpy op scripts run through both stores (columnar and dict): creates,
updates with a stale resourceVersion, guaranteed_update, deletes,
delete_pods with misses and duplicates, update_pod_status, bind_many with
raced, not-found and already-bound rows, single binds, generic kinds and
transaction(), watch resumes from inside a bind batch and from below the
history floor. Both must give the same RV sequence, the same errors, and the
same per-object and coalesced event streams. Also: a replay larger than the
watch buffer and the history bound's floor (the two faults the port had),
ring and terminating watches with their drop counts by reason, the
lock-order check, is_bind_conflict and the mutation detector's verdicts.
"""

import numpy as np
import pytest

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.chaos.faultinject as jfi
import kubernetes_tpu.store as jstore_mod
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.chaos.faultinject as tfi
import kubernetes_tpu_torch.store as tstore_mod
import kubernetes_tpu_torch.testing as tt

PKGS = {"jax": (jstore_mod, jt, jfi), "port": (tstore_mod, tt, tfi)}


def make_store(pkg, **kw):
    mod = PKGS[pkg][0]
    if pkg == "jax":
        kw.setdefault("native_commit", False)  # the Python commit loops
    return mod.APIStore(**kw)


# -- normalized views of objects and events ---------------------------------------


def obj_sig(o):
    if o is None:
        return None
    m = o.metadata
    out = (type(o).__name__, m.namespace, m.name, m.resource_version,
           tuple(sorted(m.labels.items())))
    if type(o).__name__ == "Pod":
        out += (o.spec.node_name, o.status.phase)
    return out


def ev_sig(ev):
    if type(ev).__name__ == "CoalescedEvent":
        return ("coalesced", ev.type, ev.kind, ev.resource_version, ev.origin,
                len(ev.events), tuple(ev_sig(e) for e in ev.events))
    return (ev.type, ev.kind, ev.resource_version, obj_sig(ev.obj), obj_sig(ev.prev))


# -- seeded op scripts --------------------------------------------------------------

OPS = ("create_pod", "create_node", "create_generic", "create_many", "update",
       "update_stale", "guaranteed_update", "delete", "delete_pods", "status",
       "bind_many", "bind", "txn", "txn_pods", "watch_since", "list")


def op_script(seed, n_ops=70, names=14):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        op = OPS[int(rng.integers(len(OPS)))]
        pick = [f"p{int(i)}" for i in rng.integers(0, names, size=6)]
        nodes = [f"n{int(i)}" for i in rng.integers(0, 4, size=6)]
        ops.append((op, pick, nodes, int(rng.integers(0, 1000)), int(rng.integers(1, 12))))
    return ops


def run_script(pkg, ops, columnar, history_limit=50_000):
    mod, testing, _fi = PKGS[pkg]
    store = make_store(pkg, columnar=columnar, history_limit=history_limit)
    per = store.watch(maxsize=0)
    coal = store.watch(maxsize=0, coalesce=True)
    out = []

    def label_of(o, v):
        o.metadata.labels["v"] = str(v)
        return o

    def status_phase(v):
        def mut(st):
            st.phase = ("Pending", "Running", "Succeeded")[v % 3]
        return mut

    for op, pick, nodes, v, k in ops:
        try:
            if op == "create_pod":
                res = obj_sig(store.create("pods", testing.MakePod(pick[0]).priority(v % 5).obj()))
            elif op == "create_node":
                res = obj_sig(store.create("nodes", testing.MakeNode(nodes[0]).obj()))
            elif op == "create_generic":
                res = obj_sig(store.create("widgets", testing.make_pod_group(pick[0], k)))
            elif op == "create_many":
                res = store.create_many("pods", [testing.MakePod(n).obj() for n in pick[:k % 6 + 1]],
                                        origin="o" if v % 2 else None)
            elif op == "update":
                res = obj_sig(store.update("pods", label_of(store.get("pods", f"default/{pick[0]}"), v)))
            elif op == "update_stale":
                a = store.get("pods", f"default/{pick[0]}")
                b = store.get("pods", f"default/{pick[0]}")
                store.update("pods", label_of(a, v))
                res = obj_sig(store.update("pods", label_of(b, v + 1)))
            elif op == "guaranteed_update":
                res = obj_sig(store.guaranteed_update("pods", f"default/{pick[0]}",
                                                      lambda o: label_of(o, v)))
            elif op == "delete":
                kind = ("pods", "widgets", "nodes")[v % 3]
                key = nodes[0] if kind == "nodes" else f"default/{pick[0]}"
                res = obj_sig(store.delete(kind, key))
            elif op == "delete_pods":
                keys = [f"default/{n}" for n in pick[:k % 5 + 1]] + [f"default/{pick[0]}"]
                res = store.delete_pods(keys, origin="o" if v % 2 else None)
            elif op == "status":
                res = obj_sig(store.update_pod_status("default", pick[0], status_phase(v)))
            elif op == "bind_many":
                triples = [("default", n, nodes[i]) for i, n in enumerate(pick[:k % 6 + 1])]
                triples.append(("default", pick[0], nodes[-1]))  # raced duplicate
                triples.append(("default", "ghost", nodes[0]))  # not found
                res = store.bind_many(triples, origin="o" if v % 2 else None)
            elif op == "bind":
                res = obj_sig(store.bind("default", pick[0], nodes[0]))
            elif op == "txn":
                with store.transaction():
                    o = store.get("pods", f"default/{pick[0]}")
                    res = obj_sig(store.update("pods", label_of(o, v)))
            elif op == "txn_pods":
                with store.transaction("pods"):
                    res = [obj_sig(store.get("pods", f"default/{n}")) for n in pick[:2]]
            elif op == "watch_since":
                w = store.watch(kind=("pods", "widgets") if v % 2 else None,
                                since_rv=max(0, store.resource_version() - 3 * k),
                                coalesce=bool(v % 3 == 0), maxsize=0)
                res = [ev_sig(e) for e in w.drain()]
                w.stop()
            else:  # list
                items, rv = store.list(("pods", "nodes", "widgets")[v % 3])
                res = (sorted(obj_sig(o) for o in items), rv)
            out.append((op, "ok", res))
        except Exception as e:  # the errors are part of the contract
            out.append((op, type(e).__name__, str(e)))
    history = [ev_sig(e) for e in store.history_events()]
    return {"ops": out, "rv": store.resource_version(), "kinds": sorted(store.kinds()),
            "per": [ev_sig(e) for e in per.drain()], "coal": [ev_sig(e) for e in coal.drain()],
            "history": history, "mid": [ev_sig(e) for e in store.history_events(len(history) // 2)],
            "columnar": store.columnar}


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
@pytest.mark.parametrize("seed", range(6))
def test_op_script_matches_jax(seed, columnar):
    ops = op_script(seed)
    want = run_script("jax", ops, columnar)
    got = run_script("port", ops, columnar)
    assert got["columnar"] is want["columnar"] is columnar
    for key in ("ops", "rv", "kinds", "per", "coal", "history", "mid"):
        assert got[key] == want[key], key


def test_op_scripts_reach_every_outcome():
    """The seeds above (and the bounded-history ones below) reach the error
    paths the parity is about."""
    seen = set()
    for seed in range(6):
        seen |= {(op, st) for op, st, _ in run_script("port", op_script(seed), True)["ops"]}
    for seed in range(3):
        seen |= {(op, st) for op, st, _ in
                 run_script("port", op_script(200 + seed, n_ops=80), True, 24)["ops"]}
    assert {("update_stale", "ConflictError"), ("bind", "AlreadyBoundError"),
            ("create_pod", "AlreadyExistsError"), ("delete", "NotFoundError"),
            ("create_generic", "ok"), ("txn", "ok"), ("bind_many", "ok"),
            ("delete_pods", "ok"), ("status", "ok"), ("guaranteed_update", "ok"),
            ("watch_since", "ok"), ("watch_since", "ResourceVersionTooOldError")} <= seen


@pytest.mark.parametrize("seed", range(3))
def test_op_script_columnar_equals_dict(seed):
    """Within the port: the columnar store gives the dict store's RVs,
    errors and event streams."""
    ops = op_script(100 + seed, n_ops=90)
    a = run_script("port", ops, True)
    b = run_script("port", ops, False)
    for key in ("ops", "rv", "per", "coal", "history", "mid"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("seed", range(3))
def test_small_history_limit_matches_jax(seed):
    """A history bound of 24 events: trimming, the floor and every resume
    below it (ResourceVersionTooOldError) agree with the JAX store."""
    ops = op_script(200 + seed, n_ops=80)
    want = run_script("jax", ops, True, history_limit=24)
    got = run_script("port", ops, True, history_limit=24)
    for key in ("ops", "rv", "per", "coal", "history", "mid"):
        assert got[key] == want[key], key


# -- fault 1: a replay larger than the watch buffer ----------------------------------


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_replay_exceeding_the_watch_buffer_raises_as_in_jax(columnar):
    """12 pods, then watch(since_rv=0, maxsize=5): the JAX store raises
    ResourceVersionTooOldError before delivering anything; the port returned
    a terminated watch holding 5 events."""
    got = {}
    for pkg in PKGS:
        store = make_store(pkg, columnar=columnar)
        testing = PKGS[pkg][1]
        store.create_many("pods", [testing.MakePod(f"p{i}").obj() for i in range(12)])
        with pytest.raises(PKGS[pkg][0].ResourceVersionTooOldError) as e:
            store.watch("pods", since_rv=0, maxsize=5)
        ok = store.watch("pods", since_rv=0, maxsize=13)
        got[pkg] = (str(e.value), len(ok.drain()), ok.terminated)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("replay of 12 events from rv 0 exceeds the watch buffer (5); "
                              "relist required")
    assert got["port"][1:] == (12, False)


# -- fault 2: the history bound and the resume floor ---------------------------------


def _resume_outcomes(store, mod, rvs):
    out = []
    for rv in rvs:
        try:
            w = store.watch("pods", since_rv=rv, maxsize=0)
            out.append(len(w.drain()))
            w.stop()
        except mod.ResourceVersionTooOldError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("limit", [16, 64, 100])
def test_history_floor_and_resume_match_jax(limit):
    got = {}
    for pkg in PKGS:
        mod, testing, _ = PKGS[pkg]
        store = make_store(pkg, history_limit=limit)
        store.create_many("pods", [testing.MakePod(f"h{i}").obj() for i in range(48)])
        store.bind_many([("default", f"h{i}", f"n{i % 3}") for i in range(48)], origin="me")
        store.delete_pods([f"default/h{i}" for i in range(0, 48, 2)])
        for i in range(5):
            store.create("pods", testing.MakePod(f"late{i}").obj())
        floor = store._history_floor_rv
        got[pkg] = (floor, store._history_n,
                    _resume_outcomes(store, mod, [0, floor - 1, floor, floor + 7, store.rv]))
    assert got["port"] == got["jax"]
    assert got["port"][0] > 0 and got["port"][1] <= limit


def test_default_history_limit_after_60000_events_matches_jax():
    """One create_many of 60,000 pods: the JAX floor is rv 22,500 (trimmed to
    3/4 of the 50,000 bound); the port's deque kept 50,000 events with a
    floor of 10,000, so a resume from rv 11,000 replayed 49,000 events."""
    got = {}
    for pkg in PKGS:
        mod, testing, _ = PKGS[pkg]
        store = make_store(pkg, columnar=False)
        store.create_many("pods", [testing.MakePod(f"x{i}").obj() for i in range(60_000)],
                          consume=True)
        got[pkg] = (store._history_floor_rv,
                    _resume_outcomes(store, mod, [11_000, 22_499, 22_500, 59_990]))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 22_500
    assert "older than retained history" in got["port"][1][0]
    assert got["port"][1][2:] == [37_500, 10]


# -- ring and terminating watches, drops by reason ------------------------------------


def _drop_run(pkg):
    mod, testing, fi = PKGS[pkg]
    store = make_store(pkg)
    ring = store.watch("pods", maxsize=3, ring=True)
    term = store.watch("pods", maxsize=3)
    per = store.watch("pods", maxsize=0)
    coal = store.watch("pods", maxsize=0, coalesce=True)
    fi.arm([fi.FaultPlan("watch.deliver", "fail", count=3)])
    try:
        store.create_many("pods", [testing.MakePod(f"d{i}").obj() for i in range(6)])
        for i in range(4):
            store.create("pods", testing.MakePod(f"e{i}").obj())
        store.bind_many([("default", f"d{i}", "n0") for i in range(6)], origin="me")
    finally:
        fi.disarm()
    drained = [[ev_sig(e) for e in w.drain()] for w in (ring, term, per, coal)]
    tel = store.watch_telemetry()
    subs = [{k: v for k, v in row.items() if k != "id"} for row in tel["subscribers"]]
    return {"drained": drained, "dropped": tel["dropped"], "subs": subs,
            "ring": (ring.ring_dropped, ring.terminated), "term": term.terminated,
            "prop_count": tel["propagation"]["count"], "lag": store.watch_lag()}


def test_ring_terminating_watches_and_drop_counts_match_jax():
    want, got = _drop_run("jax"), _drop_run("port")
    assert got == want
    assert set(got["dropped"]) == {"chaos", "ring_overflow", "overflow"}
    assert got["term"] and not got["ring"][1] and got["ring"][0] > 0
    # the coalesced and per-object watchers saw the same pod deliveries less
    # the injected drops; propagation counts the dequeued events
    assert got["prop_count"] > 0


@pytest.mark.parametrize("coalesce", [True, False])
def test_resume_from_inside_a_bind_batch_matches_jax(coalesce):
    got = {}
    for pkg in PKGS:
        mod, testing, _ = PKGS[pkg]
        store = make_store(pkg)
        store.create_many("pods", [testing.MakePod(f"m{i}").obj() for i in range(8)])
        rv0 = store.rv
        store.bind_many([("default", f"m{i}", "n") for i in range(8)], origin="me")
        w = store.watch("pods", since_rv=rv0 + 3, coalesce=coalesce)
        got[pkg] = [ev_sig(e) for e in w.drain()]
    assert got["port"] == got["jax"]
    assert [e[2] for e in got["port"]] == list(range(12, 17))


# -- locks, conflicts, the mutation detector ------------------------------------------


@pytest.mark.parametrize("order", [("_lock", "_pods_lock", "_nodes_lock"),
                                   ("_pods_lock", "_nodes_lock"), ("_lock", "_nodes_lock"),
                                   ("_nodes_lock", "_pods_lock"), ("_pods_lock", "_lock"),
                                   ("_nodes_lock", "_lock")])
def test_lock_order_check_matches_jax(order):
    verdict = {}
    for pkg in PKGS:
        store = make_store(pkg, lock_order_check=True)
        held = []
        try:
            for name in order:
                getattr(store, name).acquire()
                held.append(getattr(store, name))
            verdict[pkg] = "ok"
        except PKGS[pkg][0].LockOrderViolation:
            verdict[pkg] = "violation"
        finally:
            for lk in reversed(held):
                lk.release()
        # the transaction helpers take the chain in rank order
        with store.transaction():
            with store.transaction("pods"):
                pass
    assert verdict["port"] == verdict["jax"]
    ranks = {"_lock": 0, "_pods_lock": 1, "_nodes_lock": 2}
    ascending = all(ranks[a] < ranks[b] for a, b in zip(order, order[1:]))
    assert verdict["port"] == ("ok" if ascending else "violation")


def test_is_bind_conflict_matches_jax():
    msgs = ["pod default/a is already bound to n1", "pods default/a not found",
            "injected fault at store.bind_many", "", " is already bound to "]
    assert [tstore_mod.is_bind_conflict(m) for m in msgs] == \
        [jstore_mod.is_bind_conflict(m) for m in msgs] == [True, False, False, False, True]
    for pkg in PKGS:
        store = make_store(pkg)
        store.create("pods", PKGS[pkg][1].MakePod("a").obj())
        store.bind_many([("default", "a", "n1")])
        _, errors = store.bind_many([("default", "a", "n2"), ("default", "b", "n2")])
        assert [PKGS[pkg][0].is_bind_conflict(m) for _k, m in errors] == [True, False]


MUTATIONS = {
    "none": lambda o: None,
    "label": lambda o: o.metadata.labels.update(x="1"),
    "phase": lambda o: setattr(o.status, "phase", "Failed"),
    "node_name": lambda o: setattr(o.spec, "node_name", "elsewhere"),
    "memo": lambda o: o.__dict__.update(_class_sig=("memo",)),
    "priority": lambda o: setattr(o.spec, "priority", 99),
}


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutation_detector_verdicts_match_jax(mutation, columnar):
    """Both detectors fingerprint through their package's serializer
    (api/serialize.py to_dict), so the verdicts and the error texts agree
    (uids normalized: each package mints its own)."""
    verdicts, texts = {}, {}
    for pkg in PKGS:
        mod, testing, _ = PKGS[pkg]
        store = make_store(pkg, mutation_detector=True, columnar=columnar)
        per = store.watch("pods")
        store.create_many("pods", [testing.MakePod(f"q{i}").obj() for i in range(3)])
        store.bind_many([("default", "q1", "n0")], origin="me")
        evs = per.drain()
        MUTATIONS[mutation](evs[-1].obj)  # the bind's MODIFIED event
        texts[pkg] = None
        try:
            store.check_mutations()
            verdicts[pkg] = False
        except mod.MutationDetectedError as e:
            verdicts[pkg] = True
            session = (jtypes if pkg == "jax" else ttypes)._uid_session
            texts[pkg] = tt.normalize_uids(str(e), session)
    assert verdicts["port"] == verdicts["jax"] == (mutation not in ("none", "memo"))
    assert texts["port"] == texts["jax"]
    if verdicts["port"]:
        assert "was mutated after emission" in texts["port"]
