"""The port's multi-process scheduler (scheduler/mpsched.py, mpworker.py)
and shared-memory columns (store/shm.py, PodColumns.attach_arena,
APIStore.enable_shm / shm_close), held against the JAX package's on the
same seeded inputs on the CPU: the counterparts of tests/test_mpsched.py.

At processes=2 both packages give the same {pod: node} maps with every pod
conserved; the resourceVersions are not compared (the workers' intents
arrive in process order). processes=1 and every fallback delegate to one
thread-path BatchScheduler, byte-identical. The JAX package's rendering
test (`ktl`) becomes a shape check here: the port's CLI is ROADMAP.md queue
1 item 7g2.

Segments: the port's arenas carry the prefix "kttorch" and every test
asserts that none it made is left (the names carry the creating process's
pid, and the check reads this process's names only, so another test
process's live arenas never count). The JAX side runs here with its prefix
set to "kttorch-jax" for the test's duration (a monkeypatch of this
process), so the JAX package's own leak checks over "ktpu", which may run
at the same time in another worker, never see a segment of these tests.
Every multi-process test of the port is in this one file, so `--dist
loadfile` never runs two of them at once. Tolerance 0.
"""

import importlib
import os
import time

import pytest

import kubernetes_tpu.store.shm as jshm
import kubernetes_tpu_torch.store.shm as tshm

PKGS = ("jax", "port")
HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"

pytestmark = pytest.mark.skipif(not tshm.available(),
                                reason="shared memory / numpy unavailable")


class Pkg:
    def __init__(self, name):
        root = "kubernetes_tpu" if name == "jax" else "kubernetes_tpu_torch"

        def mod(m):
            return importlib.import_module(f"{root}.{m}")

        self.name = name
        self.t = mod("testing")
        self.store_mod = mod("store")
        self.shm = mod("store.shm")
        self.mps = mod("scheduler.mpsched")
        self.batch = mod("scheduler.batch")
        self.fi = mod("chaos.faultinject")
        self._fw = mod("scheduler.runtime").Framework
        self._plugins = mod("scheduler.plugins").default_plugins
        self.kw = {"device": "cpu"} if name == "port" else {}

    def fw(self):
        return self._fw(self._plugins())

    def store(self, nodes=0, zones=0, **kw):
        store = self.store_mod.APIStore(**kw)
        for i in range(nodes):
            labels = {HOST: f"node-{i}"}
            if zones:
                labels[ZONE] = f"zone-{i % zones}"
            store.create("nodes", self.t.MakeNode(f"node-{i}").labels(labels).capacity(
                {"cpu": "16", "memory": "64Gi", "pods": "110"}).obj())
        return store

    def mp(self, store, processes=2, **kw):
        s = self.mps.MPScheduler(store, self.fw, processes=processes, **self.kw, **kw)
        if processes >= 2:
            assert s.mode == "mp", s.fallback
        return s

    def pods(self, n, pfx="p", cpu="500m"):
        return [self.t.MakePod(f"{pfx}-{i}").req({"cpu": cpu, "memory": "1Gi"}).obj()
                for i in range(n)]


P = {name: Pkg(name) for name in PKGS}


@pytest.fixture(autouse=True)
def _jax_side_prefix(monkeypatch):
    # the JAX package's arenas made by THESE tests carry a prefix its own
    # leak checks do not scan, and the port's does
    monkeypatch.setattr(jshm, "NAME_PREFIX", tshm.NAME_PREFIX + "-jax")


@pytest.fixture(autouse=True)
def _force_mutation_detector(monkeypatch):
    gens = [P[name].t.mutation_detector_guard(monkeypatch) for name in PKGS]
    for g in gens:
        next(g)
    yield
    for g in gens:
        next(g, None)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    for p in P.values():
        p.fi.disarm()


def mine():
    """This process's live segments, the port's and the JAX side's of these
    tests (every arena name is <prefix>-<creating pid>-...)."""
    pid = os.getpid()
    return [seg for seg in tshm.leaked_segments()
            if seg.startswith((f"{tshm.NAME_PREFIX}-{pid}-", f"{tshm.NAME_PREFIX}-jax-{pid}-"))]


@pytest.fixture(autouse=True)
def _no_leaked_segments():
    yield
    assert mine() == [], f"test leaked shm segments: {mine()}"


def drain(sched):
    sched.run_until_idle()
    sched.flush_binds()


def placements(store):
    return sorted((p.key, p.spec.node_name) for p in store.list("pods")[0])


def bind_transitions(store):
    out = {}
    for ev in store.history_events():
        if ev.kind != "pods" or ev.type != "MODIFIED":
            continue
        if ev.obj.spec.node_name and (ev.prev is None or not ev.prev.spec.node_name):
            out[ev.obj.key] = out.get(ev.obj.key, 0) + 1
    return out


def both(scenario, *args, **kw):
    return {name: scenario(P[name], *args, **kw) for name in PKGS}


def test_port_prefix_is_apart_from_the_jax_package():
    assert not tshm.NAME_PREFIX.startswith("ktpu")
    assert tshm.fresh_base_name("x").startswith(tshm.NAME_PREFIX + "-")
    assert tshm.POD_COLS_SCHEMA == jshm.POD_COLS_SCHEMA
    assert tshm.NODE_COLS_SCHEMA == jshm.NODE_COLS_SCHEMA
    assert tshm.BATCH_COLS_SCHEMA == jshm.BATCH_COLS_SCHEMA


# ---------------------------------------------------------------------------
# (a) processes=1 byte-parity + the fallback matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("columnar", [True, False])
def test_processes_1_is_byte_identical(columnar):
    def run(p, build):
        store = p.store(24)
        s = build(store)
        s.sync()
        store.create_many("pods", p.pods(300), consume=True)
        drain(s)
        events = [(ev.type, ev.kind, ev.resource_version,
                   ev.obj.key if hasattr(ev.obj, "key") else None,
                   getattr(ev.obj.spec, "node_name", None) if ev.kind == "pods" else None)
                  for ev in store.history_events()]
        s.stop()
        return placements(store), events

    t, j = P["port"], P["jax"]
    kw = dict(batch_size=256, solver="fast", columnar=columnar)
    pl_a, ev_a = run(t, lambda st: t.batch.BatchScheduler(st, t.fw(), device="cpu", **kw))
    pl_b, ev_b = run(t, lambda st: t.mp(st, processes=1, **kw))
    pl_j, ev_j = run(j, lambda st: j.mp(st, processes=1, **kw))
    assert pl_a == pl_b == pl_j
    assert ev_a == ev_b == ev_j
    assert len(pl_a) == 300 and all(node for _k, node in pl_a)


def test_fallback_matrix(monkeypatch):
    def run(p):
        out = []
        store = p.store()
        out.append((p.mp(store, processes=1).mode, p.mp(store, processes=1).fallback))
        monkeypatch.setenv("SCHED_PROCESSES", "0")
        s = p.mps.MPScheduler(store, p.fw, **p.kw)
        out.append((s.mode, s.fallback))
        monkeypatch.delenv("SCHED_PROCESSES")
        with monkeypatch.context() as m:
            m.setattr(p.mps, "default_processes", lambda: 1)
            s = p.mps.MPScheduler(store, p.fw, **p.kw)
            out.append((s.mode, s.fallback))
        with monkeypatch.context() as m:
            m.setattr(p.shm, "available", lambda: False)
            s = p.mps.MPScheduler(store, p.fw, processes=2, **p.kw)
            out.append((s.mode, s.fallback))
        s = p.mps.MPScheduler(p.store(columnar=False), p.fw, processes=2, **p.kw)
        out.append((s.mode, s.fallback))
        st = s.sched_stats()["processes"]
        out.append((st["mode"], st["fallback"], st["configured"], st["workers"]))
        return out

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"] == [("thread", "requested"), ("thread", "requested"),
                           ("thread", "1-core-auto"), ("thread", "no-shm"),
                           ("thread", "no-columnar-store"),
                           ("thread", "no-columnar-store", 1, [])]


def test_pod_is_plain_gate():
    def run(p):
        mk = p.t.MakePod
        pods = [mk("a").req({"cpu": "1"}).obj(),
                mk("b").req({"cpu": "1"}).node_selector({HOST: "x"}).obj(),
                mk("c").labels({"app": "s"}).topology_spread(1, ZONE, "DoNotSchedule",
                                                             {"app": "s"}).obj(),
                mk("d").labels({"pod-group.scheduling/name": "g"}).obj(),
                mk("e").req({"cpu": "1"}, host_port=8080).obj(),
                mk("f").req({"cpu": "1", "memory": "2Gi"}).obj()]
        return [p.mps.pod_is_plain(x) for x in pods]

    got = both(run)
    assert got["jax"] == got["port"] == [True, False, False, False, False, True]


# ---------------------------------------------------------------------------
# (b) the mp path: conservation, arbitration, exactly-once
# ---------------------------------------------------------------------------


def test_mp_conservation_with_constrained_residual():
    """Plain pods through the worker processes, pinned and zone-spread pods
    through the owner's residual BatchScheduler: equal maps, conservation,
    one bind transition a pod."""
    def run(p):
        store = p.store(24, zones=4)
        sched = p.mp(store, batch_size=512, solver="fast")
        try:
            sched.sync()
            plain = p.pods(300)
            pinned = [p.t.MakePod(f"sel-{i}").req({"cpu": "100m"})
                      .node_selector({HOST: f"node-{18 + i}"}).obj() for i in range(6)]
            spread = [p.t.MakePod(f"sp-{i}").labels({"app": "s"}).req({"cpu": "200m"})
                      .topology_spread(1, ZONE, "DoNotSchedule", {"app": "s"}).obj()
                      for i in range(8)]
            store.create_many("pods", plain + pinned + spread, consume=True)
            keys = [x.key for x in plain + pinned + spread]
            drain(sched)
            rep = p.t.assert_pod_conservation(store, sched, keys)
            st = sched.sched_stats()["processes"]
            out = (placements(store), rep["counts"],
                   sum(w["binds"] for w in st["workers"]), st["residual"]["scheduled"],
                   [w["state"] for w in st["workers"]], sorted(set(bind_transitions(store)
                                                                   .values())))
            assert all(w["pid"] > 0 for w in st["workers"]) and st["rounds"] >= 1
        finally:
            sched.stop()
        return out

    got = both(run)
    assert got["jax"] == got["port"]
    pl, cons, worker_binds, residual, states, trans = got["port"]
    assert len(pl) == 314 and all(node for _k, node in pl)
    assert cons["bound"] == 314 and worker_binds == 300 and residual == 14
    assert states == ["live", "live"] and trans == [1]


def test_stale_intent_revalidation_absorbs_out_of_band_bind():
    """An intent whose rv snapshot no longer matches the live columns is
    dropped at arbitration (stale_intents), never committed."""
    def run(p):
        store = p.store(8)
        sched = p.mp(store)
        stolen = {}
        orig = sched._arbitrate

        def arbitrate(w, chunk):
            if not stolen and chunk:
                key = sched._round_keys[chunk[0][0]]
                ns, name = key.split("/", 1)
                bound, errs = store.bind_many([(ns, name, "node-0")], origin="thief")
                assert bound == 1 and not errs
                stolen["key"] = key
            return orig(w, chunk)

        sched._arbitrate = arbitrate
        try:
            sched.sync()
            pods = p.pods(60, "st")
            store.create_many("pods", pods, consume=True)
            drain(sched)
            rep = p.t.assert_pod_conservation(store, sched, [x.key for x in pods])
            return (bool(stolen), sched.stale_intents >= 1, rep["counts"],
                    sorted(set(bind_transitions(store).values())))
        finally:
            sched.stop()

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"][:2] == (True, True) and got["port"][3] == [1]


def test_bind_conflict_is_absorbed_exactly_once():
    def run(p):
        store = p.store(8)
        sched = p.mp(store)
        orig = store.bind_many
        stolen = {}

        def bind_many(bindings, origin=None, **kw):
            if origin == sched._origin and not stolen and bindings:
                ns, name, _node = bindings[0]
                orig([(ns, name, "node-1")], origin="thief")
                stolen["key"] = f"{ns}/{name}"
            return orig(bindings, origin=origin, **kw)

        store.bind_many = bind_many
        try:
            sched.sync()
            pods = p.pods(60, "cf")
            store.create_many("pods", pods, consume=True)
            drain(sched)
            rep = p.t.assert_pod_conservation(store, sched, [x.key for x in pods])
            return (bool(stolen), sched.bind_conflicts >= 1, rep["counts"],
                    sorted(set(bind_transitions(store).values())))
        finally:
            del store.bind_many
            sched.stop()

    got = both(run)
    assert got["jax"] == got["port"]
    assert got["port"][:2] == (True, True) and got["port"][3] == [1]


# ---------------------------------------------------------------------------
# (c) worker failure domain
# ---------------------------------------------------------------------------


def test_sigkilled_worker_is_detected_respawned_and_conserved():
    def run(p):
        store = p.store(16)
        sched = p.mp(store)
        try:
            sched.sync()
            pods = p.pods(200, "kk")
            store.create_many("pods", pods, consume=True)
            p.fi.arm([p.fi.FaultPlan("process.worker", "kill", count=1, match="worker-0")])
            try:
                drain(sched)
            finally:
                p.fi.disarm()
            drain(sched)
            st = sched.sched_stats()["processes"]
            rep = p.t.assert_pod_conservation(store, sched, [x.key for x in pods])
            return (st["worker_restarts"] >= 1,
                    [(w["restarts"] >= 1, w["state"]) for w in st["workers"]],
                    rep["counts"], sorted(set(bind_transitions(store).values())))
        finally:
            sched.stop()

    got = both(run)
    assert got["jax"] == got["port"]
    restarted, workers, cons, trans = got["port"]
    assert restarted and any(r for r, _s in workers)
    assert all(s == "live" for _r, s in workers)
    assert cons["bound"] == 200 and trans == [1]


def test_worker_kill_in_waves_matches_jax():
    """The chip smoke's SIGKILL leg at a small size: worker 1 is killed at
    its second round (the pods arrive in waves); a restart, and every pod
    bound once."""
    def run(p):
        store = p.store(16)
        sched = p.mp(store)
        try:
            sched.sync()
            pods = p.pods(160, "wv")
            keys = [x.key for x in pods]
            p.fi.arm([p.fi.FaultPlan("process.worker", "kill", match="worker-1", after=1)])
            try:
                for lo in range(0, 160, 40):
                    store.create_many("pods", pods[lo:lo + 40], consume=True)
                    sched.run_until_idle()
            finally:
                p.fi.disarm()
            drain(sched)
            st = sched.sched_stats()["processes"]
            rep = p.t.assert_pod_conservation(store, sched, keys)
            return st["worker_restarts"], rep["counts"], placements(store)
        finally:
            sched.stop()

    got = both(run)
    assert got["jax"] == got["port"]
    restarts, cons, pl = got["port"]
    assert restarts >= 1 and cons["bound"] == 160 and all(n for _k, n in pl)


# ---------------------------------------------------------------------------
# (d) unlink-clean teardown + observability surfaces
# ---------------------------------------------------------------------------


def test_stop_is_unlink_clean_and_idempotent():
    p = P["port"]
    store = p.store(4)
    sched = p.mp(store)
    sched.sync()
    store.create_many("pods", p.pods(20, "uc"), consume=True)
    drain(sched)
    live = mine()
    assert len(live) >= 6 and all(seg.startswith("kttorch-") for seg in live)
    sched.stop()
    sched.stop()  # idempotent
    assert mine() == []
    assert store.pod_columns() is not None and store.shm_name is None
    assert len(placements(store)) == 20 and all(n for _k, n in placements(store))


def test_sched_stats_shape():
    """The shape the JAX package's `ktl sched stats` renders (the port's CLI
    is item 7g): the processes section and its worker rows, equal key sets
    in both packages, in mp mode and in the thread fallback."""
    def run(p):
        store = p.store(4)
        sched = p.mp(store)
        try:
            sched.sync()
            store.create_many("pods", p.pods(10, "rr"), consume=True)
            drain(sched)
            st = sched.sched_stats()
        finally:
            sched.stop()
        thread = p.mp(store, processes=1).sched_stats()
        return (sorted(st), sorted(st["processes"]), sorted(st["processes"]["workers"][0]),
                st["processes"]["mode"], len(st["processes"]["workers"]),
                sorted(thread["processes"]), thread["processes"]["mode"],
                thread["processes"]["fallback"], st["scheduled"])

    got = both(run)
    assert got["jax"] == got["port"]
    top, procs, worker, mode, n, tprocs, tmode, tfb, scheduled = got["port"]
    for k in ("mode", "configured", "rounds", "stale_intents", "bind_conflicts",
              "dispatch_faults", "worker_restarts", "worker_cpu_s", "workers", "residual"):
        assert k in procs
    assert worker == sorted(("index", "pid", "state", "binds", "conflicts", "restarts",
                             "faults"))
    assert (mode, n, tmode, tfb, scheduled) == ("mp", 2, "thread", "requested", 10)


def test_thread_path_start_runs_the_batch_loop():
    """processes=1 delegates start() to its BatchScheduler's background
    loop: pods created while it runs are bound, equal across packages, and
    stop() leaves no thread behind."""
    from kubernetes_tpu_torch.utils.leakcheck import assert_no_thread_leaks

    def run(p):
        with assert_no_thread_leaks(grace=5.0):
            store = p.store(nodes=6)
            s = p.mp(store, processes=1)
            s.sync()
            s.start()
            alive = s._inner._thread is not None and s._inner._thread.is_alive()
            store.create_many("pods", p.pods(30, "th"), consume=True)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and sum(
                    1 for x in store.list("pods")[0] if x.spec.node_name) < 30:
                time.sleep(0.02)
            s.stop()
        pods = store.list("pods")[0]
        return (alive, s.mode, sum(1 for x in pods if x.spec.node_name),
                s._inner._thread is None)

    got = both(run)
    assert got["jax"] == got["port"] == (True, "thread", 30, True)


# ---------------------------------------------------------------------------
# shm arena: grow-by-remap, read-only readers, seqlock, the store's columns
# ---------------------------------------------------------------------------


def test_arena_grow_by_remap_keeps_readers_live():
    arena = tshm.ShmArena(tshm.NODE_COLS_SCHEMA, capacity=4,
                          base_name=tshm.fresh_base_name("t1"))
    try:
        reader = tshm.ShmArenaReader(arena.base_name, tshm.NODE_COLS_SCHEMA)
        try:
            arena.arrays["alloc_cpu"][:3] = (7, 8, 9)
            arena.publish(3)
            reader.refresh()
            assert reader.nrows == 3
            assert list(reader.arrays["alloc_cpu"][:3]) == [7, 8, 9]
            gen0 = arena.generation
            arena.grow(100)
            assert arena.generation > gen0 and arena.capacity >= 100
            arena.arrays["alloc_cpu"][50] = 123
            arena.publish(51)
            assert reader.refresh() is True
            assert reader.nrows == 51
            assert int(reader.arrays["alloc_cpu"][50]) == 123
            assert int(reader.arrays["alloc_cpu"][1]) == 8
            assert reader.refresh() is False
        finally:
            reader.close()
    finally:
        arena.close()
        arena.close()  # idempotent
    assert mine() == []


def test_reader_mappings_are_read_only():
    arena = tshm.ShmArena(tshm.BATCH_COLS_SCHEMA, capacity=4,
                          base_name=tshm.fresh_base_name("t2"))
    try:
        reader = tshm.ShmArenaReader(arena.base_name, tshm.BATCH_COLS_SCHEMA)
        try:
            with pytest.raises(ValueError):
                reader.arrays["cpu"][0] = 1
            with pytest.raises(ValueError, match="schema mismatch"):
                tshm.ShmArenaReader(arena.base_name, tshm.NODE_COLS_SCHEMA)
        finally:
            reader.close()
    finally:
        arena.close()


def test_store_enable_shm_roundtrip_and_close_matches_jax():
    """enable_shm / shm_close on the same columns in both packages: the
    arena's rows equal the JAX arena's, column by column, through a grow,
    binds and a close; the columns survive privately after the close."""
    def run(p):
        store = p.store(4)
        base = store.enable_shm()
        assert base is not None and store.shm_name == base and store.enable_shm() == base
        store.create_many("pods", p.pods(10, "sr"), consume=True)
        reader = p.shm.ShmArenaReader(base, p.shm.POD_COLS_SCHEMA)
        try:
            first = {name: reader.arrays[name][:reader.nrows].tolist()
                     for name, _dt in p.shm.POD_COLS_SCHEMA}
            # past the initial capacity: the arena grows by remap under the reader
            store.create_many("pods", p.pods(1500, "gr"), consume=True)
            store.bind_many([("default", f"sr-{i}", f"node-{i % 4}") for i in range(10)])
            reader.refresh()
            grown = {name: reader.arrays[name][:reader.nrows].tolist()
                     for name, _dt in p.shm.POD_COLS_SCHEMA if name != "row_rv"}
            stats = store.columnar_stats()["shm"]
        finally:
            reader.close()
        store.shm_close()
        store.shm_close()
        return (first, grown, {k: stats[k] for k in ("generation", "capacity", "nrows",
                                                     "columns", "bytes")},
                store.shm_name, store.pod_columns().n, store.columnar_stats().get("shm"))

    got = both(run)
    assert got["jax"] == got["port"]
    first, grown, stats, name, n, after = got["port"]
    assert first["node_id"] == [-1] * 10 and all(v >= 0 for v in first["row_rv"])
    assert grown["node_id"][:10] == [0, 1, 2, 3] * 2 + [0, 1]
    assert stats["generation"] >= 1 and stats["nrows"] == 1510
    assert name is None and n == 1510 and after is None


def test_default_processes_honors_environment(monkeypatch):
    p = P["port"]
    monkeypatch.setenv("SCHED_PROCESSES", "2")
    s = p.mps.MPScheduler(p.store(), p.fw, device="cpu")
    assert s.processes == 2 and s.mode == "mp"
    s.stop()
    monkeypatch.delenv("SCHED_PROCESSES")
    assert p.mps.default_processes() == P["jax"].mps.default_processes()
