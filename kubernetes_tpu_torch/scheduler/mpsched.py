"""Multi-process scheduler: worker PROCESSES over shared-memory column
shards, with cross-process bind arbitration in the store process.

The counterpart of `kubernetes_tpu/scheduler/mpsched.py`. `MPScheduler`
runs each solve pipeline in its own process (its own interpreter lock),
built from three pieces —

  shared columns    the store's pod columns live in a store/shm.py arena
                    (`APIStore.enable_shm()`); the owner writes, workers
                    map the same bytes read-only.
  worker solve      scheduler/mpworker.py: numpy-only FFD over the
                    owner-built batch/node shards; bind INTENTS —
                    (batch_row, node_row, rv_snapshot) int triples — come
                    back over a bounded queue. No Pod ever crosses the
                    boundary.
  arbitration       the owner re-validates every intent's rv snapshot
                    against the LIVE columns, then commits through
                    `store.bind_many`, whose `is_bind_conflict` surfacing
                    absorbs any race — exactly-once binding with no new
                    shared lock (the partitioned scheduler's conflict
                    contract, now cross-process).

Work split: only PLAIN pods (cpu/mem requests and nothing else) go to
workers; anything constraint-shaped — node selector/affinity, inter-pod
terms, topology spread, gangs, gates, claims, host ports, PVCs — routes
to a thread-path residual BatchScheduler with full cluster visibility
(the scheduler/partition.py residual-pass precedent), which also delivers
the terminal verdict for pods FFD could not place. That residual pipeline
is the card's path here: its device mirrors (kernel B) and its solver
kernels (C, D and A in the fast mode) run in the owner process. Tainted and
unschedulable nodes are excluded from the worker shards for the same
reason.

Workers are started with the "spawn" context, never "fork": the owner holds
a CUDA context, and a forked child must not inherit it. A spawned worker
imports only torch-free modules (scheduler/mpworker.py docstring).

Failure domain: a SIGKILLed worker is detected by the owner's collect
loop (the supervisor), its round re-offers to survivors, the slot is
respawned, and the estate is reconciled via `resync_from_store`. The chaos
site `process.worker` (key="worker-<i>") injects fail/delay/kill per worker
per round; a kill plan SIGKILLs the REAL process.

Fallback matrix (every row runs the thread path, byte-identical to a
standalone BatchScheduler — pure delegation, the partitions=1 precedent;
on a card that thread path is the card's path):

  processes=1 / auto on a 1-core machine  thread path
  SCHED_PROCESSES=0                       thread path
  no /dev/shm, no numpy, dict-path store  thread path

Concurrency is judged only by measured CPU overlap (owner plus worker CPU
seconds beyond the wall time, `overlap_cpu_s`), never by wall clock.

Not in this slice: the thread path's background start() (it delegates to
BatchScheduler.start(), ROADMAP.md queue 1 item 7g) raises; the mp path's
start() brings the workers up.
"""

from __future__ import annotations

import itertools
import os
import queue as _queue
import signal
import time
import zlib
from typing import Any, Dict, List, Optional, Set, Tuple

from ..api.resources import Resource, compute_pod_resource_request
from ..chaos import faultinject as _chaos
from ..chaos.faultinject import FaultInjected, FaultKill
from ..obs import tracebuf as _tracebuf
from ..ops.kernels import launch_scope
from ..store.store import APIStore, is_bind_conflict
from .batch import BatchScheduler
from .flightrec import register_scheduler
from .partition import spans_partitions
from .queue import QueuedPodInfo
from .serial import NOT_PORTED

_mp_seq = itertools.count(1)

# pending-pod record fields (plain list for rate): store row, milli-cpu,
# mem bytes, reroute hops, preferred worker slot
_ROW, _CPU, _MEM, _HOPS, _SLOT = range(5)


def default_processes() -> int:
    """Auto process count: the machine's cores (capped), 1 on a 1-core
    machine — mirroring PartitionedScheduler's concurrent-drive
    degradation."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - platforms without affinity
        cores = os.cpu_count() or 1
    return min(cores, 8) if cores > 1 else 1


def pod_is_plain(pod) -> bool:
    """True when FFD over (cpu, mem, pod-slot) is a SOUND solver for this
    pod: no constraint that could make a resource-feasible node infeasible
    (tolerations only widen feasibility and untainted shards need none, so
    they stay plain). Everything else goes to the residual pipeline."""
    spec = pod.spec
    if (spec.node_selector or spec.affinity is not None
            or spec.scheduling_gates or spec.resource_claims):
        return False
    if spans_partitions(pod):  # inter-pod terms, topology spread, gangs
        return False
    for v in spec.volumes:
        if v.pvc_claim_name:
            return False
    for c in spec.containers:
        for p in c.ports:
            if p.host_port:
                return False
    return True


class _ShimQueue:
    """Conservation-checker face of the mp pending set
    (testing.py pod_conservation_report wants queue.tracked_keys())."""

    def __init__(self, sched: "MPScheduler"):
        self._sched = sched

    def tracked_keys(self) -> List[str]:
        return list(self._sched._pending)

    def lengths(self) -> Tuple[int, int, int]:
        return (len(self._sched._pending), 0, 0)

    def contains(self, key: str) -> bool:
        return key in self._sched._pending

    def flush_backoff_completed(self) -> None:
        pass

    def move_all_to_active_or_backoff(self) -> None:
        pass


class _ShimSnapshot:
    node_info_list: List[Any] = []


class _ShimCache:
    """Conservation-checker face of the mp path's (nonexistent) assume
    cache: the owner binds synchronously, so nothing is ever assumed."""

    def is_assumed(self, _key: str) -> bool:
        return False

    def materialize_columnar_rows(self) -> int:
        return 0

    def update_snapshot(self) -> _ShimSnapshot:
        return _ShimSnapshot()


class _Worker:
    """Owner-side handle for one worker slot."""

    __slots__ = ("idx", "proc", "cmd_q", "pid", "state", "binds",
                 "conflicts", "restarts", "faults")

    def __init__(self, idx: int, proc, cmd_q):
        self.idx = idx
        self.proc = proc
        self.cmd_q = cmd_q
        self.pid = proc.pid
        self.state = "live"
        self.binds = 0
        self.conflicts = 0
        self.restarts = 0
        self.faults = 0

    def row(self) -> Dict[str, Any]:
        return {"index": self.idx, "pid": self.pid, "state": self.state,
                "binds": self.binds, "conflicts": self.conflicts,
                "restarts": self.restarts, "faults": self.faults}


class MPScheduler:
    """Owner/coordinator. Mirrors the BatchScheduler driving surface
    (sync / run_until_idle / flush_binds / resync_from_store / sched_stats
    / stop) so a harness can swap it in.

    processes: explicit >=2 forces the mp path even on a 1-core machine
    (overlap is then not comparable). None = auto: SCHED_PROCESSES env,
    else cores. <=1, no shm, or a dict-path store all fall back to PURE
    DELEGATION to one thread-path BatchScheduler — byte-identical by
    construction. Other keyword arguments (device, solver, batch_size, ...)
    go to the thread-path or residual BatchScheduler."""

    MAX_ROUNDS = 64
    ROUND_DEADLINE_S = 60.0

    def __init__(self, store: APIStore, framework=None,
                 processes: Optional[int] = None, residual: bool = True,
                 **kw):
        self.store = store
        self._fw = framework
        self._kw = dict(kw)
        self._origin = f"mp{next(_mp_seq)}"
        configured = processes
        if configured is None:
            env = os.environ.get("SCHED_PROCESSES")
            configured = int(env) if env not in (None, "") \
                else default_processes()
        fallback = None
        if configured <= 1:
            fallback = "requested" if (processes is not None
                                       or os.environ.get("SCHED_PROCESSES")
                                       ) else "1-core-auto"
        else:
            from ..store import shm as _shm

            if not _shm.available():
                fallback = "no-shm"
            elif not store.columnar:
                fallback = "no-columnar-store"
        self.fallback = fallback
        self.processes = 1 if fallback else int(configured)
        self.mode = "thread" if fallback else "mp"
        self._inner: Optional[BatchScheduler] = None
        if self.mode == "thread":
            fw = framework() if callable(framework) else framework
            self._inner = BatchScheduler(store, fw, **kw)
            return
        # -- mp owner state (everything below is owner-process only) -------
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self._out_q = None
        self._workers: List[_Worker] = []
        self._store_base: Optional[str] = None
        self._batch_arena = None
        self._node_arena = None
        self._residual_enabled = residual
        self._residual: Optional[BatchScheduler] = None
        self._residual_keys: Set[str] = set()
        self._residual_qps: List[QueuedPodInfo] = []
        # key -> [store_row, cpu_milli, mem_bytes, hops, slot]
        self._pending: Dict[str, List[int]] = {}
        self._req_cache: Dict[str, Tuple[int, int]] = {}
        self._node_names: List[str] = []
        self._node_acct: List[List[int]] = []  # [ac, am, ap, uc, um, up]
        self._node_rows: Dict[str, int] = {}
        self._round_keys: List[str] = []
        self._sampler = None
        self._stopped = False
        self.queue = _ShimQueue(self)
        self.cache = _ShimCache()
        self.rounds = 0
        self.stale_intents = 0
        self.bind_conflicts = 0
        self.dispatch_faults = 0
        self.worker_restarts = 0
        self.worker_cpu_s = 0.0
        self.residual_passes = 0
        self._bound_total = 0
        self._failed_binds = 0
        register_scheduler(self._origin, self)

    # -- thread-path delegation ------------------------------------------------

    def __getattr__(self, name: str):
        inner = self.__dict__.get("_inner")
        if inner is not None:
            return getattr(inner, name)
        raise AttributeError(name)

    @property
    def watch_coalesce(self):
        if self._inner is not None:
            return self._inner.watch_coalesce
        return None  # mp path: workers read columns, not watch events

    @watch_coalesce.setter
    def watch_coalesce(self, v) -> None:
        if self._inner is not None:
            self._inner.watch_coalesce = v

    # -- worker lifecycle ------------------------------------------------------

    def _ensure_workers(self) -> None:
        if self._workers or self._stopped:
            return
        from ..store import shm as _shm

        try:
            self._store_base = self.store.enable_shm()
            if self._store_base is None:  # pragma: no cover - init gates
                raise RuntimeError("mp mode needs the columnar store + shm")
            self._batch_arena = _shm.ShmArena(
                _shm.BATCH_COLS_SCHEMA, capacity=4096,
                base_name=_shm.fresh_base_name("batch"))
            self._node_arena = _shm.ShmArena(
                _shm.NODE_COLS_SCHEMA, capacity=1024,
                base_name=_shm.fresh_base_name("nodes"))
            self._out_q = self._ctx.Queue(maxsize=256)
            for i in range(self.processes):
                self._workers.append(self._spawn(i))
        except BaseException:
            # a failed bring-up (spawn refused, shm exhausted) must not
            # leak named segments: tear down whatever was created
            self.stop()
            raise

    def _spawn(self, idx: int) -> _Worker:
        from .mpworker import worker_main

        cmd_q = self._ctx.Queue(maxsize=8)
        proc = self._ctx.Process(
            target=worker_main,
            args=(idx, self._store_base, self._batch_arena.base_name,
                  self._node_arena.base_name, cmd_q, self._out_q),
            daemon=True, name=f"mpsched-w{idx}")
        proc.start()
        return _Worker(idx, proc, cmd_q)

    def _handle_death(self, w: _Worker) -> None:
        """The supervisor half of the worker failure domain: reap the
        corpse, respawn the slot (cumulative counters carry over — restarts
        are honest), reconcile the estate from the store. Pods the dead
        worker was solving simply stay pending and re-offer to the
        survivors' next round."""
        w.state = "dead"
        try:
            w.proc.join(timeout=0.2)
        except Exception:  # pragma: no cover - join on a corpse
            pass
        nw = self._spawn(w.idx)
        nw.binds, nw.conflicts, nw.faults = w.binds, w.conflicts, w.faults
        nw.restarts = w.restarts + 1
        self._workers[w.idx] = nw
        self.worker_restarts += 1
        self.resync_from_store()

    # -- estate (nodes + pending pods) -----------------------------------------

    def _pod_req(self, key: str, pod) -> Tuple[int, int]:
        got = self._req_cache.get(key)
        if got is None:
            r = compute_pod_resource_request(pod)
            got = (r.milli_cpu, r.memory)
            self._req_cache[key] = got
        return got

    def _refresh_estate(self) -> Dict[str, int]:
        """Full re-scan of the store's columns: eligible nodes with their
        live usage, and the pending split (plain -> worker shards,
        constrained -> residual parking). The mp path's resync — O(rows),
        run at sync, between run_until_idle calls, and after a death."""
        names: List[str] = []
        acct: List[List[int]] = []
        rows: Dict[str, int] = {}
        for node in self.store.list("nodes")[0]:
            if node.spec.unschedulable or node.spec.taints:
                continue
            alloc = Resource.from_resource_list(node.status.allocatable)
            rows[node.metadata.name] = len(names)
            names.append(node.metadata.name)
            acct.append([alloc.milli_cpu, alloc.memory,
                         alloc.allowed_pod_number or 110, 0, 0, 0])
        self._node_names, self._node_acct, self._node_rows = (
            names, acct, rows)
        pending: Dict[str, List[int]] = {}
        view = self.store.pod_columns()
        n_bound = 0
        for i in range(view.n):
            key = view.keys[i]
            if key is None or view.row_rv[i] < 0:
                continue
            pod = view.base[i]
            nid = int(view.node_id[i])
            if nid >= 0:
                row = rows.get(view.node_names[nid])
                if row is not None:
                    c, m = self._pod_req(key, pod)
                    a = acct[row]
                    a[3] += c
                    a[4] += m
                    a[5] += 1
                n_bound += 1
                continue
            if pod.is_terminal() or key in self._residual_keys:
                continue
            if pod_is_plain(pod):
                c, m = self._pod_req(key, pod)
                old = self._pending.get(key)
                slot = old[_SLOT] if old else \
                    zlib.crc32(key.encode()) % self.processes
                pending[key] = [i, c, m, 0, slot]
            else:
                self._park_residual(pod)
        self._pending = pending
        return {"nodes": len(names), "bound": n_bound,
                "pending": len(pending), "dropped_assumes": 0}

    # -- driving ---------------------------------------------------------------

    def sync(self) -> None:
        if self._inner is not None:
            self._inner.sync()
            return
        self._ensure_workers()
        self._refresh_estate()

    def resync_from_store(self) -> Dict[str, int]:
        if self._inner is not None:
            return self._inner.resync_from_store()
        totals = self._refresh_estate()
        if self._residual is not None:
            for k, v in self._residual.resync_from_store().items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def run_until_idle(self, max_cycles: int = 10_000) -> int:
        if self._inner is not None:
            return self._inner.run_until_idle(max_cycles)
        self._ensure_workers()
        if not self._pending and not self._residual_qps:
            self._refresh_estate()
        rounds = 0
        for _ in range(min(self.MAX_ROUNDS, max_cycles)):
            if not self._pending:
                break
            placed, parked, deaths = self._round()
            rounds += 1
            if placed == 0 and parked == 0 and deaths == 0:
                # no worker could place anything and nothing re-routed:
                # the rest gets the global residual verdict
                for key in list(self._pending):
                    self._park_residual_key(key)
                break
        self._run_residual_pass()
        return rounds

    def _round(self) -> Tuple[int, int, int]:
        """One dispatch/collect/arbitrate cycle across the live workers."""
        live = [w for w in self._workers if w.state == "live"]
        if not live:
            for key in list(self._pending):
                self._park_residual_key(key)
            return 0, len(self._residual_qps), 0
        rid = self.rounds
        self.rounds += 1
        live_idx = [w.idx for w in live]
        self._publish_round(live_idx)
        dispatched: Set[int] = set()
        for w in live:
            if _chaos.ACTIVE is not None:
                try:
                    _chaos.ACTIVE.fire("process.worker",
                                       key=f"worker-{w.idx}")
                except FaultInjected:
                    w.faults += 1
                    self.dispatch_faults += 1
                    continue  # skipped round: its pods re-offer next time
                except FaultKill:
                    # a kill plan kills the REAL process — the supervisor
                    # path below must detect and recover it
                    try:
                        os.kill(w.proc.pid, signal.SIGKILL)
                    except OSError:  # pragma: no cover - already gone
                        pass
                    continue
            try:
                w.cmd_q.put(("round", rid), timeout=1.0)
                dispatched.add(w.idx)
            except _queue.Full:  # pragma: no cover - wedged worker
                pass
        placed, parked = self._collect(rid, dispatched)
        deaths = 0
        for w in list(self._workers):
            if w.state == "live" and not w.proc.is_alive():
                deaths += 1
                self._handle_death(w)
        return placed, parked, deaths

    def _publish_round(self, live_idx: List[int]) -> None:
        """Write this round's batch + node shards into the arenas. Worker
        assignment: each pending pod's preferred slot, folded onto the live
        workers; nodes round-robin over the live workers."""
        nlive = len(live_idx)
        entries = list(self._pending.items())
        ba = self._batch_arena
        if len(entries) > ba.capacity:
            ba.grow(len(entries))
        arrs = ba.arrays
        self._round_keys = []
        for i, (key, ent) in enumerate(entries):
            arrs["store_row"][i] = ent[_ROW]
            arrs["cpu"][i] = ent[_CPU]
            arrs["mem"][i] = ent[_MEM]
            arrs["worker"][i] = live_idx[ent[_SLOT] % nlive]
            self._round_keys.append(key)
        ba.publish(len(entries))
        na = self._node_arena
        if len(self._node_acct) > na.capacity:
            na.grow(len(self._node_acct))
        narrs = na.arrays
        for j, a in enumerate(self._node_acct):
            narrs["alloc_cpu"][j] = a[0]
            narrs["alloc_mem"][j] = a[1]
            narrs["alloc_pods"][j] = a[2]
            narrs["used_cpu"][j] = a[3]
            narrs["used_mem"][j] = a[4]
            narrs["used_pods"][j] = a[5]
            narrs["worker"][j] = live_idx[j % nlive]
        na.publish(len(self._node_acct))

    def _collect(self, rid: int, dispatched: Set[int]) -> Tuple[int, int]:
        """Drain worker results for one round, arbitrating bind intents as
        they arrive. Returns (placed, parked)."""
        placed = 0
        parked = 0
        done: Set[int] = set()
        deadline = time.monotonic() + self.ROUND_DEADLINE_S
        by_idx = {w.idx: w for w in self._workers}
        while dispatched - done:
            try:
                msg = self._out_q.get(timeout=0.2)
            except _queue.Empty:
                for idx in list(dispatched - done):
                    w = by_idx[idx]
                    if not w.proc.is_alive():
                        dispatched.discard(idx)  # death handled by caller
                if time.monotonic() > deadline:  # pragma: no cover - wedge
                    for idx in dispatched - done:
                        by_idx[idx].proc.kill()
                    break
                continue
            kind = msg[0]
            if kind == "ready":
                continue
            idx, mrid = msg[1], msg[2]
            if mrid != rid:
                continue  # stale message from a pre-respawn round
            w = by_idx[idx]
            if kind == "bind":
                placed += self._arbitrate(w, msg[3])
            elif kind == "error":
                w.faults += 1
                self.dispatch_faults += 1
                done.add(idx)
            elif kind == "done":
                _idx, _rid, _placed, unplaced, t0, t1, cpu_s = msg[1:]
                self.worker_cpu_s += cpu_s
                if _tracebuf.ACTIVE is not None:
                    _tracebuf.ACTIVE.note_span(
                        f"w{idx}-sched", f"round-{rid}", t0, t1,
                        cat="sched",
                        args={"pid": w.pid, "offered": _placed,
                              "cpu_ms": round(cpu_s * 1e3, 3)})
                parked += self._reroute_unplaced(unplaced)
                done.add(idx)
        return placed, parked

    def _arbitrate(self, w: _Worker, chunk) -> int:
        """Cross-process bind arbitration: re-validate each intent's rv
        snapshot against the LIVE columns (a changed row raced — stale,
        re-offered next round), then commit survivors through bind_many.
        Conflicts surface per-pod via is_bind_conflict and mean the pod IS
        bound (by someone) — it leaves the pending set either way."""
        view = self.store.pod_columns()
        batch: List[Tuple[str, str, str]] = []
        keys: List[str] = []
        reqs: List[Tuple[str, int, int, int]] = []
        nkeys = len(self._round_keys)
        for bi, node_row, rv_snap in chunk:
            if bi >= nkeys:
                continue
            key = self._round_keys[bi]
            ent = self._pending.get(key)
            if ent is None:
                continue  # already resolved this round
            row = ent[_ROW]
            if (row >= view.n or view.keys[row] != key
                    or int(view.row_rv[row]) != rv_snap
                    or int(view.node_id[row]) >= 0):
                self.stale_intents += 1
                continue
            ns, name = key.split("/", 1)
            batch.append((ns, name, self._node_names[node_row]))
            keys.append(key)
            reqs.append((key, ent[_CPU], ent[_MEM], node_row))
        if not batch:
            return 0
        bound, errors = self.store.bind_many(batch, origin=self._origin)
        failed = {key for key, _msg in errors}
        for key, msg in errors:
            if is_bind_conflict(msg):
                w.conflicts += 1
                self.bind_conflicts += 1
            else:
                self._failed_binds += 1
            self._pending.pop(key, None)
        for key, c, m, node_row in reqs:
            if key in failed:
                continue
            a = self._node_acct[node_row]
            a[3] += c
            a[4] += m
            a[5] += 1
            self._pending.pop(key, None)
        w.binds += bound
        self._bound_total += bound
        return bound

    def _reroute_unplaced(self, unplaced) -> int:
        """Shard-local unschedulability hops to the next worker; once every
        live worker has declined, the global residual pass owns the
        terminal verdict (the partition reroute contract)."""
        live = sum(1 for w in self._workers if w.state == "live")
        parked = 0
        nkeys = len(self._round_keys)
        for bi in unplaced:
            if bi >= nkeys:
                continue
            key = self._round_keys[bi]
            ent = self._pending.get(key)
            if ent is None:
                continue
            ent[_HOPS] += 1
            if ent[_HOPS] >= max(live, 1):
                self._park_residual_key(key)
                parked += 1
            else:
                ent[_SLOT] += 1
        return parked

    # -- the global residual pass (partition.py precedent) ---------------------

    def _ensure_residual(self) -> BatchScheduler:
        if self._residual is None:
            fw = self._fw() if callable(self._fw) else self._fw
            r = BatchScheduler(self.store, fw, **self._kw)
            r.partition_index = -1
            r._pod_gate = self._residual_gate
            if self._sampler is not None:
                r.attach_resource_sampler(self._sampler)
            self._residual = r
        return self._residual

    def _residual_gate(self, _etype: str, pod) -> bool:
        if pod.spec.node_name or pod.is_terminal():
            return True  # the residual cache mirrors every bound pod
        return pod.key in self._residual_keys

    def _park_residual(self, pod) -> None:
        key = pod.key
        if key in self._residual_keys:
            return
        self._residual_keys.add(key)
        self._residual_qps.append(QueuedPodInfo(pod=pod))

    def _park_residual_key(self, key: str) -> None:
        ent = self._pending.pop(key, None)
        if ent is None or key in self._residual_keys:
            return
        view = self.store.pod_columns()
        row = ent[_ROW]
        if row < view.n and view.keys[row] == key:
            self._park_residual(view.base[row])

    def _run_residual_pass(self) -> int:
        if self._inner is not None or not self._residual_enabled:
            return 0
        parked = self._residual_qps
        self._residual_qps = []
        if not parked:
            return 0
        r = self._ensure_residual()
        self.residual_passes += 1
        r.resync_from_store()
        with launch_scope("residual"):
            handled = r.run_until_idle()
        r.flush_binds()
        if r._watch is not None:
            r._watch.stop()
            r._watch = None
        still = set(r.queue.tracked_keys())
        self._residual_keys &= still | {
            qp.pod.key for qp in self._residual_qps}
        # residual binds shift the estate under the workers — refresh usage
        self._refresh_estate()
        return handled

    # -- BatchScheduler-surface compatibility ----------------------------------

    def flush_binds(self) -> None:
        if self._inner is not None:
            self._inner.flush_binds()
        elif self._residual is not None:
            self._residual.flush_binds()

    def pump_events(self) -> None:
        if self._inner is not None:
            self._inner.pump_events()

    def sweep_expired_assumes(self) -> int:
        if self._inner is not None:
            return self._inner.sweep_expired_assumes()
        return 0

    def flush_queues(self) -> None:
        if self._inner is not None:
            self._inner.queue.flush_backoff_completed()
            self._inner.queue.move_all_to_active_or_backoff()
        elif self._residual is not None:
            self._residual.queue.flush_backoff_completed()
            self._residual.queue.move_all_to_active_or_backoff()

    def take_bind_failures(self) -> List:
        if self._inner is not None:
            return self._inner.take_bind_failures()
        return (self._residual.take_bind_failures()
                if self._residual is not None else [])

    def attach_resource_sampler(self, sampler) -> None:
        if self._inner is not None:
            self._inner.attach_resource_sampler(sampler)
            return
        self._sampler = sampler
        if self._residual is not None:
            self._residual.attach_resource_sampler(sampler)

    def conservation_members(self):
        if self._inner is not None:
            return [self._inner], None
        return [self], self._residual

    @property
    def scheduled_count(self) -> int:
        if self._inner is not None:
            return self._inner.scheduled_count
        return self._bound_total + (self._residual.scheduled_count
                                    if self._residual is not None else 0)

    @property
    def failed_count(self) -> int:
        if self._inner is not None:
            return self._inner.failed_count
        return self._failed_binds + (self._residual.failed_count
                                     if self._residual is not None else 0)

    def start(self) -> None:
        if self._inner is not None:
            raise NotImplementedError("the thread path's background start() is "
                                      + NOT_PORTED.format("7g"))
        self._ensure_workers()

    def stop(self) -> None:
        """Tear everything down unlink-clean: workers stopped (then
        killed), queues drained, both owner arenas AND the store's pod
        arena closed+unlinked — `/dev/shm` must hold no segment of the
        port's prefix afterwards (store/shm.py leaked_segments)."""
        if self._inner is not None:
            self._inner.stop()
            return
        if self._stopped:
            return
        self._stopped = True
        try:
            for w in self._workers:
                if w.state == "live":
                    try:
                        w.cmd_q.put_nowait(("stop",))
                    except _queue.Full:
                        pass
            for w in self._workers:
                w.proc.join(timeout=2.0)
                if w.proc.is_alive():
                    w.proc.kill()
                    w.proc.join(timeout=2.0)
                w.state = "stopped"
            for w in self._workers:
                w.cmd_q.cancel_join_thread()
                w.cmd_q.close()
            if self._out_q is not None:
                self._out_q.cancel_join_thread()
                self._out_q.close()
            if self._residual is not None:
                self._residual.stop()
        finally:
            if self._batch_arena is not None:
                self._batch_arena.close()
            if self._node_arena is not None:
                self._node_arena.close()
            self.store.shm_close()

    # -- observability ---------------------------------------------------------

    def sched_stats(self) -> Dict:
        if self._inner is not None:
            st = dict(self._inner.sched_stats())
            st["processes"] = {
                "mode": "thread", "configured": self.processes,
                "fallback": self.fallback, "workers": [],
            }
            return st
        return {
            "scheduled": self.scheduled_count,
            "failed": self.failed_count,
            "queue": {"active": len(self._pending), "backoff": 0,
                      "unschedulable": 0},
            "processes": {
                "mode": "mp",
                "configured": self.processes,
                "fallback": None,
                "rounds": self.rounds,
                "stale_intents": self.stale_intents,
                "bind_conflicts": self.bind_conflicts,
                "dispatch_faults": self.dispatch_faults,
                "worker_restarts": self.worker_restarts,
                "worker_cpu_s": round(self.worker_cpu_s, 4),
                "workers": [w.row() for w in self._workers],
                "residual": {
                    "enabled": self._residual_enabled,
                    "passes": self.residual_passes,
                    "parked": len(self._residual_qps),
                    "scheduled": (self._residual.scheduled_count
                                  if self._residual is not None else 0),
                },
            },
        }
