"""In-memory versioned object store with watch semantics.

The counterpart of `kubernetes_tpu/store/store.py`. It fuses the roles of
etcd3, the apiserver registry and the watch cache into one process-local
component (reference: staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go,
storage/cacher/cacher.go:261, endpoints/handlers/watch.go:187):

  - A single monotonically increasing resourceVersion across all writes
    (etcd revision analog); every object carries the RV of its last write.
  - Optimistic concurrency: update fails on an RV conflict (apiserver
    GuaranteedUpdate precondition behavior).
  - LIST returns a consistent snapshot + the RV it is current to; WATCH from
    that RV streams every subsequent event exactly once, in order — the
    List+Watch contract client-go's Reflector relies on
    (tools/cache/reflector.go:394).
  - Transactional pod binding: sets spec.nodeName iff still unset
    (BindingREST.Create, pkg/registry/core/pod/storage/storage.go:149).
  - Any kind is stored (a kind's row dict is made on its first write).

The store is thread-safe. Watch buffers are bounded: a consumer that falls
`maxsize` deliveries behind is terminated and must relist, unless it
subscribed as a lossy ring (Watch).

Concurrency (sharded locking): a GLOBAL lock plus PER-KIND shards for the
two high-traffic kinds, so a bind batch's validate phase does not stall
every other client:

  LOCK-ORDERING TABLE (acquire strictly in ascending rank, release in any
  order; the composite helpers below always enter in rank order):

    rank | lock            | guards
    -----+-----------------+----------------------------------------------
      0  | _lock           | resourceVersion allocation, the kind map,
         |                 | every non-sharded kind's rows, watcher
         |                 | registration, event history, event emission
      1  | _pods_lock      | the `pods` rows AND the columnar pod-row
         |                 | table (store/columnar.py PodColumns)
      2  | _nodes_lock     | the `nodes` rows
    leaf | partition locks | PartitionRouter._route_lock /
         |                 | PartitionedScheduler._dispatch_lock — strictly
         |                 | after the whole store chain
         |                 | (scheduler/partition.py lock discipline)

  bind_many validates under the pods shard ALONE (the expensive part); the
  commit (contiguous RV range, row/column writes, event emission) then runs
  in ONE short critical section under global + shard, which keeps the
  List+Watch contract exact — a LIST observes either none or all of the
  writes at the RV it returns. A thread holding a shard must not acquire a
  lock of LOWER rank (bind_many RELEASES the shard between its phases and
  re-validates raced rows instead of holding through). The _OrderedRLock
  wrappers (APIStore(lock_order_check=True), env STORE_LOCK_ORDER_CHECK=1,
  on for every store built under pytest) raise LockOrderViolation on an
  inversion.

Event allocation (clone-free commits): pod events on the bind / status /
delete paths are LAZY — the Event initially SHARES the stored object (safe:
the store never mutates stored objects in place, later writes REPLACE
them), and a private per-object clone is materialized at most once, on
first delivery or replay to a non-coalescing watcher (_materialize_event).
Per-object watchers only ever receive (and replay) private events, and the
mutation detector fingerprints both forms.

Columnar pod rows: when numpy is importable (and STORE_COLUMNAR /
APIStore(columnar=) do not opt out), the pod rows ALSO live in a
struct-of-arrays table (store/columnar.py PodColumns) and bind_many commits
by COLUMN WRITES — node ids, a contiguous rv range, one diverged-bitmap
set, ONE LazyBindBatch event marker a call — with no per-pod object or
Event allocated. The bound Pod object of a row, and the per-object Events
of the batch, materialize lazily (at most once) when an API read, a
non-coalescing watcher, a history replay or a cold field access needs
them. Every other write path stays on the dict rows and keeps the columns
coherent (PodColumns.sync/insert/remove); a diverged row is reconciled by
_materialize_pod_row before any dict-path read or write touches it. The
dict store stays the oracle: columnar=False, STORE_COLUMNAR=0, a missing
numpy, or a store without the lazy/deep-copy event contract run the pure
dict path, with the same placements, RV sequence and event streams.

Native commit engine: the store's hot loops (bind_many's validate+clone
prepare and its commit, the columnar prepare, delete_pods' commit) also run
through the g++ C-API engine (native/hostcommit.cpp), which replays exactly
the same object operations, byte-identical to the Python loops here (the
oracle; tests/test_torch_native.py holds rows, RV sequence and event streams
equal). Selection: APIStore(native_commit=) or env STORE_NATIVE_COMMIT, and
the engine-level HOSTSCHED_NATIVE_COMMIT switch; a selected engine whose
build fails raises. The `native.commit` fault site fires in the phase gap
(no lock held) when the engine is selected.

  NATIVE LOCK RULE: the PyDLL commit entries HOLD the GIL and are legal
  under the store locks (plain interpreter work, cheaper). The
  GIL-RELEASING kernels (ctypes CDLL in native/hostsched.py:
  native_greedy_solve, native_commit_deltas) must NEVER run inside a store
  or scheduler lock: dropping the GIL while holding a store lock invites
  every lock/GIL interleaving (a GIL-waiting thread that needs this lock, a
  lock-waiting thread that holds the GIL).

Shared-memory columns: enable_shm() moves the columnar pod rows' numeric
columns into a store/shm.py arena that worker processes map read-only
(scheduler/mpsched.py); the store stays the only writer, under the pods
shard as before, and shm_close() unlinks the arena (its caller owns that).
The ordered locks record every (held -> acquired) edge into the lock-graph
witness (store/lockgraph.py).

Not in this slice: the API serializer the mutation detector fingerprints
through (ROADMAP.md queue 1 item 7f: until then it walks the objects'
fields, or their own `to_dict`).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import queue
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..api.types import Pod
from ..chaos import faultinject as _chaos
from ..obs import tracebuf as _tracebuf
from ..server import metrics as _metrics
from . import columnar as _columnar

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"

_watch_seq = itertools.count()

@dataclass(frozen=True)
class Event:
    type: str
    kind: str
    obj: Any
    resource_version: int
    # the object's previous stored state (None on create). Lets filtered
    # watchers decide scope transitions the way the reference's watchCache
    # does (predicate on prevObj vs obj); read-only like obj.
    prev: Any = None
    # lazy-materialization slot for hot-path pod events: a mutable
    # [materialized Event or None, cloner] pair, None on eager events. The
    # obj of a lazy event IS the stored object; APIStore._materialize_event
    # builds (once) the private clone handed to non-coalescing watchers.
    # compare=False keeps Event equality identical to the eager form.
    lazy: Any = field(default=None, compare=False, repr=False)
    # watch-propagation stamp: perf_counter at store commit,
    # SHARED across a batched write's events (one clock read per batch).
    # 0.0 = unstamped (propagation tracing disabled). compare=False keeps
    # Event equality identical to the pre-stamp form.
    commit_ts: float = field(default=0.0, compare=False, repr=False)


@dataclass(frozen=True)
class CoalescedEvent:
    """One multi-object event for a whole batched write (bind_many /
    create_many chunk) — the internal fast-path channel. Only watchers that
    subscribed with coalesce=True receive these; every other watcher sees the
    per-object `events` individually, so the external watch API is unchanged.

    origin is the writer's opaque tag (a scheduler passes its own so it can
    short-circuit re-ingesting its own bind confirmations); None for writers
    that don't tag. resource_version is the LAST rv in the batch."""

    type: str
    kind: str
    events: Tuple[Event, ...]
    resource_version: int
    origin: Optional[str] = None
    # the batch's shared commit stamp (the coalesced fast path carries it
    # too, or propagation histograms would miss batched ingest). 0.0 =
    # tracing disabled.
    commit_ts: float = 0.0


class LazyBindBatch:
    """ONE history/event marker for a whole columnar bind_many call — the
    lazy-event idiom extended from events to rows. The
    commit captures only O(batch) state: the key strings, the PRE-bind base
    object refs (the events' `prev`), the interned node ids (plus a ref to
    the append-only name table, so resolution is lock-free on any thread),
    the first rv of the contiguous range, and the shared commit stamp.

    Per-object Events materialize AT MOST ONCE for the whole consumer set
    (`events()`, double-checked under a per-batch lock): each gets a fresh
    bind clone of its base with the committed node/rv applied and a lazy
    slot ([None, cloner]) so non-coalescing watchers receive their private
    clones through the ordinary _materialize_event path. Field-for-field
    the stream is identical to the dict path's; identity-wise the event
    objects are private to the batch (never the stored row), which is
    strictly safer under the read-only event contract. In the scheduler
    steady state — only coalescing watchers, origin-tagged self-skip — a
    100k-bind run never materializes any of it."""

    __slots__ = ("type", "kind", "rv0", "n", "keys", "bases", "node_ids",
                 "node_names", "cloner", "commit_ts", "_mat", "_mlock")

    def __init__(self, etype: str, rv0: int, keys, bases, node_ids,
                 node_names, cloner, commit_ts: float):
        self.type = etype
        self.kind = "pods"
        self.rv0 = rv0  # rv of the FIRST event; the range is contiguous
        self.n = len(keys)
        self.keys = keys
        self.bases = bases
        self.node_ids = node_ids
        self.node_names = node_names  # append-only intern table (shared ref)
        self.cloner = cloner
        self.commit_ts = commit_ts
        self._mat = None  # materialized per-object Event list (once)
        self._mlock = threading.Lock()

    def __len__(self) -> int:
        return self.n

    @property
    def resource_version(self) -> int:
        """The LAST rv of the batch (watch-watermark semantics, matching
        CoalescedEvent.resource_version)."""
        return self.rv0 + self.n - 1

    def count_since(self, since_rv: int) -> int:
        """How many of this batch's events have rv > since_rv."""
        if since_rv < self.rv0:
            return self.n
        return max(0, self.n - (since_rv - self.rv0 + 1))

    def events(self) -> List["Event"]:
        """The batch's per-object events in rv order (materialized once,
        thread-safe: consumers iterate on their own threads outside any
        store lock; builds touch only batch-captured refs, never the store,
        so taking the batch lock under the store lock — replay — is safe)."""
        mat = self._mat
        if mat is not None:
            return mat
        with self._mlock:
            if self._mat is None:
                cloner = self.cloner
                names = self.node_names
                ids = self.node_ids.tolist() if hasattr(
                    self.node_ids, "tolist") else list(self.node_ids)
                rv = self.rv0
                etype = self.type
                ts = self.commit_ts
                out = []
                for i in range(self.n):
                    base = self.bases[i]
                    obj = cloner(base)
                    obj.spec.node_name = names[ids[i]]
                    obj.metadata.resource_version = rv + i
                    out.append(_make_event(etype, "pods", obj, rv + i, base,
                                           [None, cloner], ts))
                self._mat = out
            return self._mat

    def events_since(self, since_rv: int) -> List["Event"]:
        evs = self.events()
        if since_rv < self.rv0:
            return evs
        return evs[since_rv - self.rv0 + 1:]


class _LazyEventSeq:
    """The `events` member of a columnar CoalescedEvent: len() is O(1) (the
    scheduler's origin-tagged self/peer skip), iteration/indexing
    materializes the batch once for every consumer."""

    __slots__ = ("_batch",)

    def __init__(self, batch: LazyBindBatch):
        self._batch = batch

    def __len__(self) -> int:
        return self._batch.n

    def __iter__(self):
        return iter(self._batch.events())

    def __getitem__(self, i):
        return self._batch.events()[i]


class ConflictError(Exception):
    pass


class ResourceVersionTooOldError(Exception):
    """Watch requested from an RV older than retained history — the client must
    relist (reference: apiserver 'too old resource version' / 410 Gone)."""


class NotFoundError(Exception):
    pass


class AlreadyExistsError(Exception):
    pass


class AlreadyBoundError(Exception):
    pass


# The per-pod bind_many error phrase for a lost bind race (another writer
# set spec.node_name first). The store OWNS the message format, so consumers
# recognize conflicts through the predicate below instead of each growing
# its own string match (a recognized conflict is a FACT: the pod is bound).
_BIND_CONFLICT_PHRASE = " is already bound to "


def is_bind_conflict(message: str) -> bool:
    """True when a bind/bind_many per-pod error message reports the
    already-bound conflict (vs infrastructure errors or not-found)."""
    return _BIND_CONFLICT_PHRASE in message


class MutationDetectedError(Exception):
    """A watch consumer mutated an event object (client-go's cache mutation
    detector failure: informer objects are shared and must be read-only)."""


class MutationDetector:
    """Fingerprints emitted event objects and detects later mutation.

    reference: client-go tools/cache/mutation_detector.go — enabled by env
    (KUBE_CACHE_MUTATION_DETECTOR); here: APIStore(mutation_detector=True) or
    env CACHE_MUTATION_DETECTOR=true, then call store.check_mutations() (the
    tests do this at teardown). The fingerprint is the object's fields as
    plain data (_plain_fields)."""

    LIMIT = 5_000

    def __init__(self):
        self._entries = []  # (event, fingerprint json)

    @staticmethod
    def _fingerprint(obj) -> str:
        try:
            return json.dumps(_plain_fields(obj), sort_keys=True, default=repr)
        except Exception:
            return repr(obj)

    def record(self, ev: "Event") -> None:
        self._entries.append((ev, self._fingerprint(ev.obj)))
        if len(self._entries) > self.LIMIT:
            del self._entries[: self.LIMIT // 4]

    def check(self) -> None:
        for ev, fp in self._entries:
            now = self._fingerprint(ev.obj)
            if now != fp:
                raise MutationDetectedError(
                    f"{ev.type} {ev.kind} event object at rv "
                    f"{ev.resource_version} was mutated after emission:\n"
                    f"was: {fp}\nnow: {now}")


def _plain_fields(obj):
    """An object as plain data for the mutation detector's fingerprint: a
    type's own `to_dict` where it has one, else its dataclass fields (or
    public attributes) walked recursively. Memo slots in a pod's __dict__
    (`_class_sig`, `_req_sig`, ...) are not fields, so they never count as a
    mutation."""
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _plain_fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain_fields(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(repr(v) for v in obj)
    to_dict = getattr(obj, "to_dict", None)
    if callable(to_dict):
        return _plain_fields(to_dict())
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain_fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    d = getattr(obj, "__dict__", None)
    if d is not None:
        return {k: _plain_fields(v) for k, v in d.items()
                if not k.startswith("_")}
    return repr(obj)


def pod_structural_clone(pod):
    """Fast pod clone for the bind/status hot paths: fresh Pod, ObjectMeta
    (with own labels/annotations containers), PodSpec, and PodStatus (own
    conditions list) — ~20x cheaper than deepcopy.

    The deep members that stay SHARED (containers, tolerations, affinity,
    topology-spread constraints, volumes, node_selector) are treated as
    immutable by every store consumer: the store itself never mutates stored
    objects (writes replace them), and clients mutate only top-level metadata
    dicts / spec.node_name / status fields — all cloned here."""
    meta = _shallow(pod.metadata)
    meta.labels = dict(meta.labels)
    meta.annotations = dict(meta.annotations)
    spec = _shallow(pod.spec)
    status = _shallow(pod.status)
    status.conditions = list(status.conditions)
    new = _shallow(pod)
    new.metadata = meta
    new.spec = spec
    new.status = status
    return new


def _shallow(obj):
    """Shallow copy without copy.copy's __reduce_ex__ machinery (~4x
    faster; this runs 3x per bind at 100k-bind rates). Replacing the fresh
    instance's __dict__ with a C-level dict copy beats update() into the
    lazily-created empty dict by another ~30%."""
    new = object.__new__(obj.__class__)
    new.__dict__ = obj.__dict__.copy()
    return new


def _make_event(etype, kind, obj, rv, prev=None, lazy=None, commit_ts=0.0):
    """Hot-path Event constructor: the frozen-dataclass __init__ goes through
    object.__setattr__ per field (~1.8µs — real money at 100k events per
    bind batch); building the instance dict directly is ~4x cheaper and
    produces an identical instance (frozen dataclasses keep their fields in
    __dict__)."""
    ev = object.__new__(Event)
    # frozen dataclasses also veto __dict__ assignment through their
    # __setattr__ — go around it the same way their own __init__ does
    object.__setattr__(ev, "__dict__",
                       {"type": etype, "kind": kind, "obj": obj,
                        "resource_version": rv, "prev": prev, "lazy": lazy,
                        "commit_ts": commit_ts})
    return ev


def pod_bind_clone(pod):
    """Minimal clone for the bind hot path: fresh Pod/ObjectMeta/PodSpec
    shells only. A bind mutates exactly spec.node_name and
    metadata.resource_version, so status and every metadata container
    (labels, annotations) stay SHARED with the
    source — the same read-only contract pod_structural_clone already applies
    to containers/tolerations/affinity, extended to the remaining members.
    Any later write that does touch those goes through pod_structural_clone
    (update_pod_status, caller-facing returns), which re-privatizes them.

    _shallow is inlined: this runs twice per bind (assume clone + store
    commit clone) at 100k-bind rates, and the call overhead alone is
    measurable there."""
    new = object.__new__(pod.__class__)
    new.__dict__ = pod.__dict__.copy()
    meta = object.__new__(pod.metadata.__class__)
    meta.__dict__ = pod.metadata.__dict__.copy()
    spec = object.__new__(pod.spec.__class__)
    spec.__dict__ = pod.spec.__dict__.copy()
    new.metadata = meta
    new.spec = spec
    return new


class Watch:
    """A single watch subscription. Iterate or .get(timeout). Call .stop() to end.

    Buffers are BOUNDED (maxsize events): a consumer that stops draining is
    terminated instead of growing the queue without limit — the reference's
    Cacher does the same to slow watchers (cacher.go terminateAllWatchers /
    per-watcher buffer overflow). A terminated watcher must relist+rewatch
    (`terminated` flips True and the stream ends)."""

    DEFAULT_MAXSIZE = 10_000

    def __init__(self, store: "APIStore", kind=None,
                 maxsize: int = DEFAULT_MAXSIZE, coalesce: bool = False,
                 ring: bool = False):
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue(maxsize=maxsize or 0)
        # ring=True turns the bounded buffer into a RING: on overflow the OLDEST buffered delivery is dropped —
        # counted as reason="ring_overflow" — and the subscription survives
        # with a gap instead of terminating. For observability consumers
        # (dashboards) that tolerate a lossy stream, this removes the
        # indirect backpressure of eviction: a terminated watcher relists,
        # and a LIST of a 100k-pod store under the global lock IS the stall
        # the bind workers would feel. Correctness
        # consumers (informer caches, the scheduler) keep ring=False — they
        # NEED the terminate->relist signal, a silent gap would corrupt them.
        self.ring = ring
        self.ring_dropped = 0  # lifetime ring_overflow drops (telemetry)
        self._store = store
        # stable subscriber id for the per-subscriber queue-length gauge
        # (store_watch_subscriber_queue_length) and watch_telemetry()
        self.id = f"w{next(_watch_seq)}"
        # kind: None = all kinds; a str = one kind; a set/tuple = several
        # (components subscribe to exactly what they handle, so high-volume
        # kinds they ignore — e.g. events — never fill their buffers)
        self._kinds = (None if kind is None
                       else {kind} if isinstance(kind, str) else set(kind))
        # coalesce=True opts into the internal fast-path channel: a batched
        # write (bind_many/create_many chunk) arrives as ONE CoalescedEvent
        # (counting as one buffered item) instead of N per-object events.
        # Consumers must handle both — history replay is always per-object.
        self.coalesce = coalesce
        self._stopped = False
        self.terminated = False  # True when evicted for falling behind
        # optional ping invoked after each delivery (a select-based watch
        # mux wakes on it instead of spending a blocked thread per stream)
        self.on_event = None
        # watch-propagation tracing: dequeue taps are O(1) — they append
        # (events, t_dequeue) ops here; per-event settlement into the
        # store's commit->delivery histograms runs at the next read surface
        # (watch_telemetry) or inline past _PROP_OPS_CAP, billed to
        # stat_sink (an object with note_self_time(seconds)). last_delivered_rv feeds the rv-lag
        # gauge; _prop_min_rv excludes replayed history from the latency
        # distribution (a late subscriber's replay is catch-up, not bus lag).
        self._prop_ops: deque = deque()
        self.last_delivered_rv = 0
        self._prop_min_rv = 0
        self.stat_sink = None

    _PROP_OPS_CAP = 64

    def _note_delivered(self, evs) -> None:
        """O(1) dequeue tap: ONE perf_counter read for the drained batch,
        one deque append (refs only — the consumer holds the events alive
        through its own processing anyway), one rv watermark store."""
        self.last_delivered_rv = evs[-1].resource_version
        if not self._store._watch_propagation:
            return
        self._prop_ops.append((evs, time.perf_counter()))
        if len(self._prop_ops) > self._PROP_OPS_CAP:
            self._store._settle_propagation(self, inline=True)

    def _deliver(self, ev: Event) -> None:
        if self.terminated or self._stopped:
            return
        if _chaos.ACTIVE is not None and _chaos.ACTIVE.should_drop(
                "watch.deliver", ev.kind):
            # injected delivery drop (drop-only site: lock held), counted
            # by reason so a chaos run can show what the resync recovered
            self._store._note_watch_drop("chaos", ev.kind)
            return
        if self._kinds is None or ev.kind in self._kinds:
            try:
                self._q.put_nowait(ev)
                cb = self.on_event
                if cb is not None:
                    # the wake ping is non-blocking by contract; the
                    # delivery itself is put_nowait
                    cb()
            except queue.Full:
                self._overflow(ev)

    def _deliver_coalesced(self, cev: "CoalescedEvent") -> None:
        """Deliver a whole batched write as one buffered item (fast-path
        channel; only called for coalesce=True watchers)."""
        if self.terminated or self._stopped:
            return
        if _chaos.ACTIVE is not None and _chaos.ACTIVE.should_drop(
                "watch.deliver", cev.kind):
            # injected drop of a whole coalesced batch — counted once (the
            # unit dropped is the delivery, matching the injection site)
            self._store._note_watch_drop("chaos", cev.kind)
            return
        if self._kinds is None or cev.kind in self._kinds:
            try:
                self._q.put_nowait(cev)
                cb = self.on_event
                if cb is not None:
                    # same non-blocking wake-ping contract as _deliver
                    cb()
            except queue.Full:
                self._overflow(cev)

    def _overflow(self, item=None) -> None:
        if self.ring and item is not None:
            # ring mode: drop the OLDEST buffered delivery to make room for
            # the newest — the subscription survives with a counted gap.
            # Everything here is non-blocking (get_nowait/put_nowait), so
            # the emitting writer is never backpressured by a slow consumer.
            try:
                old = self._q.get_nowait()
            except queue.Empty:
                old = None  # consumer drained between Full and here: the
                # slot freed itself, nothing was actually lost
            if old is not None:
                self.ring_dropped += 1
                self._store._note_watch_drop("ring_overflow", old.kind)
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                # raced with a concurrent writer refilling the slot: this
                # delivery is the drop instead
                self.ring_dropped += 1
                self._store._note_watch_drop("ring_overflow", item.kind)
                return
        # slow watcher: evict rather than buffer forever; drop one
        # event to make room for the end-of-stream sentinel (the
        # stream is void anyway — the consumer must relist)
        self.terminated = True
        self._store._note_watch_drop("overflow", "")
        self._store._unsubscribe(self)
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    def get(self, timeout: Optional[float] = None) -> Optional[Event]:
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if ev is not None:
            self._note_delivered((ev,))
        return ev

    def drain(self, max_n: Optional[int] = None) -> List[Event]:
        """Drain buffered events; max_n bounds the take so a capped consumer
        LEAVES the remainder buffered (a break mid-list would silently drop
        already-dequeued events)."""
        out = []
        while max_n is None or len(out) < max_n:
            try:
                ev = self._q.get_nowait()
            except queue.Empty:
                break
            if ev is not None:
                out.append(ev)
        if out:
            self._note_delivered(out)
        return out

    def __iter__(self):
        while not self._stopped:
            ev = self._q.get()
            if ev is None:
                return
            self._note_delivered((ev,))
            yield ev

    def stop(self) -> None:
        self._stopped = True
        self._store._unsubscribe(self)
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # consumer is behind anyway; it checks _stopped/terminated


class LockOrderViolation(RuntimeError):
    """A thread acquired a store lock of lower rank than one it already
    holds (the module docstring's ordering table reversed — a latent
    deadlock against every writer of that kind)."""


class _LockOrderState(threading.local):
    """Per-store, per-thread held-lock stack for the order assertion."""

    def __init__(self):
        self.stack = []


class _OrderedRLock:
    """RLock wrapper asserting the store's lock-ordering rule at runtime,
    catching acquisition orders a reading of the code cannot prove
    (callbacks, reflection, test doubles). Enabled per store via
    APIStore(lock_order_check=True) or env STORE_LOCK_ORDER_CHECK=1 (pytest
    turns it on for every test store through an autouse fixture in
    tests/conftest.py).

    Rule: acquiring a lock of LOWER rank than one already held (global 0 <
    pods shard 1 < nodes shard 2) raises LockOrderViolation — unless the
    thread already holds the lock (reentrant acquires never deadlock). The
    stack is per-store, so two independent stores never alias ranks.

    Every fresh acquisition made while another ordered lock is held also
    RECORDS the edge (held -> acquired) into the lock-graph witness
    (store/lockgraph.py), whose diff() holds the run's edge set against the
    ordering table. The record is one dict hit; the stack is captured only
    on an edge's first sighting."""

    __slots__ = ("_lock", "_rank", "_name", "_state", "_witness")

    def __init__(self, name: str, rank: int, state: _LockOrderState,
                 witness=None):
        from .lockgraph import WITNESS

        self._lock = threading.RLock()
        self._rank = rank
        self._name = name
        self._state = state
        self._witness = WITNESS if witness is None else witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = self._state.stack
        if all(held is not self for held in stack):  # fresh, not reentrant
            for held in stack:
                if held._rank > self._rank:
                    raise LockOrderViolation(
                        f"acquiring {self._name} while holding "
                        f"{held._name}: store/store.py mandates _lock "
                        "(global RV) -> _pods_lock (pods shard) -> "
                        "_nodes_lock (nodes shard), never reversed")
            if stack:
                top = stack[-1]
                self._witness.record(top._name, top._rank,
                                     self._name, self._rank)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            stack.append(self)
        return ok

    def release(self) -> None:
        stack = self._state.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _LockPair:
    """Context manager acquiring the global RV lock then a kind shard, in the
    module docstring's mandatory order (both RLocks, so nesting under either
    is fine)."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __enter__(self):
        self.a.acquire()
        self.b.acquire()
        return self

    def __exit__(self, *exc):
        self.b.release()
        self.a.release()


class _LockChain:
    """_LockPair generalized to the full ranked chain (global, pods, nodes):
    acquires every lock in the ordering
    table's ascending-rank order, releases in reverse. Safe to nest under
    any prefix of itself (all RLocks)."""

    __slots__ = ("locks",)

    def __init__(self, *locks):
        self.locks = locks

    def __enter__(self):
        for lk in self.locks:
            lk.acquire()
        return self

    def __exit__(self, *exc):
        for lk in reversed(self.locks):
            lk.release()


class APIStore:
    """The hub every component is a client of."""

    def __init__(self, deep_copy_on_write: bool = True,
                 mutation_detector: Optional[bool] = None,
                 lazy_pod_events: Optional[bool] = None,
                 lock_order_check: Optional[bool] = None,
                 watch_propagation: bool = True,
                 native_commit: Optional[bool] = None,
                 columnar: Optional[bool] = None,
                 history_limit: int = 50_000):
        import os

        if lock_order_check is None:
            lock_order_check = os.environ.get(
                "STORE_LOCK_ORDER_CHECK", "").lower() in ("1", "true")
        if lock_order_check:
            # rank-asserting lock wrappers (see _OrderedRLock)
            state = _LockOrderState()
            self._lock = _OrderedRLock("_lock (global RV)", 0, state)
            self._pods_lock = _OrderedRLock("_pods_lock (pods shard)", 1,
                                            state)
            self._nodes_lock = _OrderedRLock("_nodes_lock (nodes shard)", 2,
                                             state)
        else:
            self._lock = threading.RLock()
            # the per-kind shards — see the module docstring's lock-ordering
            # TABLE (_lock -> _pods_lock -> _nodes_lock, ascending rank only)
            self._pods_lock = threading.RLock()
            self._nodes_lock = threading.RLock()
        self._pods_pair = _LockPair(self._lock, self._pods_lock)
        self._nodes_pair = _LockPair(self._lock, self._nodes_lock)
        self._store_chain = _LockChain(self._lock, self._pods_lock,
                                       self._nodes_lock)
        self._rv = 0  # monotonic resourceVersion, read via .rv
        if mutation_detector is None:
            mutation_detector = os.environ.get(
                "CACHE_MUTATION_DETECTOR", "").lower() in ("1", "true")
        self._mutation_detector = MutationDetector() if mutation_detector else None
        # lazy pod events (module docstring): default on; STORE_LAZY_POD_EVENTS=0
        # or the constructor arg force the eager per-event clones (the parity
        # oracle the columnar-pipeline tests compare against)
        if lazy_pod_events is None:
            lazy_pod_events = os.environ.get(
                "STORE_LAZY_POD_EVENTS", "").lower() not in ("0", "false")
        self._lazy_pod_events = lazy_pod_events
        # native host commit engine (module docstring): default on;
        # STORE_NATIVE_COMMIT=0 or the constructor argument select the
        # Python loops (the parity tests' oracle). The engine is loaded at
        # the first commit, so a fresh checkout's one-time g++ build never
        # blocks construction.
        if native_commit is None:
            native_commit = os.environ.get(
                "STORE_NATIVE_COMMIT", "").lower() not in ("0", "false")
        self._native_commit = native_commit
        # columnar pod-row table (module docstring): default on
        # when numpy is importable AND the store carries the lazy/deep-copy
        # event contract the column commit path is written against; the
        # env/constructor knobs and a numpy-less rig all fall back to the
        # pure dict path (the byte-for-bit oracle).
        if columnar is None:
            columnar = _columnar.env_enabled()
        self._cols = (_columnar.PodColumns(pod_bind_clone)
                      if columnar and _columnar.numpy_available()
                      and deep_copy_on_write and self._lazy_pod_events
                      else None)
        # kind -> {"namespace/name" or "name": obj}. The sharded kinds' row
        # dicts exist from birth so shard-only paths never mutate the kind
        # map. NOTE: a pod row may be STALE while its columnar row is
        # diverged (bind committed by column writes only) — internal readers
        # go through _materialize_pod_row / _materialize_pod_rows first.
        self._objects: Dict[str, Dict[str, Any]] = {"pods": {}, "nodes": {}}
        # bounded event history for watch replay (RV-ordered; columnar bind
        # calls retain ONE LazyBindBatch marker each). The bound is the
        # store's steady-state memory knob: each retained eager event pins
        # an object clone (a lazy batch pins only base refs), so a churning
        # control plane holds up to ~history_limit x pod-size bytes HERE.
        # A resume older than the floor relists, the contract subscribers
        # already handle.
        self._history: List[Any] = []
        self._history_n = 0  # EVENT count (batch markers count their size)
        self._history_limit = history_limit
        # all events with rv > _history_floor_rv are retained
        self._history_floor_rv = 0
        self._watchers: List[Watch] = []
        self._deep_copy = deep_copy_on_write
        # watch-bus telemetry: per-reason dropped delivery counts (chaos injection, overflow eviction) kept as plain
        # ints here (the drop sites run under the store lock) and mirrored
        # into store_watch_dropped_deliveries_total
        self._watch_drops: Dict[str, int] = {}
        self._watch_metrics_registered = False
        # watch-propagation tracing: commit->dequeue latency per kind. Events carry a perf_counter commit stamp (one read per
        # batched write); subscriber dequeue taps record O(1) ops settled
        # HERE at render time (watch_telemetry) under a private lock — never
        # the store lock. False disables stamps AND taps (the
        # parity-oracle knob for the on/off byte-identical test).
        self._watch_propagation = watch_propagation
        self._prop_lock = threading.Lock()
        self._prop_hist: Dict[str, Any] = {}  # kind -> metrics.Histogram
        self._prop_settle_s = 0.0

    # -- helpers ---------------------------------------------------------------

    def _native_commit_engine(self):
        """The loaded C-API commit engine, or None where this store or the
        HOSTSCHED_NATIVE_COMMIT switch selects the Python loops. The first
        call pays the one-time g++ build and raises if it fails; call it
        before taking a store lock."""
        if not self._native_commit:
            return None
        from ..native import hostcommit

        return hostcommit if hostcommit.selected() else None

    @property
    def rv(self) -> int:
        """Current (highest committed) resourceVersion."""
        with self._lock:
            return self._rv

    def _kind_lock(self, kind: str):
        """The lock(s) an op touching `kind` rows plus RV/history must hold:
        the global lock alone for most kinds, global + shard (ascending rank
        order) for the sharded kinds (pods, nodes)."""
        if kind == "pods":
            return self._pods_pair
        if kind == "nodes":
            return self._nodes_pair
        return self._lock

    def _materialize_pod_row(self, key: str) -> None:
        """Reconcile ONE diverged columnar row into its dict object before a
        dict-path read/write touches it (caller holds the pods shard). No-op
        on the dict path or for clean/missing rows."""
        if self._cols is not None:
            self._cols.materialize_key(key, self._objects["pods"])

    def _materialize_pod_rows(self) -> None:
        """Reconcile EVERY diverged columnar row (LIST / snapshot reads;
        caller holds the pods shard). Cost is one bind clone per row bound
        since the last full read — exactly the clones the columnar commit
        skipped, paid once and only when someone actually reads the rows."""
        if self._cols is not None:
            self._cols.materialize_all(self._objects["pods"])

    @staticmethod
    def object_key(obj) -> str:
        meta = obj.metadata
        ns = getattr(meta, "namespace", None)
        return f"{ns}/{meta.name}" if ns else meta.name

    def _copy(self, obj):
        """Full isolation copy: get/list results and stored create/update
        inputs must be immune to caller mutation, however deep."""
        return copy.deepcopy(obj) if self._deep_copy else obj

    def _event_copy(self, obj):
        """Copy for WATCH EVENTS — the fan-out hot path under churn. Event
        objects carry the client-go read-only contract (that is what the
        mutation detector polices), so pods take the ~20x cheaper structural
        clone; core Events (recorder narration — one store write per victim
        under preemption storms) take a flat-field clone; other kinds keep
        deepcopy. get/list/storage copies stay on _copy: their callers never
        signed the event contract."""
        if self._deep_copy:
            if type(obj) is Pod:
                return pod_structural_clone(obj)
            if type(obj).__name__ == "Event" and hasattr(obj, "involved_kind"):
                # core/v1 Event: scalar fields + metadata — a fresh shell
                # with a private metadata is full isolation minus the shared
                # metadata containers, same contract as pod events
                new = _shallow(obj)
                new.metadata = _shallow(obj.metadata)
                return new
        return self._copy(obj)

    def _emit(self, etype: str, kind: str, obj, prev=None) -> None:
        # Events carry a copy, never the stored object. For pods the copy is
        # a STRUCTURAL clone: top-level metadata/spec/status are private, but
        # nested spec members (containers, volumes, tolerations, ...) are
        # shared with the stored pod — event objects are read-only all the
        # way down, and the mutation detector polices exactly that contract.
        self._emit_prepared(etype, kind, self._event_copy(obj), prev=prev)

    def check_mutations(self) -> None:
        """Raise MutationDetectedError if any watcher mutated an event object
        (no-op unless the detector is enabled)."""
        if self._mutation_detector is not None:
            self._mutation_detector.check()

    def _emit_prepared(self, etype: str, kind: str, obj, prev=None) -> None:
        """Emit an event whose object is ALREADY private to the event (hot
        write paths pre-clone instead of paying a second deepcopy here).
        prev is the replaced stored object — orphaned from the store by this
        very write, so sharing it with watchers is safe (read-only)."""
        self._emit_event(Event(etype, kind, obj, self._rv, prev,
                               commit_ts=self._commit_stamp()))

    def _commit_stamp(self) -> float:
        """The propagation commit stamp for an event being emitted right now
        (0.0 when tracing is off). Batched writes read perf_counter ONCE and
        share the stamp across the batch instead of calling this per event."""
        return time.perf_counter() if self._watch_propagation else 0.0

    def _pod_event(self, etype: str, obj, cloner, prev=None) -> Event:
        """Event for a just-committed pod write (the clone-free commit hot
        path). Lazy fast path: the event SHARES `obj` (the stored object, or
        delete's orphaned post-delete clone — never mutated in place; later
        writes replace the row) and materializes a private per-object clone
        only for non-coalescing consumers (_materialize_event). Falls back
        to the eager clone when lazy events are disabled (the parity oracle
        knob) or the store doesn't isolate at all (deep_copy_on_write=False
        shares everywhere already)."""
        ts = self._commit_stamp()
        if not self._deep_copy:
            return _make_event(etype, "pods", obj, self._rv, prev,
                               commit_ts=ts)
        if self._lazy_pod_events:
            return _make_event(etype, "pods", obj, self._rv, prev,
                               lazy=[None, cloner], commit_ts=ts)
        return _make_event(etype, "pods", cloner(obj), self._rv, prev,
                           commit_ts=ts)

    def _materialize_event(self, ev: Event) -> Event:
        """The per-object form of a lazy event: a private clone of the shared
        stored object, built at most ONCE (first delivery or replay to a
        non-coalescing watcher) and reused for every later per-object
        consumer — all of them see the same object identity, exactly like
        the eager path. Callers hold _lock. The detector fingerprints the
        materialized object too, so a watcher mutating it is caught even
        though the emission-time record covered only the shared form."""
        lazy = ev.lazy
        if lazy is None:
            return ev
        mat = lazy[0]
        if mat is None:
            # the materialized form keeps the ORIGINAL commit stamp:
            # propagation measures commit->dequeue, not clone time
            mat = _make_event(ev.type, ev.kind, lazy[1](ev.obj),
                              ev.resource_version, ev.prev,
                              commit_ts=ev.commit_ts)
            if self._mutation_detector is not None:
                self._mutation_detector.record(mat)
            lazy[0] = mat
        return mat

    def _emit_event(self, ev: Event) -> None:
        """History + delivery for one event. Lazy events reach coalescing
        watchers (and history) in their shared form; per-object watchers get
        the materialized private clone."""
        if self._mutation_detector is not None:
            self._mutation_detector.record(ev)
        self._history.append(ev)
        self._history_n += 1
        self._trim_history()
        # snapshot: _deliver may evict (unsubscribe) a slow watcher mid-loop
        for w in list(self._watchers):
            if ev.lazy is not None and not w.coalesce:
                w._deliver(self._materialize_event(ev))
            else:
                w._deliver(ev)

    def _emit_batch(self, etype: str, kind: str, events: List[Event],
                    origin: Optional[str]) -> None:
        """Emit one batched write: per-object events go to history and every
        per-object watcher (external semantics unchanged — ordering and rv
        monotonicity are the list order), while coalesce=True watchers get a
        single CoalescedEvent for the whole batch (the internal fast path;
        one buffered item, one wake-up). Lazy events materialize their
        per-object clones once for the whole watcher set."""
        if not events:
            return
        if self._mutation_detector is not None:
            for ev in events:
                self._mutation_detector.record(ev)
        self._history.extend(events)
        self._history_n += len(events)
        self._trim_history()
        cev = None
        mat = None
        for w in list(self._watchers):
            if w.coalesce:
                if cev is None:
                    # the batch's shared stamp rides the coalesced form too
                    # (without it batched ingest would be invisible to the
                    # propagation histograms)
                    cev = CoalescedEvent(etype, kind, tuple(events),
                                         events[-1].resource_version, origin,
                                         events[-1].commit_ts)
                w._deliver_coalesced(cev)
            else:
                if mat is None:
                    mat = [self._materialize_event(ev) for ev in events]
                for ev in mat:
                    w._deliver(ev)

    def _trim_history(self) -> None:
        """Enforce the retained-event bound (caller holds _lock). History
        items are Events or whole LazyBindBatch markers; trimming drops
        whole items from the front until the overshoot plus a quarter of the
        bound is gone (hysteresis: one trim per ~limit/4 events, not one per
        event) and advances the replay floor to the last dropped rv."""
        if self._history_n <= self._history_limit:
            return
        target = (self._history_n - self._history_limit
                  + self._history_limit // 4)
        dropped = 0
        i = 0
        h = self._history
        while i < len(h) and dropped < target:
            item = h[i]
            dropped += item.n if type(item) is LazyBindBatch else 1
            i += 1
        self._history_floor_rv = h[i - 1].resource_version
        del h[:i]
        self._history_n -= dropped

    def history_events(self, since_rv: int = -1):
        """Flat per-object iteration of the retained history with rv >
        since_rv — the debug/testing read surface (pod-conservation audits,
        bind-transition counts). Columnar bind batches materialize their
        per-object events on demand; items are read-only like any event."""
        with self._lock:
            items = list(self._history)
        for item in items:
            if type(item) is LazyBindBatch:
                for ev in item.events_since(since_rv):
                    yield ev
            elif item.resource_version > since_rv:
                yield item

    # -- CRUD ------------------------------------------------------------------

    def create(self, kind: str, obj) -> Any:
        with self._kind_lock(kind):
            objs = self._objects.setdefault(kind, {})
            key = self.object_key(obj)
            if key in objs:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            obj = self._copy(obj)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            objs[key] = obj
            if kind == "pods" and self._cols is not None:
                self._cols.insert(key, obj)
            self._emit(ADDED, kind, obj)
            return obj

    def create_many(self, kind: str, objects: Iterable[Any],
                    origin: Optional[str] = None,
                    consume: bool = False) -> Tuple[int, List[Tuple[str, str]]]:
        """Bulk create under ONE lock acquisition with ONE coalesced ADDED
        event for the batch (per-object events still reach history and
        per-object watchers — see _emit_batch). Per-object failures
        (AlreadyExists) don't abort the batch; returns (created_count,
        [(key, error message), ...]) like bind_many.

        consume=True transfers OWNERSHIP of the passed objects to the store
        (no isolation copy — the bulk-loader contract: the caller must never
        touch them again). Default False keeps create()'s copy semantics."""
        errors: List[Tuple[str, str]] = []
        created = 0
        events: List[Event] = []
        with self._kind_lock(kind):
            objs = self._objects.setdefault(kind, {})
            cols = self._cols if kind == "pods" else None
            # ONE shared commit stamp for the whole batch: the coalesced
            # ingest path must carry propagation stamps too
            t_commit = self._commit_stamp()
            for obj in objects:
                key = self.object_key(obj)
                if key in objs:
                    errors.append((key, f"{kind} {key} already exists"))
                    continue
                if not consume:
                    obj = self._copy(obj)
                self._rv += 1
                obj.metadata.resource_version = self._rv
                objs[key] = obj
                if cols is not None:
                    cols.insert(key, obj)
                events.append(_make_event(ADDED, kind, self._event_copy(obj),
                                          self._rv, commit_ts=t_commit))
                created += 1
            self._emit_batch(ADDED, kind, events, origin)
        return created, errors

    def get(self, kind: str, key: str) -> Any:
        """Returns a copy (when deep_copy_on_write) — like a REST GET, each read is a
        fresh decode, so caller mutation can never corrupt stored state.
        Sharded-kind reads take the kind shard alone (no RV is returned, and
        every row commit of that kind holds its shard), so a bind batch in
        its validate phase never stalls them on the global lock."""
        if kind == "pods":
            lock = self._pods_lock
        elif kind == "nodes":
            lock = self._nodes_lock
        else:
            lock = self._lock
        with lock:
            if kind == "pods":
                # a columnar-bound row materializes on first read (shard
                # alone suffices: no RV allocation, no event emission)
                self._materialize_pod_row(key)
            try:
                return self._copy(self._objects.get(kind, {})[key])
            except KeyError:
                raise NotFoundError(f"{kind} {key} not found") from None

    def update(self, kind: str, obj, check_rv: bool = True) -> Any:
        with self._kind_lock(kind):
            objs = self._objects.setdefault(kind, {})
            key = self.object_key(obj)
            if kind == "pods":
                # the rv-conflict check below must see the row's CURRENT
                # state, not a pre-bind base a diverged columnar row stands
                # in front of
                self._materialize_pod_row(key)
            if key not in objs:
                raise NotFoundError(f"{kind} {key} not found")
            if check_rv and objs[key].metadata.resource_version != obj.metadata.resource_version:
                raise ConflictError(
                    f"{kind} {key}: rv {obj.metadata.resource_version} != "
                    f"{objs[key].metadata.resource_version}"
                )
            old = objs[key]
            obj = self._copy(obj)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            objs[key] = obj
            if kind == "pods" and self._cols is not None:
                row = self._cols.key2row.get(key)
                if row is not None:
                    self._cols.sync(row, obj)
            self._emit(MODIFIED, kind, obj, prev=old)
            return obj

    def guaranteed_update(self, kind: str, key: str, mutate: Callable[[Any], Any], max_retries: int = 16) -> Any:
        """Read-modify-write with conflict retry (reference: etcd3 GuaranteedUpdate)."""
        for _ in range(max_retries):
            cur = self.get(kind, key)
            updated = mutate(copy.deepcopy(cur))
            try:
                return self.update(kind, updated)
            except ConflictError:
                continue
        raise ConflictError(f"{kind} {key}: too many conflicts")

    def delete(self, kind: str, key: str) -> Any:
        with self._kind_lock(kind):
            objs = self._objects.get(kind, {})
            if kind == "pods":
                # the DELETED event's clone source must carry the committed
                # bind a diverged columnar row holds in its columns
                self._materialize_pod_row(key)
            if key not in objs:
                raise NotFoundError(f"{kind} {key} not found")
            old = objs.pop(key)
            if kind == "pods" and self._cols is not None:
                self._cols.remove(key)
            # The DELETED event carries the object at its post-delete RV (client-go
            # convention: watchers track progress from obj.metadata.resourceVersion).
            # Pods take ONE structural clone (hot under preemption victim
            # storms: the async preparation worker deletes victims at batch
            # rate): the stamped clone is shared lazily with the event AND
            # returned — the return value is the history/event object, so it
            # carries the event read-only contract (the mutation detector
            # polices it; in-repo delete consumers serialize or discard it).
            # Other kinds keep the deepcopy + event-copy pair.
            if self._deep_copy and type(old) is Pod:
                obj = pod_structural_clone(old)
                self._rv += 1
                obj.metadata.resource_version = self._rv
                self._emit_event(self._pod_event(
                    DELETED, obj, pod_structural_clone, prev=old))
                return obj
            obj = self._copy(old)
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._emit(DELETED, kind, obj, prev=old)
            return obj

    def list(self, kind: str, predicate: Optional[Callable[[Any], bool]] = None) -> Tuple[List[Any], int]:
        """Consistent snapshot + the RV it is current to. Items are copies (when
        deep_copy_on_write), like a REST LIST response."""
        with self._kind_lock(kind):
            if kind == "pods":
                self._materialize_pod_rows()
            items = list(self._objects.get(kind, {}).values())
            if predicate is not None:
                items = [o for o in items if predicate(o)]
            return [self._copy(o) for o in items], self._rv

    def list_many(self, kinds: Iterable[str]) -> Tuple[Dict[str, List[Any]], int]:
        """Consistent multi-kind snapshot under one RV — the safe way to seed an
        informer over several kinds (a per-kind list+watch would race: an object
        created between two lists is in neither the lists nor the replay).
        Takes the global lock plus every requested shard, in the ordering
        table's ascending-rank order."""
        kinds = list(kinds)
        has_pods = "pods" in kinds
        has_nodes = "nodes" in kinds
        if has_pods and has_nodes:
            lock = self._store_chain
        elif has_pods:
            lock = self._pods_pair
        elif has_nodes:
            lock = self._nodes_pair
        else:
            lock = self._lock
        with lock:
            if has_pods:
                self._materialize_pod_rows()
            out = {k: [self._copy(o) for o in self._objects.get(k, {}).values()] for k in kinds}
            return out, self._rv

    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    def kinds(self) -> List[str]:
        """Kinds that currently hold at least one object (discovery-equivalent)."""
        with self._lock:
            return [k for k, objs in self._objects.items() if objs]

    def transaction(self, kind: Optional[str] = None):
        """Hold the store locks across several operations (reentrant), making
        a read-check-write sequence atomic against other threads — the
        stand-in for the reference's etcd txn around quota check+create.
        Default (kind=None) takes the full chain (global + every shard, in
        the ordering table's rank order) — safe for any sequence. Callers
        that provably touch only one kind's rows can pass it to take the
        narrower lock set, so they don't stall holding the chain behind a
        bind batch's shard-only validate phase."""
        if kind == "pods":
            return self._pods_pair
        if kind == "nodes":
            return self._nodes_pair
        if kind is not None:
            return self._lock
        return self._store_chain

    # -- watch -----------------------------------------------------------------

    def watch(self, kind=None, since_rv: int = -1,
              maxsize: int = Watch.DEFAULT_MAXSIZE,
              coalesce: bool = False, ring: bool = False) -> Watch:
        """Subscribe to events. since_rv >= 0 replays history events with rv > since_rv
        first (the Reflector resume contract); since_rv == -1 means 'from now'.
        Raises ResourceVersionTooOldError if since_rv predates retained history
        or the replay alone would overflow the watch buffer — the caller must
        relist (410 Gone analog). maxsize bounds the per-watcher buffer; a
        consumer that falls that far behind is evicted (Watch.terminated).
        coalesce=True opts into CoalescedEvent delivery for batched writes
        (replay is still per-object). ring=True makes the bounded buffer a
        lossy ring for slow OBSERVABILITY consumers: overflow drops the
        oldest delivery (counted, reason="ring_overflow") and the
        subscription survives instead of terminating into a relist storm —
        see Watch.__init__; never use it for a consumer that builds a cache
        from the stream."""
        with self._lock:
            if 0 <= since_rv < self._history_floor_rv:
                raise ResourceVersionTooOldError(
                    f"rv {since_rv} is older than retained history (floor "
                    f"{self._history_floor_rv}); relist required"
                )
            replay = []
            replay_n = 0
            if since_rv >= 0:
                # history items are Events or whole LazyBindBatch markers;
                # count before materializing anything (a too-old resume must
                # not pay for events it will never deliver)
                for item in self._history:
                    if type(item) is LazyBindBatch:
                        c = item.count_since(since_rv)
                        if c:
                            replay.append(item)
                            replay_n += c
                    elif item.resource_version > since_rv:
                        replay.append(item)
                        replay_n += 1
                if maxsize and replay_n >= maxsize:
                    raise ResourceVersionTooOldError(
                        f"replay of {replay_n} events from rv {since_rv} exceeds "
                        f"the watch buffer ({maxsize}); relist required")
            w = Watch(self, kind, maxsize=maxsize, coalesce=coalesce,
                      ring=ring)
            # propagation baseline: replayed history is catch-up,
            # not bus lag — only events committed AFTER this subscription
            # enter the latency distribution. The delivered-RV watermark
            # starts at the resume point (or now) so the lag gauge reads 0
            # until real commits outrun the consumer.
            w._prop_min_rv = self._rv
            w.last_delivered_rv = since_rv if since_rv >= 0 else self._rv
            for item in replay:
                # a non-coalescing subscriber arriving mid/after a lazy batch
                # must see fully private event objects, same as live delivery
                # (replay is always per-object — columnar batches expand)
                if type(item) is LazyBindBatch:
                    for ev in item.events_since(since_rv):
                        w._deliver(ev if coalesce
                                   else self._materialize_event(ev))
                else:
                    w._deliver(item if coalesce
                               else self._materialize_event(item))
            self._watchers.append(w)
            # first successful subscription: expose this store's subscribers
            # to the render-time queue-length gauge (weakref — a collected
            # store silently drops out). Flag flipped under the lock so two
            # concurrent first watch() calls can't both register (duplicate
            # series); the registry call itself stays outside the critical
            # section.
            register = not self._watch_metrics_registered
            self._watch_metrics_registered = True
        if register:
            _metrics.register_watch_source(weakref.ref(self))
        return w

    def _unsubscribe(self, w: Watch) -> None:
        with self._lock:
            try:
                self._watchers.remove(w)
            except ValueError:
                pass

    def _note_watch_drop(self, reason: str, kind: str) -> None:
        """Count one dropped watch delivery (chaos injection or overflow
        eviction) — rare by construction, so the metrics import/inc on this
        path costs nothing in the steady state."""
        self._watch_drops[reason] = self._watch_drops.get(reason, 0) + 1
        _metrics.store_watch_dropped.inc(reason=reason, kind=kind)

    # -- watch propagation ------------------------------------------------------

    def _prop_child(self, kind: str):
        """The per-kind commit->dequeue histogram (created on first use,
        under the private propagation lock — never the store lock)."""
        with self._prop_lock:
            h = self._prop_hist.get(kind)
            if h is None:
                h = self._prop_hist[kind] = _metrics.Histogram(
                    "watch_propagation", buckets=_metrics.PROPAGATION_BUCKETS)
            return h

    def _settle_propagation(self, w: Watch, inline: bool = False) -> None:
        """Settle one subscriber's pending dequeue ops into the per-kind
        propagation histograms (private + the process-wide Prometheus
        series). Runs at read surfaces (watch_telemetry) or inline on the
        consuming thread past the ops cap — inline cost bills the watch's
        stat_sink (the scheduler's flight recorder), read-side cost accrues
        to the settle_seconds counter only. Concurrent settlers are safe:
        deque.popleft hands each op to exactly one of them."""
        ops = w._prop_ops
        if not ops:
            return
        t0 = time.perf_counter()
        min_rv = w._prop_min_rv
        by_kind: Dict[str, List[float]] = {}
        bulk: List[Tuple[str, float, int]] = []
        while True:
            try:
                evs, t = ops.popleft()
            except IndexError:
                break
            for ev in evs:
                ts = ev.commit_ts
                if ts <= 0.0 or ev.resource_version <= min_rv:
                    continue  # unstamped, or replayed catch-up history
                if type(ev) is CoalescedEvent:
                    # the whole batch shares ONE stamp: n observations of
                    # one value, one bucket probe (Histogram.observe_n)
                    bulk.append((ev.kind, t - ts, len(ev.events)))
                else:
                    by_kind.setdefault(ev.kind, []).append(t - ts)
        for kind, vals in by_kind.items():
            h = self._prop_child(kind)
            res = h.bucket_counts(vals)
            if res is not None:
                # one numpy bucket pass feeds the private histogram AND the
                # process-wide series (identical bucket layouts)
                h.observe_counts(*res)
                _metrics.store_watch_propagation.child(kind).observe_counts(*res)
        for kind, val, n in bulk:
            self._prop_child(kind).observe_n(val, n)
            _metrics.store_watch_propagation.child(kind).observe_n(val, n)
        dt = time.perf_counter() - t0
        with self._prop_lock:
            self._prop_settle_s += dt
        # trace timeline: one slice per settlement PASS (a pass
        # drains every pending dequeue op — never per event)
        if _tracebuf.ACTIVE is not None:
            settled = sum(len(v) for v in by_kind.values()) \
                + sum(n for _k, _v, n in bulk)
            _tracebuf.ACTIVE.note_span(
                "watch", "settle", t0, t0 + dt, cat="watch",
                args={"events": settled, "inline": inline})
        if inline:
            sink = w.stat_sink
            if sink is not None:
                sink.note_self_time(dt)

    def clear_watch_propagation(self) -> None:
        """Reset the settled propagation distributions (a measurement
        clears them at its window's start)."""
        with self._prop_lock:
            self._prop_hist.clear()
            self._prop_settle_s = 0.0

    def watch_propagation_summary(self) -> Dict:
        """Per-kind + merged commit->dequeue distribution. Callers
        that need fresh numbers go through watch_telemetry(), which settles
        every subscriber's pending ops first."""
        with self._prop_lock:
            hists = dict(self._prop_hist)
            settle = self._prop_settle_s
        merged = _metrics.Histogram("merged", buckets=_metrics.PROPAGATION_BUCKETS)
        kinds: Dict[str, Dict] = {}
        for kind, h in sorted(hists.items()):
            counts, total_sum, n = h.counts_snapshot()
            if n == 0:
                continue
            merged.observe_counts(counts, total_sum, n)
            kinds[kind] = {
                "count": n,
                "mean_s": round(total_sum / n, 6),
                "p50_s": round(h.quantile(0.50), 6),
                "p99_s": round(h.quantile(0.99), 6),
            }
        total_sum, n = merged.snapshot()
        return {
            "kinds": kinds,
            "count": n,
            "p50_s": round(merged.quantile(0.50), 6) if n else None,
            "p99_s": round(merged.quantile(0.99), 6) if n else None,
            "settle_seconds": round(settle, 6),
        }

    def watch_subscriber_telemetry(self) -> List[Dict]:
        """Subscriber rows only — the cheap read the watch GaugeFuncs
        (server/metrics.py) use per scrape. Settles pending propagation ops first (keeps the
        Prometheus propagation series fresh and the per-watch op deques
        empty — a falsy no-op when nothing is pending) but SKIPS the
        merged-summary construction watch_telemetry() does, which the
        gauges never read. The rv watermark is against the GLOBAL
        resourceVersion stream (etcd-revision semantics), so a
        kind-filtered subscriber's lag includes unrelated commits — like
        the reference's watch-cache lag, it measures staleness, not
        undelivered matching events."""
        with self._lock:
            watchers = list(self._watchers)
            rv = self._rv
        for w in watchers:
            # outside the store lock
            self._settle_propagation(w)
        return [{"id": w.id,
                 "queue_length": w._q.qsize(),
                 "coalesce": w.coalesce,
                 "ring": w.ring,
                 "ring_dropped": w.ring_dropped,
                 "terminated": w.terminated,
                 "last_delivered_rv": w.last_delivered_rv,
                 "rv_lag": max(0, rv - w.last_delivered_rv)}
                for w in watchers]

    def watch_lag(self) -> Dict:
        """Subscriber count + worst delivered-RV lag as a PURE O(subscribers)
        read — no propagation-op settlement, no distribution construction
        (settlement stays owned by the surfaces that publish distributions:
        watch_telemetry and the watch gauges)."""
        with self._lock:
            watchers = list(self._watchers)
            rv = self._rv
        return {"subscribers": len(watchers),
                "max_rv_lag": max((max(0, rv - w.last_delivered_rv)
                                   for w in watchers), default=0)}

    def watch_telemetry(self) -> Dict:
        """Per-subscriber watch-bus state: live subscriber ids with
        buffered-event counts and delivered-RV watermarks, the
        dropped-delivery counters by reason, and the settled commit->dequeue
        propagation distribution."""
        with self._lock:
            drops = dict(self._watch_drops)
        return {
            "subscribers": self.watch_subscriber_telemetry(),
            "dropped": drops,
            "propagation": self.watch_propagation_summary(),
        }

    # -- columnar read surfaces ---------------------------------------------------

    @property
    def columnar(self) -> bool:
        """True when the columnar pod-row table is engaged (numpy present,
        not opted out, lazy/deep-copy event contract)."""
        return self._cols is not None

    def pod_columns(self):
        """Read-only view over the live pod columns (store/columnar.py
        PodColumnsView), or None on the dict path. The view's rows/arrays
        are STORE-RETURNED READ-ONLY objects — the same contract as event
        objects and get/list results (the numpy members refuse writes at
        runtime).
        Take it under transaction(\"pods\") for a consistent snapshot, or
        read it lock-free as advisory telemetry."""
        if self._cols is None:
            return None
        with self._pods_lock:
            return _columnar.PodColumnsView(self._cols)

    def capture_sig_memos(self, pods) -> int:
        """Back-fill the columnar sig column from pod objects whose
        signature memos were primed outside the store. The scheduler calls
        this at the batch's
        bind/assume edge, right after build_pod_batch primed
        `_class_sig`/`_req_sig` on its queue pods: those refs anchor to the
        same spec/labels objects the stored rows share (structural clones
        copy __dict__ at the C level), so a row re-synced later by a
        status/relist write keeps a seedable signature instead of starting
        over. Returns the number of rows captured; 0 on the dict path."""
        if self._cols is None:
            return 0
        captured = 0
        with self._pods_lock:
            for p in pods:
                if self._cols.capture(p.key, p):
                    captured += 1
        return captured

    def columnar_stats(self) -> Optional[Dict]:
        """Columnar-table telemetry (rows, diverged count, lifetime lazy
        materializations, intern-table sizes); None on the dict path."""
        if self._cols is None:
            return None
        with self._pods_lock:
            return self._cols.stats()

    def enable_shm(self) -> Optional[str]:
        """Back the columnar numeric columns with a shared-memory arena
        (store/shm.py): the existing columns migrate into named /dev/shm
        segments a worker process can map read-only by the returned base
        name. Idempotent (returns the live arena's name); None on the dict
        path or where shared memory is unavailable. The store stays the ONLY
        writer: everything still mutates under the pods shard, into shared
        bytes."""
        if self._cols is None:
            return None
        from . import shm as _shm

        if not _shm.available():
            return None
        with self._pods_lock:
            if self._cols._arena is not None:
                return self._cols._arena.base_name
            arena = _shm.ShmArena(_shm.POD_COLS_SCHEMA, capacity=len(self._cols.keys))
            try:
                self._cols.attach_arena(arena)
            except Exception:
                arena.close()
                raise
            return arena.base_name

    @property
    def shm_name(self) -> Optional[str]:
        """The live pod-column arena's base name (None until enable_shm)."""
        cols = self._cols
        return cols._arena.base_name if cols is not None and cols._arena is not None else None

    def shm_close(self) -> None:
        """Detach and unlink the pod-column arena (idempotent). Whoever called
        enable_shm() owns calling this on its stop/finally path, so a
        teardown never leaks /dev/shm segments. The columns fall back to
        private numpy arrays with their contents preserved."""
        if self._cols is None:
            return
        with self._pods_lock:
            arena = self._cols._arena
            if arena is None:
                return
            cols = self._cols
            cap = len(cols.keys)
            for attr in cols._SHM_ATTRS:
                shared = getattr(cols, attr)
                setattr(cols, attr, _columnar.np.array(shared[:cap], copy=True))
            cols._arena = None
            arena.close()

    # -- scheduling-specific transactional surfaces ----------------------------

    def _pod_internal(self, key: str):
        # dict-path consumers (single bind, status writes) need the CURRENT
        # row: reconcile a diverged columnar row first (caller holds the
        # shard, which is all materialization needs)
        self._materialize_pod_row(key)
        try:
            return self._objects.get("pods", {})[key]
        except KeyError:
            raise NotFoundError(f"pods {key} not found") from None

    def bind(self, namespace: str, name: str, node_name: str) -> Any:
        """Atomic pod->node binding (reference: BindingREST.Create,
        pkg/registry/core/pod/storage/storage.go:149 — guaranteed-update that fails
        if the pod is already bound to a different node).

        Hot path: binds happen at batch-solver rate, so the stored object is ONE bind-specialized clone and the event
        shares it lazily (_pod_event) — per-object watchers get their private
        clone on first delivery."""
        with self._pods_pair:
            key = f"{namespace}/{name}"
            pod = self._pod_internal(key)
            if pod.spec.node_name:
                raise AlreadyBoundError(f"pod {key} is already bound to {pod.spec.node_name}")
            new = pod_bind_clone(pod)
            new.spec.node_name = node_name
            self._rv += 1
            new.metadata.resource_version = self._rv
            self._objects["pods"][key] = new
            if self._cols is not None:
                row = self._cols.key2row.get(key)
                if row is not None:
                    self._cols.sync(row, new)
            self._emit_event(self._pod_event(MODIFIED, new, pod_bind_clone,
                                             prev=pod))
            # the caller's copy is distinct from both the stored object and
            # the event object (mutating it must corrupt neither); the full
            # structural clone re-privatizes the metadata containers too
            return pod_structural_clone(new)

    def bind_many(self, bindings: Iterable[Tuple[str, str, str]],
                  origin: Optional[str] = None) -> Tuple[int, List[Tuple[str, str]]]:
        """Batched bind: one lock acquisition for a whole solver batch.
        bindings = (namespace, name, node_name) triples. Returns
        (bound_count, [(key, error message) ...]) — per-pod failures do not
        abort the batch (each binding is its own transaction, like N
        BindingREST calls back-to-back).

        origin tags the batch's CoalescedEvent so the writer can recognize
        its own bind MODIFIED events on re-ingest (the scheduler's bind
        worker confirms its assumes directly and skips them); foreign
        consumers and per-object watchers are unaffected.

        Two phases (module docstring lock-ordering rule): validate + ONE
        pod_bind_clone per pod under the kind shard ALONE — the expensive
        part, concurrent with every non-pod store client — then a short
        commit under global+shard that stamps a contiguous RV range, inserts
        the rows, and emits lazy events sharing the stored objects. Rows
        that changed between the phases (a concurrent store.bind from the
        serial fallback path) are re-validated by stored-object identity."""
        # commit-latency histogram: ONE observation per bind_many call
        # covering both phases, on success returns only (an injected raise
        # never committed)
        t0 = time.perf_counter()
        if _chaos.ACTIVE is not None:
            # injected transient store failure (raises/delays BEFORE any
            # lock): the caller's retry/backoff is what the chaos tests prove
            _chaos.ACTIVE.fire("store.bind_many")
        if self._cols is not None:
            # columnar pod-row path (module docstring): commit by column
            # writes, no per-pod dict/Event allocation
            return self._bind_many_columnar(bindings, origin, t0)
        errors: List[Tuple[str, str]] = []
        prepared: List = []  # (key, old stored pod, new clone, node_name)
        pods = self._objects["pods"]
        native = self._native_commit_engine()
        with self._pods_lock:
            if native is not None:
                # the native validate+clone loop: identical entries and
                # errors (PyDLL: GIL held, legal under the shard)
                native.bind_prepare(pods, bindings, prepared, errors)
            else:
                for namespace, name, node_name in bindings:
                    key = f"{namespace}/{name}"
                    pod = pods.get(key)
                    if pod is None:
                        errors.append((key, f"pods {key} not found"))
                        continue
                    if pod.spec.node_name:
                        errors.append(
                            (key, f"pod {key} is already bound to {pod.spec.node_name}"))
                        continue
                    new = pod_bind_clone(pod)
                    new.spec.node_name = node_name
                    prepared.append((key, pod, new, node_name))
        bound = 0
        if not prepared:
            _metrics.store_bind_many_duration.observe(
                time.perf_counter() - t0)
            return bound, errors
        if native is not None and _chaos.ACTIVE is not None:
            # injected native-commit failure in the phase gap: clones made,
            # NOTHING committed, no lock held, so the store is untouched and
            # the caller's retry/requeue machinery must conserve every pod
            _chaos.ACTIVE.fire("native.commit")
        events: List[Event] = []
        # mode decided once per batch; rv and the event constructor live in
        # locals — the loop below runs once a pod of a whole solver batch
        lazy_on = self._deep_copy and self._lazy_pod_events
        eager = self._deep_copy and not self._lazy_pod_events
        append = events.append
        get = pods.get
        with self._lock:
            with self._pods_lock:
                rv = self._rv
                # shared propagation stamp for the whole commit (one read)
                t_commit = self._commit_stamp()
                if native is not None:
                    mode = 1 if lazy_on else (2 if eager else 0)
                    rv, bound = native.bind_commit(
                        pods, prepared, events, errors, rv, mode, t_commit,
                        pod_bind_clone, MODIFIED)
                else:
                    for key, old, new, node_name in prepared:
                        if get(key) is not old:
                            # raced between the phases: re-validate on the
                            # current row (also catches duplicate keys
                            # within one batch — the second commit sees the
                            # first)
                            cur = get(key)
                            if cur is None:
                                errors.append((key, f"pods {key} not found"))
                                continue
                            if cur.spec.node_name:
                                errors.append(
                                    (key, f"pod {key} is already bound to "
                                          f"{cur.spec.node_name}"))
                                continue
                            old = cur
                            new = pod_bind_clone(cur)
                            new.spec.node_name = node_name
                        rv += 1
                        new.metadata.resource_version = rv
                        pods[key] = new
                        if lazy_on:
                            append(_make_event(MODIFIED, "pods", new, rv, old,
                                               [None, pod_bind_clone],
                                               t_commit))
                        elif eager:
                            append(_make_event(MODIFIED, "pods",
                                               pod_bind_clone(new), rv, old,
                                               commit_ts=t_commit))
                        else:
                            append(_make_event(MODIFIED, "pods", new, rv, old,
                                               commit_ts=t_commit))
                        bound += 1
                self._rv = rv
                self._emit_batch(MODIFIED, "pods", events, origin)
        _metrics.store_bind_many_duration.observe(time.perf_counter() - t0)
        return bound, errors

    def _bind_many_columnar(self, bindings, origin: Optional[str],
                            t0: float) -> Tuple[int, List[Tuple[str, str]]]:
        """bind_many on the columnar pod-row table. Same two
        phases and the same external contract as the dict path — identical
        RV sequence, error messages, event-stream content across both
        coalesce modes — but the commit is COLUMN WRITES (node ids, one
        contiguous rv range, the diverged bitmap) plus ONE LazyBindBatch
        event marker, instead of a clone-and-swap + Event per pod. Raced
        rows between the phases are re-validated against the row-rv
        snapshot (every row write bumps it; delete poisons it), mirroring
        the dict path's stored-object identity check."""
        cols = self._cols
        errors: List[Tuple[str, str]] = []
        native = self._native_commit_engine()
        if native is not None and not isinstance(bindings, (list, tuple)):
            bindings = list(bindings)
        with self._pods_lock:
            rows, ids, keys, rv_snap = cols.bind_prepare(bindings, errors, native)
        if not len(rows):
            _metrics.store_bind_many_duration.observe(
                time.perf_counter() - t0)
            return 0, errors
        if native is not None and _chaos.ACTIVE is not None:
            # the same phase-gap boundary as the dict path: rows validated,
            # NOTHING committed, no lock held
            _chaos.ACTIVE.fire("native.commit")
        bound = 0
        with self._lock:
            with self._pods_lock:
                rv0 = self._rv
                t_commit = self._commit_stamp()
                bound, keys, bases, ids = cols.commit_bind(
                    rows, ids, keys, rv_snap, rv0, errors)
                if bound:
                    self._rv = rv0 + bound
                    batch = LazyBindBatch(MODIFIED, rv0 + 1, keys, bases,
                                          ids, cols.node_names,
                                          pod_bind_clone, t_commit)
                    self._emit_bind_batch(batch, origin)
        _metrics.store_bind_many_duration.observe(time.perf_counter() - t0)
        return bound, errors

    def _emit_bind_batch(self, batch: LazyBindBatch,
                         origin: Optional[str]) -> None:
        """History + delivery for one columnar bind batch: ONE retained
        marker, ONE CoalescedEvent per coalescing watcher (lazy events
        sequence — len() without materialization), per-object watchers get
        the materialized stream through the ordinary lazy-slot path. With
        the mutation detector armed the batch materializes eagerly right
        here, so emission-time fingerprints exist exactly like the dict
        path's (the detector is a test-tier knob; the zero-alloc claim is
        about the production steady state)."""
        if self._mutation_detector is not None:
            for ev in batch.events():
                self._mutation_detector.record(ev)
        self._history.append(batch)
        self._history_n += batch.n
        self._trim_history()
        cev = None
        mat = None
        for w in list(self._watchers):
            if w.coalesce:
                if cev is None:
                    cev = CoalescedEvent(batch.type, "pods",
                                         _LazyEventSeq(batch),
                                         batch.resource_version, origin,
                                         batch.commit_ts)
                w._deliver_coalesced(cev)
            else:
                if mat is None:
                    mat = [self._materialize_event(ev)
                           for ev in batch.events()]
                for ev in mat:
                    w._deliver(ev)

    def delete_pods(self, keys: Iterable[str],
                    origin: Optional[str] = None) -> Tuple[int, List[Tuple[str, str]]]:
        """Batched pod delete: one lock acquisition + one coalesced DELETED
        batch for a whole victim set. Per-pod semantics preserved exactly:
        each deleted pod's event carries ONE structural clone at its
        post-delete RV with prev=old (lazy, like delete()); per-key misses
        (and duplicate keys) don't abort the batch. Returns (deleted_count,
        [(key, error), ...]).

        Victim sets are small (bounded by one preemption batch), so a single
        critical section is fine."""
        keys = list(keys)
        errors: List[Tuple[str, str]] = []
        events: List[Event] = []
        deleted = 0
        native = self._native_commit_engine()
        if native is not None and _chaos.ACTIVE is not None:
            # the same injected boundary as bind_many's (no lock held yet)
            _chaos.ACTIVE.fire("native.commit")
        with self._pods_pair:
            pods = self._objects["pods"]
            if self._cols is not None:
                # victims bound by a columnar batch materialize first: the
                # DELETED events' clone source must carry the committed
                # node/rv (victim sets are preemption-batch sized)
                for key in keys:
                    self._cols.materialize_key(key, pods)
            t_commit = self._commit_stamp()
            if native is not None:
                mode = (0 if not self._deep_copy
                        else 1 if self._lazy_pod_events else 2)
                self._rv, deleted = native.delete_commit(
                    pods, keys, events, errors, self._rv, mode, t_commit,
                    pod_structural_clone, DELETED)
            else:
                # build-then-pop, exactly like the native engine: every
                # clone/event is constructed BEFORE any row is removed, so a
                # mid-batch failure leaves the store untouched (no
                # popped-but-never-narrated pods); a duplicate key errors
                # like the pop it replaces
                rv = self._rv
                found: List[str] = []
                seen = set()
                for key in keys:
                    old = None if key in seen else pods.get(key)
                    if old is None:
                        errors.append((key, f"pods {key} not found"))
                        continue
                    seen.add(key)
                    found.append(key)
                    rv += 1
                    if not self._deep_copy:
                        old.metadata.resource_version = rv
                        events.append(_make_event(DELETED, "pods", old, rv,
                                                  old, commit_ts=t_commit))
                    else:
                        obj = pod_structural_clone(old)
                        obj.metadata.resource_version = rv
                        if self._lazy_pod_events:
                            events.append(_make_event(
                                DELETED, "pods", obj, rv, old,
                                [None, pod_structural_clone], t_commit))
                        else:
                            events.append(_make_event(
                                DELETED, "pods", pod_structural_clone(obj),
                                rv, old, commit_ts=t_commit))
                    deleted += 1
                for key in found:
                    del pods[key]
                self._rv = rv
            if self._cols is not None:
                # drop the freed rows (no-op for error keys that never had
                # one; second occurrence of a duplicate is already gone)
                for key in keys:
                    if key not in pods:
                        self._cols.remove(key)
            self._emit_batch(DELETED, "pods", events, origin)
        return deleted, errors

    def update_pod_status(self, namespace: str, name: str, mutate_status: Callable[[Any], None]) -> Any:
        """Status-subresource write (hot under failure storms: ONE structural
        clone for the store; the event shares it lazily, the caller's return
        stays a private clone)."""
        with self._pods_pair:
            key = f"{namespace}/{name}"
            old = self._pod_internal(key)
            pod = pod_structural_clone(old)
            mutate_status(pod.status)
            self._rv += 1
            pod.metadata.resource_version = self._rv
            self._objects["pods"][key] = pod
            if self._cols is not None:
                row = self._cols.key2row.get(key)
                if row is not None:
                    self._cols.sync(row, pod)
            self._emit_event(self._pod_event(MODIFIED, pod,
                                             pod_structural_clone, prev=old))
            return pod_structural_clone(pod)
