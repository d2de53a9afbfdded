"""Sampled pod lifecycle tracing: what a USER of the cluster experiences.

The counterpart of `kubernetes_tpu/scheduler/podtrace.py`. The flight
recorder (scheduler/flightrec.py) explains where a batch's milliseconds go;
this module measures the submit->bound latency of individual pods, so a tail
regression (a stalled bind chunk, a breaker cooldown, a backoff-tier
pile-up) shows while throughput holds. Two instruments, both built under
the reference's HP001 constraint (instrumentation is per BATCH/chunk, never
per pod in a pod-scale loop):

  PodTracer.admitted   — reservoir-samples K pod keys per window at queue
                         admission using Algorithm L (Li 1994): the geometric
                         jump makes the per-batch cost O(samples taken), so a
                         100k-pod admission touches a handful of keys, not
                         100k random draws. The enqueue stamp is the batch's
                         shared admission timestamp (QueuedPodInfo.timestamp),
                         not a per-pod clock read.
  lifecycle stamps     — sampled pods are stamped at the pipeline edges
                         (enqueue, pop, solve, assume, dispatch, bind_commit,
                         bind_confirmed) with ONE shared timestamp per batch/
                         chunk. Unsampled pods pay one attribute read in the
                         settlement pass; per-pod stamping is legal ONLY
                         behind the sampled-set membership check.
  latency histogram    — the aggregate submit->bound distribution covers ALL
                         pods, not just the sample: each committed bind chunk
                         bulk-observes (chunk commit stamp) - (admission batch
                         stamp) per pod — batch-boundary timestamps only, and
                         one histogram lock per chunk.

Every stamp tap is O(1) on the hot path (the lazy-event idiom): it
records an op — the batch/chunk ref plus its shared timestamps — and the
per-pod settlement passes run at the next read surface with the recorded
stamps, identical whenever they happen, so the contended scheduling window
never pays a batch scan. Past a bounded pending cap the flush runs inline on
the recording thread and bills the recorder's <2% self-time budget
(stat_sink); read-side settlement is rendering cost,
tracked separately as flush_seconds (published in snapshot()).

Everything is bounded: the reservoir holds K keys, completed spans live in a
ring, incomplete spans from rotated windows are capped and evicted oldest-
first (counted, never silent).

Consumers: sched_stats()["latency"] / ["trace"], the critical path
(obs/critpath.py), the SLO gates (scheduler/slo.py), the trace export's
flow arrows (obs/tracebuf.py), GET /debug/schedtrace (server/rest.py) and
`ktl sched trace` (ROADMAP.md queue 1 item 7g2). The
post-bound edges (watch_delivered, kubelet_observed, running) are stamped
by the node agent through note_pod_event (item 7h).

The evict->replace link reads each pod's owner references: a ReplicaSet's
replacement (controllers/replicaset.py) links back to the evicted pod it
replaces.
"""

from __future__ import annotations

import math
import random
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

# lifecycle edges, in pipeline order (bind_commit = store.bind_many returned,
# bind_confirmed = the cache assume-confirm settled on the same chunk).
# The span extends past the scheduler's horizon: watch_delivered =
# the bind MODIFIED event dequeued by the pod's kubelet watcher,
# kubelet_observed = the kubelet's syncLoop picked the pod up, running =
# the Running status write committed — the TRUE end-to-end latency a user
# of the cluster experiences, stamped via note_pod_event (O(1) miss for
# unsampled pods: one module-dict probe).
SPAN_STAGES = ("enqueue", "pop", "solve", "assume", "dispatch",
               "bind_commit", "bind_confirmed",
               "watch_delivered", "kubelet_observed", "running")

# -- post-edge key registry (module-level, like flightrec's configz pattern) ----
#
# Components OUTSIDE the scheduler (the hollow kubelet's syncLoop, a future
# real kubelet shim) stamp sampled spans through note_pod_event without
# holding a tracer reference. The registry maps sampled pod keys -> weak
# tracer refs; unsampled pods pay ONE falsy module check (empty dict) or one
# dict probe. Bounded: tracers register exactly their live + post-completion
# sampled keys and unregister on completion of the running edge, eviction,
# deletion, drop_live and clear; dead-tracer refs are pruned opportunistically.

_post_lock = threading.Lock()
_post_keys: Dict[str, "weakref.ref"] = {}


def _post_register(key: str, tracer: "PodTracer") -> None:
    with _post_lock:
        if len(_post_keys) > 4096:  # prune dead-tracer leftovers
            for k in [k for k, r in _post_keys.items() if r() is None]:
                _post_keys.pop(k, None)
        _post_keys[key] = weakref.ref(tracer)


def _post_unregister(key: str) -> None:
    with _post_lock:
        _post_keys.pop(key, None)


def _owner_link_key(ref: Dict) -> Optional[str]:
    """The identity an evict->replace link is keyed by: the owner's uid when
    set, else kind/name (this repo's workload builders often leave uid
    empty; the controller identity is what makes old and new pod siblings)."""
    uid = ref.get("uid")
    if uid:
        return uid
    kind, name = ref.get("kind"), ref.get("name")
    return f"{kind}/{name}" if kind and name else None


def note_pod_event(key: str, stage: str, ts: Optional[float] = None) -> None:
    """Stamp a post-scheduler lifecycle edge on a sampled pod's span (no-op
    for unsampled pods — the common case is one falsy check). Callers pass
    no timestamp; the owning tracer stamps with ITS clock so every edge of
    a span shares one clock."""
    if not _post_keys:
        return
    with _post_lock:
        ref = _post_keys.get(key)
    tracer = ref() if ref is not None else None
    if tracer is not None:
        tracer.stamp_post(key, stage, ts)


class PodSpan:
    """One sampled pod's lifecycle record. stamps maps stage -> absolute
    clock time (scheduler clock); re-pops overwrite, so the span always
    describes the attempt that finally bound (pops counts the retries).
    replaces/replaced_by link an evicted pod's span to its ReplicaSet
    replacement (causal chains under churn); deleted marks a span
    whose pod was evicted before it could complete."""

    __slots__ = ("key", "window", "stamps", "pops", "complete",
                 "replaces", "replaced_by", "deleted")

    def __init__(self, key: str, window: int):
        self.key = key
        self.window = window
        self.stamps: Dict[str, float] = {}
        self.pops = 0
        self.complete = False
        self.replaces: Optional[str] = None
        self.replaced_by: Optional[str] = None
        self.deleted = False

    def stamp(self, stage: str, ts: float) -> None:
        self.stamps[stage] = ts

    def render(self) -> Dict:
        t0 = self.stamps.get("enqueue")
        offsets = {}
        if t0 is not None:
            for stage in SPAN_STAGES:
                ts = self.stamps.get(stage)
                if ts is not None:
                    offsets[stage] = round((ts - t0) * 1000, 3)
        total = offsets.get("bind_confirmed")
        # t0 = absolute enqueue stamp (scheduler clock): the anchor the
        # trace exporter (obs/tracebuf.py) uses to place span-derived flow
        # arrows on the perf_counter timeline
        out = {"pod": self.key, "window": self.window, "pops": self.pops,
               "complete": self.complete, "t0": t0, "stamps_ms": offsets,
               "submit_to_bound_ms": total,
               "submit_to_running_ms": offsets.get("running")}
        if self.replaces is not None:
            out["replaces"] = self.replaces
        if self.replaced_by is not None:
            out["replaced_by"] = self.replaced_by
        if self.deleted:
            out["deleted"] = True
        return out


class PodTracer:
    """Reservoir-sampled lifecycle tracer + all-pods latency histogram."""

    DEFAULT_SAMPLE_K = 64
    DEFAULT_WINDOW_S = 30.0
    SPAN_RING = 512
    LIVE_CAP_FACTOR = 4  # incomplete spans kept across windows: K * this
    EVICTED_LINK_CAP = 64  # pending evict->replace links kept (oldest drop)
    # recorded-but-unsettled trace ops held for deferred processing; past
    # this the flush runs inline on the recording thread (bounded memory:
    # the deque holds refs to batch/chunk lists that are alive during the
    # batch anyway)
    PENDING_OPS_CAP = 64

    def __init__(self, clock=None, sample_k: int = DEFAULT_SAMPLE_K,
                 window_s: float = DEFAULT_WINDOW_S, enabled: bool = True,
                 rng_seed: Optional[int] = None, stat_sink=None):
        from ..server.metrics import E2E_LATENCY_BUCKETS, Histogram
        from ..utils import Clock

        self._clock = clock or Clock()
        self.sample_k = max(1, sample_k)
        self.window_s = window_s
        self.enabled = enabled
        self._rng = random.Random(rng_seed)
        self._lock = threading.Lock()
        # keys with a live (incomplete) span — THE stamp guard every per-pod
        # loop below checks before touching a span
        self._sampled: set = set()
        self._live: Dict[str, PodSpan] = {}  # insertion-ordered: evict oldest
        self._done: deque = deque(maxlen=self.SPAN_RING)
        # bound spans still awaiting post-scheduler edges (watch_delivered /
        # kubelet_observed / running) — bounded by the done ring:
        # a span evicted from the ring leaves here too
        self._post_sampled: Dict[str, PodSpan] = {}
        # evict->replace causal links: owner identity -> FIFO of (evicted
        # key, its span) — one ReplicaSet drain evicts MANY siblings, each
        # owed a link to a replacement. Consumed oldest-first at admission;
        # bounded at EVICTED_LINK_CAP total links (oldest dropped).
        self._evicted_sampled: Dict[str, List[Tuple[str, PodSpan]]] = {}
        self._evicted_links = 0
        # Algorithm L reservoir state for the current window
        self._reservoir: List[str] = []
        self._w: Optional[float] = None
        self._skip = 0
        self._window_seq = 0
        self._window_start = self._clock.now()
        self.windows_rotated = 0
        self.evicted_incomplete = 0
        self._completed = 0
        # trace ops awaiting settlement (see the lifecycle-stamp taps);
        # appends and poplefts are atomic deque ops, so the recording
        # threads never contend on a lock for the O(1) taps. _flush_lock
        # serializes settlement (ops are order-dependent).
        self._ops: deque = deque()
        self._flush_lock = threading.Lock()
        self.flush_seconds = 0.0  # read-side settlement cost (rendering)
        # aggregate submit->bound latency over ALL pods (private histogram so
        # concurrent schedulers in one process don't blend; the process-wide
        # Prometheus series is fed alongside in chunk_bound)
        self.latency = Histogram("submit_to_bound_seconds",
                                 buckets=E2E_LATENCY_BUCKETS)
        # sampled keys present in the batch being scheduled right now
        # (scheduling thread only)
        self._batch_hits: Tuple = ()
        self.stat_sink = stat_sink  # FlightRecorder: self-time budget

    # -- sampling (queue admission) --------------------------------------------

    def _rand(self) -> float:
        return max(self._rng.random(), 1e-12)  # log() needs (0, 1]

    def _geom_skip(self) -> int:
        # items to pass over before the next reservoir replacement
        return int(math.log(self._rand()) / math.log(1.0 - self._w))

    def admitted(self, qps) -> None:
        """One call per admission batch (SchedulingQueue.add_batch / add).
        Samples this batch's slice of the admission stream into the
        candidate reservoir. Cost: O(samples taken) — Algorithm L's
        geometric jumps skip the rest of the batch untouched, and a sampled
        candidate costs only a slot write + set update (its PodSpan
        materializes lazily at first pop, so reservoir churn never allocates
        spans that immediately get replaced)."""
        if not self.enabled or not qps:
            return
        t0 = time.perf_counter()
        # settle pending ops FIRST: window rotation and candidate
        # displacement below read span.pops to decide which live spans
        # survive, so deferred pop stamps must land before sampling state
        # advances. Ops are empty in the bulk-ingest common case (admission
        # precedes the batch's pop), so this is a falsy check there.
        self._flush_ops(inline=True)
        with self._lock:
            now = qps[0].timestamp or self._clock.now()
            self._maybe_rotate(now)
            k = self.sample_k
            n = len(qps)
            res = self._reservoir  # slots hold QueuedPodInfo refs
            rng = self._rng.random
            log = math.log
            idx = 0
            filled = len(res)
            while idx < n and len(res) < k:
                res.append(qps[idx])
                idx += 1
            mutated = len(res) != filled
            if len(res) == k and self._w is None:
                self._w = math.exp(log(self._rand()) / k)
                self._skip = self._geom_skip()
            # jump phase, locals only: a replacement is one slot write plus
            # ~3 rng/log ops — the span bookkeeping for this call's
            # SURVIVORS happens once below, so within-call reservoir churn
            # allocates nothing
            w, skip, inv_k = self._w, self._skip, 1.0 / k
            while w is not None and idx + skip < n:
                idx += skip
                res[int(rng() * k)] = qps[idx]
                mutated = True
                idx += 1
                w *= (rng() or 1e-12) ** inv_k
                skip = int(log(rng() or 1e-12) / log(1.0 - w))
            if w is not None:
                skip -= n - idx
            self._w, self._skip = w, skip
            # the geometric jump skipped this whole slice (the per-pod
            # add() common case once the reservoir is warm): occupants are
            # unchanged, so reconciliation has nothing to do — skip the
            # O(K + live) scan
            if mutated:
                self._sync_candidates()
            # evict->replace causal chains: one falsy check in the
            # steady state; only while links are pending does admission pay
            # an owner-uid probe per pod
            if self._evicted_sampled:
                self._link_replacements(qps)
        sink = self.stat_sink
        if sink is not None:
            sink.note_self_time(time.perf_counter() - t0)

    def _sync_candidates(self) -> None:
        """Reconcile live spans with the reservoir's final occupants (caller
        holds self._lock): new candidates get a span (enqueue = their shared
        admission stamp) linked onto their QueuedPodInfo — the link every
        later stage reads instead of building keys and probing sets per pod;
        requeues reuse the same object so it survives retries. Displaced
        candidates that were never popped leave the sample; mid-flight spans
        keep their stamps coming and complete normally."""
        live = self._live
        current = set()
        for qp in self._reservoir:
            # a slot whose pod already bound (its span completed and left
            # the live set) is a SPENT sample: it keeps the slot — it is a
            # legitimately sampled stream item — but must not be re-issued
            # a fresh span that can never complete (admission waves after
            # binds would otherwise mint zombie incomplete spans)
            done = qp.trace_span
            if done is not None and done.complete:
                continue
            key = qp.pod.key
            current.add(key)
            span = live.get(key)
            if span is None:
                span = PodSpan(key, self._window_seq)
                span.stamp("enqueue", qp.submit_ts or qp.timestamp
                           or self._clock.now())
                live[key] = span
                self._sampled.add(key)
                _post_register(key, self)
            qp.trace_span = span
        for key in list(live):
            if key not in current and live[key].pops == 0:
                del live[key]
                self._sampled.discard(key)
                _post_unregister(key)
        # a pod that never binds must not leak spans forever: cap the live
        # set AFTER this window's additions, evicting oldest-first (counted,
        # never silent) — insertion order puts prior windows' stragglers up
        # front, so fresh candidates are the last to go
        cap = self.LIVE_CAP_FACTOR * self.sample_k
        while len(live) > cap:
            old = next(iter(live))
            live.pop(old)
            self._sampled.discard(old)
            _post_unregister(old)
            self.evicted_incomplete += 1

    def _maybe_rotate(self, now: float) -> None:
        if now - self._window_start < self.window_s:
            return
        self._window_start = now
        self._window_seq += 1
        self.windows_rotated += 1
        # un-materialized candidates from the old window lose their slot;
        # live spans keep tracing until they complete, bounded by the cap
        # in _sync_candidates
        self._reservoir = []
        self._sampled = set(self._live)
        self._w = None
        self._skip = 0

    # -- lifecycle stamps (O(1) taps, deferred settlement) ---------------------
    #
    # Every stamp tap records an op — (kind, payload, shared timestamp) — in
    # a FIFO and returns; the per-pod passes run in _flush_ops at the next
    # read surface with the RECORDED timestamps, so the rendered result is
    # byte-identical whenever settlement happens but the contended
    # scheduling window never pays a batch scan. Past PENDING_OPS_CAP the
    # flush runs inline on the recording thread and bills the recorder
    # budget; read-side settlement is rendering cost (tracked in
    # flush_seconds, published in snapshot()).

    def batch_popped(self, qps) -> None:
        """Once per popped batch: record the pop edge (shared timestamp)."""
        if not self.enabled or not qps:
            return
        self._ops.append(("pop", qps, self._clock.now()))
        if len(self._ops) > self.PENDING_OPS_CAP:
            self._flush_ops(inline=True)

    def batch_stage(self, stage: str) -> None:
        """Record one pipeline-stage edge for the current batch's sampled
        pods (resolved by the preceding pop op at settlement)."""
        if not self.enabled:
            return
        self._ops.append(("stage", stage, self._clock.now()))
        if len(self._ops) > self.PENDING_OPS_CAP:
            self._flush_ops(inline=True)

    def chunk_bound(self, items, t_commit: float, t_confirm: float,
                    errkeys=frozenset()) -> None:
        """Once per committed bind chunk (the bind worker thread, or the
        synchronous bind path): record the chunk with its ONE commit stamp.
        items are the bind triples (qp, node_name, assumed)."""
        if not self.enabled or not items:
            return
        self._ops.append(("chunk", (items, t_commit, t_confirm, errkeys),
                          0.0))
        if len(self._ops) > self.PENDING_OPS_CAP:
            self._flush_ops(inline=True)

    def _flush_ops(self, inline: bool = False) -> None:
        """Settle every deferred op in recording order (FIFO — a pop op
        establishes the batch hits its stage ops stamp). _flush_lock
        serializes flushers so order holds under concurrency; inline=True
        (cap overflow on a recording thread) bills the recorder budget,
        read-side settlement only accrues flush_seconds."""
        if not self._ops:
            return
        with self._flush_lock:
            # timer starts AFTER the lock: a flusher that blocked while a
            # peer drained the FIFO did no work, and must not re-bill the
            # peer's wall time to flush_seconds / the recorder budget
            t0 = time.perf_counter()
            while True:
                try:
                    kind, payload, ts = self._ops.popleft()
                except IndexError:
                    break
                if kind == "pop":
                    self._apply_pop(payload, ts)
                elif kind == "stage":
                    self._apply_stage(payload, ts)
                else:
                    self._apply_chunk(*payload)
            # accrued under _flush_lock: concurrent flushers (read surfaces
            # + cap overflows on recording threads) must not lose updates
            dt = time.perf_counter() - t0
            self.flush_seconds += dt
        if inline:
            sink = self.stat_sink
            if sink is not None:
                sink.note_self_time(dt)

    def _apply_pop(self, qps, now: float) -> None:
        """Find the sampled pods in a popped batch and stamp 'pop' with the
        batch's shared timestamp. The full-batch pass costs unsampled pods
        one attribute read each (the span was linked onto the QueuedPodInfo
        at sampling time); the membership check against the sampled set then
        guards only the <=K linked spans against staleness."""
        if not self._sampled:  # common case: one falsy check per batch
            self._batch_hits = ()
            return
        # C-speed pass: one attribute read per pod; only the <=K linked
        # spans reach the stamping loop below
        hits = [qp.trace_span for qp in qps if qp.trace_span is not None]
        kept = []
        if hits:
            with self._lock:
                sampled = self._sampled
                for sp in hits:
                    if sp.key in sampled:  # staleness guard
                        sp.stamp("pop", now)
                        sp.pops += 1
                        kept.append(sp.key)
        self._batch_hits = tuple(kept)

    def _apply_stage(self, stage: str, now: float) -> None:
        """Stamp one pipeline stage for the current batch's sampled pods —
        shared timestamp, O(hits) with hits <= K."""
        if not self._batch_hits:
            return
        with self._lock:
            for k in self._batch_hits:
                if k in self._sampled:  # guard (evicted mid-batch)
                    sp = self._live.get(k)
                    if sp is not None:
                        sp.stamp(stage, now)

    def _apply_chunk(self, items, t_commit: float, t_confirm: float,
                     errkeys) -> None:
        """Settle one committed bind chunk: bulk-observe submit->bound
        latency for EVERY successfully bound pod (shared commit stamp minus
        the shared admission stamp — submit_ts is always set,
        QueuedPodInfo.__post_init__), then stamp bind_commit/bind_confirmed
        for the sampled ones. Unsampled pods pay two attribute reads in
        C-speed listcomps."""
        if errkeys:
            vals = [t_commit - qp.submit_ts for qp, _node, _a in items
                    if qp.pod.key not in errkeys]
            spans = [qp.trace_span for qp, _node, _a in items
                     if qp.trace_span is not None
                     and qp.pod.key not in errkeys]
        else:
            vals = [t_commit - qp.submit_ts for qp, _node, _a in items]
            spans = [qp.trace_span for qp, _node, _a in items
                     if qp.trace_span is not None]
        if vals:
            # ONE bucket pass feeds both the private histogram and the
            # process-wide Prometheus series (identical E2E buckets)
            res = self.latency.bucket_counts(vals)
            self.latency.observe_counts(*res)
            from ..server import metrics as m

            m.pod_e2e_latency.observe_counts(*res)
        if spans:
            with self._lock:
                for sp in spans:
                    if sp.key in self._sampled:  # staleness guard
                        sp.stamp("bind_commit", t_commit)
                        sp.stamp("bind_confirmed", t_confirm)
                        self._complete(sp.key)

    def pod_bound(self, qp, now: float) -> None:
        """Serial-path bind (the per-pod fallback loop — inherently per pod,
        so a per-pod tap is the loop's own granularity): one latency
        observation plus the sampled stamps."""
        if not self.enabled:
            return
        # settle deferred pop/stage ops BEFORE completing: _complete()
        # removes the key from the sampled set, so a pending pop op settling
        # later would be staleness-guarded away and the finished span would
        # render with pops=0 and missing mid-pipeline stamps. Falsy check
        # after the first pod of the batch.
        self._flush_ops(inline=True)
        dt = now - (qp.submit_ts or qp.timestamp)
        self.latency.observe(dt)
        from ..server import metrics as m

        m.pod_e2e_latency.observe(dt)
        sp = qp.trace_span
        if sp is not None and sp.key in self._sampled:  # staleness guard
            with self._lock:
                sp.stamp("bind_commit", now)
                sp.stamp("bind_confirmed", now)
                self._complete(sp.key)

    def _complete(self, key: str) -> None:
        """Caller holds self._lock."""
        sp = self._live.pop(key, None)
        if sp is None:
            return
        self._sampled.discard(key)
        sp.complete = True
        if len(self._done) == self._done.maxlen:
            # ring eviction: the evicted span's post-edge tracking ends too
            old = self._done[0]
            self._post_sampled.pop(old.key, None)
            _post_unregister(old.key)
        self._done.append(sp)
        self._completed += 1
        if "running" in sp.stamps:
            # the running edge already arrived (serial path + fast kubelet):
            # the kubelet taps are done with this key
            _post_unregister(key)
        # keep the span addressable until ring eviction: for the
        # watch_delivered / kubelet_observed / running stamps while they are
        # pending, and for the evict->replace link if this pod is later
        # evicted (bounded by the done ring)
        self._post_sampled[key] = sp

    def stamp_post(self, key: str, stage: str,
                   ts: Optional[float] = None) -> None:
        """Stamp a post-scheduler edge (watch_delivered / kubelet_observed /
        running) on a sampled span — live (bind still settling) or bound.
        Reached via note_pod_event; unsampled pods never get here."""
        if not self.enabled:
            return
        done = False
        with self._lock:
            sp = self._post_sampled.get(key) or self._live.get(key)
            if sp is None:
                return
            sp.stamp(stage, ts if ts is not None else self._clock.now())
            if stage == "running":
                # the kubelet is done with this span — but it STAYS in
                # _post_sampled until ring eviction, so a later eviction of
                # this pod can still find it for the evict->replace link
                done = True
        if done:
            _post_unregister(key)

    def note_deleted(self, pod) -> None:
        """A sampled pod was DELETED (evicted). A live span can never
        complete — close it out (kept in the ring, marked deleted); either
        way remember the owner uid so the ReplicaSet replacement's span
        links back to this one (causal chains under churn). O(1)
        for unsampled pods: two membership probes."""
        if not self.enabled:
            return
        key = pod.key
        if key not in self._sampled and key not in self._post_sampled:
            return
        # settle pending pop/stage ops first: the span's last stamps must
        # land before it leaves the live set (the pod_bound discipline)
        self._flush_ops(inline=True)
        meta = getattr(pod, "metadata", None)
        owner_uid = None
        for ref in (meta.owner_references if meta is not None else ()):
            owner_uid = _owner_link_key(ref)
            if owner_uid:
                break
        with self._lock:
            live_sp = self._live.pop(key, None)
            self._sampled.discard(key)
            span = self._post_sampled.pop(key, None) or live_sp
            if span is None:
                _post_unregister(key)
                return
            span.deleted = True
            if live_sp is not None:
                # an unbound evicted span joins the ring incomplete — the
                # chain must render even though the pod never bound
                if len(self._done) == self._done.maxlen:
                    old = self._done[0]
                    self._post_sampled.pop(old.key, None)
                    _post_unregister(old.key)
                self._done.append(live_sp)
            if owner_uid is not None:
                self._evicted_sampled.setdefault(owner_uid, []).append(
                    (key, span))
                self._evicted_links += 1
                while self._evicted_links > self.EVICTED_LINK_CAP:
                    oldest = next(iter(self._evicted_sampled))
                    lst = self._evicted_sampled[oldest]
                    lst.pop(0)
                    if not lst:
                        del self._evicted_sampled[oldest]
                    self._evicted_links -= 1
        _post_unregister(key)

    def _link_replacements(self, qps) -> None:
        """Adopt replacements of evicted sampled pods into the sample
        (caller holds self._lock; runs only while links are pending). A
        replacement is FORCE-sampled — causal chains are only useful when
        both ends exist, so it bypasses the reservoir lottery."""
        for qp in qps:
            meta = getattr(qp.pod, "metadata", None)
            if meta is None:
                continue
            for ref in meta.owner_references:
                link = _owner_link_key(ref)
                if link in self._evicted_sampled:
                    self._adopt_replacement(qp, link)
                    # one replacement consumes ONE link: a second owner ref
                    # with its own pending entry must not overwrite this
                    # span's `replaces` and starve the next real sibling
                    break
            if not self._evicted_sampled:
                return

    def _adopt_replacement(self, qp, uid: str) -> None:
        """Link one replacement (caller holds self._lock)."""
        lst = self._evicted_sampled[uid]
        old_key, old_span = lst.pop(0)  # oldest eviction claims the link
        if not lst:
            del self._evicted_sampled[uid]
        self._evicted_links -= 1
        key = qp.pod.key
        span = self._live.get(key)
        if span is None:
            span = PodSpan(key, self._window_seq)
            span.stamp("enqueue", qp.submit_ts or qp.timestamp
                       or self._clock.now())
            self._live[key] = span
            self._sampled.add(key)
            _post_register(key, self)
        qp.trace_span = span
        span.replaces = old_key
        old_span.replaced_by = key

    def drop_live(self) -> None:
        """Abandon every in-flight span (counted, never silent). Called on
        crash resync / relist: the rebuilt queue holds fresh QueuedPodInfos
        with no span links, so the old spans could never complete — exactly
        like the rest of the in-memory scheduler state a crash loses.
        Chunks that COMMITTED before the crash settle first: their binds
        are store facts the resync will re-observe."""
        self._flush_ops()
        with self._lock:
            self.evicted_incomplete += len(self._live)
            for key in self._live:
                _post_unregister(key)
            self._live.clear()
            self._sampled = set()
            self._reservoir = []
            self._w = None
            self._skip = 0
            self._batch_hits = ()
            # bound spans keep their post-edge tracking: their binds are
            # store facts the resync re-observes, so the kubelet's stamps
            # still land; pending evict->replace links die with the queue
            self._evicted_sampled.clear()
            self._evicted_links = 0

    # -- read side (every surface settles deferred chunks first) ---------------

    def settle(self) -> None:
        """Settle the deferred ops now (a stopping scheduler's last chunks,
        which no later read may come to settle)."""
        self._flush_ops()

    @property
    def live_incomplete(self) -> int:
        self._flush_ops()
        return len(self._live)

    @property
    def completed_total(self) -> int:
        self._flush_ops()
        return self._completed

    def latency_stats(self) -> Dict:
        """The aggregate submit->bound distribution: count/mean/p50/p99."""
        self._flush_ops()
        total_s, count = self.latency.snapshot()
        p50 = self.latency.quantile(0.50)
        p99 = self.latency.quantile(0.99)
        return {
            "count": count,
            "sum_s": round(total_s, 4),
            "mean_s": round(total_s / count, 6) if count else None,
            "p50_s": round(p50, 6) if p50 is not None else None,
            "p99_s": round(p99, 6) if p99 is not None else None,
        }

    def snapshot(self) -> Dict:
        """The /debug/schedtrace payload: config, window counters, the
        latency distribution, and every span (completed ring + live)."""
        self._flush_ops()
        with self._lock:
            spans = [sp.render() for sp in self._done]
            spans.extend(sp.render() for sp in self._live.values())
            live = len(self._live)
            post = len(self._post_sampled)
        return {
            "enabled": self.enabled,
            "sample_k": self.sample_k,
            "window_s": self.window_s,
            "windows_rotated": self.windows_rotated,
            "completed": self._completed,
            "live_incomplete": live,
            # bound spans still addressable for post edges / evict links
            # (bounded by the done ring)
            "post_sampled": post,
            "evicted_incomplete": self.evicted_incomplete,
            "flush_seconds": round(self.flush_seconds, 6),
            "latency": self.latency_stats(),
            "spans": spans,
        }

    def clear(self) -> None:
        from ..server.metrics import E2E_LATENCY_BUCKETS, Histogram

        with self._lock:
            for key in self._sampled:
                _post_unregister(key)
            for key in self._post_sampled:
                _post_unregister(key)
            self._sampled.clear()
            self._live.clear()
            self._done.clear()
            self._post_sampled.clear()
            self._evicted_sampled.clear()
            self._evicted_links = 0
            self._reservoir = []
            self._w = None
            self._skip = 0
            self._window_start = self._clock.now()
            self.windows_rotated = 0
            self.evicted_incomplete = 0
            self._completed = 0
            self._ops.clear()
            self.flush_seconds = 0.0
            self._batch_hits = ()
            self.latency = Histogram("submit_to_bound_seconds",
                                     buckets=E2E_LATENCY_BUCKETS)
