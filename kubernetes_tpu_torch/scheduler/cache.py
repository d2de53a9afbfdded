"""Scheduler cache: in-scheduler cluster state with the assumed-pod
lifecycle and generation-based incremental snapshotting.

The counterpart of `kubernetes_tpu/scheduler/cache.py` (reference:
pkg/scheduler/backend/cache/cache.go — UpdateSnapshot :186, AssumePod :361,
FinishBinding :376, ForgetPod :404, the expiry of assumed pods,
scheduler.go:57-59 durationToExpireAssumedPod). An assumed pod is a PodInfo
(assume_pod, assume_pods, assume_pods_structural) or a columnar cache row
(assume_pods_columnar, scheduler/cachecols.py). finish_binding starts an
assume's TTL; cleanup_expired_assumed_pods drops the assumes whose TTL ran
out on the cache's clock without a confirmation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..api import Node, Pod, compute_pod_resource_request
from ..utils import Clock
from .cachecols import CacheColumns, CacheColumnsView
from .framework import NodeInfo, PodInfo, Snapshot


def _pod_req_pair(pod: Pod):
    """The pod's (request, non_zero_request) Resource pair — the same
    `_req_cache` memo PodInfo.__init__ and the tensorizer seed, get-or-compute
    so removal accounting works even for a pod that never grew a PodInfo."""
    cached = pod.__dict__.get("_req_cache")
    if cached is None:
        cached = (compute_pod_resource_request(pod),
                  compute_pod_resource_request(pod, non_zero=True))
        pod.__dict__["_req_cache"] = cached
    return cached


class Cache:
    def __init__(self, clock: Optional[Clock] = None, ttl: float = 15.0):
        self._lock = threading.RLock()
        self._clock = clock or Clock()
        self._ttl = ttl
        self._generation = 0
        self._nodes: Dict[str, NodeInfo] = {}
        # pod key -> node name for every known (added or assumed) pod
        self._pod_nodes: Dict[str, str] = {}
        self._assumed: Dict[str, float] = {}  # pod key -> deadline (0 = no expiry yet)
        self._snapshot_generation = -1
        self._snapshot: Optional[Snapshot] = None
        # image name -> shared ImageStateSummary (num_nodes mutated in place)
        self._image_entries: Dict[str, object] = {}
        # Columnar cache rows (scheduler/cachecols.py): created lazily on the
        # first assume_pods_columnar, so object-path schedulers never pay for
        # (or observe) the row table.
        self._cols = None
        # Names of nodes touched since the last snapshot; None = a structural
        # event (node add/remove/promote) happened and the next
        # update_snapshot must do the full generation walk.
        self._dirty_names: Optional[Set[str]] = set()

    def _next_gen(self) -> int:
        self._generation += 1
        return self._generation

    def _touch(self, ni: NodeInfo, name: Optional[str] = None) -> None:
        ni.generation = self._next_gen()
        if name is None:
            self._dirty_names = None
        elif self._dirty_names is not None:
            self._dirty_names.add(name)

    # -- nodes -----------------------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            name = node.metadata.name
            ni = self._nodes.get(name)
            structural = ni is None or ni.node is None
            if ni is None:
                ni = NodeInfo()
                self._nodes[name] = ni
            elif ni.node is not None:
                self._remove_image_counts(ni.node)
            ni.set_node(node)
            ni.image_states = self._add_image_counts(node)
            # a NEW node (or a placeholder promotion) changes the snapshot's
            # node set — the incremental from_prev path can't represent that
            self._touch(ni, None if structural else name)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            ni = self._nodes.get(name)
            if ni is None:
                return
            if ni.node is not None:
                self._remove_image_counts(ni.node)
            if ni.pods or ni.col_count:
                # Bound pods still reference this node: keep the NodeInfo as a
                # placeholder (node=None) so their accounting survives a node
                # flap (reference: cache.go RemoveNode keeps nodeInfo until the
                # last pod is removed). Snapshots skip placeholder nodes.
                ni.node = None
                self._touch(ni, None)
            else:
                self._nodes.pop(name, None)
            self._generation += 1  # force snapshot rebuild to drop the node
            self._dirty_names = None  # node set changed: full snapshot walk

    # Image-state bookkeeping mirrors cache.go's shared imageStates map: one
    # ImageStateSummary object per image, shared by every NodeInfo that has it,
    # with NumNodes mutated in place — O(images of changed node) per event
    # instead of a full-cluster recount.

    def _add_image_counts(self, node: Node):
        from .framework import ImageStateSummary

        states = {}
        for img in node.status.images:
            for nm in img.names:
                entry = self._image_entries.get(nm)
                if entry is None:
                    entry = ImageStateSummary(size=img.size_bytes, num_nodes=0)
                    self._image_entries[nm] = entry
                entry.num_nodes += 1
                entry.size = img.size_bytes
                states[nm] = entry
        return states

    def _remove_image_counts(self, node: Node) -> None:
        for img in node.status.images:
            for nm in img.names:
                entry = self._image_entries.get(nm)
                if entry is not None:
                    entry.num_nodes -= 1
                    if entry.num_nodes <= 0:
                        self._image_entries.pop(nm, None)

    # -- pods ------------------------------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        """A bound pod was observed (informer ADD). Confirms an assumed pod."""
        with self._lock:
            key = pod.key
            if key in self._assumed:
                # confirmation: informer caught up with our optimistic assume
                self._assumed.pop(key, None)
                if self._pod_nodes.get(key) == pod.spec.node_name:
                    return  # already accounted
                self._remove_pod_internal(key)
            elif key in self._pod_nodes:
                return
            self._add_pod_internal(pod)

    def _add_pod_internal(self, pod: Pod) -> None:
        node_name = pod.spec.node_name
        if not node_name:
            return
        ni = self._nodes.get(node_name)
        if ni is None:
            ni = NodeInfo()  # node not yet observed; pods land on a placeholder
            self._nodes[node_name] = ni
        ni.add_pod(PodInfo(pod))
        self._pod_nodes[pod.key] = node_name
        self._touch(ni, node_name)

    def _remove_pod_internal(self, key: str) -> None:
        # Columnar row? Exact inverse of the row's lifecycle: drop the row,
        # subtract its full request pair (phase 2 scatter-added the same
        # `_req_cache` values — the raw layout covers every dim the batch's
        # classes declare, mirroring ni.remove_pod's full subtraction on the
        # object path), decrement the row population.
        cols = self._cols
        if cols is not None:
            got = cols.remove(key)
            if got is not None:
                pod, node_name = got
                self._pod_nodes.pop(key, None)
                ni = self._nodes.get(node_name)
                if ni is not None:
                    ni.col_count -= 1
                    req, req_nz = _pod_req_pair(pod)
                    ni.requested.sub(req)
                    ni.non_zero_requested.sub(req_nz)
                    self._touch(ni, node_name)
                return
        node_name = self._pod_nodes.pop(key, None)
        if node_name is None:
            return
        ni = self._nodes.get(node_name)
        if ni is None:
            return
        ns, name = key.split("/", 1)
        for pi in ni.pods:
            if pi.pod.metadata.namespace == ns and pi.pod.metadata.name == name:
                ni.remove_pod(pi.pod)
                break
        self._touch(ni, node_name)

    def update_pod(self, pod: Pod) -> None:
        with self._lock:
            self._remove_pod_internal(pod.key)
            self._add_pod_internal(pod)

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed.pop(pod.key, None)
            self._remove_pod_internal(pod.key)

    # -- assumed pod lifecycle (cache.go:361-420) ------------------------------

    def assume_pod(self, pod: Pod, node_name: str) -> None:
        with self._lock:
            self._assume_internal(pod, node_name)

    def assume_pods(self, pairs) -> List[Tuple[int, str]]:
        """Bulk assume under ONE lock acquisition (batch-solver rates make
        100k per-pod acquires measurable). pairs = [(pod, node_name)];
        returns (index, error message) for entries that failed."""
        failed = []
        with self._lock:
            for i, (pod, node_name) in enumerate(pairs):
                try:
                    self._assume_internal(pod, node_name)
                except ValueError as e:
                    failed.append((i, str(e)))
        return failed

    # -- columnar assume (the batched solver's accounting path) ----------------

    def assume_pods_structural(self, pairs,
                               check_ports: bool = True) -> List[Tuple[int, str]]:
        """Phase 1 of the columnar assume: per-pod bookkeeping ONLY —
        validation, _pod_nodes/_assumed entries, PodInfo appends (pods lists,
        affinity sublists, host ports). Requested-resource totals and
        generations are NOT touched; the caller must follow up with
        apply_node_resource_deltas (computed as numpy scatter-adds over the
        solver batch — the per-pod Resource.add loop was a top stage of the
        100k assume). Between the two calls the touched NodeInfos are
        transiently inconsistent (pods appended, requested stale); the
        scheduling thread is the only snapshot taker, so no consumer can
        observe the gap. check_ports=False skips the host-port scan when the
        caller proved no pod in the batch declares host ports (the
        tensorizer's per-class flag). Returns (index, error) for entries
        that failed."""
        from .framework import _host_ports

        # native commit engine: the per-pod loop below (key check, node_name
        # stamp, PodInfo build, list appends, bookkeeping dict inserts)
        # replayed in C for port-free batches (PyDLL: GIL held, so legal
        # under the cache lock). Selected BEFORE taking the lock: first use
        # may pay the one-time g++ build, which must not stall every cache
        # consumer (store.bind_many hoists the same way). A failed build
        # raises; HOSTSCHED_NATIVE_COMMIT=0 selects the Python loop.
        native = None
        if not check_ports:
            from ..native import hostcommit

            if hostcommit.selected():
                native = hostcommit
        failed = []
        with self._lock:
            if native is not None:
                native.assume_structural(
                    pairs, self._pod_nodes, self._assumed, self._nodes,
                    failed)
                return failed
            pod_nodes = self._pod_nodes
            assumed = self._assumed
            nodes = self._nodes
            for i, (pod, node_name) in enumerate(pairs):
                key = pod.key
                if key in pod_nodes:
                    failed.append((i, f"pod {key} is already in the cache"))
                    continue
                pod.spec.node_name = node_name
                ni = nodes.get(node_name)
                if ni is None:
                    ni = NodeInfo()
                    nodes[node_name] = ni
                pi = PodInfo(pod)
                ni.pods.append(pi)
                if (pi.required_affinity_terms or pi.preferred_affinity_terms
                        or pi.required_anti_affinity_terms
                        or pi.preferred_anti_affinity_terms):
                    ni.pods_with_affinity.append(pi)
                    if pi.required_anti_affinity_terms:
                        ni.pods_with_required_anti_affinity.append(pi)
                if check_ports:
                    for port in _host_ports(pod):
                        ni.used_ports.add(port)
                pod_nodes[key] = node_name
                assumed[key] = 0.0
        return failed

    def assume_pods_columnar(self, pairs) -> List[Tuple[int, str]]:
        """Row-mode phase 1: the zero-object assume. Instead of building a
        PodInfo per placement, each pod lands as a columnar row (key, original
        Pod ref, interned node id) plus one `col_count` increment on its
        NodeInfo — a handful of dict/list/int32 writes, no per-pod Python
        allocation. Phase 2 (apply_node_resource_deltas — the same GIL-free
        commit_deltas scatter output) remains the only resource/generation
        mutation, exactly as on the structural path.

        The dispatch gate guarantees every pod in `pairs` is constraint-free
        (no gang, no affinity/topology-spread terms, no host ports), so rows
        never owe affinity sublists or port claims. Unlike the structural
        path, the pod is NOT stamped with `spec.node_name`: these are the
        store/queue ORIGINALS (store-returned objects are read-only),
        and the bind worker only needs key + target node. Returns (index,
        error) for entries that failed validation."""
        failed = []
        with self._lock:
            cols = self._cols
            if cols is None:
                cols = self._cols = CacheColumns()
            pod_nodes = self._pod_nodes
            assumed = self._assumed
            nodes = self._nodes
            for i, (pod, node_name) in enumerate(pairs):
                key = pod.key
                if key in pod_nodes:
                    failed.append((i, f"pod {key} is already in the cache"))
                    continue
                ni = nodes.get(node_name)
                if ni is None:
                    ni = NodeInfo()
                    nodes[node_name] = ni
                cols.insert(key, pod, node_name)
                ni.col_count += 1
                pod_nodes[key] = node_name
                assumed[key] = 0.0
        return failed

    def materialize_columnar_rows(self, out: Optional[list] = None) -> int:
        """Collapse every columnar row into a real PodInfo on its node — the
        escape hatch for consumers that genuinely need object rows (a
        constrained batch's selector counts, the serial fallback's plugin
        walks, the conservation checker). Resources are NOT re-added (phase 2
        already scatter-added them) and rows are constraint-free by the
        dispatch gate, so this is append + generation touch per row. Counted
        in `materialized_total`; at steady
        state this never runs. Returns the number of rows materialized; when
        `out` is given, appends one (node_name, PodInfo) per row so callers
        holding a pre-materialization snapshot can patch their clones."""
        with self._lock:
            cols = self._cols
            if cols is None or not cols.key2row:
                return 0
            rows = list(cols.iter_rows())
            for key, pod, node_name in rows:
                cols.remove(key)
                ni = self._nodes.get(node_name)
                if ni is None:
                    continue
                ni.col_count -= 1
                pi = PodInfo(pod)
                if out is not None:
                    out.append((node_name, pi))
                ni.pods.append(pi)
                if (pi.required_affinity_terms or pi.preferred_affinity_terms
                        or pi.required_anti_affinity_terms
                        or pi.preferred_anti_affinity_terms):
                    ni.pods_with_affinity.append(pi)
                    if pi.required_anti_affinity_terms:
                        ni.pods_with_required_anti_affinity.append(pi)
                self._touch(ni, node_name)
            cols.materialized_total += len(rows)
            return len(rows)

    def pod_columns(self):
        """Read-only columnar view of the live cache rows (CacheColumnsView),
        or None when no row table exists. READ-ONLY: the numpy column refuses
        writes at runtime."""
        with self._lock:
            if self._cols is None:
                return None
            return CacheColumnsView(self._cols)

    def columnar_rows(self) -> int:
        with self._lock:
            return self._cols.rows() if self._cols is not None else 0

    def columnar_materialized(self) -> int:
        """Lifetime row->PodInfo collapses."""
        with self._lock:
            return self._cols.materialized_total if self._cols is not None else 0

    def columnar_stats(self) -> Optional[Dict]:
        with self._lock:
            return self._cols.stats() if self._cols is not None else None

    def forget_pods_structural(self, pods, check_ports: bool = True) -> None:
        """Rollback of assume_pods_structural BEFORE the matching
        apply_node_resource_deltas: undo exactly what phase 1 did — the
        _pod_nodes/_assumed entries, the PodInfo appends (pods lists,
        affinity sublists), and (when phase 1 scanned them) the host-port
        claims — WITHOUT the requested-resource subtraction forget_pod
        performs, because phase 2 never added those totals. Subtracting them
        here would drive NodeInfo.requested negative (the gang all-or-nothing
        rollback found this the hard way). check_ports must mirror the
        assume call's flag, or a port another pod legitimately owns could be
        released."""
        from .framework import _host_ports

        with self._lock:
            cols = self._cols
            for pod in pods:
                key = pod.key
                if cols is not None:
                    got = cols.remove(key)
                    if got is not None:
                        # columnar row pre-phase-2: undo exactly what
                        # assume_pods_columnar did (row + bookkeeping +
                        # col_count) with NO resource subtraction
                        _p, node_name = got
                        self._pod_nodes.pop(key, None)
                        self._assumed.pop(key, None)
                        ni = self._nodes.get(node_name)
                        if ni is not None:
                            ni.col_count -= 1
                            self._touch(ni, node_name)
                        continue
                node_name = self._pod_nodes.pop(key, None)
                self._assumed.pop(key, None)
                if node_name is None:
                    continue
                ni = self._nodes.get(node_name)
                if ni is None:
                    continue
                for lst in (ni.pods, ni.pods_with_affinity,
                            ni.pods_with_required_anti_affinity):
                    for i in range(len(lst) - 1, -1, -1):
                        if lst[i].pod.key == key:
                            lst.pop(i)
                            break
                if check_ports:
                    for port in _host_ports(pod):
                        ni.used_ports.discard(port)
                self._touch(ni, node_name)

    def apply_node_resource_deltas(self, resource_dims, node_deltas,
                                   expected_gen: Optional[int] = None
                                   ) -> Optional[int]:
        """Phase 2 of the columnar assume: per-NODE aggregate requested /
        non-zero-requested updates (one Resource poke per touched node
        instead of two Resource.adds per pod) plus the generation touch that
        makes update_snapshot clone exactly these nodes. node_deltas =
        [(node_name, d_raw, d_raw_nz)] with d_* int64 vectors laid out by
        resource_dims (milli-CPU, bytes, bytes, then scalar counts — the
        tensorizer's raw layout, so the same scatter-add feeds both this and
        TensorCache.apply_assume_deltas).

        Returns the generation after the touches IF the cache was still at
        expected_gen on entry — proving, under one lock hold, that every
        generation between the two is one of these touches (the TensorCache
        fast path's precondition). Returns None when a foreign mutation got
        in first (e.g. a bind-worker forget_pod): the deltas still apply,
        but the caller must leave requantization to the normal diff path."""
        from ..api.resources import CPU, EPHEMERAL_STORAGE, MEMORY

        with self._lock:
            clean = expected_gen is None or self._generation == expected_gen
            for node_name, d_raw, d_raw_nz in node_deltas:
                ni = self._nodes.get(node_name)
                if ni is None:
                    continue
                for res, vec in ((ni.requested, d_raw),
                                 (ni.non_zero_requested, d_raw_nz)):
                    for di, dim in enumerate(resource_dims):
                        v = int(vec[di])
                        if not v:
                            continue
                        if dim == CPU:
                            res.milli_cpu += v
                        elif dim == MEMORY:
                            res.memory += v
                        elif dim == EPHEMERAL_STORAGE:
                            res.ephemeral_storage += v
                        else:
                            res.scalar[dim] = res.scalar.get(dim, 0) + v
                self._touch(ni, node_name)
            return self._generation if clean else None

    def confirm_assumed_bulk(self, pairs) -> List[int]:
        """Self-bind short-circuit: confirm assumed pods whose bind MODIFIED
        events came back from our own bind_many — equivalent to add_pod's
        confirmation branch (drop the assume record, accounting already
        matches) without a per-event ingest. pairs = [(pod key, node_name)];
        returns the indices that did NOT match an assume on that node — the
        caller must push those through the full ingest path (foreign bind,
        expired assume, node mismatch)."""
        leftover = []
        with self._lock:
            for i, (key, node_name) in enumerate(pairs):
                if key in self._assumed and self._pod_nodes.get(key) == node_name:
                    del self._assumed[key]
                else:
                    leftover.append(i)
        return leftover

    @property
    def generation(self) -> int:
        """Current mutation counter (snapshots stamp it; TensorCache compares
        it to decide whether its columnar assume deltas fully explain the
        diff since the last tensorize)."""
        with self._lock:
            return self._generation

    def _assume_internal(self, pod: Pod, node_name: str) -> None:
        key = pod.key
        if key in self._pod_nodes:
            raise ValueError(f"pod {key} is already in the cache")
        pod.spec.node_name = node_name
        self._add_pod_internal(pod)
        self._assumed[key] = 0.0  # no expiry until binding finishes

    def finish_binding(self, pod: Pod) -> None:
        with self._lock:
            if pod.key in self._assumed:
                self._assumed[pod.key] = self._clock.now() + self._ttl

    def finish_binding_bulk(self, pods) -> None:
        """finish_binding for a whole committed bind batch: one lock, one
        clock read (the bind worker's per-pod acquires were measurable at
        100k-bind scale)."""
        with self._lock:
            deadline = self._clock.now() + self._ttl
            assumed = self._assumed
            for pod in pods:
                key = pod.key
                if key in assumed:
                    assumed[key] = deadline

    def forget_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed.pop(pod.key, None)
            self._remove_pod_internal(pod.key)

    def is_assumed(self, key: str) -> bool:
        with self._lock:
            return key in self._assumed

    def assumed_count(self) -> int:
        """How many pods are currently assumed-but-unconfirmed (the state a
        crash resync drops — resync_from_store reports it)."""
        with self._lock:
            return len(self._assumed)

    def contains(self, key: str) -> bool:
        """Whether the cache accounts for this pod at all (bound or assumed).
        A gang member whose assume EXPIRED out of the cache reads False while
        the GangDirectory may still count it toward quorum until the sweep
        counts it back out (GangDirectory.note_expired_keys)."""
        with self._lock:
            return key in self._pod_nodes

    def cleanup_expired_assumed_pods(self) -> List[str]:
        with self._lock:
            now = self._clock.now()
            expired = [k for k, dl in self._assumed.items() if dl and dl < now]
            for key in expired:
                self._assumed.pop(key, None)
                self._remove_pod_internal(key)
            return expired

    # -- snapshotting (cache.go:186 UpdateSnapshot) ----------------------------

    def update_snapshot(self) -> Snapshot:
        """Incremental: clone only NodeInfos newer than the last snapshot.

        Fast path: when every mutation since the last snapshot was tracked by
        name (`_dirty_names` — resource pokes, pod adds/removes on existing
        real nodes), only those names are generation-compared and the
        snapshot derives via Snapshot.from_prev, skipping the O(all nodes)
        walk. Any structural event (node add/remove/promote) clears the set
        to None and the full walk below runs — producing a bit-identical
        result, just slower. The derived snapshot carries
        changed_names/changed_from_gen so the tensorizer can diff by the same
        set instead of identity-walking the node list."""
        with self._lock:
            if self._snapshot is not None and self._snapshot_generation == self._generation:
                return self._snapshot
            prev_snap = self._snapshot
            dirty = self._dirty_names
            if prev_snap is not None and dirty is not None:
                changed: Dict[str, NodeInfo] = {}
                ok = True
                for name in dirty:
                    ni = self._nodes.get(name)
                    if ni is None:
                        ok = False  # vanished without a structural event? full walk
                        break
                    if ni.node is None:
                        continue  # placeholder: excluded from prev too
                    old = prev_snap.node_info_map.get(name)
                    if old is None:
                        ok = False  # appeared without a structural event? full walk
                        break
                    if old.generation != ni.generation:
                        changed[name] = ni.clone()
                if ok:
                    snap = Snapshot.from_prev(prev_snap, changed)
                    snap.generation = self._generation
                    self._snapshot = snap
                    self._snapshot_generation = self._generation
                    self._dirty_names = set()
                    return snap
            prev = prev_snap.node_info_map if prev_snap is not None else {}
            new_map: Dict[str, NodeInfo] = {}
            for name, ni in self._nodes.items():
                if ni.node is None:
                    continue  # placeholder without a real Node yet
                old = prev.get(name)
                if old is not None and old.generation == ni.generation:
                    new_map[name] = old
                else:
                    new_map[name] = ni.clone()
            snap = Snapshot(new_map)
            snap.generation = self._generation
            self._snapshot = snap
            self._snapshot_generation = self._generation
            self._dirty_names = set()
            return snap

    def node_count(self) -> int:
        with self._lock:
            return sum(1 for ni in self._nodes.values() if ni.node is not None)

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_nodes)
