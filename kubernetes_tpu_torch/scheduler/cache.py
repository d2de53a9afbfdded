"""Scheduler cache: in-scheduler cluster state with the assumed-pod
lifecycle and generation-based incremental snapshotting.

The counterpart of `kubernetes_tpu/scheduler/cache.py` on the object path
(reference: pkg/scheduler/backend/cache/cache.go — UpdateSnapshot :186,
AssumePod :361, ForgetPod :404). Every assumed pod here is a PodInfo (the
columnar cache rows of the JAX package come with the remaining host layers,
ROADMAP.md queue 1 item 7). Binds are synchronous and confirm their assumes
right after the commit (confirm_assumed_bulk), so assumes carry no expiry
deadline; the assume TTL comes with pipelined binds (item 7).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..api import Node, Pod
from .framework import NodeInfo, PodInfo, Snapshot


class Cache:
    def __init__(self):
        self._lock = threading.RLock()
        self._generation = 0
        self._nodes: Dict[str, NodeInfo] = {}
        # pod key -> node name for every known (added or assumed) pod
        self._pod_nodes: Dict[str, str] = {}
        self._assumed: Set[str] = set()  # keys of assumed, unconfirmed pods
        self._snapshot_generation = -1
        self._snapshot: Optional[Snapshot] = None
        # image name -> shared ImageStateSummary (num_nodes mutated in place)
        self._image_entries: Dict[str, object] = {}
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

    def remove_node(self, name: str) -> None:
        with self._lock:
            ni = self._nodes.get(name)
            if ni is None:
                return
            if ni.node is not None:
                self._remove_image_counts(ni.node)
            if ni.pods:
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
                self._assumed.discard(key)
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
        self.forget_pod(pod)

    # -- assumed pod lifecycle (cache.go:361-420) ------------------------------

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
                    self._assumed.discard(key)
                else:
                    leftover.append(i)
        return leftover

    def _assume_internal(self, pod: Pod, node_name: str) -> None:
        key = pod.key
        if key in self._pod_nodes:
            raise ValueError(f"pod {key} is already in the cache")
        pod.spec.node_name = node_name
        self._add_pod_internal(pod)
        self._assumed.add(key)

    def forget_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed.discard(pod.key)
            self._remove_pod_internal(pod.key)

    def is_assumed(self, key: str) -> bool:
        with self._lock:
            return key in self._assumed

    def contains(self, key: str) -> bool:
        """Is the pod accounted (added or assumed) on some node?"""
        with self._lock:
            return key in self._pod_nodes

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
