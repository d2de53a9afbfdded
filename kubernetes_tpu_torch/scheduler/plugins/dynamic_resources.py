"""DynamicResources plugin: DRA claims drive placement.

reference: pkg/scheduler/framework/plugins/dynamicresources/dynamicresources.go
(PreEnqueue :350, PreFilter :430, Filter :550, Reserve/Unreserve, PreBind) and
staging/src/k8s.io/dynamic-resource-allocation/structured (the allocator over
ResourceSlice pools). The counterpart of
`kubernetes_tpu/scheduler/plugins/dynamic_resources.py`, with the same
statuses, allocations and writes:
  PreEnqueue  pods whose referenced ResourceClaims don't exist stay gated.
  PreFilter   load the pod's claims; allocated claims pin the candidate
              nodes; for unallocated claims the allocator's inputs (slices by
              node, classes, devices in use) are read once a cycle.
  Filter      a node passes iff every unallocated claim can be satisfied
              from the node's free slice devices and every allocated claim
              is on this node.
  Reserve     allocate devices on the chosen node in memory (assume);
              Unreserve returns them.
  PreBind     persist the allocation and reservedFor through the store's
              guaranteed_update; the assumed devices are dropped either way.
The allocator is structural (attribute requirements, counts), not CEL.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from ...api.dra import AllocationResult, DeviceClass, ResourceClaim, ResourceSlice
from ...store import NotFoundError
from ..framework import (
    ClusterEventWithHint,
    CycleState,
    NodeInfo,
    Plugin,
    PreFilterResult,
    Status,
    SUCCESS,
)

_STATE_KEY = "DynamicResources"


class _PodClaimState:
    """Per-cycle state: the pod's claims, split by allocation status."""

    __slots__ = ("claims", "allocated", "pending")

    def __init__(self, claims):
        self.claims: List[ResourceClaim] = claims
        self.allocated = [c for c in claims if c.allocation is not None]
        self.pending = [c for c in claims if c.allocation is None]


class DynamicResources(Plugin):
    name = "DynamicResources"

    def __init__(self, store=None):
        self.store = store
        # in-flight reservations between Reserve and PreBind: claim key ->
        # its allocation (persisted allocations are read from the store)
        self._lock = threading.Lock()
        self._assumed: Dict[str, AllocationResult] = {}

    def set_handles(self, framework, store, recorder=None) -> None:
        self.store = store

    # -- listers ---------------------------------------------------------------

    @staticmethod
    def _claim_names(pod):
        """Resolved claim object names: direct spec references + generated
        claims recorded by the resourceclaim controller
        (status.resourceClaimStatuses); template refs without a recorded
        claim yet resolve to None (pod must wait)."""
        out = []
        for _ref, claim_name in pod.spec.resource_claims:
            out.append(claim_name)
        for ref, _tmpl in pod.spec.resource_claim_templates:
            out.append(pod.status.resource_claim_statuses.get(ref))
        return out

    @staticmethod
    def _has_claims(pod) -> bool:
        return bool(pod.spec.resource_claims
                    or pod.spec.resource_claim_templates)

    def _claims_for(self, pod) -> Optional[List[ResourceClaim]]:
        """None when a referenced claim is missing (or a template's claim
        has not been generated yet)."""
        if self.store is None or not self._has_claims(pod):
            return []
        out = []
        for claim_name in self._claim_names(pod):
            if not claim_name:
                return None
            try:
                out.append(self.store.get(
                    "resourceclaims", f"{pod.metadata.namespace}/{claim_name}"))
            except NotFoundError:
                return None
        return out

    def _slices_by_node(self) -> Dict[str, List[ResourceSlice]]:
        if self.store is None:
            return {}
        slices, _ = self.store.list("resourceslices")
        by_node: Dict[str, List[ResourceSlice]] = {}
        for s in slices:
            by_node.setdefault(s.node_name, []).append(s)
        return by_node

    def _classes(self) -> Dict[str, DeviceClass]:
        if self.store is None:
            return {}
        classes, _ = self.store.list("deviceclasses")
        return {c.metadata.name: c for c in classes}

    def _in_use_devices(self) -> Set[str]:
        """Device keys held by persisted allocations + in-flight assumes."""
        used: Set[str] = set()
        if self.store is not None:
            claims, _ = self.store.list("resourceclaims")
            for c in claims:
                if c.allocation is not None:
                    for d in c.allocation.all_devices():
                        used.add(f"{c.allocation.node_name}/{d}")
        with self._lock:
            for alloc in self._assumed.values():
                for d in alloc.all_devices():
                    used.add(f"{alloc.node_name}/{d}")
        return used

    # -- extension points ------------------------------------------------------

    def pre_enqueue(self, pod) -> Status:
        """PreEnqueue (:350): a pod whose claims are absent can't schedule."""
        if not self._has_claims(pod):
            return SUCCESS
        if self._claims_for(pod) is None:
            return Status.unschedulable(
                "waiting for ResourceClaim(s) to be created", plugin=self.name)
        return SUCCESS

    def events_to_register(self):
        def claim_related(pod, claim) -> bool:
            """isSchedulableAfterClaimChange: the pod's own claim changing
            always matters; a FOREIGN claim matters when it just released its
            devices (allocation cleared) — those devices may now satisfy this
            pod's pending claims."""
            names = {cn for cn in DynamicResources._claim_names(pod) if cn}
            if (claim.metadata.name in names
                    and claim.metadata.namespace == pod.metadata.namespace):
                return True
            return claim.allocation is None

        return (ClusterEventWithHint("resourceclaims", "add", claim_related),
                ClusterEventWithHint("resourceclaims", "update", claim_related),
                # a deleted claim frees its devices even when it still carried
                # an allocation — always requeue on claim deletes
                ClusterEventWithHint("resourceclaims", "delete"),
                ClusterEventWithHint("resourceslices", "add"),
                ClusterEventWithHint("resourceslices", "update"),
                ClusterEventWithHint("deviceclasses", "add"))

    def pre_filter(self, state: CycleState, pod, snapshot):
        if not self._has_claims(pod):
            return None, Status.skip()
        claims = self._claims_for(pod)
        if claims is None:
            return None, Status.unschedulable(
                "pod's ResourceClaim(s) do not exist", plugin=self.name)
        st = _PodClaimState(claims)
        state.write(_STATE_KEY, st)
        if st.pending:
            # snapshot the allocator's inputs ONCE per cycle — Filter runs per
            # node and must not re-list the store each time (the reference
            # allocator preloads in PreFilter the same way)
            state.write(_STATE_KEY + "/ctx", (
                self._slices_by_node(), self._classes(), self._in_use_devices()))
        # an allocated claim pins the pod to its allocation node unless this
        # pod is already among reservedFor users on another (shared claims)
        pinned = {c.allocation.node_name for c in st.allocated}
        if len(pinned) > 1:
            return None, Status.unschedulable(
                "claims are allocated on different nodes", plugin=self.name)
        if pinned:
            return PreFilterResult(node_names=pinned), SUCCESS
        return None, SUCCESS

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        st: Optional[_PodClaimState] = state.read_or_none(_STATE_KEY)
        if st is None:
            return SUCCESS
        node_name = node_info.node.metadata.name
        for c in st.allocated:
            if c.allocation.node_name != node_name:
                return Status.unschedulable(
                    f"claim {c.metadata.name} is allocated on "
                    f"{c.allocation.node_name}", plugin=self.name)
        if st.pending:
            alloc = self._try_allocate(st.pending, node_name,
                                       ctx=state.read_or_none(_STATE_KEY + "/ctx"))
            if alloc is None:
                return Status.unschedulable(
                    "cannot allocate all claim devices on this node",
                    plugin=self.name)
        return SUCCESS

    def _try_allocate(self, claims: List[ResourceClaim], node_name: str,
                      ctx=None) -> Optional[Dict[str, AllocationResult]]:
        """The structured allocator: greedily satisfy every request of every
        claim from the node's free devices. Returns claim key -> allocation,
        or None (reference: structured.Allocator.Allocate). ctx, when given,
        is the cycle-invariant (slices_by_node, classes, in_use) snapshot."""
        if ctx is not None:
            slices_by_node, classes, in_use = ctx
        else:
            slices_by_node = self._slices_by_node()
            classes = self._classes()
            in_use = self._in_use_devices()
        slices = slices_by_node.get(node_name, [])
        if not slices:
            return None
        free = []  # (device key, Device)
        for s in slices:
            for d in s.devices:
                key = f"{node_name}/{d.name}"
                if key not in in_use:
                    free.append((key, d))
        out: Dict[str, AllocationResult] = {}
        taken: Set[str] = set()
        for c in claims:
            alloc = AllocationResult(node_name=node_name)
            for req in c.requests:
                cls = classes.get(req.device_class_name)
                if cls is None:
                    return None
                picked = []
                for key, d in free:
                    if key in taken:
                        continue
                    if not cls.matches(d):
                        continue
                    if not all(sel.matches(d.attributes) for sel in req.selectors):
                        continue
                    picked.append((key, d))
                    if len(picked) == req.count:
                        break
                if len(picked) < req.count:
                    return None
                for key, d in picked:
                    taken.add(key)
                alloc.devices[req.name] = [d.name for _k, d in picked]
            out[c.key] = alloc
        return out

    def reserve(self, state: CycleState, pod, node_name: str) -> Status:
        st: Optional[_PodClaimState] = state.read_or_none(_STATE_KEY)
        if st is None or not st.pending:
            return SUCCESS
        allocs = self._try_allocate(st.pending, node_name)
        if allocs is None:
            return Status.unschedulable(
                "claim devices were taken between Filter and Reserve",
                plugin=self.name)
        with self._lock:
            self._assumed.update(allocs)
        state.write(_STATE_KEY + "/reserved", allocs)
        return SUCCESS

    def unreserve(self, state: CycleState, pod, node_name: str) -> None:
        allocs = state.read_or_none(_STATE_KEY + "/reserved")
        if not allocs:
            return
        with self._lock:
            for claim_key in allocs:
                self._assumed.pop(claim_key, None)

    def pre_bind(self, state: CycleState, pod, node_name: str) -> Status:
        """Persist allocation + reservedFor; on write failure the framework
        unreserves (serial.py commit chain)."""
        st: Optional[_PodClaimState] = state.read_or_none(_STATE_KEY)
        if st is None:
            return SUCCESS
        allocs = state.read_or_none(_STATE_KEY + "/reserved") or {}
        try:
            for c in st.claims:
                alloc = allocs.get(c.key)
                if alloc is None and c.allocation is None:
                    continue

                def mutate(cur, _alloc=alloc):
                    if _alloc is not None:
                        cur.allocation = _alloc
                    if pod.metadata.name not in cur.reserved_for:
                        cur.reserved_for.append(pod.metadata.name)
                    return cur

                self.store.guaranteed_update("resourceclaims", c.key, mutate)
        except Exception as e:
            return Status.error(f"persisting claim allocation: {e}", plugin=self.name)
        finally:
            with self._lock:
                for claim_key in allocs:
                    self._assumed.pop(claim_key, None)
        return SUCCESS

    def deallocate(self, claim_key: str) -> None:
        """Free a claim's devices (pod deletion path / kubelet claim teardown —
        the controller side of the reference's claim lifecycle)."""
        def mutate(cur):
            cur.allocation = None
            cur.reserved_for = []
            return cur

        try:
            self.store.guaranteed_update("resourceclaims", claim_key, mutate)
        except NotFoundError:
            pass  # the claim is gone: nothing holds its devices
