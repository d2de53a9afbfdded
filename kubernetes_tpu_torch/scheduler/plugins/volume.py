"""Volume plugins: VolumeBinding, VolumeRestrictions, VolumeZone,
NodeVolumeLimits.

reference: pkg/scheduler/framework/plugins/{volumebinding/volume_binding.go,
volumerestrictions/volume_restrictions.go, volumezone/volume_zone.go,
nodevolumelimits/csi.go}. The counterpart of
`kubernetes_tpu/scheduler/plugins/volume.py`, with the same statuses, scores
and writes: VolumeBinding partitions the pod's claims in PreFilter, checks
static binding and provisioning per node in Filter, picks the PVs in Reserve
and writes the PV/PVC binding through the store in PreBind;
VolumeRestrictions checks shared-disk conflicts and ReadWriteOncePod;
VolumeZone checks a bound PV's zone and region labels against the node;
NodeVolumeLimits enforces CSINode attach limits. The plugins share one
VolumeLister, which the scheduler feeds from the store's storage kinds
(scheduler/serial.py STORAGE_KINDS).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...api.storage import (
    BINDING_WAIT_FOR_FIRST_CONSUMER,
    CLAIM_BOUND,
    CSINode,
    PersistentVolume,
    PersistentVolumeClaim,
    READ_WRITE_ONCE_POD,
    StorageClass,
    VOLUME_BOUND,
)
from ...api.types import LABEL_REGION, LABEL_ZONE
from ...store import NotFoundError
from ..framework import (
    ClusterEventWithHint,
    CycleState,
    NodeInfo,
    Plugin,
    Status,
    SUCCESS,
)

ERR_REASON_NOT_FOUND = "persistentvolumeclaim not found"
ERR_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_BINDING = "node(s) didn't find available persistent volumes to bind"
ERR_ZONE_CONFLICT = "node(s) had no available volume zone"
ERR_DISK_CONFLICT = "node(s) had no available disk"
ERR_RWOP_CONFLICT = "pod uses a ReadWriteOncePod PVC already in use"
ERR_VOLUME_LIMIT = "node(s) exceed max volume count"


@dataclass
class VolumeLister:
    """Handle onto the storage objects the volume plugins consult (the
    reference reaches these through framework.Handle's SharedInformerFactory)."""

    pvcs: Dict[str, PersistentVolumeClaim] = field(default_factory=dict)  # "ns/name"
    pvs: Dict[str, PersistentVolume] = field(default_factory=dict)  # name
    classes: Dict[str, StorageClass] = field(default_factory=dict)  # name
    csinodes: Dict[str, CSINode] = field(default_factory=dict)  # node name

    def get_pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self.pvcs.get(f"{namespace}/{name}")

    def clear(self) -> None:
        """Drop all state ahead of a relist (informer cache replace)."""
        self.pvcs.clear()
        self.pvs.clear()
        self.classes.clear()
        self.csinodes.clear()

    def default_class(self) -> Optional[StorageClass]:
        for sc in self.classes.values():
            if sc.is_default:
                return sc
        return None

    def class_for(self, pvc: PersistentVolumeClaim) -> Optional[StorageClass]:
        name = pvc.spec.storage_class_name
        if name is None:
            return self.default_class()
        return self.classes.get(name)

    def _map_for(self, obj) -> Tuple[Dict, str]:
        if isinstance(obj, PersistentVolumeClaim):
            return self.pvcs, obj.key
        if isinstance(obj, PersistentVolume):
            return self.pvs, obj.metadata.name
        if isinstance(obj, StorageClass):
            return self.classes, obj.metadata.name
        if isinstance(obj, CSINode):
            return self.csinodes, obj.metadata.name
        raise TypeError(type(obj).__name__)

    def add(self, obj) -> None:
        m, key = self._map_for(obj)
        m[key] = obj

    def remove(self, obj) -> None:
        m, key = self._map_for(obj)
        m.pop(key, None)


def pod_pvc_names(pod) -> List[Tuple[str, bool]]:
    """(claim name, read_only) per PVC-backed volume; ephemeral volumes use the
    '<pod>-<volume>' generated claim name (volume_binding.go podVolumeClaims)."""
    out = []
    for v in pod.spec.volumes:
        if v.pvc_claim_name:
            out.append((v.pvc_claim_name, v.pvc_read_only))
        elif v.ephemeral:
            out.append((f"{pod.metadata.name}-{v.name}", False))
    return out


def pv_matches_node(pv: PersistentVolume, node) -> bool:
    if pv.spec.node_affinity is None:
        return True
    return pv.spec.node_affinity.matches(node)


@dataclass
class _PodVolumeState:
    bound: List[Tuple[PersistentVolumeClaim, PersistentVolume]]
    unbound: List[PersistentVolumeClaim]  # WaitForFirstConsumer, need binding


@dataclass
class _NodeBinding:
    static: List[Tuple[PersistentVolumeClaim, PersistentVolume]]
    provision: List[PersistentVolumeClaim]


class VolumeBinding(Plugin):
    """Topology-aware PV/PVC binding (volumebinding/volume_binding.go:603).

    PreFilter partitions the pod's claims; Filter checks each node can satisfy
    them (bound-PV affinity, matchable PVs, or provisionable class topology);
    Reserve picks concrete PVs per claim; PreBind writes the bindings through
    the lister (the in-memory stand-in for the API writes the reference's
    volume binder issues).
    """

    name = "VolumeBinding"
    STATE_KEY = "PreFilterVolumeBinding"
    BIND_KEY = "VolumeBindingReserved"

    def __init__(self, lister: Optional[VolumeLister] = None):
        self.lister = lister or VolumeLister()
        self._store = None

    def events_to_register(self):
        """volume_binding EventsToRegister: any PV/PVC/StorageClass/CSINode
        change can unblock a pending claim; assigned-pod deletes release
        ReadWriteOncePod claims and attach slots."""
        return (ClusterEventWithHint("persistentvolumes", "add"),
                ClusterEventWithHint("persistentvolumes", "update"),
                ClusterEventWithHint("persistentvolumeclaims", "add"),
                ClusterEventWithHint("persistentvolumeclaims", "update"),
                ClusterEventWithHint("storageclasses", "add"),
                ClusterEventWithHint("storageclasses", "update"),
                ClusterEventWithHint("csinodes", "add"),
                ClusterEventWithHint("csinodes", "update"),
                ClusterEventWithHint("nodes", "add"),
                ClusterEventWithHint("pods", "delete"))

    def set_handles(self, framework, store, recorder=None) -> None:
        """Persist PreBind's PVC/PV writes through the API store (the reference
        binder PATCHes the apiserver; serial.py calls this during wiring)."""
        self._store = store

    def _persist(self, kind: str, obj) -> None:
        """Write-through to the API store. Update-then-create covers objects
        the lister knows but the store hasn't seen yet; any other failure
        propagates so PreBind fails instead of silently diverging from the
        store."""
        if self._store is None:
            return
        try:
            self._store.update(kind, obj, check_rv=False)
        except NotFoundError:
            self._store.create(kind, obj)

    def pre_filter(self, state: CycleState, pod, snapshot):
        claims = pod_pvc_names(pod)
        if not claims:
            state.write(self.STATE_KEY, _PodVolumeState([], []))
            return None, Status.skip(plugin=self.name)
        bound, unbound = [], []
        for claim_name, _ro in claims:
            pvc = self.lister.get_pvc(pod.metadata.namespace, claim_name)
            if pvc is None:
                return None, Status.unresolvable(
                    f'{ERR_REASON_NOT_FOUND}: "{claim_name}"', plugin=self.name)
            if pvc.is_bound():
                pv = self.lister.pvs.get(pvc.spec.volume_name)
                if pv is None:
                    return None, Status.unresolvable(
                        f'PersistentVolume "{pvc.spec.volume_name}" not found',
                        plugin=self.name)
                bound.append((pvc, pv))
                continue
            sc = self.lister.class_for(pvc)
            if sc is None or sc.volume_binding_mode != BINDING_WAIT_FOR_FIRST_CONSUMER:
                # Immediate-mode claims must be bound by the PV controller
                # before scheduling (volume_binding.go PreFilter).
                return None, Status.unresolvable(ERR_UNBOUND_IMMEDIATE, plugin=self.name)
            unbound.append(pvc)
        state.write(self.STATE_KEY, _PodVolumeState(bound, unbound))
        return None, SUCCESS

    def _find_matching_pv(self, pvc: PersistentVolumeClaim, node,
                          taken: set) -> Optional[PersistentVolume]:
        """Smallest available PV satisfying class/capacity/access/affinity
        (volume_binding.go findMatchingVolumes semantics)."""
        best = None
        # A claim without an explicit class resolves to the cluster default —
        # the PV must match the effective class either way.
        sc = self.lister.class_for(pvc)
        sc_name = pvc.spec.storage_class_name
        if sc_name is None:
            sc_name = sc.metadata.name if sc is not None else ""
        for pv in self.lister.pvs.values():
            if pv.metadata.name in taken or pv.spec.claim_ref or pv.phase == VOLUME_BOUND:
                continue
            if pv.spec.storage_class_name != sc_name:
                continue
            if pv.spec.capacity < pvc.spec.request:
                continue
            if not set(pvc.spec.access_modes) <= set(pv.spec.access_modes):
                continue
            if not pv_matches_node(pv, node):
                continue
            if best is None or pv.spec.capacity < best.spec.capacity:
                best = pv
        return best

    def _node_binding(self, state: CycleState, pod, node) -> Tuple[Optional[_NodeBinding], Status]:
        # Per-node result cached in CycleState: Filter computes it, Score and
        # Reserve reuse it (the reference caches PodVolumes the same way).
        cache_key = f"{self.STATE_KEY}/{node.metadata.name}"
        cached = state.read_or_none(cache_key)
        if cached is not None:
            return cached
        result = self._node_binding_uncached(state, pod, node)
        state.write(cache_key, result)
        return result

    def _node_binding_uncached(self, state: CycleState, pod, node) -> Tuple[Optional[_NodeBinding], Status]:
        vs: _PodVolumeState = state.read(self.STATE_KEY)
        for _pvc, pv in vs.bound:
            if not pv_matches_node(pv, node):
                return None, Status.unschedulable(ERR_NODE_CONFLICT, plugin=self.name)
        static, provision, taken = [], [], set()
        for pvc in vs.unbound:
            pv = self._find_matching_pv(pvc, node, taken)
            if pv is not None:
                taken.add(pv.metadata.name)
                static.append((pvc, pv))
                continue
            sc = self.lister.class_for(pvc)
            if sc is not None and sc.provisioner and (
                    sc.allowed_topologies is None or sc.allowed_topologies.matches(node)):
                provision.append(pvc)
                continue
            return None, Status.unschedulable(ERR_BINDING, plugin=self.name)
        return _NodeBinding(static, provision), SUCCESS

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        _, st = self._node_binding(state, pod, node_info.node)
        return st

    def score(self, state: CycleState, pod, node_info: NodeInfo):
        """Prefer nodes where static binding wastes the least capacity
        (volume_binding.go scorer: utilization of the chosen PVs)."""
        binding, st = self._node_binding(state, pod, node_info.node)
        if not st.is_success() or binding is None or not binding.static:
            return 0, SUCCESS
        util = sum(min(pvc.spec.request / pv.spec.capacity, 1.0)
                   for pvc, pv in binding.static if pv.spec.capacity) / len(binding.static)
        return int(util * 100), SUCCESS

    def reserve(self, state: CycleState, pod, node_name: str) -> Status:
        snapshot = state.read_or_none("Snapshot")
        node_info = snapshot.get(node_name) if snapshot is not None else None
        if node_info is None:
            return Status.error(f"node {node_name} not in snapshot", plugin=self.name)
        binding, st = self._node_binding(state, pod, node_info.node)
        if not st.is_success():
            return st
        state.write(self.BIND_KEY, binding)
        return SUCCESS

    def unreserve(self, state: CycleState, pod, node_name: str) -> None:
        state.write(self.BIND_KEY, None)

    def pre_bind(self, state: CycleState, pod, node_name: str) -> Status:
        binding: Optional[_NodeBinding] = state.read_or_none(self.BIND_KEY)
        if binding is None:
            return SUCCESS
        try:
            return self._pre_bind(binding)
        except Exception as e:  # failed PVC/PV write must fail the bind
            return Status.error(f"binding volumes: {e}", plugin=self.name)

    def _pre_bind(self, binding: "_NodeBinding") -> Status:
        for pvc, pv in binding.static:
            pv.spec.claim_ref = pvc.key
            pv.phase = VOLUME_BOUND
            pvc.spec.volume_name = pv.metadata.name
            pvc.phase = CLAIM_BOUND
            self._persist("persistentvolumes", pv)
            self._persist("persistentvolumeclaims", pvc)
        for pvc in binding.provision:
            # Dynamic provisioning: materialize a PV on the spot (stand-in for
            # the external provisioner round-trip).
            sc = self.lister.class_for(pvc)
            name = f"pvc-{pvc.metadata.uid or pvc.metadata.name}"
            pv = PersistentVolume(metadata=type(pvc.metadata)(name=name))
            pv.spec.capacity = pvc.spec.request
            pv.spec.access_modes = list(pvc.spec.access_modes)
            pv.spec.storage_class_name = pvc.spec.storage_class_name or (
                sc.metadata.name if sc else "")
            pv.spec.claim_ref = pvc.key
            pv.phase = VOLUME_BOUND
            self.lister.pvs[name] = pv
            pvc.spec.volume_name = name
            pvc.phase = CLAIM_BOUND
            self._persist("persistentvolumes", pv)
            self._persist("persistentvolumeclaims", pvc)
        return SUCCESS


class VolumeRestrictions(Plugin):
    """Shared-disk conflicts + ReadWriteOncePod enforcement
    (volumerestrictions/volume_restrictions.go)."""

    name = "VolumeRestrictions"

    def __init__(self, lister: Optional[VolumeLister] = None):
        self.lister = lister or VolumeLister()

    def pre_filter(self, state: CycleState, pod, snapshot):
        # ReadWriteOncePod: the claim must not be in use by any other pod
        # anywhere in the cluster (volume_restrictions.go isRWOPConflict).
        rwop = set()
        for claim_name, _ro in pod_pvc_names(pod):
            pvc = self.lister.get_pvc(pod.metadata.namespace, claim_name)
            if pvc is not None and READ_WRITE_ONCE_POD in pvc.spec.access_modes:
                rwop.add(pvc.key)
        if rwop:
            for ni in snapshot.node_info_list:
                for pi in ni.pods:
                    other = pi.pod
                    if other.key == pod.key:
                        continue
                    for claim_name, _ro in pod_pvc_names(other):
                        if f"{other.metadata.namespace}/{claim_name}" in rwop:
                            return None, Status.unschedulable(
                                ERR_RWOP_CONFLICT, plugin=self.name)
        if not pod.spec.volumes:
            return None, Status.skip(plugin=self.name)
        return None, SUCCESS

    @staticmethod
    def _conflicts(v, existing) -> bool:
        """True when two volume sources collide (volume_restrictions.go
        isVolumeConflict): GCE PD / RBD / ISCSI allow sharing only when both
        sides are read-only; AWS EBS never shares."""
        if v.gce_pd and v.gce_pd == existing.gce_pd:
            if not (v.gce_read_only and existing.gce_read_only):
                return True
        if v.aws_ebs and v.aws_ebs == existing.aws_ebs:
            return True
        if v.rbd and v.rbd == existing.rbd:
            if not (v.rbd_read_only and existing.rbd_read_only):
                return True
        if v.iscsi and v.iscsi == existing.iscsi:
            if not (v.iscsi_read_only and existing.iscsi_read_only):
                return True
        return False

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        for v in pod.spec.volumes:
            if not (v.gce_pd or v.aws_ebs or v.rbd or v.iscsi):
                continue
            for pi in node_info.pods:
                for ev in pi.pod.spec.volumes:
                    if self._conflicts(v, ev):
                        return Status.unschedulable(ERR_DISK_CONFLICT, plugin=self.name)
        return SUCCESS


class VolumeZone(Plugin):
    """Bound-PV zone/region labels must be satisfied by the node
    (volumezone/volume_zone.go)."""

    name = "VolumeZone"
    _TOPOLOGY_KEYS = (LABEL_ZONE, LABEL_REGION,
                      "failure-domain.beta.kubernetes.io/zone",
                      "failure-domain.beta.kubernetes.io/region")

    def __init__(self, lister: Optional[VolumeLister] = None):
        self.lister = lister or VolumeLister()

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        node_labels = node_info.node.metadata.labels
        for claim_name, _ro in pod_pvc_names(pod):
            pvc = self.lister.get_pvc(pod.metadata.namespace, claim_name)
            if pvc is None or not pvc.spec.volume_name:
                continue  # unbound claims are VolumeBinding's problem
            pv = self.lister.pvs.get(pvc.spec.volume_name)
            if pv is None:
                continue
            for key in self._TOPOLOGY_KEYS:
                want = pv.metadata.labels.get(key)
                if want is None:
                    continue
                # PV zone labels may hold a __ separated set (volume_zone.go
                # uses LabelZonesToSet).
                if node_labels.get(key) not in want.split("__"):
                    return Status.unschedulable(ERR_ZONE_CONFLICT, plugin=self.name)
        return SUCCESS


class NodeVolumeLimits(Plugin):
    """CSI attachable-volume count limits (nodevolumelimits/csi.go)."""

    name = "NodeVolumeLimits"

    def __init__(self, lister: Optional[VolumeLister] = None):
        self.lister = lister or VolumeLister()

    def _csi_volumes(self, pod) -> Dict[str, set]:
        """driver -> {volume handles or pv names} the pod would attach."""
        out: Dict[str, set] = {}
        for claim_name, _ro in pod_pvc_names(pod):
            pvc = self.lister.get_pvc(pod.metadata.namespace, claim_name)
            if pvc is None:
                continue
            driver, handle = "", ""
            if pvc.spec.volume_name:
                pv = self.lister.pvs.get(pvc.spec.volume_name)
                if pv is not None and pv.spec.csi_driver:
                    driver = pv.spec.csi_driver
                    handle = pv.spec.volume_handle or pv.metadata.name
            else:
                sc = self.lister.class_for(pvc)
                if sc is not None:
                    driver, handle = sc.provisioner, pvc.key
            if driver:
                out.setdefault(driver, set()).add(handle)
        return out

    def filter(self, state: CycleState, pod, node_info: NodeInfo) -> Status:
        new = self._csi_volumes(pod)
        if not new:
            return SUCCESS
        csinode = self.lister.csinodes.get(node_info.node.metadata.name)
        if csinode is None:
            return SUCCESS  # no CSINode => no limits known (csi.go)
        existing: Dict[str, set] = {}
        for pi in node_info.pods:
            for driver, handles in self._csi_volumes(pi.pod).items():
                existing.setdefault(driver, set()).update(handles)
        for driver, handles in new.items():
            limit = csinode.drivers.get(driver)
            if limit is None:
                continue
            total = handles | existing.get(driver, set())
            if len(total) > limit:
                return Status.unschedulable(ERR_VOLUME_LIMIT, plugin=self.name)
        return SUCCESS
