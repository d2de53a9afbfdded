"""Storage API types: PersistentVolume, PersistentVolumeClaim, StorageClass,
CSINode, VolumeAttachment.

reference: staging/src/k8s.io/api/core/v1/types.go (PersistentVolume,
PersistentVolumeClaim), staging/src/k8s.io/api/storage/v1/types.go
(StorageClass, CSINode). The counterpart of `kubernetes_tpu/api/storage.py`:
the fields the scheduler's volume plugins read and write, with the same
names, defaults and wire shapes, and the VolumeAttachment the attach/detach
controller writes (controllers/volume.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .labels import NodeSelector
from .resources import quantity_value
from .types import ObjectMeta

# volumeBindingMode (storage/v1/types.go VolumeBindingMode)
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# PV/PVC phases
VOLUME_AVAILABLE = "Available"
VOLUME_BOUND = "Bound"
VOLUME_RELEASED = "Released"
CLAIM_PENDING = "Pending"
CLAIM_BOUND = "Bound"


def _node_selector_to_dict(ns: NodeSelector) -> Dict[str, Any]:
    def reqs(rs):
        return [{"key": r.key, "operator": r.op,
                 **({"values": list(r.values)} if r.values else {})} for r in rs]

    return {"nodeSelectorTerms": [
        {**({"matchExpressions": reqs(t.match_expressions)} if t.match_expressions else {}),
         **({"matchFields": reqs(t.match_fields)} if t.match_fields else {})}
        for t in ns.terms
    ]}

# Access modes (core/v1/types.go PersistentVolumeAccessMode)
READ_WRITE_ONCE = "ReadWriteOnce"
READ_ONLY_MANY = "ReadOnlyMany"
READ_WRITE_MANY = "ReadWriteMany"
READ_WRITE_ONCE_POD = "ReadWriteOncePod"


@dataclass
class PersistentVolumeSpec:
    capacity: int = 0  # storage bytes
    access_modes: List[str] = field(default_factory=list)
    storage_class_name: str = ""
    # persistentVolumeReclaimPolicy: Retain (manual default) | Delete
    reclaim_policy: str = "Retain"
    node_affinity: Optional[NodeSelector] = None  # spec.nodeAffinity.required
    claim_ref: str = ""  # "ns/name" of the bound PVC
    csi_driver: str = ""  # spec.csi.driver (for NodeVolumeLimits counting)
    volume_handle: str = ""  # spec.csi.volumeHandle


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    phase: str = VOLUME_AVAILABLE

    kind = "PersistentVolume"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "PersistentVolume":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        spec = d.get("spec") or {}
        csi = spec.get("csi") or {}
        claim = spec.get("claimRef") or {}
        na = (spec.get("nodeAffinity") or {}).get("required")
        return PersistentVolume(
            metadata=meta,
            spec=PersistentVolumeSpec(
                capacity=quantity_value((spec.get("capacity") or {}).get("storage", 0)),
                access_modes=list(spec.get("accessModes") or []),
                storage_class_name=spec.get("storageClassName", ""),
                reclaim_policy=spec.get("persistentVolumeReclaimPolicy",
                                        "Retain"),
                node_affinity=NodeSelector.from_dict(na),
                claim_ref=(f"{claim.get('namespace', 'default')}/{claim['name']}"
                           if claim.get("name") else ""),
                csi_driver=csi.get("driver", ""),
                volume_handle=csi.get("volumeHandle", ""),
            ),
            phase=(d.get("status") or {}).get("phase", VOLUME_AVAILABLE),
        )

    def to_dict(self) -> Dict[str, Any]:
        meta = self.metadata.to_dict()
        meta.pop("namespace", None)
        spec: Dict[str, Any] = {
            "capacity": {"storage": self.spec.capacity},
            "accessModes": list(self.spec.access_modes),
        }
        if self.spec.storage_class_name:
            spec["storageClassName"] = self.spec.storage_class_name
        if self.spec.reclaim_policy != "Retain":
            spec["persistentVolumeReclaimPolicy"] = self.spec.reclaim_policy
        if self.spec.claim_ref:
            ns, _, name = self.spec.claim_ref.partition("/")
            spec["claimRef"] = {"namespace": ns, "name": name}
        if self.spec.csi_driver:
            spec["csi"] = {"driver": self.spec.csi_driver,
                           "volumeHandle": self.spec.volume_handle}
        if self.spec.node_affinity is not None:
            spec["nodeAffinity"] = {
                "required": _node_selector_to_dict(self.spec.node_affinity)}
        return {"apiVersion": "v1", "kind": "PersistentVolume", "metadata": meta,
                "spec": spec, "status": {"phase": self.phase}}


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    request: int = 0  # resources.requests.storage, bytes
    storage_class_name: Optional[str] = None  # None = cluster default class
    volume_name: str = ""  # bound PV name


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    phase: str = CLAIM_PENDING

    kind = "PersistentVolumeClaim"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def is_bound(self) -> bool:
        return bool(self.spec.volume_name) and self.phase == CLAIM_BOUND

    @staticmethod
    def from_dict(d: Mapping) -> "PersistentVolumeClaim":
        spec = d.get("spec") or {}
        req = ((spec.get("resources") or {}).get("requests") or {}).get("storage", 0)
        return PersistentVolumeClaim(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PersistentVolumeClaimSpec(
                access_modes=list(spec.get("accessModes") or []),
                request=quantity_value(req),
                storage_class_name=spec.get("storageClassName"),
                volume_name=spec.get("volumeName", ""),
            ),
            phase=(d.get("status") or {}).get("phase", CLAIM_PENDING),
        )

    def to_dict(self) -> Dict[str, Any]:
        spec: Dict[str, Any] = {
            "accessModes": list(self.spec.access_modes),
            "resources": {"requests": {"storage": self.spec.request}},
        }
        if self.spec.storage_class_name is not None:
            spec["storageClassName"] = self.spec.storage_class_name
        if self.spec.volume_name:
            spec["volumeName"] = self.spec.volume_name
        return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                "metadata": self.metadata.to_dict(), "spec": spec,
                "status": {"phase": self.phase}}


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = BINDING_IMMEDIATE
    allowed_topologies: Optional[NodeSelector] = None  # terms ORed, like PV affinity
    is_default: bool = False

    kind = "StorageClass"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "StorageClass":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        topo = d.get("allowedTopologies")
        ns = None
        if topo:
            # allowedTopologies is a list of TopologySelectorTerms; model as a
            # NodeSelector whose requirements use the In operator.
            ns = NodeSelector.from_dict({"nodeSelectorTerms": [
                {"matchExpressions": [
                    {"key": e["key"], "operator": "In", "values": list(e.get("values") or [])}
                    for e in t.get("matchLabelExpressions") or []
                ]}
                for t in topo
            ]})
        return StorageClass(
            metadata=meta,
            provisioner=d.get("provisioner", ""),
            volume_binding_mode=d.get("volumeBindingMode", BINDING_IMMEDIATE),
            allowed_topologies=ns,
            is_default=(meta.annotations.get(
                "storageclass.kubernetes.io/is-default-class") == "true"),
        )

    def to_dict(self) -> Dict[str, Any]:
        meta = self.metadata.to_dict()
        meta.pop("namespace", None)
        d: Dict[str, Any] = {
            "apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
            "metadata": meta, "provisioner": self.provisioner,
            "volumeBindingMode": self.volume_binding_mode,
        }
        if self.allowed_topologies is not None:
            d["allowedTopologies"] = [
                {"matchLabelExpressions": [
                    {"key": r.key, "values": list(r.values)}
                    for r in t.match_expressions
                ]}
                for t in self.allowed_topologies.terms
            ]
        return d


@dataclass
class CSINode:
    """Per-node CSI driver registry with attach limits (storage/v1/types.go
    CSINode; consumed by the NodeVolumeLimits plugin)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # driver name -> allocatable count; None = registered but unenforced
    # (nil Allocatable.Count in the reference means "no limit")
    drivers: Dict[str, Optional[int]] = field(default_factory=dict)

    kind = "CSINode"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped, named after the node

    @staticmethod
    def from_dict(d: Mapping) -> "CSINode":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        drivers = {}
        for drv in (d.get("spec") or {}).get("drivers") or []:
            count = (drv.get("allocatable") or {}).get("count")
            drivers[drv["name"]] = int(count) if count is not None else None
        return CSINode(metadata=meta, drivers=drivers)

    def to_dict(self) -> Dict[str, Any]:
        meta = self.metadata.to_dict()
        meta.pop("namespace", None)
        return {"apiVersion": "storage.k8s.io/v1", "kind": "CSINode", "metadata": meta,
                "spec": {"drivers": [
                    {"name": name,
                     **({"allocatable": {"count": count}} if count is not None else {})}
                    for name, count in sorted(self.drivers.items())
                ]}}


@dataclass
class VolumeAttachment:
    """storage.k8s.io/v1 VolumeAttachment: the attach/detach controller's
    record that a PV is attached to a node (reference:
    pkg/controller/volume/attachdetach/attach_detach_controller.go; the
    external CSI attacher flips status.attached — here the controller is
    the attach backend for the fake runtime and attaches synchronously)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    attacher: str = ""
    node_name: str = ""
    pv_name: str = ""  # spec.source.persistentVolumeName
    attached: bool = False

    kind = "VolumeAttachment"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @staticmethod
    def from_dict(d: Mapping) -> "VolumeAttachment":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        spec = d.get("spec") or {}
        return VolumeAttachment(
            metadata=meta,
            attacher=spec.get("attacher", ""),
            node_name=spec.get("nodeName", ""),
            pv_name=(spec.get("source") or {}).get("persistentVolumeName", ""),
            attached=bool((d.get("status") or {}).get("attached", False)),
        )

    def to_dict(self) -> Dict[str, Any]:
        meta = self.metadata.to_dict()
        meta.pop("namespace", None)
        return {"apiVersion": "storage.k8s.io/v1", "kind": self.kind,
                "metadata": meta,
                "spec": {"attacher": self.attacher,
                         "nodeName": self.node_name,
                         "source": {"persistentVolumeName": self.pv_name}},
                "status": {"attached": self.attached}}
