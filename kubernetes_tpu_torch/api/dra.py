"""Dynamic Resource Allocation (DRA) API types, the resource.k8s.io/v1beta1
subset the scheduler reads.

reference: staging/src/k8s.io/api/resource/v1beta1/types.go (ResourceClaim,
DeviceClass, ResourceSlice, structured parameters) and
staging/src/k8s.io/dynamic-resource-allocation/structured (the allocator these
types feed). The counterpart of `kubernetes_tpu/api/dra.py`: devices are
selected by declarative attribute requirements (key op value) where the
reference evaluates CEL, the same decision surface over a bounded
vocabulary. ResourceClaimTemplate comes with the claim controller (ROADMAP.md
queue 1 item 7f).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .types import ObjectMeta


@dataclass(frozen=True)
class DeviceAttributeRequirement:
    """One attribute requirement: key op value. Ops: ==, !=, in, exists,
    >=, <= (numeric). The analog of one CEL comparison in
    device.attributes (resource/v1beta1 CELDeviceSelector)."""

    key: str
    op: str = "=="
    value: Any = None

    def matches(self, attributes: Mapping[str, Any]) -> bool:
        have = attributes.get(self.key)
        if self.op == "exists":
            return have is not None
        if self.op == "==":
            return have == self.value
        if self.op == "!=":
            return have != self.value
        if self.op == "in":
            return have in (self.value or ())
        try:
            if self.op == ">=":
                return have is not None and float(have) >= float(self.value)
            if self.op == "<=":
                return have is not None and float(have) <= float(self.value)
        except (TypeError, ValueError):
            return False
        return False

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceAttributeRequirement":
        return DeviceAttributeRequirement(
            key=d.get("key", ""), op=d.get("op", "=="), value=d.get("value"))


@dataclass
class Device:
    """One allocatable device in a ResourceSlice (resource/v1beta1 Device:
    name + basic.attributes + basic.capacity)."""

    name: str
    attributes: Dict[str, Any] = field(default_factory=dict)
    capacity: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Mapping) -> "Device":
        basic = d.get("basic") or d
        return Device(
            name=d.get("name", ""),
            attributes=dict(basic.get("attributes") or {}),
            capacity=dict(basic.get("capacity") or {}),
        )


@dataclass
class ResourceSlice:
    """Per-node (or per-pool) inventory of devices published by a driver.
    reference: resource/v1beta1 ResourceSlice (spec.nodeName, spec.pool,
    spec.devices)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    driver: str = ""
    pool: str = ""
    devices: List[Device] = field(default_factory=list)

    kind = "ResourceSlice"

    @staticmethod
    def from_dict(d: Mapping) -> "ResourceSlice":
        spec = d.get("spec") or {}
        return ResourceSlice(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            node_name=spec.get("nodeName", ""),
            driver=spec.get("driver", ""),
            pool=(spec.get("pool") or {}).get("name", "") if isinstance(
                spec.get("pool"), Mapping) else spec.get("pool", ""),
            devices=[Device.from_dict(x) for x in spec.get("devices") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "apiVersion": "resource.k8s.io/v1beta1",
            "metadata": self.metadata.to_dict(),
            "spec": {
                "nodeName": self.node_name,
                "driver": self.driver,
                "pool": {"name": self.pool},
                "devices": [
                    {"name": dv.name, "basic": {
                        "attributes": dict(dv.attributes),
                        "capacity": dict(dv.capacity)}}
                    for dv in self.devices
                ],
            },
        }


@dataclass
class DeviceClass:
    """Admin-defined device category (resource/v1beta1 DeviceClass):
    selectors every device of the class must satisfy."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selectors: List[DeviceAttributeRequirement] = field(default_factory=list)

    kind = "DeviceClass"

    def matches(self, device: Device) -> bool:
        return all(s.matches(device.attributes) for s in self.selectors)

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceClass":
        spec = d.get("spec") or {}
        return DeviceClass(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selectors=[DeviceAttributeRequirement.from_dict(s)
                       for s in spec.get("selectors") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "apiVersion": "resource.k8s.io/v1beta1",
            "metadata": self.metadata.to_dict(),
            "spec": {"selectors": [
                {"key": s.key, "op": s.op, "value": s.value}
                for s in self.selectors]},
        }


@dataclass
class DeviceRequest:
    """One request inside a claim (resource/v1beta1 DeviceRequest):
    `count` devices of `device_class_name` matching extra `selectors`."""

    name: str
    device_class_name: str
    count: int = 1
    selectors: List[DeviceAttributeRequirement] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "DeviceRequest":
        return DeviceRequest(
            name=d.get("name", ""),
            device_class_name=d.get("deviceClassName", ""),
            count=int(d.get("count", 1) or 1),
            selectors=[DeviceAttributeRequirement.from_dict(s)
                       for s in d.get("selectors") or []],
        )


@dataclass
class AllocationResult:
    """status.allocation (resource/v1beta1 AllocationResult): which devices on
    which node satisfy the claim."""

    node_name: str = ""
    # request name -> [device names] (all from this node's slices)
    devices: Dict[str, List[str]] = field(default_factory=dict)

    def all_devices(self) -> List[str]:
        return [d for ds in self.devices.values() for d in ds]


@dataclass
class ResourceClaim:
    """resource/v1beta1 ResourceClaim: devices.requests + allocation status +
    reservedFor (the pods allowed to use it)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    requests: List[DeviceRequest] = field(default_factory=list)
    allocation: Optional[AllocationResult] = None
    reserved_for: List[str] = field(default_factory=list)  # pod UIDs or keys

    kind = "ResourceClaim"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "ResourceClaim":
        spec = d.get("spec") or {}
        devices = spec.get("devices") or {}
        st = d.get("status") or {}
        alloc = None
        if st.get("allocation"):
            a = st["allocation"]
            alloc = AllocationResult(
                node_name=a.get("nodeName", ""),
                devices={k: list(v) for k, v in (a.get("devices") or {}).items()},
            )
        return ResourceClaim(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            requests=[DeviceRequest.from_dict(r)
                      for r in devices.get("requests") or []],
            allocation=alloc,
            reserved_for=[r.get("name", r) if isinstance(r, Mapping) else r
                          for r in st.get("reservedFor") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": self.kind,
            "apiVersion": "resource.k8s.io/v1beta1",
            "metadata": self.metadata.to_dict(),
            "spec": {"devices": {"requests": [
                {"name": r.name, "deviceClassName": r.device_class_name,
                 "count": r.count,
                 **({"selectors": [{"key": s.key, "op": s.op, "value": s.value}
                                   for s in r.selectors]} if r.selectors else {})}
                for r in self.requests]}},
        }
        status: Dict[str, Any] = {}
        if self.allocation is not None:
            status["allocation"] = {
                "nodeName": self.allocation.node_name,
                "devices": {k: list(v) for k, v in self.allocation.devices.items()},
            }
        if self.reserved_for:
            status["reservedFor"] = [{"name": n} for n in self.reserved_for]
        if status:
            out["status"] = status
        return out

