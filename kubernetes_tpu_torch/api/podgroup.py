"""Gang-scheduling API surface: the PodGroup object and its label convention.

The counterpart of `kubernetes_tpu/api/podgroup.py`. A multi-host training
job is a set of ranks that must start together (all-or-nothing) or the
half-placed job deadlocks holding capacity. The shape is the coscheduling
ecosystem's (sigs.k8s.io/scheduler-plugins apis/scheduling/v1alpha1
PodGroup: minMember plus a pod label naming the group):

  - a PodGroup object (kind "podgroups" in the store) with spec.min_member:
    the quorum of members that must be placeable in one solve for ANY member
    to bind;
  - pods join a group by carrying POD_GROUP_LABEL, whose value names the
    PodGroup in the pod's own namespace (groups never span namespaces);
  - nodes advertise their TPU slice (interconnect domain) via
    LABEL_TPU_SLICE and, optionally, their ring position via
    LABEL_TPU_SLICE_INDEX; the gang packing score and the rank alignment
    read them.

The scheduler's gang directory (scheduler/gang.py) is the consumer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping

from .types import POD_GROUP_RANK_LABEL, ObjectMeta  # noqa: F401 (re-export)

# Pods opt into a gang with this label; the value names a PodGroup in the
# pod's namespace.
POD_GROUP_LABEL = "pod-group.scheduling/name"

# Node label carrying the TPU slice (interconnect domain) of the node. Nodes
# of one slice share the fast interconnect; the gang packing score prefers
# placing a whole gang inside one slice.
LABEL_TPU_SLICE = "tpu.scheduling/slice"

# Optional node label: the node's position on its slice's ring (an integer).
# Nodes without it fall back to their enumeration order within the slice.
LABEL_TPU_SLICE_INDEX = "tpu.scheduling/slice-index"


@dataclass
class PodGroupSpec:
    # quorum: the minimum number of members that must be schedulable together
    # before any member binds (an all-or-nothing floor, not a replica target)
    min_member: int = 1

    @staticmethod
    def from_dict(d: Mapping) -> "PodGroupSpec":
        return PodGroupSpec(min_member=int(d.get("minMember", 1) or 1))


@dataclass
class PodGroupStatus:
    phase: str = "Pending"  # Pending | Scheduled (best-effort, controller-set)
    scheduled: int = 0  # members observed bound

    @staticmethod
    def from_dict(d: Mapping) -> "PodGroupStatus":
        return PodGroupStatus(phase=d.get("phase", "Pending"),
                              scheduled=int(d.get("scheduled", 0) or 0))


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    kind = "PodGroup"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PodGroup":
        return PodGroup(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=PodGroupSpec.from_dict(d.get("spec") or {}),
            status=PodGroupStatus.from_dict(d.get("status") or {}),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "apiVersion": "scheduling.x-k8s.io/v1alpha1",
            "kind": "PodGroup",
            "metadata": self.metadata.to_dict(),
            "spec": {"minMember": self.spec.min_member},
        }
        if self.status.phase != "Pending" or self.status.scheduled:
            out["status"] = {"phase": self.status.phase,
                             "scheduled": self.status.scheduled}
        return out


def pod_gang_rank(pod) -> int:
    """The pod's gang rank (POD_GROUP_RANK_LABEL parsed as int), or -1 when
    absent or unparseable; rank-less members align by arrival order."""
    v = pod.metadata.labels.get(POD_GROUP_RANK_LABEL)
    if not v:
        return -1
    try:
        return int(v)
    except ValueError:
        return -1


def pod_group_key(pod) -> str:
    """Group key ("namespace/name") of a labeled pod, "" for a pod that is
    not a gang member."""
    name = pod.metadata.labels.get(POD_GROUP_LABEL)
    if not name:
        return ""
    return f"{pod.metadata.namespace}/{name}"
