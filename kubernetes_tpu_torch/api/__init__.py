"""L0 — typed API object model (the kinds the scheduler and the workload
controllers read; the workload kinds are in api/workloads.py and their wire
forms in api/serialize.py)."""

from .dra import (  # noqa: F401
    AllocationResult,
    Device,
    DeviceAttributeRequirement,
    DeviceClass,
    DeviceRequest,
    ResourceClaim,
    ResourceSlice,
)

from .labels import (  # noqa: F401
    NodeSelector,
    NodeSelectorTerm,
    PreferredSchedulingTerm,
    Requirement,
    Selector,
)
from .resources import (  # noqa: F401
    Resource,
    compute_pod_resource_request,
    parse_quantity_milli,
    quantity_milli_value,
    quantity_value,
)
from .storage import (  # noqa: F401
    CSINode,
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    PersistentVolumeSpec,
    StorageClass,
)
from .types import (  # noqa: F401
    Affinity,
    Binding,
    Container,
    ContainerImage,
    ContainerPort,
    Namespace,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodCondition,
    PodSpec,
    PodStatus,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
    find_matching_untolerated_taint,
    new_uid,
)
