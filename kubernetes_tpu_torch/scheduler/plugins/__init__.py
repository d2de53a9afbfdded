"""The default scheduler plugins, run per pod on the host.

The counterpart of `kubernetes_tpu/scheduler/plugins/__init__.py`: the
default enabled set in the order of apis/config/v1/default_plugins.go:30-56,
without the four volume plugins (VolumeRestrictions, NodeVolumeLimits,
VolumeBinding, VolumeZone) and DynamicResources, which come with the
fallback classes (ROADMAP.md queue 1 item 2 (d)). A profile that enables one
of them raises (scheduler/config.py).
"""

from .default_preemption import DefaultPreemption  # noqa: F401
from .fit import BalancedAllocation, NodeResourcesFit  # noqa: F401
from .interpod_affinity import InterPodAffinity  # noqa: F401
from .node_plugins import (  # noqa: F401
    ImageLocality,
    NodeAffinity,
    NodeName,
    NodePorts,
    NodeUnschedulable,
    PrioritySort,
    SchedulingGates,
    TaintToleration,
)
from .topology_spread import PodTopologySpread  # noqa: F401

# registered in the reference, ported with the fallback classes
UNPORTED_PLUGINS = ("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding",
                    "VolumeZone", "DynamicResources")


def default_plugins():
    """Registry + default ordering (plugins/registry.go:64,
    default_plugins.go:30), the JAX package's list without UNPORTED_PLUGINS."""
    return [
        PrioritySort(),
        SchedulingGates(),
        NodeUnschedulable(),
        NodeName(),
        TaintToleration(),
        NodeAffinity(),
        NodePorts(),
        NodeResourcesFit(),
        PodTopologySpread(),
        InterPodAffinity(),
        BalancedAllocation(),
        ImageLocality(),
        DefaultPreemption(),
    ]
