"""The default scheduler plugins, run per pod on the host.

The counterpart of `kubernetes_tpu/scheduler/plugins/__init__.py`: the
default enabled set in the order of apis/config/v1/default_plugins.go:30-56,
the four volume plugins sharing one VolumeLister, and DynamicResources
behind the DynamicResourceAllocation gate.
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
from .volume import (  # noqa: F401
    NodeVolumeLimits,
    VolumeBinding,
    VolumeLister,
    VolumeRestrictions,
    VolumeZone,
)


def default_plugins(volume_lister=None):
    """Registry + default ordering (plugins/registry.go:64,
    default_plugins.go:30). DynamicResources joins the set behind its feature
    gate at index 8, as in the reference's registry (plugins/registry.go:45-60)."""
    from ...utils.featuregate import feature_gates

    vl = volume_lister if volume_lister is not None else VolumeLister()
    plugins = [
        PrioritySort(),
        SchedulingGates(),
        NodeUnschedulable(),
        NodeName(),
        TaintToleration(),
        NodeAffinity(),
        NodePorts(),
        NodeResourcesFit(),
        VolumeRestrictions(vl),
        NodeVolumeLimits(vl),
        VolumeBinding(vl),
        VolumeZone(vl),
        PodTopologySpread(),
        InterPodAffinity(),
        BalancedAllocation(),
        ImageLocality(),
        DefaultPreemption(),
    ]
    if feature_gates.enabled("DynamicResourceAllocation"):
        from .dynamic_resources import DynamicResources

        plugins.insert(8, DynamicResources())
    return plugins
