"""Scheduler ComponentConfig: versioned KubeSchedulerConfiguration with
defaulting, validation, and profile -> Framework construction.

reference: pkg/scheduler/apis/config/types.go (KubeSchedulerConfiguration :37,
Parallelism :49, PercentageOfNodesToScore :70, PodInitialBackoffSeconds :75,
KubeSchedulerProfile :100, Plugins :138) and v1 defaults
(apis/config/v1/default_plugins.go:30). Parses the same YAML/JSON shape a
`kubescheduler.config.k8s.io/v1` file has, so existing config files work.

The counterpart of `kubernetes_tpu/scheduler/config.py`. Extenders are not
ported yet (ROADMAP.md queue 1 item 6): a configuration that lists one raises
in from_dict. The volume plugins of every profile share the VolumeLister
passed as `volume_lister` (a fresh one when None).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Set, Tuple

from ..api.types import DEFAULT_SCHEDULER_NAME
from .runtime import DEFAULT_WEIGHTS, Framework
from .serial import NOT_PORTED

# Extension points as named in config files (types.go Plugins struct fields).
EXTENSION_POINTS = (
    "preEnqueue", "queueSort", "preFilter", "filter", "postFilter",
    "preScore", "score", "reserve", "permit", "preBind", "bind", "postBind",
)

# config point name -> plugin method the runtime dispatches on
_POINT_TO_METHOD = {
    "preEnqueue": "pre_enqueue",
    "queueSort": "less",
    "preFilter": "pre_filter",
    "filter": "filter",
    "postFilter": "post_filter",
    "preScore": "pre_score",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "preBind": "pre_bind",
    "bind": "bind",
    "postBind": "post_bind",
}


@dataclass
class PluginSet:
    """One extension point's enabled/disabled lists (types.go PluginSet)."""

    enabled: List[Tuple[str, int]] = field(default_factory=list)  # (name, weight)
    disabled: List[str] = field(default_factory=list)  # names or "*"

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> "PluginSet":
        d = d or {}
        return PluginSet(
            enabled=[(e["name"], int(e.get("weight", 0) or 0))
                     for e in d.get("enabled") or []],
            disabled=[e["name"] if isinstance(e, Mapping) else e
                      for e in d.get("disabled") or []],
        )


@dataclass
class KubeSchedulerProfile:
    """types.go KubeSchedulerProfile :100."""

    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    percentage_of_nodes_to_score: Optional[int] = None
    plugins: Dict[str, PluginSet] = field(default_factory=dict)  # point -> set
    plugin_config: Dict[str, Dict] = field(default_factory=dict)  # plugin -> args

    @staticmethod
    def from_dict(d: Mapping) -> "KubeSchedulerProfile":
        return KubeSchedulerProfile(
            scheduler_name=d.get("schedulerName", DEFAULT_SCHEDULER_NAME),
            percentage_of_nodes_to_score=d.get("percentageOfNodesToScore"),
            plugins={point: PluginSet.from_dict((d.get("plugins") or {}).get(point))
                     for point in EXTENSION_POINTS
                     if point in (d.get("plugins") or {})},
            plugin_config={e["name"]: dict(e.get("args") or {})
                           for e in d.get("pluginConfig") or []},
        )


@dataclass
class KubeSchedulerConfiguration:
    """types.go KubeSchedulerConfiguration :37 (the scheduler-relevant subset)."""

    parallelism: int = 16
    percentage_of_nodes_to_score: int = 0  # 0 = adaptive (schedule_one.go:675)
    pod_initial_backoff_seconds: float = 1.0  # scheduler.go:252
    pod_max_backoff_seconds: float = 10.0  # scheduler.go:253
    profiles: List[KubeSchedulerProfile] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> "KubeSchedulerConfiguration":
        d = d or {}
        if d.get("extenders"):
            raise NotImplementedError("scheduler extenders are " + NOT_PORTED.format(6))

        def opt(key, default, cast):
            v = d.get(key)
            return default if v is None else cast(v)

        cfg = KubeSchedulerConfiguration(
            parallelism=opt("parallelism", 16, int),
            percentage_of_nodes_to_score=opt("percentageOfNodesToScore", 0, int),
            pod_initial_backoff_seconds=opt("podInitialBackoffSeconds", 1.0, float),
            pod_max_backoff_seconds=opt("podMaxBackoffSeconds", 10.0, float),
            profiles=[KubeSchedulerProfile.from_dict(p) for p in d.get("profiles") or []],
        )
        if not cfg.profiles:
            cfg.profiles = [KubeSchedulerProfile()]
        return cfg

    def validate(self) -> None:
        """apis/config/validation/validation.go ValidateKubeSchedulerConfiguration."""
        errs = []
        if self.parallelism <= 0:
            errs.append("parallelism must be greater than 0")
        if not 0 <= self.percentage_of_nodes_to_score <= 100:
            errs.append("percentageOfNodesToScore must be in [0, 100]")
        if self.pod_initial_backoff_seconds <= 0:
            errs.append("podInitialBackoffSeconds must be greater than 0")
        if self.pod_max_backoff_seconds < self.pod_initial_backoff_seconds:
            errs.append("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
        seen = set()
        for prof in self.profiles:
            if not prof.scheduler_name:
                errs.append("profile schedulerName is required")
            if prof.scheduler_name in seen:
                errs.append(f"duplicate profile schedulerName {prof.scheduler_name!r}")
            seen.add(prof.scheduler_name)
            unknown = set(prof.plugins) - set(EXTENSION_POINTS)
            if unknown:
                errs.append(f"unknown extension points {sorted(unknown)}")
            for point, ps in prof.plugins.items():
                for name, weight in ps.enabled:
                    if name != "*" and name not in plugin_registry():
                        errs.append(f"unknown plugin {name!r} at {point}")
                    if weight < 0:
                        errs.append(f"negative weight for {name!r}")
        if errs:
            raise ValueError("; ".join(errs))


def plugin_registry(volume_lister=None) -> Dict[str, object]:
    """Name -> constructed plugin instance (plugins/registry.go:64)."""
    from .plugins import (
        BalancedAllocation,
        DefaultPreemption,
        ImageLocality,
        InterPodAffinity,
        NodeAffinity,
        NodeName,
        NodePorts,
        NodeResourcesFit,
        NodeUnschedulable,
        NodeVolumeLimits,
        PodTopologySpread,
        PrioritySort,
        SchedulingGates,
        TaintToleration,
        VolumeBinding,
        VolumeLister,
        VolumeRestrictions,
        VolumeZone,
    )

    vl = volume_lister if volume_lister is not None else VolumeLister()
    return {
        "PrioritySort": PrioritySort(),
        "SchedulingGates": SchedulingGates(),
        "NodeUnschedulable": NodeUnschedulable(),
        "NodeName": NodeName(),
        "TaintToleration": TaintToleration(),
        "NodeAffinity": NodeAffinity(),
        "NodePorts": NodePorts(),
        "NodeResourcesFit": NodeResourcesFit(),
        "VolumeRestrictions": VolumeRestrictions(vl),
        "NodeVolumeLimits": NodeVolumeLimits(vl),
        "VolumeBinding": VolumeBinding(vl),
        "VolumeZone": VolumeZone(vl),
        "PodTopologySpread": PodTopologySpread(),
        "InterPodAffinity": InterPodAffinity(),
        "NodeResourcesBalancedAllocation": BalancedAllocation(),
        "ImageLocality": ImageLocality(),
        "DefaultPreemption": DefaultPreemption(),
    }


# Default plugin order (default_plugins.go:30); weights in runtime.DEFAULT_WEIGHTS.
DEFAULT_PLUGIN_ORDER = (
    "PrioritySort", "SchedulingGates", "NodeUnschedulable", "NodeName",
    "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
    "PodTopologySpread", "InterPodAffinity", "NodeResourcesBalancedAllocation",
    "ImageLocality", "DefaultPreemption",
)


def build_framework(profile: KubeSchedulerProfile, volume_lister=None) -> Framework:
    """Default plugins +- the profile's per-point enabled/disabled deltas
    (v1/default_plugins.go mergePlugins semantics, name-keyed)."""
    registry = plugin_registry(volume_lister)
    order = list(DEFAULT_PLUGIN_ORDER)
    weights = dict(DEFAULT_WEIGHTS)
    disabled_points: Set[Tuple[str, str]] = set()
    for point, ps in profile.plugins.items():
        method = _POINT_TO_METHOD[point]
        if "*" in ps.disabled:
            for name in order:
                if hasattr(registry[name], method):
                    disabled_points.add((name, method))
        else:
            for name in ps.disabled:
                disabled_points.add((name, method))
        for name, weight in ps.enabled:
            disabled_points.discard((name, method))
            if name not in order:
                order.append(name)
            if point == "score" and weight:
                weights[name] = weight
    plugins = [registry[n] for n in order if n in registry]
    fw = Framework(plugins, weights=weights, disabled_points=disabled_points)
    fw.profile_name = profile.scheduler_name
    fw.percentage_of_nodes_to_score = profile.percentage_of_nodes_to_score
    return fw


def build_profiles(config: KubeSchedulerConfiguration,
                   volume_lister=None) -> Tuple[Dict[str, Framework], List]:
    """profile.NewMap (profile/profile.go). Returns (profiles, extenders),
    as the JAX package does; the extender list is always empty, since a
    configuration that lists an extender raises in from_dict."""
    config.validate()
    profiles = {p.scheduler_name: build_framework(p, volume_lister)
                for p in config.profiles}
    return profiles, []
