"""Feature gates: named on/off switches.

reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go and
the gate catalog in pkg/features/kube_features.go. The counterpart of
`kubernetes_tpu/utils/featuregate.py`, holding only the gates the port
reads: SchedulerQueueingHints (scheduler/serial.py _move_for_event),
SchedulerAsyncPreemption (plugins/default_preemption.py) and
DynamicResourceAllocation (plugins/__init__.py default_plugins, which adds
DynamicResources behind it). A gate joins the catalog with the code that
reads it. Components read a gate with
`FeatureGates.enabled(name)` and set it with `FeatureGates.set(name, value)`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Mapping

BETA = "BETA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    stage: str


class FeatureGates:
    """Thread-safe gate registry (featuregate.go featureGate)."""

    def __init__(self, specs: Mapping[str, FeatureSpec]):
        self._lock = threading.Lock()
        self._specs: Dict[str, FeatureSpec] = dict(specs)
        self._overrides: Dict[str, bool] = {}

    def _spec(self, name: str) -> FeatureSpec:
        spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"unknown feature gate {name!r}")
        return spec

    def enabled(self, name: str) -> bool:
        with self._lock:
            return self._overrides.get(name, self._spec(name).default)

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            self._spec(name)
            self._overrides[name] = value


# The gates the port reads (scheduler gates: plugins/registry.go:45-60).
DEFAULT_FEATURE_GATES = {
    "SchedulerQueueingHints": FeatureSpec(True, BETA),
    "SchedulerAsyncPreemption": FeatureSpec(True, BETA),
    "DynamicResourceAllocation": FeatureSpec(False, BETA),
}


def default_feature_gates() -> FeatureGates:
    return FeatureGates(DEFAULT_FEATURE_GATES)


# process-wide default instance (pkg/features DefaultFeatureGate)
feature_gates = default_feature_gates()
