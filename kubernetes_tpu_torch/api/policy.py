"""policy/v1 PodDisruptionBudget.

The counterpart of the PodDisruptionBudget of `kubernetes_tpu/api/policy.py`
(reference: staging/src/k8s.io/api/policy/v1/types.go): the selector and
`disruptions_allowed` that preemption reads (scheduler/gangpreempt.py
pdb_blocked_mask) and that the disruption controller maintains
(controllers/disruption.py). The quota, limit-range, priority-class,
service-account and autoscaler types come with ROADMAP.md queue 1 item 7j.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

from .labels import Selector
from .types import ObjectMeta


@dataclass
class PodDisruptionBudget:
    """Bounds voluntary evictions (consumed by preemption)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[Selector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    disruptions_allowed: int = 0

    kind = "PodDisruptionBudget"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PodDisruptionBudget":
        sp = d.get("spec") or {}
        return PodDisruptionBudget(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            selector=Selector.from_label_selector(sp.get("selector")),
            min_available=sp.get("minAvailable"),
            max_unavailable=sp.get("maxUnavailable"),
            disruptions_allowed=int((d.get("status") or {}).get("disruptionsAllowed", 0) or 0),
        )

    def to_dict(self) -> Dict[str, Any]:
        sp: Dict[str, Any] = {}
        if self.min_available is not None:
            sp["minAvailable"] = self.min_available
        if self.max_unavailable is not None:
            sp["maxUnavailable"] = self.max_unavailable
        return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                "metadata": self.metadata.to_dict(), "spec": sp,
                "status": {"disruptionsAllowed": self.disruptions_allowed}}
