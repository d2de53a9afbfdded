"""apiregistration.k8s.io APIService — the aggregation layer's routing
record.

reference: kube-aggregator (cmd/kube-apiserver delegation chain
apiextensions→core→aggregator, server.go:173 CreateServerChain;
staging/src/k8s.io/kube-aggregator). An APIService claims one API group:
requests under /apis/{group}/... that no built-in or CRD serves are
reverse-proxied to the extension apiserver named in spec.service (here a
plain URL — the reference resolves a Service to endpoints; this build's
Services have no real network backend, so the URL is explicit).
Local=true entries (no service) mark groups served by this server itself.

The counterpart of `kubernetes_tpu/api/apiservice.py`: the same names,
defaults and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping

from .types import ObjectMeta


@dataclass
class APIService:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    group: str = ""
    version: str = "v1"
    # extension server base URL (e.g. http://127.0.0.1:9443); empty = Local
    service_url: str = ""
    group_priority_minimum: int = 1000
    # status condition Available (set by the availability checker)
    available: bool = False
    available_message: str = ""

    kind = "APIService"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped
        if not self.metadata.name and self.group:
            self.metadata.name = f"{self.version}.{self.group}"

    @property
    def local(self) -> bool:
        return not self.service_url

    @staticmethod
    def from_dict(d: Mapping) -> "APIService":
        meta = ObjectMeta.from_dict(d.get("metadata") or {})
        meta.namespace = ""
        spec = d.get("spec") or {}
        st = d.get("status") or {}
        conds = {c.get("type"): c for c in st.get("conditions") or []}
        avail = conds.get("Available") or {}
        return APIService(
            metadata=meta,
            group=spec.get("group", ""),
            version=spec.get("version", "v1"),
            service_url=(spec.get("service") or {}).get("url", ""),
            group_priority_minimum=int(
                spec.get("groupPriorityMinimum", 1000) or 1000),
            available=avail.get("status") == "True",
            available_message=avail.get("message", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        meta = self.metadata.to_dict()
        meta.pop("namespace", None)
        spec: Dict[str, Any] = {
            "group": self.group,
            "version": self.version,
            "groupPriorityMinimum": self.group_priority_minimum,
        }
        if self.service_url:
            spec["service"] = {"url": self.service_url}
        return {
            "apiVersion": "apiregistration.k8s.io/v1",
            "kind": self.kind,
            "metadata": meta,
            "spec": spec,
            "status": {"conditions": [{
                "type": "Available",
                "status": "True" if self.available else "False",
                **({"message": self.available_message}
                   if self.available_message else {}),
            }]},
        }
