"""ResourceQuota controller: recompute per-namespace usage into quota status.

reference: pkg/controller/resourcequota/resource_quota_controller.go (usage
recalculation; the enforcement half lives in apiserver admission). Tracked
resources: requests.cpu/memory, cpu/memory aliases, pods count, and
count/<resource> object counts.

The counterpart of `kubernetes_tpu/controllers/resourcequota.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api.policy import ResourceQuota
from ..api.resources import quantity_milli_value, quantity_value
from ..store import NotFoundError
from .base import Controller


def pod_request_totals(pods) -> Dict[str, int]:
    """Sum of container requests over non-terminal pods; cpu in millis,
    memory in bytes (quota usage math)."""
    cpu_m = 0
    mem = 0
    for p in pods:
        if p.is_terminal():
            continue
        for c in list(p.spec.containers) + list(p.spec.init_containers):
            req = (c.resources or {}).get("requests") or {}
            cpu_m += quantity_milli_value(req.get("cpu", 0))
            mem += quantity_value(req.get("memory", 0))
    return {"cpu_milli": cpu_m, "memory": mem}


class ResourceQuotaController(Controller):
    watch_kinds = ("resourcequotas", "pods", "persistentvolumeclaims",
                   "services", "replicasets")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "resourcequotas":
            return obj.key
        ns = getattr(obj.metadata, "namespace", "")
        return f"{ns}/*" if ns else None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        if name == "*":
            quotas, _ = self.store.list(
                "resourcequotas", lambda q: q.metadata.namespace == ns)
            for q in quotas:
                self._recalculate(q)
            return
        try:
            quota: ResourceQuota = self.store.get("resourcequotas", key)
        except NotFoundError:
            return
        self._recalculate(quota)

    def _recalculate(self, quota: ResourceQuota) -> None:
        ns = quota.metadata.namespace
        used: Dict[str, object] = {}
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ns and not p.is_terminal())
        totals = pod_request_totals(pods)
        for key in quota.hard:
            if key in ("requests.cpu", "cpu"):
                used[key] = f"{totals['cpu_milli']}m"
            elif key in ("requests.memory", "memory"):
                used[key] = str(totals["memory"])
            elif key == "pods":
                used[key] = str(len(pods))
            elif key.startswith("count/"):
                resource = key.split("/", 1)[1]
                objs, _ = self.store.list(
                    resource, lambda o: getattr(o.metadata, "namespace", "") == ns)
                used[key] = str(len(objs))

        def mutate(obj: ResourceQuota) -> ResourceQuota:
            obj.used = used
            return obj

        try:
            self.store.guaranteed_update("resourcequotas", quota.key, mutate)
        except NotFoundError:
            pass
