"""Horizontal pod autoscaler controller.

reference: pkg/controller/podautoscaler/horizontal.go — desiredReplicas =
ceil(currentReplicas * currentUtilization / targetUtilization), clamped to
[minReplicas, maxReplicas], with a scale-down stabilization window. Metrics
come from an injected usage function (the metrics-server boundary): by default
pod CPU usage is read from the `metrics.k8s.io/cpu-usage` annotation (millis),
which the hollow kubelet can stamp.

The counterpart of `kubernetes_tpu/controllers/podautoscaler.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from ..api import Pod
from ..api.policy import HorizontalPodAutoscaler
from ..api.resources import quantity_milli_value
from ..store import NotFoundError
from .base import Controller

USAGE_ANNOTATION = "metrics.k8s.io/cpu-usage"
TOLERANCE = 0.1  # horizontal.go defaultTolerance

TARGET_RESOURCE = {"Deployment": "deployments", "ReplicaSet": "replicasets",
                   "StatefulSet": "statefulsets"}


def annotation_usage(pod: Pod) -> Optional[int]:
    raw = pod.metadata.annotations.get(USAGE_ANNOTATION)
    return quantity_milli_value(raw) if raw is not None else None


class HorizontalPodAutoscalerController(Controller):
    watch_kinds = ("horizontalpodautoscalers",)

    def __init__(self, store, clock=None,
                 usage_fn: Callable[[Pod], Optional[int]] = annotation_usage,
                 downscale_stabilization: float = 300.0):
        super().__init__(store, clock)
        self.usage_fn = usage_fn
        self.downscale_stabilization = downscale_stabilization

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return obj.key

    def resync(self) -> None:
        """Periodic metric sweep (the reference reconciles every 15s)."""
        hpas, _ = self.store.list("horizontalpodautoscalers")
        for h in hpas:
            self._mark(h.key)
        self.process()

    def sync(self, key: str) -> None:
        try:
            hpa: HorizontalPodAutoscaler = self.store.get(
                "horizontalpodautoscalers", key)
        except NotFoundError:
            return
        resource = TARGET_RESOURCE.get(hpa.target_kind)
        if resource is None:
            return
        target_key = f"{hpa.metadata.namespace}/{hpa.target_name}"
        try:
            target = self.store.get(resource, target_key)
        except NotFoundError:
            return
        selector = target.spec.selector
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == hpa.metadata.namespace
            and not p.is_terminal()
            and (selector.matches(p.metadata.labels) if selector is not None
                 else all(p.metadata.labels.get(k) == v
                          for k, v in target.spec.template.metadata.labels.items())))
        current = target.spec.replicas
        desired = self._desired_replicas(hpa, pods, current)
        if desired != current:
            if desired < current:
                # scale-down stabilization (horizontal.go stabilizeRecommendation)
                last = hpa.last_scale_time or 0.0
                if self.clock.now() - last < self.downscale_stabilization:
                    desired = current
            if desired != current:
                def scale(obj):
                    obj.spec.replicas = desired
                    return obj

                try:
                    self.store.guaranteed_update(resource, target_key, scale)
                except NotFoundError:
                    return

        def mutate(obj: HorizontalPodAutoscaler) -> HorizontalPodAutoscaler:
            obj.current_replicas = current
            obj.desired_replicas = desired
            if desired != current:
                obj.last_scale_time = self.clock.now()
            return obj

        try:
            self.store.guaranteed_update("horizontalpodautoscalers", key, mutate)
        except NotFoundError:
            pass

    def _desired_replicas(self, hpa: HorizontalPodAutoscaler, pods, current: int) -> int:
        usages, requests = [], []
        for p in pods:
            u = self.usage_fn(p)
            if u is None:
                continue
            req = sum(quantity_milli_value(
                (c.resources.get("requests") or {}).get("cpu", 0))
                for c in p.spec.containers)
            if req <= 0:
                continue
            usages.append(u)
            requests.append(req)
        if not usages:
            return max(hpa.min_replicas, min(current, hpa.max_replicas))
        utilization = sum(usages) / sum(requests)  # fraction of requested
        target = hpa.target_cpu_utilization / 100.0
        ratio = utilization / target
        if abs(ratio - 1.0) <= TOLERANCE:
            desired = current
        else:
            desired = math.ceil(len(usages) * ratio)
        return max(hpa.min_replicas, min(desired, hpa.max_replicas))
