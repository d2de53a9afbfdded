"""Node lifecycle + taint eviction — the failure-detection loop.

The counterpart of `kubernetes_tpu/controllers/node_lifecycle.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go:262-289
(NotReady after nodeMonitorGracePeriod, NoExecute taints) and
pkg/controller/tainteviction (evict pods that don't tolerate NoExecute taints).

Health signal: each node agent renews a coordination Lease named after the node
(kubelet's Lease heartbeat). A lease older than the grace period marks the node
NotReady and taints it; recovery clears both. The eviction half deletes pods on
NoExecute-tainted nodes (honoring tolerations + tolerationSeconds is left to
tolerationSeconds=0 semantics this round: tolerating pods stay indefinitely).
"""

from __future__ import annotations

from typing import Optional

from ..api import Node, Taint
from ..api.types import NodeCondition, TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE
from ..store import NotFoundError
from .base import Controller

NOT_READY_TAINT = "node.kubernetes.io/not-ready"
DEFAULT_GRACE_PERIOD = 40.0  # nodeMonitorGracePeriod default


class NodeLifecycleController(Controller):
    watch_kinds = ("nodes", "leases")

    def __init__(self, store, clock=None, grace_period: float = DEFAULT_GRACE_PERIOD):
        super().__init__(store, clock)
        self.grace_period = grace_period

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        # leases are named after their node, so both kinds key by object name
        return obj.metadata.name

    def monitor(self) -> None:
        """Periodic health sweep (the controller's 5s monitor loop)."""
        nodes, _ = self.store.list("nodes")
        for n in nodes:
            self._mark(n.metadata.name)
        self.process()

    def sync(self, name: str) -> None:
        try:
            node: Node = self.store.get("nodes", name)
        except NotFoundError:
            return
        ready = self._node_healthy(name)
        # match by (key, effect): the TaintNodesByCondition admission plugin
        # seeds new nodes with a NoSchedule not-ready taint, which must not
        # suppress this controller's NoExecute escalation for unhealthy nodes
        has_noexec = any(t.key == NOT_READY_TAINT and t.effect == TAINT_NO_EXECUTE
                         for t in node.spec.taints)
        has_nosched = any(t.key == NOT_READY_TAINT and t.effect == TAINT_NO_SCHEDULE
                          for t in node.spec.taints)
        has_any = any(t.key == NOT_READY_TAINT for t in node.spec.taints)
        if ready and has_any:
            def clear(obj: Node) -> Node:
                obj.spec.taints = [t for t in obj.spec.taints if t.key != NOT_READY_TAINT]
                self._set_ready_condition(obj, True)
                return obj

            self.store.guaranteed_update("nodes", name, clear)
        elif not ready and not (has_noexec and has_nosched):
            def taint(obj: Node) -> Node:
                # BOTH effects, like the reference controller: NoExecute
                # drives the eviction chain, while NoSchedule keeps the
                # scheduler off the dead node — without it, replacements
                # that tolerate not-ready:NoExecute (the admission-defaulted
                # 300s toleration) would land right back on the corpse and
                # churn through eviction again (the node-death chain)
                effects = {t.effect for t in obj.spec.taints
                           if t.key == NOT_READY_TAINT}
                for eff in (TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE):
                    if eff not in effects:
                        obj.spec.taints.append(
                            Taint(key=NOT_READY_TAINT, effect=eff))
                self._set_ready_condition(obj, False)
                return obj

            self.store.guaranteed_update("nodes", name, taint)
        if not ready:
            self._evict(name)

    def _node_healthy(self, name: str) -> bool:
        try:
            lease = self.store.get("leases", f"kube-node-lease/{name}")
        except NotFoundError:
            return False  # no heartbeat ever observed
        return (self.clock.now() - lease.renew_time) <= self.grace_period

    def _set_ready_condition(self, node: Node, ready: bool) -> None:
        node.status.conditions = [c for c in node.status.conditions if c.type != "Ready"]
        node.status.conditions.append(NodeCondition(
            type="Ready",
            status="True" if ready else "False",
            reason="KubeletReady" if ready else "NodeStatusUnknown",
            last_transition_time=self.clock.now(),
        ))

    # -- taint eviction (pkg/controller/tainteviction) -------------------------

    def _evict(self, node_name: str) -> None:
        pods, _ = self.store.list("pods", lambda p: p.spec.node_name == node_name)
        for p in pods:
            tolerates = any(
                t.tolerates(Taint(key=NOT_READY_TAINT, effect=TAINT_NO_EXECUTE))
                for t in p.spec.tolerations
            )
            if not tolerates:
                try:
                    self.store.delete("pods", p.key)
                except NotFoundError:
                    pass
