"""DaemonSet controller: one pod per eligible node.

The counterpart of `kubernetes_tpu/controllers/daemonset.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/daemon/daemon_controller.go (syncDaemonSet ->
podsShouldBeOnNode; eligibility = nodeSelector/affinity match + taints
tolerated). The reference creates pods with node affinity and lets the
scheduler bind them; here the controller sets spec.nodeName directly (the
pre-1.12 daemon behavior) — the placement decision is the same because
eligibility is evaluated with the scheduler's own helpers.
"""

from __future__ import annotations

from typing import Optional

from ..api import Pod, find_matching_untolerated_taint
from ..api.types import TAINT_NO_EXECUTE, TAINT_NO_SCHEDULE, Toleration
from ..api.workloads import DaemonSet
from ..scheduler.plugins.helpers import node_matches_node_selector_and_affinity
from ..store import AlreadyExistsError, NotFoundError
from .base import Controller

# tolerations every daemon pod gets (daemon_controller.go AddOrUpdateDaemonPodTolerations)
_AUTO_TOLERATIONS = (
    Toleration(key="node.kubernetes.io/not-ready", operator="Exists", effect=TAINT_NO_EXECUTE),
    Toleration(key="node.kubernetes.io/unreachable", operator="Exists", effect=TAINT_NO_EXECUTE),
    Toleration(key="node.kubernetes.io/unschedulable", operator="Exists", effect=TAINT_NO_SCHEDULE),
)


from .revision import REVISION_LABEL  # noqa: F401  (shared fingerprint home)


def revision_hash(ds: DaemonSet) -> str:
    from .revision import revision_name

    return revision_name(ds.metadata.name, ds.spec.template)


def ds_owner_ref(ds: DaemonSet) -> dict:
    return {"apiVersion": "apps/v1", "kind": "DaemonSet", "name": ds.metadata.name,
            "uid": ds.metadata.uid, "controller": True}


def _owned(pod: Pod, ds: DaemonSet) -> bool:
    return any(r.get("kind") == "DaemonSet" and r.get("uid") == ds.metadata.uid
               for r in pod.metadata.owner_references)


class DaemonSetController(Controller):
    watch_kinds = ("daemonsets", "pods", "nodes")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "daemonsets":
            return obj.key
        if kind == "nodes":
            return "*"  # node churn resyncs every DaemonSet
        for ref in obj.metadata.owner_references:
            if ref.get("kind") == "DaemonSet":
                return f"{obj.metadata.namespace}/{ref['name']}"
        return None

    def sync(self, key: str) -> None:
        if key == "*":
            sets, _ = self.store.list("daemonsets")
            for ds in sets:
                self.sync(ds.key)
            return
        try:
            ds: DaemonSet = self.store.get("daemonsets", key)
        except NotFoundError:
            self._delete_owned(key)
            return
        nodes, _ = self.store.list("nodes")
        # the probe pod is node-independent: build it once per sync
        probe = ds.spec.template.make_pod("probe", ds.metadata.namespace)
        tolerations = list(probe.spec.tolerations) + list(_AUTO_TOLERATIONS)
        eligible = {n.metadata.name for n in nodes
                    if self._should_run(probe, tolerations, n)}
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ds.metadata.namespace
            and _owned(p, ds))
        have = {}
        for p in pods:
            if p.is_terminal():
                try:
                    self.store.delete("pods", p.key)  # restart daemon pods
                except NotFoundError:
                    pass
                continue
            have.setdefault(p.spec.node_name, p)
        rev = revision_hash(ds)
        for node_name in eligible - set(have):
            self._create_pod(ds, node_name, rev)
        misscheduled = 0
        for node_name, pod in have.items():
            if node_name not in eligible:
                misscheduled += 1
                try:
                    self.store.delete("pods", pod.key)
                except NotFoundError:
                    pass

        # rolling update (daemon/update.go rollingUpdate): delete up to
        # maxUnavailable stale-revision pods per sync. Unavailable counts
        # every ELIGIBLE node without a Running pod — including nodes whose
        # replacement was just created (absent from the pre-sync `have`) —
        # or the budget would double-spend across syncs.
        if ds.spec.update_strategy == "RollingUpdate":
            on_node = {n: p for n, p in have.items() if n in eligible}
            stale = [p for p in on_node.values()
                     if p.metadata.labels.get(REVISION_LABEL) != rev]
            # already-down stale pods are deleted WITHOUT charging the budget
            # (daemon/update.go deletes unavailable old pods first): a pod
            # stuck Pending/CrashLoop on the old template must not stall the
            # very rollout that would fix it
            stale_down = [p for p in stale if p.status.phase != "Running"]
            stale_up = [p for p in stale if p.status.phase == "Running"]
            for p in stale_down:
                try:
                    self.store.delete("pods", p.key)
                except NotFoundError:
                    pass
            unavailable = sum(
                1 for n in eligible
                if n not in have or have[n].status.phase != "Running")
            budget = max(0, ds.spec.max_unavailable - unavailable)
            for p in sorted(stale_up, key=lambda p: p.spec.node_name)[:budget]:
                try:
                    self.store.delete("pods", p.key)
                except NotFoundError:
                    pass
        ready = sum(1 for n, p in have.items()
                    if n in eligible and p.status.phase == "Running")
        updated = sum(1 for n, p in have.items()
                      if n in eligible
                      and p.metadata.labels.get(REVISION_LABEL) == rev)

        def mutate(obj: DaemonSet) -> DaemonSet:
            obj.status.desired_number_scheduled = len(eligible)
            obj.status.current_number_scheduled = len(eligible & set(have))
            obj.status.number_ready = ready
            obj.status.number_misscheduled = misscheduled
            obj.status.updated_number_scheduled = updated
            obj.status.observed_generation = obj.metadata.generation
            return obj

        try:
            self.store.guaranteed_update("daemonsets", key, mutate)
        except NotFoundError:
            pass

    @staticmethod
    def _should_run(probe: Pod, tolerations, node) -> bool:
        """nodeShouldRunDaemonPod: selector/affinity + tolerated taints."""
        if not node_matches_node_selector_and_affinity(probe, node):
            return False
        return find_matching_untolerated_taint(node.spec.taints, tolerations) is None

    def _create_pod(self, ds: DaemonSet, node_name: str, rev: str) -> None:
        name = f"{ds.metadata.name}-{node_name}"
        pod = ds.spec.template.make_pod(name, ds.metadata.namespace, ds_owner_ref(ds))
        pod.metadata.labels[REVISION_LABEL] = rev
        pod.spec.tolerations.extend(_AUTO_TOLERATIONS)
        pod.spec.node_name = node_name
        try:
            self.store.create("pods", pod)
        except AlreadyExistsError:
            pass

    def _delete_owned(self, key: str) -> None:
        ns, name = key.split("/", 1)
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == ns and any(
                r.get("kind") == "DaemonSet" and r.get("name") == name
                for r in p.metadata.owner_references))
        for p in pods:
            try:
                self.store.delete("pods", p.key)
            except NotFoundError:
                pass
