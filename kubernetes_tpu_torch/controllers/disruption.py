"""Disruption controller: maintains PodDisruptionBudget status.

The counterpart of `kubernetes_tpu/controllers/disruption.py`: the same behaviour,
names and store writes, held equal to it by the port's tests.

reference: pkg/controller/disruption/disruption.go — trySync computes
currentHealthy / desiredHealthy over the pods the PDB selects and writes
status.disruptionsAllowed = max(0, currentHealthy - desiredHealthy); the
scheduler's preemption engine consumes disruptionsAllowed when counting PDB
violations (preemption.go filterPodsWithPDBViolation).

minAvailable and maxUnavailable accept absolute ints or "N%" strings
(disruption.go getExpectedPodCount; percentages resolve against the expected
count, here the matched-pod count since we don't track controller scale).
"""

from __future__ import annotations

from typing import Optional

from ..api.policy import PodDisruptionBudget
from ..store import NotFoundError
from .base import Controller


def _resolve(value, total: int) -> int:
    """IntOrString: ints pass through, 'N%' rounds up for minAvailable-style
    semantics (intstr.GetScaledValueFromIntOrPercent roundUp=true)."""
    if isinstance(value, str) and value.endswith("%"):
        pct = int(value[:-1] or 0)
        return -(-pct * total // 100)
    return int(value)


class DisruptionController(Controller):
    watch_kinds = ("poddisruptionbudgets", "pods")

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        if kind == "poddisruptionbudgets":
            return obj.key
        # any pod event re-evaluates the PDBs of its namespace (the reference
        # maps pod -> PDBs via label matching; one namespace sweep is our scale)
        return f"ns|{obj.metadata.namespace}"

    def sync(self, key: str) -> None:
        if key.startswith("ns|"):
            ns = key[3:]
            pdbs, _ = self.store.list(
                "poddisruptionbudgets", lambda b: b.metadata.namespace == ns)
            for b in pdbs:
                self._sync_pdb(b.key)
            return
        self._sync_pdb(key)

    def _sync_pdb(self, key: str) -> None:
        try:
            pdb: PodDisruptionBudget = self.store.get("poddisruptionbudgets", key)
        except NotFoundError:
            return
        sel = pdb.selector
        pods, _ = self.store.list(
            "pods", lambda p: p.metadata.namespace == pdb.metadata.namespace
            and p.metadata.deletion_timestamp is None
            and (sel.matches(p.metadata.labels) if sel is not None else False))
        # healthy = bound, non-terminal (the reference requires Ready condition;
        # the hollow runtime marks bound pods Running)
        healthy = sum(1 for p in pods if p.spec.node_name and not p.is_terminal())
        total = len(pods)
        if pdb.min_available is not None:
            desired = _resolve(pdb.min_available, total)
        elif pdb.max_unavailable is not None:
            desired = total - _resolve(pdb.max_unavailable, total)
        else:
            desired = total
        allowed = max(0, healthy - desired)

        def mutate(b: PodDisruptionBudget) -> PodDisruptionBudget:
            b.disruptions_allowed = allowed
            return b

        try:
            if pdb.disruptions_allowed != allowed:
                self.store.guaranteed_update("poddisruptionbudgets", key, mutate)
        except NotFoundError:
            pass
