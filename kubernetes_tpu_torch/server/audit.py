"""Audit logging — who did what, recorded in the handler chain.

reference: staging/src/k8s.io/apiserver/pkg/audit (+ apis/audit/v1): the
handler chain runs authn -> AUDIT -> authz -> admission; a Policy maps each
request to a level (None/Metadata/Request/RequestResponse) and matching
events are written as JSON lines to a sink. The subset carried here: policy
rules matched in order on user/group/verb/resource, Metadata-level events
(identity + action + outcome; request bodies are not captured), a file sink
plus a bounded in-memory ring for tests and the /auditz debug surface.

The counterpart of `kubernetes_tpu/server/audit.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"


@dataclass
class AuditRule:
    """First matching rule decides the level (audit/v1 Policy.rules)."""

    level: str = LEVEL_METADATA
    users: Tuple[str, ...] = ("*",)
    groups: Tuple[str, ...] = ("*",)
    verbs: Tuple[str, ...] = ("*",)
    resources: Tuple[str, ...] = ("*",)

    def matches(self, user, verb: str, resource: str) -> bool:
        """Specified criteria AND together (audit/v1 policy semantics: a rule
        matches only when every non-empty/non-wildcard field matches);
        empty or wildcard fields are unconstrained."""
        if "*" not in self.verbs and verb not in self.verbs:
            return False
        if "*" not in self.resources and resource not in self.resources:
            return False
        checks = []
        if self.users and "*" not in self.users:
            checks.append(user is not None and user.name in self.users)
        if self.groups and "*" not in self.groups:
            checks.append(user is not None
                          and any(g in self.groups for g in user.groups))
        return all(checks)


class AuditPolicy:
    def __init__(self, rules: Sequence[AuditRule] = (),
                 default_level: str = LEVEL_METADATA):
        self.rules = list(rules)
        self.default_level = default_level

    def level_for(self, user, verb: str, resource: str) -> str:
        for r in self.rules:
            if r.matches(user, verb, resource):
                return r.level
        return self.default_level


def default_audit_policy() -> AuditPolicy:
    """The pragmatic default: drop high-volume read-only noise from system
    components (the reference ships a similar recommended policy), audit
    everything else at Metadata."""
    return AuditPolicy(rules=[
        AuditRule(level=LEVEL_NONE, users=(), groups=("system:nodes",),
                  verbs=("get", "list", "watch")),
        AuditRule(level=LEVEL_NONE, verbs=("get", "list", "watch"),
                  resources=("events", "leases", "podlogs"), users=("*",),
                  groups=("*",)),
    ])


class AuditLogger:
    """Metadata-level sink: JSON line per event to an optional file, always
    into a bounded ring (newest last)."""

    def __init__(self, policy: Optional[AuditPolicy] = None,
                 path: Optional[str] = None, ring_size: int = 1000):
        self.policy = policy or default_audit_policy()
        self.path = path
        self.ring_size = ring_size
        self.ring: List[Dict] = []
        self._lock = threading.Lock()
        self._fh = open(path, "a") if path else None

    def log(self, user, verb: str, resource: str, namespace: str,
            name: str, code: int) -> None:
        if self.policy.level_for(user, verb, resource) == LEVEL_NONE:
            return
        ev = {
            "ts": time.time(),
            "level": LEVEL_METADATA,
            "user": getattr(user, "name", "system:anonymous"),
            "groups": list(getattr(user, "groups", ()) or ()),
            "verb": verb,
            "resource": resource,
            "namespace": namespace,
            "name": name,
            "code": code,
        }
        with self._lock:
            self.ring.append(ev)
            if len(self.ring) > self.ring_size:
                del self.ring[:len(self.ring) - self.ring_size]
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(ev) + "\n")
                    self._fh.flush()
                except Exception:
                    pass  # audit must never fail the request

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self.ring)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
