"""flowcontrol.apiserver.k8s.io API objects.

reference: staging/src/k8s.io/api/flowcontrol/v1 — PriorityLevelConfiguration
and FlowSchema are API objects the apiserver watches; edits reconfigure
dispatch live (server/flowcontrol.py FlowConfigSource consumes these).

The counterpart of `kubernetes_tpu/api/flowcontrolapi.py`: the same names,
defaults and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations


class PriorityLevelConfiguration:
    """Wire form subset: spec.type Exempt|Limited, spec.limited.seats,
    queueLength, queueTimeoutSeconds (the queuing knobs collapsed to the
    one-FIFO model documented above)."""

    kind = "PriorityLevelConfiguration"

    def __init__(self, metadata=None, type: str = "Limited", seats: int = 10,
                 queue_length: int = 50, queue_timeout: float = 5.0):
        from ..api.types import ObjectMeta

        self.metadata = metadata or ObjectMeta()
        self.metadata.namespace = ""  # cluster-scoped
        self.type = type
        self.seats = seats
        self.queue_length = queue_length
        self.queue_timeout = queue_timeout

    @staticmethod
    def from_dict(d):
        from ..api.types import ObjectMeta

        spec = d.get("spec") or {}
        limited = spec.get("limited") or {}

        def val(key, default):
            # explicit zeros are meaningful (queueLength 0 = reject
            # immediately) — only ABSENT fields take defaults
            v = limited.get(key)
            return default if v is None else v

        return PriorityLevelConfiguration(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            type=spec.get("type", "Limited"),
            seats=int(val("seats", 10)),
            queue_length=int(val("queueLength", 50)),
            queue_timeout=float(val("queueTimeoutSeconds", 5.0)),
        )

    def to_dict(self):
        spec = {"type": self.type}
        if self.type == "Limited":
            spec["limited"] = {"seats": self.seats,
                               "queueLength": self.queue_length,
                               "queueTimeoutSeconds": self.queue_timeout}
        return {"apiVersion": "flowcontrol.apiserver.k8s.io/v1",
                "kind": "PriorityLevelConfiguration",
                "metadata": self.metadata.to_dict(), "spec": spec}

    def to_level(self):
        from ..server.flowcontrol import PriorityLevel

        return PriorityLevel(self.metadata.name, seats=self.seats,
                             queue_length=self.queue_length,
                             queue_timeout=self.queue_timeout,
                             exempt=self.type == "Exempt")


class FlowSchemaConfiguration:
    """FlowSchema as an API object: matchingPrecedence orders schemas, the
    subject/rule lists collapse to the FlowSchema matcher's tuples."""

    kind = "FlowSchema"

    def __init__(self, metadata=None, priority_level: str = "global-default",
                 matching_precedence: int = 1000, users=("*",), groups=("*",),
                 verbs=("*",), resources=("*",)):
        from ..api.types import ObjectMeta

        self.metadata = metadata or ObjectMeta()
        self.metadata.namespace = ""  # cluster-scoped
        self.priority_level = priority_level
        self.matching_precedence = matching_precedence
        self.users = tuple(users)
        self.groups = tuple(groups)
        self.verbs = tuple(verbs)
        self.resources = tuple(resources)

    @staticmethod
    def from_dict(d):
        from ..api.types import ObjectMeta

        spec = d.get("spec") or {}
        def sel(key):
            # explicit [] means "match nothing", not wildcard
            v = spec.get(key)
            return ("*",) if v is None else tuple(v)

        return FlowSchemaConfiguration(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            priority_level=(spec.get("priorityLevelConfiguration") or {}).get(
                "name", "global-default"),
            matching_precedence=int(spec.get("matchingPrecedence", 1000) or 1000),
            users=sel("users"),
            groups=sel("groups"),
            verbs=sel("verbs"),
            resources=sel("resources"),
        )

    def to_dict(self):
        return {"apiVersion": "flowcontrol.apiserver.k8s.io/v1",
                "kind": "FlowSchema",
                "metadata": self.metadata.to_dict(),
                "spec": {
                    "priorityLevelConfiguration": {"name": self.priority_level},
                    "matchingPrecedence": self.matching_precedence,
                    "users": list(self.users),
                    "groups": list(self.groups),
                    "verbs": list(self.verbs),
                    "resources": list(self.resources),
                }}

    def to_schema(self):
        from ..server.flowcontrol import FlowSchema

        return FlowSchema(self.metadata.name, self.priority_level,
                          users=self.users, groups=self.groups,
                          verbs=self.verbs, resources=self.resources)


