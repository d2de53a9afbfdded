"""admissionregistration.k8s.io API objects.

reference: staging/src/k8s.io/api/admissionregistration/v1 —
ValidatingAdmissionPolicy(+Binding) carry expression-based policy evaluated
in-process (plugin/policy/validating/plugin.go); Mutating/Validating
WebhookConfiguration call out to HTTP admission webhooks
(plugin/webhook/mutating, plugin/webhook/validating). All four are live API
objects: creating one changes admission behavior on the next write, no
server restart.

The counterpart of `kubernetes_tpu/api/admissionregistration.py`: the same
names, defaults and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .types import ObjectMeta


def _rule_matches(rules: List[Dict], resource: str, operation: str) -> bool:
    """MatchConstraints / webhook rules: [{resources: [...], operations:
    [...]}] with "*" wildcards (admissionregistration/v1 types.go Rule)."""
    for r in rules or []:
        resources = r.get("resources") or ["*"]
        operations = r.get("operations") or ["*"]
        if ("*" in resources or resource in resources) and \
                ("*" in operations or operation in operations
                 or operation.capitalize() in operations
                 or operation.upper() in operations):
            return True
    return False


class ValidatingAdmissionPolicy:
    """spec.matchConstraints.resourceRules + spec.validations[].expression
    (+ message/reason), spec.failurePolicy Fail|Ignore. Expressions run on
    the restricted evaluator (server/celexpr.py) over `object`, `oldObject`,
    `request`."""

    kind = "ValidatingAdmissionPolicy"

    def __init__(self, metadata: Optional[ObjectMeta] = None,
                 resource_rules: Optional[List[Dict]] = None,
                 validations: Optional[List[Dict]] = None,
                 failure_policy: str = "Fail"):
        self.metadata = metadata or ObjectMeta()
        self.metadata.namespace = ""  # cluster-scoped
        self.resource_rules = resource_rules or []
        self.validations = validations or []
        self.failure_policy = failure_policy or "Fail"

    def matches(self, resource: str, operation: str) -> bool:
        return _rule_matches(self.resource_rules, resource, operation)

    @staticmethod
    def from_dict(d: Dict) -> "ValidatingAdmissionPolicy":
        spec = d.get("spec") or {}
        mc = spec.get("matchConstraints") or {}
        return ValidatingAdmissionPolicy(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            resource_rules=[dict(r) for r in mc.get("resourceRules") or []],
            validations=[dict(v) for v in spec.get("validations") or []],
            failure_policy=spec.get("failurePolicy", "Fail"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "spec": {
                "matchConstraints": {"resourceRules": self.resource_rules},
                "validations": self.validations,
                "failurePolicy": self.failure_policy,
            },
        }


class ValidatingAdmissionPolicyBinding:
    """spec.policyName + optional spec.matchResources.namespaceSelector
    (matchLabels subset) + spec.validationActions ([Deny] default). A policy
    without a binding is inert (plugin/policy/validating: definitions are
    matched through bindings)."""

    kind = "ValidatingAdmissionPolicyBinding"

    def __init__(self, metadata: Optional[ObjectMeta] = None,
                 policy_name: str = "",
                 namespace_match_labels: Optional[Dict[str, str]] = None,
                 validation_actions: Optional[List[str]] = None):
        self.metadata = metadata or ObjectMeta()
        self.metadata.namespace = ""  # cluster-scoped
        self.policy_name = policy_name
        self.namespace_match_labels = namespace_match_labels
        self.validation_actions = validation_actions or ["Deny"]

    @staticmethod
    def from_dict(d: Dict) -> "ValidatingAdmissionPolicyBinding":
        spec = d.get("spec") or {}
        mr = spec.get("matchResources") or {}
        ns_sel = (mr.get("namespaceSelector") or {}).get("matchLabels")
        return ValidatingAdmissionPolicyBinding(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            policy_name=spec.get("policyName", ""),
            namespace_match_labels=dict(ns_sel) if ns_sel else None,
            validation_actions=list(spec.get("validationActions") or ["Deny"]),
        )

    def to_dict(self) -> Dict[str, Any]:
        spec: Dict[str, Any] = {"policyName": self.policy_name,
                                "validationActions": self.validation_actions}
        if self.namespace_match_labels is not None:
            spec["matchResources"] = {"namespaceSelector": {
                "matchLabels": self.namespace_match_labels}}
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "spec": spec,
        }


class _WebhookConfiguration:
    """Shared shape: webhooks: [{name, clientConfig.url, rules,
    failurePolicy, timeoutSeconds}]."""

    kind = ""

    def __init__(self, metadata: Optional[ObjectMeta] = None,
                 webhooks: Optional[List[Dict]] = None):
        self.metadata = metadata or ObjectMeta()
        self.metadata.namespace = ""  # cluster-scoped
        self.webhooks = webhooks or []

    @classmethod
    def from_dict(cls, d: Dict):
        return cls(metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
                   webhooks=[dict(w) for w in d.get("webhooks") or []])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "webhooks": self.webhooks,
        }


class MutatingWebhookConfiguration(_WebhookConfiguration):
    kind = "MutatingWebhookConfiguration"


class ValidatingWebhookConfiguration(_WebhookConfiguration):
    kind = "ValidatingWebhookConfiguration"
