"""Admission extensibility: ValidatingAdmissionPolicy + HTTP webhooks.

Two mechanisms, matching the reference's admission plugin split:

- `PolicyAdmission` (apiserver/pkg/admission/plugin/policy/validating/
  plugin.go): ValidatingAdmissionPolicy(+Binding) objects read LIVE from the
  store; expressions run on the restricted evaluator (celexpr.py) over
  `object` / `request`. In-process and allocation-free, so it runs inside
  the normal admission chain (under the store transaction) like every
  compiled-in plugin.

- `WebhookAdmission` (apiserver/pkg/admission/plugin/webhook/{mutating,
  validating}): Mutating/ValidatingWebhookConfiguration objects call out
  over HTTP with an AdmissionReview payload. Webhook round-trips MUST NOT
  run under the store transaction (a slow webhook would stall every store
  consumer; a webhook that calls back into this API server would deadlock
  until timeout), so the REST handlers run this phase BEFORE entering the
  transaction; mutating patches are re-applied to the authoritative object
  inside (rest.py). With zero webhook configurations the phase is two dict
  lookups — the common path stays free.

Self-referential loop guard: the four admissionregistration resources are
never sent to webhooks (the reference excludes webhook configuration
objects the same way).

The counterpart of `kubernetes_tpu/server/admissionpolicy.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from ..store import APIStore
from .admission import AdmissionError, AdmissionPlugin
from .celexpr import ExpressionError, compile_expression

_SELF_RESOURCES = {
    "validatingadmissionpolicies", "validatingadmissionpolicybindings",
    "mutatingwebhookconfigurations", "validatingwebhookconfigurations",
}

_REASON_CODES = {"Invalid": 422, "Forbidden": 403, "Unauthorized": 401,
                 "RequestEntityTooLarge": 413}


def _ns_labels(store: APIStore, namespace: str) -> Dict[str, str]:
    if not namespace:
        return {}
    try:
        ns = store.get("namespaces", namespace)
    except KeyError:
        return {}
    except Exception:
        return {}
    return dict(ns.metadata.labels or {})


class PolicyAdmission(AdmissionPlugin):
    """Evaluates live ValidatingAdmissionPolicy objects bound by
    ValidatingAdmissionPolicyBinding. A policy with no binding is inert;
    a binding's namespaceSelector scopes it; validationActions without
    "Deny" degrade to warnings (per-thread `last_warnings`, never
    rejecting). On UPDATE, `oldObject` is the live stored object (fetched
    under the same transaction, so it is exactly the pre-write state)."""

    name = "ValidatingAdmissionPolicy"

    def __init__(self):
        import threading

        # expression -> compiled evaluator; keyed by source so policy
        # updates (new expression strings) compile fresh
        self._cache: Dict[str, Any] = {}
        self._tl = threading.local()

    @property
    def last_warnings(self) -> List[str]:
        return getattr(self._tl, "warnings", [])

    def _compiled(self, src: str):
        fn = self._cache.get(src)
        if fn is None:
            fn = compile_expression(src)
            if len(self._cache) > 1024:
                self._cache.clear()
            self._cache[src] = fn
        return fn

    @staticmethod
    def _old_object(store: APIStore, resource: str, obj):
        from ..api.serialize import CLUSTER_SCOPED, to_dict

        ns = getattr(obj.metadata, "namespace", "")
        key = obj.metadata.name if (resource in CLUSTER_SCOPED or not ns) \
            else f"{ns}/{obj.metadata.name}"
        try:
            return to_dict(store.get(resource, key))
        except Exception:
            return None

    def validate(self, store: APIStore, resource: str, operation: str, obj,
                 user: str = "") -> None:
        self._tl.warnings = []
        if resource in _SELF_RESOURCES:
            return
        try:
            policies, _ = store.list("validatingadmissionpolicies")
        except Exception:
            return
        if not policies:
            return
        bindings, _ = store.list("validatingadmissionpolicybindings")
        by_policy: Dict[str, List] = {}
        for b in bindings:
            by_policy.setdefault(b.policy_name, []).append(b)
        from ..api.serialize import to_dict

        wire = None
        old = None
        for pol in policies:
            bound = by_policy.get(pol.metadata.name)
            if not bound or not pol.matches(resource, operation):
                continue
            ns = getattr(obj.metadata, "namespace", "")
            active = []
            for b in bound:
                if b.namespace_match_labels is not None:
                    labels = _ns_labels(store, ns)
                    if any(labels.get(k) != v
                           for k, v in b.namespace_match_labels.items()):
                        continue
                active.append(b)
            if not active:
                continue
            if wire is None:
                wire = to_dict(obj)
                if operation == "UPDATE":
                    old = self._old_object(store, resource, obj)
            variables = {
                "object": wire,
                "oldObject": old,
                "request": {"operation": operation, "resource": resource,
                            "userInfo": {"username": user}},
            }
            for v in pol.validations:
                expr = v.get("expression", "")
                try:
                    ok = self._compiled(expr)(variables)
                except ExpressionError as e:
                    if pol.failure_policy == "Ignore":
                        continue
                    raise AdmissionError(
                        f"policy {pol.metadata.name}: expression error: {e}",
                        code=500, reason="InternalError")
                if ok:
                    continue
                message = v.get("message") or \
                    f"failed expression: {expr}"
                msg = f"ValidatingAdmissionPolicy {pol.metadata.name!r} " \
                      f"denied request: {message}"
                deny = any("Deny" in b.validation_actions for b in active)
                if not deny:
                    self.last_warnings.append(msg)
                    continue
                reason = v.get("reason", "Invalid")
                raise AdmissionError(msg,
                                     code=_REASON_CODES.get(reason, 422),
                                     reason=reason)


def apply_json_patch(doc: Dict, patch: List[Dict]) -> Dict:
    """Minimal RFC-6902: add / replace / remove over object keys and list
    indices ("-" appends). The reference's mutating webhooks respond with
    exactly this patch type."""
    doc = json.loads(json.dumps(doc))
    for op in patch:
        kind = op.get("op")
        path = op.get("path", "")
        if not path.startswith("/"):
            raise ValueError(f"bad patch path {path!r}")
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in path[1:].split("/")]
        parent: Any = doc
        for p in parts[:-1]:
            parent = parent[int(p)] if isinstance(parent, list) else parent[p]
        last = parts[-1]
        if kind == "add":
            if isinstance(parent, list):
                if last == "-":
                    parent.append(op["value"])
                else:
                    parent.insert(int(last), op["value"])
            else:
                parent[last] = op["value"]
        elif kind == "replace":
            if isinstance(parent, list):
                parent[int(last)] = op["value"]
            else:
                if last not in parent:
                    raise ValueError(f"replace at missing path {path!r}")
                parent[last] = op["value"]
        elif kind == "remove":
            if isinstance(parent, list):
                del parent[int(last)]
            else:
                if last not in parent:
                    raise ValueError(f"remove at missing path {path!r}")
                del parent[last]
        else:
            raise ValueError(f"unsupported patch op {kind!r}")
    return doc


class WebhookAdmission:
    """Calls mutating then validating webhooks with AdmissionReview over
    HTTP. Runs OUTSIDE store transactions (see module docstring). Returns
    the accumulated mutating JSONPatches so PATCH-style handlers can
    re-apply them to the authoritative merged object inside the
    transaction."""

    def __init__(self, store: APIStore, timeout_cap: float = 10.0):
        self.store = store
        self.timeout_cap = timeout_cap

    def _configs(self):
        try:
            mut, _ = self.store.list("mutatingwebhookconfigurations")
            val, _ = self.store.list("validatingwebhookconfigurations")
        except Exception:
            return [], []
        return mut, val

    def active(self) -> bool:
        """Cheap pre-check so PATCH-style handlers skip the pre-read merge
        entirely when no webhook is configured (the common case)."""
        mut, val = self._configs()
        return bool(mut or val)

    def _call(self, hook: Dict, review: Dict) -> Dict:
        url = (hook.get("clientConfig") or {}).get("url", "")
        if not url:
            raise urllib.error.URLError("webhook has no clientConfig.url")
        timeout = min(float(hook.get("timeoutSeconds") or 10.0),
                      self.timeout_cap)
        req = urllib.request.Request(
            url, data=json.dumps(review).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def run(self, resource: str, operation: str, wire: Dict,
            user: str = "") -> Tuple[Dict, List[List[Dict]]]:
        """-> (possibly-mutated wire dict, list of applied JSONPatches).
        Raises AdmissionError on denial or Fail-policy errors."""
        if resource in _SELF_RESOURCES:
            return wire, []
        from ..api.admissionregistration import _rule_matches

        mut, val = self._configs()
        if not mut and not val:
            return wire, []
        applied: List[List[Dict]] = []

        def review_for(obj_wire: Dict) -> Dict:
            return {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": (obj_wire.get("metadata") or {}).get("uid", ""),
                    "resource": {"resource": resource},
                    "operation": operation.capitalize(),
                    "name": (obj_wire.get("metadata") or {}).get("name", ""),
                    "namespace": (obj_wire.get("metadata") or {}).get(
                        "namespace", ""),
                    "object": obj_wire,
                    "userInfo": {"username": user},
                },
            }

        def each(configs, mutating: bool):
            nonlocal wire
            for cfg in configs:
                for hook in cfg.webhooks:
                    if not _rule_matches(hook.get("rules") or [],
                                         resource, operation):
                        continue
                    fail_open = (hook.get("failurePolicy") or "Fail") \
                        == "Ignore"
                    try:
                        out = self._call(hook, review_for(wire))
                    except Exception as e:
                        if fail_open:
                            continue
                        raise AdmissionError(
                            f"failed calling webhook "
                            f"{hook.get('name', '?')!r}: {e}",
                            code=500, reason="InternalError")
                    resp = out.get("response") or {}
                    if not resp.get("allowed", False):
                        status = resp.get("status") or {}
                        code = int(status.get("code", 403) or 403)
                        if not 400 <= code <= 599:
                            # a denial must be an error on the wire — the
                            # reference clamps webhook codes the same way
                            code = 403
                        raise AdmissionError(
                            f"admission webhook {hook.get('name', '?')!r} "
                            f"denied the request: "
                            f"{status.get('message', 'denied')}",
                            code=code,
                            reason=status.get("reason", "Forbidden"))
                    if mutating and resp.get("patch"):
                        try:
                            patch = json.loads(
                                base64.b64decode(resp["patch"]))
                            wire = apply_json_patch(wire, patch)
                            applied.append(patch)
                        except Exception as e:
                            if fail_open:
                                continue
                            raise AdmissionError(
                                f"webhook {hook.get('name', '?')!r} "
                                f"returned a bad patch: {e}",
                                code=500, reason="InternalError")

        each(mut, mutating=True)
        each(val, mutating=False)
        return wire, applied
