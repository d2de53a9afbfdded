"""HTTP REST front-end over the APIStore — the apiserver surface (L2).

reference: staging/src/k8s.io/apiserver/pkg/endpoints/handlers/{get,create,
update,delete,watch}.go and handlers/watch.go:187 WatchServer. Paths follow the
kubernetes URL scheme:

  GET/POST        /api/v1/namespaces/{ns}/pods[?watch=true&resourceVersion=N]
  GET/PUT/DELETE  /api/v1/namespaces/{ns}/pods/{name}
  POST            /api/v1/namespaces/{ns}/pods/{name}/binding   (BindingREST)
  GET/POST        /api/v1/nodes ... (cluster-scoped)
  GET             /healthz /readyz /metrics

Watches stream newline-delimited JSON events over a chunked response, exactly
the client-go wire shape: {"type": "ADDED", "object": {...}}.

The counterpart of `kubernetes_tpu/server/rest.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api.serialize import (
    CLUSTER_SCOPED,
    RESOURCE_TO_TYPE,
    from_dict,
    to_dict,
)
from ..store import (
    AlreadyBoundError,
    AlreadyExistsError,
    APIStore,
    ConflictError,
    NotFoundError,
    ResourceVersionTooOldError,
)


def _parse_path(path: str) -> Optional[Tuple[str, Optional[str], Optional[str], Optional[str]]]:
    """-> (resource, namespace, name, subresource) or None."""
    parts = [p for p in path.split("/") if p]
    # /api/v1/... or /apis/{group}/{version}/...
    if not parts or parts[0] not in ("api", "apis"):
        return None
    parts = parts[2:] if parts[0] == "api" else parts[3:]
    if not parts:
        return None
    if parts[0] == "namespaces" and len(parts) >= 3:
        ns, resource = parts[1], parts[2]
        name = parts[3] if len(parts) > 3 else None
        sub = parts[4] if len(parts) > 4 else None
        return resource, ns, name, sub
    if parts[0] == "namespaces" and len(parts) == 2:
        return "namespaces", None, parts[1], None
    resource = parts[0]
    name = parts[1] if len(parts) > 1 else None
    sub = parts[2] if len(parts) > 2 else None
    return resource, None, name, sub


_FIELD_READERS = {
    "metadata.name": lambda o: o.metadata.name,
    "metadata.namespace": lambda o: getattr(o.metadata, "namespace", ""),
    "spec.nodeName": lambda o: getattr(getattr(o, "spec", None), "node_name", ""),
    "spec.schedulerName": lambda o: getattr(
        getattr(o, "spec", None), "scheduler_name", ""),
    "status.phase": lambda o: getattr(getattr(o, "status", None), "phase", ""),
}


def parse_field_selector(raw: str):
    """`spec.nodeName=n1,status.phase!=Failed` -> predicate(obj) or None.
    The subset the reference serves from etcd/cacher for pods and nodes
    (apiserver fields.Selector); `==` is accepted as an alias of `=`.
    Raises ValueError for unsupported field paths (the apiserver's
    'field label not supported' 400, not a silently-empty result)."""
    if not raw:
        return None
    clauses = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            key, _, want = part.partition("!=")
            neg = True
        else:
            key, _, want = part.partition("=")
            if want.startswith("="):  # the k8s `==` alias
                want = want[1:]
            neg = False
        key = key.strip()
        if key not in _FIELD_READERS:
            raise ValueError(f"field label not supported: {key!r}")
        clauses.append((key, want.strip(), neg))

    def pred(obj):
        for key, want, neg in clauses:
            if (_FIELD_READERS[key](obj) == want) == neg:
                return False
        return True

    return pred


def json_merge_patch(target, patch):
    """RFC 7386 JSON Merge Patch: dicts merge recursively, null deletes,
    everything else replaces (the subset of strategic-merge the build's types
    need — k8s list-merge keys degrade to whole-list replace, which is also
    what strategic merge does for lists without a patchMergeKey)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = json_merge_patch(out.get(k), v)
    return out


def _builtin_groups():
    """API groups this server serves natively (from the registered
    prefixes) — never proxied to an extension apiserver."""
    from ..api.serialize import GROUP_PREFIX

    groups = set()
    for prefix in GROUP_PREFIX.values():
        parts = [p for p in prefix.split("/") if p]
        if parts and parts[0] == "apis" and len(parts) >= 2:
            groups.add(parts[1])
    return groups


_BUILTIN_GROUPS = None


def _IDENTITY_VIEW(d):
    """Shared identity view: its object identity marks a watch event as
    safely cacheable across watchers (no redaction applied)."""
    return d


class _PatchParseError(Exception):
    """Carries a buffered (code, msg, reason) verdict out of the PATCH
    transaction block."""

    def __init__(self, verdict):
        super().__init__(verdict[1])
        self.verdict = verdict


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubernetes-tpu-apiserver"

    # quiet by default
    def log_message(self, fmt, *args):
        if self.server.verbose:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    @property
    def store(self) -> APIStore:
        return self.server.store  # type: ignore[attr-defined]

    # ---- dynamic (CRD-served) resources --------------------------------------

    def _crd(self, resource: str):
        """CustomResourceDefinition serving `resource`, or None. Static types
        win: a CRD cannot shadow a built-in (the reference's aggregation
        layer has the same precedence)."""
        if resource in RESOURCE_TO_TYPE:
            return None
        reg = getattr(self.server, "crds", None)
        return reg.resolve(resource) if reg is not None else None

    def _known(self, resource: str, crd) -> bool:
        return resource in RESOURCE_TO_TYPE or crd is not None

    def _cluster_scoped(self, resource: str, crd=None) -> bool:
        if resource in RESOURCE_TO_TYPE:
            return resource in CLUSTER_SCOPED
        return crd is not None and crd.scope == "Cluster"

    def _try_aggregate(self) -> bool:
        """The aggregation layer (kube-aggregator; delegation chain
        apiextensions -> core -> aggregator, server.go:173): a request
        under /apis/{group}/... whose group no built-in or CRD serves, but
        an Available APIService claims, is reverse-proxied WHOLESALE to
        the extension apiserver. The authenticated identity forwards as
        X-Remote-User (the reference's front-proxy request headers).
        Returns True when the request was handled here."""
        global _BUILTIN_GROUPS
        import urllib.error
        import urllib.request as _ur

        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if len(parts) < 3 or parts[0] != "apis":
            return False
        group = parts[1]
        if _BUILTIN_GROUPS is None:
            _BUILTIN_GROUPS = _builtin_groups()
        if group in _BUILTIN_GROUPS or group in (
                "apiregistration.k8s.io", "authorization.k8s.io",
                "authentication.k8s.io", "admission.k8s.io"):
            return False
        parsed = _parse_path(url.path)
        reg = getattr(self.server, "crds", None)
        if reg is not None and parsed is not None:
            crd = reg.resolve(parsed[0])
            # apiextensions precedes aggregation — for the CRD's OWN group
            # only (a same-named plural in another group must still proxy)
            if crd is not None and crd.group == group:
                return False
        try:
            svcs, _ = self.store.list(
                "apiservices", lambda s: s.group == group and not s.local)
        except Exception:
            return False
        if not svcs:
            return False
        # the request's version segment picks its APIService; ties and
        # unversioned requests fall to the highest groupPriorityMinimum
        version = parts[2] if len(parts) > 2 else ""
        matching = [s for s in svcs if s.version == version] or svcs
        svc = sorted(matching, key=lambda s: -s.group_priority_minimum)[0]
        # aggregated requests pass the SAME authn/authz gate as local ones
        # — the proxy must never launder a request past RBAC
        verb, authz_resource = self._request_attrs(parsed)
        user = self._authenticated_user(
            verb, authz_resource or f"{group}/*")
        if user is None:
            return True  # 401/403 already sent
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else None
        if not svc.available:
            # body already drained: keep-alive connections stay in sync
            self._error(503, f"APIService {svc.metadata.name} is not "
                        f"available: {svc.available_message or 'unknown'}",
                        "ServiceUnavailable")
            return True
        target = svc.service_url.rstrip("/") + url.path + (
            f"?{url.query}" if url.query else "")
        headers = {"Content-Type": self.headers.get("Content-Type",
                                                    "application/json")}
        headers["X-Remote-User"] = user.name
        if user.groups:
            headers["X-Remote-Group"] = ",".join(user.groups)
        req = _ur.Request(target, data=body, method=self.command,
                          headers=headers)
        is_watch = "watch=true" in (url.query or "")
        try:
            resp = _ur.urlopen(req, timeout=3600 if is_watch else 30)
        except urllib.error.HTTPError as e:
            payload = e.read()
            self._audit_record(e.code)
            self.send_response(e.code)
            self.send_header("Content-Type", e.headers.get(
                "Content-Type", "application/json"))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return True
        except (urllib.error.URLError, OSError) as e:
            self._error(502, f"error trying to reach APIService "
                        f"{svc.metadata.name}: {e}", "BadGateway")
            return True
        with resp:
            ctype = resp.headers.get("Content-Type", "application/json")
            self._audit_record(resp.status)
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            if is_watch:
                # stream the backend's watch through without buffering
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    while True:
                        # read1: forward whatever is available NOW —
                        # read(n) on a chunked response blocks until n
                        # bytes or EOF, which would buffer a watch stream
                        chunk = resp.read1(65536)
                        if not chunk:
                            break
                        self.wfile.write(
                            f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                return True
            payload = resp.read()
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)
        return True

    def _parse_obj(self, resource: str, body, crd):
        """-> (obj, None) or (None, (code, msg, reason)). Dynamic objects get
        structural-schema defaulting + pruning + validation here — the same
        write path the reference's apiextensions handler runs."""
        from ..api.crd import Unstructured, validate_custom_object

        if not isinstance(body, dict):
            return None, (400, f"body must be a JSON object, got "
                          f"{type(body).__name__}", "BadRequest")
        if crd is not None:
            obj, errs = validate_custom_object(crd, Unstructured.from_dict(body))
            if errs:
                return None, (422, "; ".join(errs), "Invalid")
            return obj, None
        try:
            obj = from_dict(resource, body)
        except Exception as e:
            return None, (400, f"cannot parse {resource}: {e}", "BadRequest")
        if resource == "customresourcedefinitions":
            err = obj.validate()
            if err is not None:
                return None, (422, err, "Invalid")
            # a CRD may not shadow a built-in resource (static check; the
            # cross-CRD plural conflict is checked under the store lock at
            # write time — see _crd_conflict)
            if obj.names.plural in RESOURCE_TO_TYPE:
                return None, (422, f"spec.names.plural {obj.names.plural!r} "
                              "shadows a built-in resource", "Invalid")
        return obj, None

    def _crd_conflict(self, obj):
        """Plurals are a single flat route namespace: a second group claiming
        an existing plural conflicts instead of silently stealing the route
        and the store bucket. Reads the store directly (re-entrant under the
        caller's transaction) so concurrent CRD writes serialize — never the
        DynamicRegistry, whose lock ranks ABOVE the store lock."""
        existing, _rv = self.store.list("customresourcedefinitions")
        for other in existing:
            if (other.names.plural == obj.names.plural
                    and other.metadata.name != obj.metadata.name):
                return (409, f"plural {obj.names.plural!r} already served by "
                        f"{other.metadata.name}", "Conflict")
            if other.metadata.name == obj.metadata.name and \
                    other.scope != obj.scope:
                # scope switches the store key scheme (ns/name vs name) and
                # would orphan existing objects; the reference makes it
                # immutable outright
                return (422, "spec.scope is immutable", "Invalid")
        return None

    def _crd_still_served(self, crd):
        """Inside a CR write transaction: the CRD resolved before the lock may
        have been deleted concurrently (its delete cascades CR removal under
        the same lock) — a write against a stale CRD would orphan the object."""
        try:
            self.store.get("customresourcedefinitions", crd.metadata.name)
            return None
        except NotFoundError:
            return (404, f"unknown resource {crd.names.plural} "
                    "(CRD deleted)", "NotFound")

    def _self_subject_access_review(self) -> None:
        """POST selfsubjectaccessreviews: "can I, the caller, do X?"
        (authorization/v1 SelfSubjectAccessReview; kubectl auth can-i).
        Evaluated against the live authorizer; an open server answers yes."""
        user = self._user()
        if user is None:
            self._error(401, "Unauthorized: invalid or missing bearer token",
                        "Unauthorized")
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return
        attrs = ((body.get("spec") or {}).get("resourceAttributes") or {})
        verb = attrs.get("verb", "")
        resource = attrs.get("resource", "")
        authz = getattr(self.server, "authorizer", None)
        allowed = True if authz is None else authz.authorize(user, verb, resource)
        self._send_json(201, {
            "kind": "SelfSubjectAccessReview",
            "apiVersion": "authorization.k8s.io/v1",
            "spec": {"resourceAttributes": {"verb": verb, "resource": resource}},
            "status": {"allowed": allowed},
        })

    # ---- API priority & fairness (apiserver/pkg/util/flowcontrol) ------------

    _FC_VERBS = {"GET": "get", "POST": "create", "PUT": "update",
                 "PATCH": "patch", "DELETE": "delete"}
    _FC_EXEMPT_PATHS = ("/healthz", "/readyz", "/metrics", "/version",
                        "/configz", "/debug/schedstats", "/debug/schedtrace",
                        "/debug/controlstats", "/debug/timeseries",
                        "/debug/trace", "/debug/critpath")

    def _flow_dispatch(self, orig: "Callable[[], None]") -> None:
        """Seat-accounted dispatch. Health/metrics always pass (the probe
        endpoints must answer exactly when the server is overloaded); watches
        are long-running and bypass seats (longRunningRequestCheck)."""
        fc = getattr(self.server, "flowcontrol", None)
        url = urlparse(self.path)
        if fc is None or url.path in self._FC_EXEMPT_PATHS:
            orig()
            return
        parsed = _parse_path(url.path)
        q = parse_qs(url.query)
        # long-running bypass ONLY for what the GET handler actually treats
        # as a watch (collection GET + watch=true) — `?watch=true` glued onto
        # writes or named GETs must not dodge the seats
        if (self.command == "GET" and parsed is not None and parsed[2] is None
                and q.get("watch", ["false"])[0] == "true"):
            orig()
            return
        # derive the SAME verb/resource vocabulary the handlers/authz use,
        # so FlowSchemas written against 'list'/'bind' actually match
        verb, resource = self._request_attrs(parsed)
        level = fc.classify(self._user(), verb, resource)
        if not level.acquire():
            # drain the request body first: on a keep-alive connection the
            # unread bytes would be parsed as the next request line
            length = int(self.headers.get("Content-Length", 0) or 0)
            if length:
                self.rfile.read(length)
            self._audit_record(429, verb=verb)  # overload IS audit-worthy
            body = json.dumps({
                "kind": "Status", "status": "Failure", "code": 429,
                "reason": "TooManyRequests",
                "message": f"too many requests for priority level "
                           f"{level.name!r}, please try again later",
            }).encode()
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", "1")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            orig()
        finally:
            level.release()

    # ---- authn/authz (DefaultBuildHandlerChain order: authn -> authz) --------

    def _user(self):
        """Resolve request identity. With an authenticator configured, only
        bearer tokens count and X-Remote-User is ignored (it is forgeable
        unless a trusted proxy sets it). Without one, the header is honored —
        the open in-process mode tests and local daemons use.

        Memoized per credential headers: flow control resolves the user
        before the handler does, and HMAC verification must not run twice
        per request."""
        from .auth import ANONYMOUS, UserInfo

        key = (self.headers.get("Authorization", ""),
               self.headers.get("X-Remote-User", ""),
               self.headers.get("X-Remote-Group", ""))
        memo = getattr(self, "_user_memo", None)
        if memo is not None and memo[0] == key:
            return memo[1]
        authn = getattr(self.server, "authenticator", None)
        if authn is not None:
            user = authn.authenticate(key[0])
        elif key[1]:
            groups = tuple(g for g in key[2].split(",") if g)
            user = UserInfo(name=key[1], groups=groups)
        else:
            user = ANONYMOUS
        self._user_memo = (key, user)
        return user

    def _authenticated_user(self, verb: str, resource: str):
        """Runs authn then authz; sends the error response and returns None on
        either failure. Health/metrics endpoints bypass (always_allow_paths)."""
        user = self._user()
        if user is None:
            self._error(401, "Unauthorized: invalid or missing bearer token",
                        "Unauthorized")
            return None
        authz = getattr(self.server, "authorizer", None)
        if authz is not None and not authz.authorize(user, verb, resource):
            self._error(403, f"user {user.name!r} cannot {verb} {resource}",
                        "Forbidden")
            return None
        return user

    def _send_json(self, code: int, payload) -> None:
        # audit BEFORE the bytes go out: a client that acts on the response
        # must already find the event recorded (and the in-memory append
        # cannot fail the request)
        self._audit_record(code)
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _request_attrs(self, parsed) -> Tuple[str, str]:
        """-> (verb, authz-resource): the ONE derivation authz, audit, and
        flow control all share. Subresources that grant something the parent
        does not (binding -> bind verb; token -> the serviceaccounts/token
        resource, since minting a credential is a bigger power than creating
        SA objects) are distinguished here."""
        verb = self._FC_VERBS.get(self.command, "get")
        if parsed is None:
            return verb, ""
        resource, _ns, name, sub = parsed
        # CRD aliases canonicalize to the plural here too — audit rules and
        # FlowSchemas match the same name authz sees, however the URL spells it
        crd = self._crd(resource)
        if crd is not None:
            resource = crd.names.plural
        if self.command == "GET" and name is None:
            q = parse_qs(urlparse(self.path).query)
            verb = ("watch" if q.get("watch", ["false"])[0] == "true"
                    else "list")
        elif self.command == "POST" and sub == "binding" and resource == "pods":
            verb = "bind"
        elif self.command == "POST" and sub == "token" \
                and resource == "serviceaccounts":
            resource = "serviceaccounts/token"
        elif self.command == "POST" and sub == "eviction" and resource == "pods":
            resource = "pods/eviction"
        elif self.command == "POST" and resource == "pods" \
                and sub in ("exec", "attach", "portforward"):
            # running commands in containers is a bigger power than creating
            # pods (the reference's pods/exec RBAC resource)
            resource = f"pods/{sub}"
        elif self.command in ("PUT", "PATCH") and sub == "status":
            resource = f"{resource}/status"
        return verb, resource

    def _audit_record(self, code: int, verb: Optional[str] = None) -> None:
        """Metadata-level audit on resource requests (audit.py). Callers
        record BEFORE writing response bytes: a client acting on the response
        must already find the event recorded; the in-memory append cannot
        delay or fail the request."""
        audit = getattr(self.server, "audit", None)
        if audit is None:
            return
        parsed = _parse_path(urlparse(self.path).path)
        if parsed is None:
            return  # non-resource endpoints are not audited (subset)
        derived_verb, resource = self._request_attrs(parsed)
        _r, ns, name, _sub = parsed
        try:
            audit.log(self._user(), verb or derived_verb,
                      resource, ns or "", name or "", code)
        except Exception:
            pass

    def _error(self, code: int, message: str, reason: str = "") -> None:
        self._send_json(code, {"kind": "Status", "status": "Failure",
                               "message": message, "reason": reason, "code": code})

    def _key(self, resource, ns, name, crd=None) -> str:
        return name if self._cluster_scoped(resource, crd) else f"{ns}/{name}"

    def _discovery(self) -> None:
        """GET /apis: every servable resource -> {prefix, namespaced, kind} —
        static registries plus live CRDs. Clients use this instead of baked-in
        tables for dynamic kinds (the reference's APIGroupDiscoveryList)."""
        from ..api.serialize import GROUP_PREFIX, KIND_TO_RESOURCE

        resources = {
            res: {"name": res,
                  "prefix": GROUP_PREFIX[res],
                  "namespaced": res not in CLUSTER_SCOPED,
                  "kind": kind}
            for kind, res in KIND_TO_RESOURCE.items()
        }
        reg = getattr(self.server, "crds", None)
        if reg is not None:
            for crd in reg.all():
                resources[crd.names.plural] = {
                    "name": crd.names.plural,
                    "prefix": crd.group_prefix,
                    "namespaced": crd.scope == "Namespaced",
                    "kind": crd.names.kind,
                    "singular": crd.names.singular,
                    "shortNames": list(crd.names.short_names),
                }
        self._send_json(200, {"kind": "APIResourceList", "resources": resources})

    def _read_body(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def _read_body_yaml(self):
        """apply-patch bodies are YAML per the reference content type
        (application/apply-patch+yaml); JSON is a YAML subset."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        raw = self.rfile.read(length) if length else b"{}"
        try:
            return json.loads(raw or b"{}")
        except json.JSONDecodeError:
            import yaml

            return yaml.safe_load(raw.decode())

    def _field_manager(self, user) -> str:
        """Manager identity for field ownership: the fieldManager query param,
        else the User-Agent's first token, else the username (the reference's
        managedfields default chain)."""
        qs = parse_qs(urlparse(self.path).query)
        manager = (qs.get("fieldManager") or [""])[0]
        if manager:
            return manager
        ua = (self.headers.get("User-Agent") or "").split("/")[0].split()[0:1]
        if ua and ua[0]:
            return ua[0]
        return user.name if user is not None else "unknown"

    # ---- GET: get / list / watch / health / metrics --------------------------

    def do_GET(self):
        if self._try_aggregate():
            return
        url = urlparse(self.path)
        if url.path == "/healthz" or url.path == "/readyz":
            self._send_json(200, {"status": "ok"})
            return
        if url.path == "/metrics":
            self._metrics()
            return
        if url.path == "/version":
            self._send_json(200, {"gitVersion": "v0.1.0-kubernetes-tpu"})
            return
        if url.path == "/configz":
            from ..utils.tracing import configz_snapshot

            # configs may be arbitrary objects; coerce like the JSON logger
            body = json.dumps(configz_snapshot(), default=lambda o: vars(o)
                              if hasattr(o, "__dict__") else str(o)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/schedstats":
            # pipeline flight recorder (scheduler/flightrec.py): per-stage
            # timing + last-batch records of every live in-process batch
            # scheduler — what `ktl sched stats` renders. The debug family
            # sits beside /configz: read-only, introspection-only.
            from ..scheduler.flightrec import schedstats_snapshot

            body = json.dumps(schedstats_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/schedtrace":
            # sampled pod lifecycle spans (scheduler/podtrace.py): the
            # per-pod latency view `ktl sched trace` renders — same
            # read-only debug family as /debug/schedstats
            from ..scheduler.flightrec import schedtrace_snapshot

            body = json.dumps(schedtrace_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/trace":
            # unified trace timeline: the armed (or last)
            # trace buffer as Chrome trace-event JSON with podtrace flow
            # arrows — save the body and open it in https://ui.perfetto.dev
            # or chrome://tracing. Same read-only debug family.
            from ..scheduler.flightrec import trace_export

            body = json.dumps(trace_export(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/critpath":
            # critical-path attribution: sampled submit→bound
            # latency decomposed into additive components per window — what
            # `ktl sched why` renders. Same read-only debug family.
            from ..scheduler.flightrec import critpath_snapshot

            body = json.dumps(critpath_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/timeseries":
            # steady-state telemetry: windowed time-series +
            # resource-sampler summary of every live batch scheduler — what
            # `ktl sched top` renders. Same read-only debug family as
            # /debug/schedstats.
            from ..scheduler.flightrec import timeseries_snapshot

            body = json.dumps(timeseries_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path == "/debug/controlstats":
            # control-plane flight recorder: per-controller
            # reconcile-loop telemetry (obs/reconcile.py) plus THIS server's
            # watch-bus propagation/lag view — what `ktl controller stats`
            # renders. Same read-only debug family as /debug/schedstats.
            from ..obs.reconcile import controlstats_snapshot, reconcile_rollup

            snap = controlstats_snapshot()
            doc = {"controllers": snap,
                   "reconcile": reconcile_rollup(snap)}
            try:
                doc["watch"] = self.server.store.watch_telemetry()
            except Exception as e:  # telemetry must not 500 the endpoint
                doc["watch"] = {"error": str(e)}
            body = json.dumps(doc, default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if url.path in ("/apis", "/api"):
            # discovery needs a valid identity but no resource grant (the
            # reference binds system:discovery to all authenticated users)
            if self._user() is None:
                self._error(401, "Unauthorized: invalid or missing bearer token",
                            "Unauthorized")
                return
            self._discovery()
            return
        parsed = _parse_path(url.path)
        if parsed is None:
            self._error(404, f"unknown path {url.path}")
            return
        resource, ns, name, _sub = parsed
        crd = self._crd(resource)
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        if crd is not None:
            resource = crd.names.plural  # singular/shortName aliases
        q = parse_qs(url.query)
        if _sub == "log" and resource == "pods" and name is not None:
            # pods/{name}/log subresource (registry/core/pod/rest/log.go):
            # rendered text/plain from the PodLog channel node agents feed
            if self._authenticated_user("get", "pods") is None:
                return
            try:
                tail = int(q.get("tailLines", ["0"])[0] or 0)
            except ValueError:
                tail = 0
            try:
                log = self.store.get("podlogs", f"{ns}/{name}")
                lines = log.entries[-tail:] if tail > 0 else log.entries
            except NotFoundError:
                # pod exists but has no log yet -> empty body; unknown pod -> 404
                try:
                    self.store.get("pods", f"{ns}/{name}")
                except NotFoundError:
                    self._error(404, f"pods {ns}/{name} not found", "NotFound")
                    return
                lines = []
            body = ("\n".join(lines) + ("\n" if lines else "")).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        is_watch = name is None and q.get("watch", ["false"])[0] == "true"
        verb = "watch" if is_watch else ("get" if name is not None else "list")
        user = self._authenticated_user(verb, resource)
        if user is None:
            return
        try:
            field_pred = parse_field_selector(q.get("fieldSelector", [""])[0])
        except ValueError as e:
            self._error(400, str(e), "BadRequest")
            return
        label_sel = None
        raw_label = q.get("labelSelector", [""])[0]
        if raw_label:
            from ..api.labels import parse_selector_string

            try:
                label_sel = parse_selector_string(raw_label)
            except ValueError as e:
                self._error(400, str(e), "BadRequest")
                return
        view = self._view_transform(resource, user)
        if is_watch:
            self._watch(resource, ns, int(q.get("resourceVersion", ["-1"])[0]),
                        field_pred, view=view, label_sel=label_sel,
                        send_initial_events=q.get(
                            "sendInitialEvents", ["false"])[0] == "true",
                        ring=q.get("ring", ["false"])[0] == "true")
            return
        try:
            if name is not None:
                obj = self.store.get(resource, self._key(resource, ns, name, crd))
                self._send_json(200, view(to_dict(obj)))
            else:
                def pred(o, _ns=ns, _fp=field_pred, _ls=label_sel):
                    if _ns and o.metadata.namespace != _ns:
                        return False
                    if _ls is not None and not _ls.matches(o.metadata.labels):
                        return False
                    return _fp is None or _fp(o)

                items, rv = self.store.list(
                    resource,
                    pred if (ns or field_pred or label_sel) else None)
                self._send_json(200, {
                    "kind": "List",
                    "metadata": {"resourceVersion": rv},
                    "items": [view(to_dict(o)) for o in items],
                })
        except NotFoundError as e:
            self._error(404, str(e), "NotFound")

    def _view_transform(self, resource: str, user):
        """Per-resource response redaction. A CSR's status.certificate is a
        LIVE bearer credential in this build (not a public x509 cert), so only
        cluster admins and the CSR's own requestor may read it — any broader
        read grant (e.g. the system:authenticated read-all bootstrap rule)
        sees the CSR with the credential blanked."""
        if resource != "certificatesigningrequests" or user is None:
            return _IDENTITY_VIEW
        privileged = (getattr(self.server, "authorizer", None) is None
                      or "system:masters" in user.groups)

        def view(d):
            if privileged:
                return d
            if (d.get("spec") or {}).get("username") == user.name:
                return d
            if (d.get("status") or {}).get("certificate"):
                d = dict(d)
                d["status"] = {**d["status"], "certificate": ""}
            return d

        return view

    def _watch(self, resource: str, ns: Optional[str], since_rv: int,
               field_pred=None, view=None, label_sel=None,
               send_initial_events: bool = False,
               ring: bool = False) -> None:
        """ring=true (query param) subscribes through a
        per-subscriber bounded RING: a slow observability stream (`ktl ...
        -w` dashboards) drops its own oldest deliveries — counted as
        reason="ring_overflow" — instead of terminating into a relist storm
        that stalls the store for every partition's bind worker. Cache-
        building clients (informers) must NOT set it: they need the
        terminate->relist signal."""
        if view is None:
            view = _IDENTITY_VIEW
        if label_sel is not None:
            # fold the label selector into the scope predicate so label
            # changes ride the same ADDED/MODIFIED/DELETED transition logic
            # the field selector uses (cacher watch filtering)
            fp = field_pred

            def field_pred(o, _fp=fp, _ls=label_sel):  # noqa: F811
                if not _ls.matches(o.metadata.labels):
                    return False
                return _fp is None or _fp(o)
        initial = None
        if send_initial_events:
            # WatchList (KEP-3157; reflector.go:121-143 streaming lists):
            # the LIST rides the watch stream as ADDED events followed by
            # an initial-events-end bookmark — clients prime caches without
            # a separate large LIST response. list+watch(list_rv) is
            # consistent: the store replays history after the list's RV.
            # The watcher's scope pushes INTO the list (a node-scoped
            # kubelet informer must not deep-copy every pod in the cluster
            # just to discard them in render)
            def _initial_pred(o, _ns=ns, _fp=field_pred, _ls=label_sel):
                if _ns and getattr(o.metadata, "namespace", "") != _ns:
                    return False
                if _ls is not None and not _ls.matches(o.metadata.labels):
                    return False
                return _fp is None or _fp(o)

            initial, since_rv = self.store.list(
                resource,
                _initial_pred if (ns or field_pred or label_sel) else None)
        try:
            w = self.store.watch(resource, since_rv=since_rv, ring=ring)
        except ResourceVersionTooOldError as e:
            self._error(410, str(e), "Expired")
            return
        self._audit_record(200, verb="watch")
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        detached = False
        try:
            import time as _time

            last_sent = _time.monotonic()

            def maybe_bookmark() -> None:
                # periodic BOOKMARK (reflector.go:156): advances the client's
                # resourceVersion so reconnects don't 410-relist, and doubles
                # as a liveness probe reaping dead clients. Fires on QUIET
                # streams and on busy-but-filtered ones alike — 5s since the
                # last actual send, not 5 queue timeouts.
                from .watchmux import bookmark_frame

                nonlocal last_sent
                if _time.monotonic() - last_sent < 5.0:
                    return
                last_sent = _time.monotonic()
                self.wfile.write(bookmark_frame(self.store.rv))
                self.wfile.flush()

            def render(ev):
                """One event -> chunk-framed wire bytes, or None when the
                event is invisible to this watcher."""
                if ns and getattr(ev.obj.metadata, "namespace", "") != ns:
                    return None
                etype = ev.type
                if field_pred is not None:
                    # the cacher's transition rule: evaluate the selector on
                    # the PREVIOUS object state vs the current one
                    # (watch_cache filtering semantics) — works for objects
                    # that matched before this watch connected, because prev
                    # rides on the event itself
                    cur_ok = etype != "DELETED" and field_pred(ev.obj)
                    prev_src = ev.prev if ev.prev is not None else (
                        ev.obj if etype == "DELETED" else None)
                    prev_ok = prev_src is not None and field_pred(prev_src)
                    if cur_ok and prev_ok:
                        etype = "MODIFIED"
                    elif cur_ok:
                        etype = "ADDED"  # entered scope
                    elif prev_ok:
                        etype = "DELETED"  # left scope (or real delete)
                    else:
                        return None  # never visible to this watcher
                line = None
                cacheable = view is _IDENTITY_VIEW and etype == ev.type
                if cacheable:
                    # serialize ONCE per event across all watchers (the
                    # cacher's cachingObject, cacher.go) — at 5k watch
                    # streams per-watcher dumps dominate the fan-out cost.
                    # Only the untransformed view is cacheable: redacted
                    # views and selector-rewritten event types are not.
                    line = getattr(ev, "_wire_line", None)
                if line is None:
                    line = json.dumps({"type": etype,
                                       "object": view(to_dict(ev.obj))
                                       }).encode() + b"\n"
                    if cacheable:
                        # Event is a frozen dataclass: plain attribute
                        # assignment raises FrozenInstanceError — the cache
                        # write must go through object.__setattr__
                        object.__setattr__(ev, "_wire_line", line)
                return f"{len(line):x}\r\n".encode() + line + b"\r\n"

            if initial is not None:
                from ..store import Event as _StoreEvent

                burst = bytearray()
                for o in initial:
                    frame = render(_StoreEvent(
                        type="ADDED", kind=resource, obj=o,
                        resource_version=since_rv))
                    if frame is not None:
                        burst += frame
                endline = json.dumps({
                    "type": "BOOKMARK",
                    "object": {"metadata": {
                        "resourceVersion": str(since_rv),
                        "annotations": {
                            "k8s.io/initial-events-end": "true"}}},
                }).encode() + b"\n"
                burst += f"{len(endline):x}\r\n".encode() + endline + b"\r\n"
                self.wfile.write(bytes(burst))
                self.wfile.flush()
                last_sent = _time.monotonic()
            mux = getattr(self.server, "watch_mux", None)
            if mux is not None:
                # hand the stream to the select-based mux: ONE thread fans
                # out to every watcher (thread-per-watch collapsed 10x at
                # 5k streams — see server/watchmux.py). The dup'd fd keeps
                # the TCP stream alive after this handler thread exits.
                self.wfile.flush()
                sock = self.connection.dup()
                self.server.mark_detached(self.connection)  # type: ignore[attr-defined]
                store = self.store
                mux.add(sock, w, render, rv_fn=lambda: store.rv)
                self.close_connection = True
                detached = True
                return  # the finally below must NOT stop the watch
            while True:
                ev = w.get(timeout=1.0)
                if ev is None:
                    if w.terminated or self.server.shutting_down:  # type: ignore[attr-defined]
                        break  # evicted slow watcher: close; client relists
                    maybe_bookmark()
                    continue
                # burst batching: everything already buffered rides ONE
                # write+flush
                payload = bytearray()
                for e in [ev] + w.drain(512):
                    frame = render(e)
                    if frame is not None:
                        payload += frame
                if not payload:
                    maybe_bookmark()
                    continue
                last_sent = _time.monotonic()
                self.wfile.write(bytes(payload))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            if not detached:
                w.stop()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    pass

    def _metrics(self) -> None:
        from .metrics import global_registry

        text = global_registry.render()
        fc = getattr(self.server, "flowcontrol", None)
        if fc is not None:
            lines = []
            for name, st in fc.stats().items():
                for k, v in st.items():
                    lines.append(
                        f'apiserver_flowcontrol_{k}{{priority_level="{name}"}} {v}')
            text += "\n".join(lines) + "\n"
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # ---- POST: create / binding ----------------------------------------------

    def do_POST(self):
        if self._try_aggregate():
            return
        path = urlparse(self.path).path
        if path == "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews":
            self._self_subject_access_review()
            return
        parsed = _parse_path(path)
        if parsed is None:
            self._error(404, "unknown path")
            return
        resource, ns, name, sub = parsed
        # canonicalize CRD aliases BEFORE authz so a grant on the plural
        # covers every alias spelling, exactly as in do_GET
        crd = self._crd(resource)
        if crd is not None:
            resource = crd.names.plural
        verb, authz_resource = self._request_attrs(
            (resource, ns, name, sub))
        user = self._authenticated_user(verb, authz_resource)
        if user is None:
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return
        if sub == "binding" and resource == "pods":
            target = (body.get("target") or {}).get("name", "")
            if not target:
                self._error(400, "binding requires target.name")
                return
            try:
                self.store.bind(ns, name, target)
                self._send_json(201, {"kind": "Status", "status": "Success"})
            except NotFoundError as e:
                self._error(404, str(e), "NotFound")
            except AlreadyBoundError as e:
                self._error(409, str(e), "Conflict")
            return
        if sub == "eviction" and resource == "pods":
            # Eviction subresource (registry/core/pod/storage/eviction.go):
            # a PDB-respecting delete — every matching budget must have
            # disruptionsAllowed > 0; the decrement and the delete commit in
            # one transaction so two racing evictions cannot both spend the
            # last allowance
            err = None
            with self.store.transaction():
                try:
                    pod = self.store.get("pods", f"{ns}/{name}")
                    pdbs, _ = self.store.list(
                        "poddisruptionbudgets",
                        lambda b: b.metadata.namespace == ns
                        and b.selector is not None
                        and b.selector.matches(pod.metadata.labels))
                    blocked = [b for b in pdbs if b.disruptions_allowed <= 0]
                    if blocked:
                        err = (429, "Cannot evict pod as it would violate "
                               f"the pod's disruption budget "
                               f"({blocked[0].metadata.name})",
                               "TooManyRequests")
                    else:
                        for b in pdbs:
                            def spend(obj):
                                obj.disruptions_allowed = max(
                                    0, obj.disruptions_allowed - 1)
                                return obj

                            self.store.guaranteed_update(
                                "poddisruptionbudgets", b.key, spend)
                        self.store.delete("pods", f"{ns}/{name}")
                except NotFoundError as e:
                    err = (404, str(e), "NotFound")
            if err is not None:
                self._error(*err)
                return
            self._send_json(201, {"kind": "Status", "status": "Success"})
            return
        if sub in ("exec", "attach", "portforward") and resource == "pods":
            self._pod_stream_session(ns, name, sub, body)
            return
        if sub == "token" and resource == "serviceaccounts":
            # TokenRequest subresource: mint a signed bearer credential for
            # the service account identity (registry/core/serviceaccount/
            # storage TokenREST + the projected-token flow)
            signer = getattr(self.server, "token_signer", None)
            if signer is None:
                self._error(501, "token signing is not configured on this "
                            "server", "NotImplemented")
                return
            try:
                self.store.get("serviceaccounts", f"{ns}/{name}")
            except NotFoundError as e:
                self._error(404, str(e), "NotFound")
                return
            raw_exp = (body.get("spec") or {}).get("expirationSeconds")
            try:
                exp = 3600 if raw_exp is None else int(raw_exp)
            except (TypeError, ValueError):
                self._error(400, "spec.expirationSeconds must be an integer",
                            "BadRequest")
                return
            if exp <= 0:
                self._error(400, "spec.expirationSeconds must be positive",
                            "BadRequest")
                return
            exp = max(600, min(exp, 86400))
            token = signer.mint(
                f"system:serviceaccount:{ns}:{name}",
                ["system:serviceaccounts", f"system:serviceaccounts:{ns}"],
                expiration_seconds=exp)
            self._send_json(201, {
                "kind": "TokenRequest",
                "apiVersion": "authentication.k8s.io/v1",
                "spec": {"expirationSeconds": exp},
                "status": {"token": token, "expirationSeconds": exp},
            })
            return
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        obj, perr = self._parse_obj(resource, body, crd)
        if perr is not None:
            self._error(*perr)
            return
        if ns and not self._cluster_scoped(resource, crd):
            obj.metadata.namespace = ns
        # mutating webhooks run BEFORE registry-side allocation and identity
        # stamping (the reference's order): a webhook patch can never forge
        # CSR identity or bypass the ClusterIP allocator
        obj, _patches, werr = self._run_webhooks(resource, "CREATE", obj,
                                                 user, crd)
        if werr is not None:
            self._error(*werr)
            return
        if resource == "certificatesigningrequests":
            # requestor identity is server-populated and unforgeable
            # (certificates/v1 PrepareForCreate semantics)
            obj.username = user.name
            obj.groups = list(user.groups)
        allocated_ip = None
        if resource == "services":
            # ClusterIP allocation (registry/core/service/ipallocator):
            # empty = assign next free; explicit = honor or conflict;
            # "None" = headless, no address
            from .ipalloc import HEADLESS

            alloc = getattr(self.server, "ipalloc", None)
            if alloc is not None and obj.spec.cluster_ip != HEADLESS:
                try:
                    obj.spec.cluster_ip = alloc.allocate(obj.spec.cluster_ip)
                    allocated_ip = obj.spec.cluster_ip
                except ValueError as e:
                    self._error(422, str(e), "Invalid")
                    return
        # the creating manager owns every field it sent (recomputed
        # server-side — a client-supplied managedFields stanza is ignored)
        from .fieldmanager import capture_update

        obj.metadata.managed_fields = capture_update(
            None, to_dict(obj), self._field_manager(user))
        # admission + create under one store transaction: concurrent creates
        # cannot both pass a quota check they jointly exceed. The verdict is
        # buffered and the HTTP response written AFTER the lock is released —
        # a slow client socket must never block every store consumer.
        err = None
        created = None
        with self.store.transaction():
            if resource == "customresourcedefinitions":
                err = self._crd_conflict(obj)
            elif crd is not None:
                err = self._crd_still_served(crd)
            if err is None:
                err = self._admission_verdict(resource, "CREATE", obj, user)
            if err is None:
                try:
                    created = self.store.create(resource, obj)
                except AlreadyExistsError as e:
                    err = (409, str(e), "AlreadyExists")
        if err is not None:
            if allocated_ip is not None:
                # the create failed AFTER allocation: return the address or
                # a retrying conflicting client drains the CIDR
                self.server.ipalloc.release(allocated_ip)  # type: ignore[attr-defined]
            self._error(*err)
            return
        self._send_json(201, to_dict(created))

    def _run_webhooks(self, resource: str, operation: str, obj, user,
                      crd=None):
        """Webhook phase, OUTSIDE any store transaction (plugin/webhook/:
        an HTTP round-trip must never ride the store lock, and a webhook
        that calls back into this server would deadlock until timeout).
        Returns (possibly-replaced obj, applied JSONPatches, verdict|None)."""
        wh = getattr(self.server, "webhooks", None)
        if wh is None:
            return obj, [], None
        from .admission import AdmissionError

        try:
            wire, patches = wh.run(resource, operation, to_dict(obj),
                                   user.name if user is not None else "")
        except AdmissionError as e:
            return obj, [], (e.code, str(e), e.reason)
        if not patches:
            return obj, [], None
        new_obj, perr = self._parse_obj(resource, wire, crd)
        if perr is not None:
            return obj, [], perr
        # identity is authoritative — a webhook patch can't rename/move
        new_obj.metadata.name = obj.metadata.name
        new_obj.metadata.namespace = obj.metadata.namespace
        new_obj.metadata.uid = obj.metadata.uid
        new_obj.metadata.resource_version = obj.metadata.resource_version
        return new_obj, patches, None

    def _pod_stream_session(self, ns: str, name: str, sub: str, body) -> None:
        """exec / attach / port-forward over a store-channel session
        (api/execapi.py): create the session, long-poll until the pod's
        kubelet answers, return the result, delete the session. Replaces
        the reference's SPDY stream through the apiserver proxy
        (kubelet/server/server.go; kubectl/pkg/cmd/exec/exec.go)."""
        import time as _time
        import uuid as _uuid

        from ..api.execapi import ATTACH_COMMAND, PodExec, PodPortForward

        if not isinstance(body, dict):
            self._error(400, "body must be a JSON object", "BadRequest")
            return
        try:
            pod = self.store.get("pods", f"{ns}/{name}")
        except NotFoundError as e:
            self._error(404, str(e), "NotFound")
            return
        if not pod.spec.node_name:
            self._error(409, f"pod {name} is not scheduled to a node yet",
                        "Conflict")
            return
        try:
            timeout = min(float(body.get("timeoutSeconds", 10) or 10), 30.0)
            port = int(body.get("port", 0) or 0)
        except (TypeError, ValueError) as e:
            self._error(400, f"invalid session parameters: {e}", "BadRequest")
            return
        owner = [{"apiVersion": "v1", "kind": "Pod", "name": name,
                  "uid": pod.metadata.uid, "controller": True}]
        sid = f"{sub}-{name}-{_uuid.uuid4().hex[:8]}"
        if sub == "portforward":
            sess = PodPortForward(pod_name=name, port=port,
                                  data=body.get("data", ""))
            kind = "podportforwards"
        else:
            command = list(body.get("command") or [])
            if sub == "attach":
                command = [ATTACH_COMMAND]
            elif not command:
                self._error(400, "exec requires a command", "BadRequest")
                return
            sess = PodExec(pod_name=name, container=body.get("container", ""),
                           command=command, stdin=body.get("stdin", ""),
                           tty=bool(body.get("tty", False)))
            kind = "podexecs"
        sess.metadata.name = sid
        sess.metadata.namespace = ns
        sess.metadata.owner_references = owner
        self.store.create(kind, sess)
        deadline = _time.monotonic() + timeout
        result = None
        while _time.monotonic() < deadline:
            try:
                cur = self.store.get(kind, f"{ns}/{sid}")
            except NotFoundError:
                break  # pod (and session) deleted mid-round
            if cur.done:
                result = cur
                break
            _time.sleep(0.02)
        try:
            self.store.delete(kind, f"{ns}/{sid}")
        except NotFoundError:
            pass
        if result is None:
            self._error(504, f"{sub} timed out after {timeout:.0f}s waiting "
                        "for the node agent", "Timeout")
            return
        if kind == "podportforwards":
            self._send_json(200, {"kind": "Status", "status": "Success",
                                  "data": result.response,
                                  **({"error": result.error}
                                     if result.error else {})})
        else:
            self._send_json(200, {"kind": "Status", "status": "Success",
                                  "stdout": result.stdout,
                                  **({"stdoutB64": result.stdout_b64}
                                     if result.stdout_b64 else {}),
                                  "stderr": result.stderr,
                                  "exitCode": result.exit_code,
                                  **({"error": result.error}
                                     if result.error else {})})

    def _admission_verdict(self, resource: str, operation: str, obj, user=None):
        """Run the admission chain; returns None on admit or an
        (http_code, message, reason) tuple on reject — the caller sends the
        response outside any store lock. Identity is the authenticated user
        (node agents are system:node:<name>)."""
        chain = getattr(self.server, "admission", None)
        if chain is None:
            return None
        from .admission import AdmissionError

        username = user.name if user is not None else ""
        try:
            chain.run(self.store, resource, operation, obj, user=username)
            return None
        except AdmissionError as e:
            return (e.code, str(e), e.reason)

    def _admit(self, resource: str, operation: str, obj, user=None) -> bool:
        """Lock-free admission wrapper for paths without a transaction."""
        err = self._admission_verdict(resource, operation, obj, user)
        if err is not None:
            self._error(*err)
            return False
        return True

    # ---- PUT / DELETE --------------------------------------------------------

    def _put_status(self, resource: str, ns, name: str, user, crd=None) -> None:
        """The status subresource (registry strategies' status REST): the
        write replaces ONLY the status stanza — a status writer (kubelet,
        controller) can never mutate spec or metadata, however its payload is
        shaped. OCC applies via the body's resourceVersion when provided.
        CRD-served resources keep status inside the Unstructured content."""
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return
        if not isinstance(body, dict):
            self._error(400, "body must be a JSON object", "BadRequest")
            return
        if crd is None:
            try:
                incoming = from_dict(resource, body)
            except Exception as e:
                self._error(400, f"cannot parse {resource}: {e}", "BadRequest")
                return
            if not hasattr(incoming, "status"):
                self._error(400, f"{resource} has no status subresource",
                            "BadRequest")
                return
            body_rv = incoming.metadata.resource_version
        else:
            from ..api.crd import Unstructured

            incoming = Unstructured.from_dict(body)
            body_rv = incoming.metadata.resource_version
        key = self._key(resource, ns, name, crd)
        err = None
        updated = None
        with self.store.transaction():
            try:
                # store reads are read-only by convention (schedlint MU001):
                # splice the status into a PRIVATE object. Under the default
                # deep_copy_on_write store, get() already returns one; only
                # a no-isolation store needs the explicit copy here.
                existing = self.store.get(resource, key)
                if not getattr(self.store, "_deep_copy", True):
                    import copy as _copy

                    existing = _copy.deepcopy(existing)
                if body_rv and body_rv != existing.metadata.resource_version:
                    raise ConflictError(
                        f"{resource} {key}: stale resourceVersion {body_rv}")
                if crd is None:
                    existing.status = incoming.status
                else:
                    from ..api.crd import validate_custom_object

                    existing.content["status"] = incoming.content.get(
                        "status", {})
                    validated, errs = validate_custom_object(crd, existing)
                    if errs:
                        raise _PatchParseError((422, "; ".join(errs), "Invalid"))
                    existing = validated
                err = self._admission_verdict(resource, "UPDATE", existing, user)
                if err is None:
                    updated = self.store.update(resource, existing,
                                                check_rv=False)
            except NotFoundError as e:
                err = (404, str(e), "NotFound")
            except ConflictError as e:
                err = (409, str(e), "Conflict")
            except _PatchParseError as e:
                err = e.verdict
        if err is not None:
            self._error(*err)
            return
        self._send_json(200, to_dict(updated))

    def do_PUT(self):
        if self._try_aggregate():
            return
        parsed = _parse_path(urlparse(self.path).path)
        if parsed is None or parsed[2] is None:
            self._error(404, "unknown path")
            return
        resource, ns, name, sub = parsed
        crd = self._crd(resource)
        if crd is not None:
            resource = crd.names.plural
        _verb, authz_resource = self._request_attrs((resource, ns, name, sub))
        user = self._authenticated_user("update", authz_resource)
        if user is None:
            return
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        if sub == "status":
            self._put_status(resource, ns, name, user, crd)
            return
        try:
            body = self._read_body()
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return
        obj, perr = self._parse_obj(resource, body, crd)
        if perr is not None:
            self._error(*perr)
            return
        # the URL is authoritative for namespace/name (the body may omit them)
        if ns and not self._cluster_scoped(resource, crd):
            obj.metadata.namespace = ns
        if obj.metadata.name and obj.metadata.name != name:
            self._error(400, f"name mismatch: URL {name!r} vs body {obj.metadata.name!r}")
            return
        obj.metadata.name = name
        obj, _patches, werr = self._run_webhooks(resource, "UPDATE", obj,
                                                 user, crd)
        if werr is not None:
            self._error(*werr)
            return
        err = None
        updated = None
        with self.store.transaction():
            if resource == "customresourcedefinitions":
                err = self._crd_conflict(obj)
            elif crd is not None:
                err = self._crd_still_served(crd)
            if err is None:
                err = self._admission_verdict(resource, "UPDATE", obj, user)
            if err is None:
                try:
                    # fields this PUT changes move to the writing manager
                    # (fieldmanager.go:68); the body can't forge ownership —
                    # it is recomputed from the live diff
                    from .fieldmanager import capture_update

                    existing = self.store.get(
                        resource, self._key(resource, ns, name, crd))
                    obj.metadata.managed_fields = capture_update(
                        to_dict(existing), to_dict(obj),
                        self._field_manager(user))
                    updated = self.store.update(resource, obj)
                except NotFoundError as e:
                    err = (404, str(e), "NotFound")
                except ConflictError as e:
                    err = (409, str(e), "Conflict")
        if err is not None:
            self._error(*err)
            return
        self._send_json(200, to_dict(updated))

    def do_PATCH(self):
        """JSON Merge Patch / strategic-merge-patch (degraded to merge
        semantics) — reference: apiserver/pkg/endpoints/handlers/patch.go.
        get + merge + admission + OCC update run under one store transaction
        so concurrent patches serialize instead of clobbering."""
        if self._try_aggregate():
            return
        parsed = _parse_path(urlparse(self.path).path)
        if parsed is None or parsed[2] is None:
            self._error(404, "unknown path")
            return
        resource, ns, name, sub = parsed
        crd = self._crd(resource)
        if crd is not None:
            resource = crd.names.plural
        _verb, authz_resource = self._request_attrs((resource, ns, name, sub))
        user = self._authenticated_user("patch", authz_resource)
        if user is None:
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == "application/apply-patch+yaml":
            # server-side apply rides PATCH with its own content type
            # (handlers/patch.go:432 applyPatcher)
            self._apply_ssa(resource, ns, name, sub, crd, user)
            return
        if ctype not in ("application/merge-patch+json",
                        "application/strategic-merge-patch+json",
                        "application/json", ""):
            self._error(415, f"unsupported patch type {ctype!r}")
            return
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        try:
            patch = self._read_body()
        except json.JSONDecodeError as e:
            self._error(400, f"invalid JSON: {e}")
            return
        if sub == "status":
            # the status endpoint only ever merges the status stanza: a
            # status-scoped principal must not smuggle spec/metadata edits
            # through PATCH any more than through PUT
            if not isinstance(patch, dict):
                self._error(400, "body must be a JSON object", "BadRequest")
                return
            patch = {"status": patch.get("status", {})}
        if isinstance(patch, dict) and isinstance(patch.get("metadata"), dict):
            # managedFields are server-managed; a patch can't forge them
            patch["metadata"].pop("managedFields", None)
        key = self._key(resource, ns, name, crd)
        # webhook phase outside the transaction, on a merge computed from a
        # pre-read (bounded staleness — the reference's webhooks see the
        # same); mutating patches are re-applied to the authoritative merge
        # inside. Zero configs (the common case) skips the pre-read.
        webhook_patches = []
        wh = getattr(self.server, "webhooks", None)
        # subresource requests never hit webhooks (rules here carry no
        # subresource dimension; in the reference a rule must name
        # pods/status to match one) — a webhook patch must not smuggle
        # spec edits through the status endpoint's scoping guard
        if wh is not None and not sub and wh.active():
            from .admission import AdmissionError

            try:
                existing0 = self.store.get(resource, key)
                merged0 = json_merge_patch(to_dict(existing0), patch)
                _, webhook_patches = wh.run(
                    resource, "UPDATE", merged0,
                    user.name if user is not None else "")
            except NotFoundError as e:
                self._error(404, str(e), "NotFound")
                return
            except AdmissionError as e:
                self._error(e.code, str(e), e.reason)
                return
        err = None
        updated = None
        with self.store.transaction():
            try:
                existing = self.store.get(resource, key)
                merged = json_merge_patch(to_dict(existing), patch)
                if webhook_patches:
                    from .admissionpolicy import apply_json_patch

                    for wp in webhook_patches:
                        merged = apply_json_patch(merged, wp)
                obj, perr = self._parse_obj(resource, merged, crd)
                if perr is None and resource == "customresourcedefinitions":
                    perr = self._crd_conflict(obj)
                elif perr is None and crd is not None:
                    perr = self._crd_still_served(crd)
                if perr is not None:
                    raise _PatchParseError(perr)
                obj.metadata.name = name
                if ns and not self._cluster_scoped(resource, crd):
                    obj.metadata.namespace = ns
                # patch is read-modify-write of the current object: carry its
                # RV so a concurrent writer between our get and update conflicts
                obj.metadata.resource_version = existing.metadata.resource_version
                # changed fields move to the patching manager
                # (managedfields/fieldmanager.go:68 Update semantics)
                from .fieldmanager import capture_update

                obj.metadata.managed_fields = capture_update(
                    to_dict(existing), to_dict(obj),
                    self._field_manager(user))
                err = self._admission_verdict(resource, "UPDATE", obj, user)
                if err is None:
                    updated = self.store.update(resource, obj)
            except NotFoundError as e:
                err = (404, str(e), "NotFound")
            except ConflictError as e:
                err = (409, str(e), "Conflict")
            except _PatchParseError as e:
                err = e.verdict
            except Exception as e:
                err = (400, f"cannot apply patch: {e}", "Invalid")
        if err is not None:
            self._error(*err)
            return
        self._send_json(200, to_dict(updated))

    def _apply_ssa(self, resource, ns, name, sub, crd, user):
        """Server-side apply (handlers/patch.go:432 applyPatcher +
        managedfields/fieldmanager.go:96): merge the applied configuration
        into the live object under field ownership; 409 lists every
        conflicting (manager, field) unless force=true steals them; absent
        fields this manager previously applied are pruned; create-on-absent."""
        if sub:
            self._error(400, "apply is not supported on subresources",
                        "BadRequest")
            return
        qs = parse_qs(urlparse(self.path).query)
        manager = (qs.get("fieldManager") or [""])[0]
        if not manager:
            # the reference hard-requires an explicit manager for apply
            self._error(400, "fieldManager is required for apply requests",
                        "BadRequest")
            return
        force = (qs.get("force") or ["false"])[0].lower() in ("true", "1")
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        try:
            applied = self._read_body_yaml()
        except Exception as e:
            self._error(400, f"invalid apply body: {e}", "BadRequest")
            return
        if not isinstance(applied, dict) or not isinstance(
                applied.get("metadata", {}), dict):
            self._error(400, "body must be an object with object metadata",
                        "BadRequest")
            return
        from .fieldmanager import Conflict, apply_patch

        applied.setdefault("metadata", {})["name"] = name
        if ns and not self._cluster_scoped(resource, crd):
            applied["metadata"]["namespace"] = ns
        applied["metadata"].pop("managedFields", None)
        # status is reset on main-resource apply (the strategy's resetFields)
        applied.pop("status", None)
        key = self._key(resource, ns, name, crd)
        # webhook phase outside the transaction (same pattern as do_PATCH);
        # an apply Conflict here is ignored — the in-transaction apply
        # raises it authoritatively
        webhook_patches = []
        wh = getattr(self.server, "webhooks", None)
        if wh is not None and wh.active():
            from .admission import AdmissionError

            try:
                try:
                    live0 = to_dict(self.store.get(resource, key))
                    op0 = "UPDATE"
                except NotFoundError:
                    live0 = None
                    op0 = "CREATE"
                try:
                    merged0 = apply_patch(live0, applied, manager,
                                          force=force)
                except Conflict:
                    merged0 = None
                if merged0 is not None:
                    _, webhook_patches = wh.run(
                        resource, op0, merged0,
                        user.name if user is not None else "")
            except AdmissionError as e:
                self._error(e.code, str(e), e.reason)
                return
        err = None
        result = None
        created = False
        with self.store.transaction():
            try:
                try:
                    existing = self.store.get(resource, key)
                except NotFoundError:
                    existing = None
                live = to_dict(existing) if existing is not None else None
                try:
                    merged = apply_patch(live, applied, manager, force=force)
                except Conflict as e:
                    raise _PatchParseError((409, str(e), "Conflict"))
                if webhook_patches:
                    from .admissionpolicy import apply_json_patch

                    for wp in webhook_patches:
                        merged = apply_json_patch(merged, wp)
                obj, perr = self._parse_obj(resource, merged, crd)
                if perr is None and resource == "customresourcedefinitions":
                    perr = self._crd_conflict(obj)
                elif perr is None and crd is not None:
                    perr = self._crd_still_served(crd)
                if perr is not None:
                    raise _PatchParseError(perr)
                obj.metadata.name = name
                if ns and not self._cluster_scoped(resource, crd):
                    obj.metadata.namespace = ns
                if existing is not None:
                    obj.metadata.resource_version = \
                        existing.metadata.resource_version
                    err = self._admission_verdict(resource, "UPDATE", obj, user)
                    if err is None:
                        result = self.store.update(resource, obj)
                else:
                    err = self._admission_verdict(resource, "CREATE", obj, user)
                    if err is None:
                        result = self.store.create(resource, obj)
                        created = True
            except NotFoundError as e:
                err = (404, str(e), "NotFound")
            except ConflictError as e:
                err = (409, str(e), "Conflict")
            except AlreadyExistsError as e:
                err = (409, str(e), "AlreadyExists")
            except _PatchParseError as e:
                err = e.verdict
            except Exception as e:
                err = (400, f"cannot apply: {e}", "Invalid")
        if err is not None:
            self._error(*err)
            return
        self._send_json(201 if created else 200, to_dict(result))

    def do_DELETE(self):
        if self._try_aggregate():
            return
        parsed = _parse_path(urlparse(self.path).path)
        if parsed is None or parsed[2] is None:
            self._error(404, "unknown path")
            return
        resource, ns, name, _ = parsed
        crd = self._crd(resource)
        if crd is not None:
            resource = crd.names.plural
        user = self._authenticated_user("delete", resource)
        if user is None:
            return
        if not self._known(resource, crd):
            self._error(404, f"unknown resource {resource}")
            return
        key = self._key(resource, ns, name, crd)
        err = None
        obj = None
        with self.store.transaction():
            try:
                existing = self.store.get(resource, key)
                # deletes go through admission too (noderestriction covers DELETE)
                err = self._admission_verdict(resource, "DELETE", existing, user)
                if err is None:
                    obj = self.store.delete(resource, key)
                    # services: the allocator releases via its store watch —
                    # an explicit release here would race a concurrent
                    # allocate that already drained the DELETED event
                    if resource == "customresourcedefinitions":
                        # CR data dies with its CRD (the reference's
                        # apiextensions finalizer); same transaction so a
                        # same-plural CRD recreated later starts empty instead
                        # of resurrecting schema-stale objects
                        plural = existing.names.plural
                        crs, _rv = self.store.list(plural)
                        for cr in crs:
                            self.store.delete(plural, self.store.object_key(cr))
            except NotFoundError as e:
                err = (404, str(e), "NotFound")
        if err is not None:
            self._error(*err)
            return
        self._send_json(200, to_dict(obj))


def _install_flowcontrol_wrappers(cls) -> None:
    """Every HTTP verb dispatches through _flow_dispatch; declared once here
    instead of renaming each do_* (the reference inserts its APF filter into
    the handler chain the same way — around, not inside, the handlers)."""
    for verb in ("GET", "POST", "PUT", "PATCH", "DELETE"):
        orig = getattr(cls, f"do_{verb}")

        def make(orig):
            def do(self):
                self._flow_dispatch(lambda: orig(self))

            do.__name__ = orig.__name__
            return do

        setattr(cls, f"do_{verb}", make(orig))


_install_flowcontrol_wrappers(_Handler)


class _Server(ThreadingHTTPServer):
    # kubemark-scale watch storms: thousands of near-simultaneous connects
    # overflow the stdlib default backlog of 5, sending clients into
    # seconds-long SYN retries (500 watchers took 84s to connect; with a
    # real backlog they take under a second)
    request_queue_size = 1024

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._detached_conns = set()
        self._detached_lock = threading.Lock()

    def mark_detached(self, request) -> None:
        """The watch mux took a dup of this connection: the handler teardown
        must not shutdown() the TCP stream (a SHUT_WR sends FIN through
        every dup), only close its own fd."""
        with self._detached_lock:
            self._detached_conns.add(request)

    def shutdown_request(self, request):
        with self._detached_lock:
            detached = request in self._detached_conns
            self._detached_conns.discard(request)
        if detached:
            self.close_request(request)  # close the fd; the dup lives on
        else:
            super().shutdown_request(request)


class APIServer:
    """Embeds the store behind HTTP. start() binds a port; .url for clients."""

    def __init__(self, store: APIStore, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False, admission="default",
                 authenticator=None, authorizer=None, flowcontrol=None,
                 audit=None, token_signer=None):
        self.store = store
        self._httpd = _Server((host, port), _Handler)
        self._httpd.store = store  # type: ignore[attr-defined]
        self._httpd.verbose = verbose  # type: ignore[attr-defined]
        self._httpd.shutting_down = False  # type: ignore[attr-defined]
        from ..api.crd import DynamicRegistry
        from .ipalloc import ClusterIPAllocator

        self._httpd.crds = DynamicRegistry(store)  # type: ignore[attr-defined]
        self._httpd.ipalloc = ClusterIPAllocator(store)  # type: ignore[attr-defined]
        from .watchmux import WatchMux

        # all watch streams fan out through ONE select-based writer thread
        self._mux = WatchMux()
        self._httpd.watch_mux = self._mux  # type: ignore[attr-defined]
        from .admissionpolicy import WebhookAdmission

        # live Mutating/ValidatingWebhookConfiguration objects; the phase
        # runs BEFORE store transactions (HTTP must never ride the lock)
        self._httpd.webhooks = WebhookAdmission(store)  # type: ignore[attr-defined]
        if admission == "default":
            from .admission import default_admission_chain

            admission = default_admission_chain()
        self._httpd.admission = admission  # type: ignore[attr-defined]
        # authn/authz: None keeps the open in-process mode (tests, local
        # daemons); see auth.py for the secured configuration
        self._httpd.authenticator = authenticator  # type: ignore[attr-defined]
        self._httpd.authorizer = authorizer  # type: ignore[attr-defined]
        # APF: None = no flow control (open mode); pass a FlowController
        # (flowcontrol.default_flow_controller()) to seat-limit dispatch
        if flowcontrol == "default":
            from .flowcontrol import FlowConfigSource, default_flow_controller

            # live APF: PriorityLevelConfiguration/FlowSchema objects in the
            # store override the bootstrap defaults on the next request
            flowcontrol = FlowConfigSource(store, default_flow_controller())
        self._httpd.flowcontrol = flowcontrol  # type: ignore[attr-defined]
        if audit == "default":
            from .audit import AuditLogger

            audit = AuditLogger()
        self._httpd.audit = audit  # type: ignore[attr-defined]
        # SignedTokenAuthenticator used to mint service-account tokens via
        # the serviceaccounts/{name}/token subresource
        self._httpd.token_signer = token_signer  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutting_down = True  # type: ignore[attr-defined]
        self._mux.stop()
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
