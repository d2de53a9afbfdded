"""Authentication + authorization for the API server front-end.

reference: the apiserver handler chain runs authn -> audit -> authz ->
admission before any storage access (staging/src/k8s.io/apiserver/pkg/server/
config.go DefaultBuildHandlerChain; SURVEY.md §1 L2).

Carried subset:
  - TokenAuthenticator — static token file authn, the analog of
    `kube-apiserver --token-auth-file` (apiserver/pkg/authentication/
    request/bearertoken + token/tokenfile): `Authorization: Bearer <t>`
    resolves to (user, groups); unknown tokens are 401.
  - RBACAuthorizer — RBAC-lite: rules are (verbs, resources) pairs bound to
    users or groups (staging/src/k8s.io/apiserver/pkg/authorization +
    plugin/pkg/auth/authorizer/rbac). `*` wildcards match everything.
    Unauthorized requests are 403.

Both are optional: a server constructed without them keeps the open,
in-process behavior the test harness uses (identity then comes from the
X-Remote-User header, the authenticating-proxy convention — only trustable
when a trusted proxy sets it, which is why enabling the authenticator
disables the header entirely).

The counterpart of `kubernetes_tpu/server/auth.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class UserInfo:
    """authentication/user.Info subset."""

    name: str
    groups: Tuple[str, ...] = ()

    @property
    def is_authenticated(self) -> bool:
        return bool(self.name)


ANONYMOUS = UserInfo(name="system:anonymous", groups=("system:unauthenticated",))


class TokenAuthenticator:
    """Static bearer-token table: token -> UserInfo.

    from_csv_lines accepts the reference's token file shape:
    `token,user,uid[,"group1,group2"]` (one per line)."""

    def __init__(self, tokens: Optional[Dict[str, UserInfo]] = None):
        self._tokens: Dict[str, UserInfo] = dict(tokens or {})

    @classmethod
    def from_csv_lines(cls, lines: Sequence[str]) -> "TokenAuthenticator":
        import csv

        tokens: Dict[str, UserInfo] = {}
        for row in csv.reader([l for l in lines if l.strip() and not l.startswith("#")]):
            if len(row) < 2:
                continue
            token, user = row[0].strip(), row[1].strip()
            groups = tuple(g.strip() for g in row[3].split(",")) if len(row) > 3 and row[3] else ()
            tokens[token] = UserInfo(name=user, groups=groups + ("system:authenticated",))
        return cls(tokens)

    @classmethod
    def from_file(cls, path: str) -> "TokenAuthenticator":
        with open(path) as f:
            return cls.from_csv_lines(f.read().splitlines())

    def add(self, token: str, user: str, groups: Sequence[str] = ()) -> None:
        self._tokens[token] = UserInfo(
            name=user, groups=tuple(groups) + ("system:authenticated",))

    def authenticate(self, authorization_header: str) -> Optional[UserInfo]:
        """Returns UserInfo for a valid `Bearer <token>` header, None otherwise."""
        if not authorization_header.startswith("Bearer "):
            return None
        return self._tokens.get(authorization_header[len("Bearer "):].strip())


class SignedTokenAuthenticator:
    """Stateless verifier for cluster-signed bearer credentials — the
    verification half of the certificates flow (reference: the apiserver
    trusting certs chained to the cluster CA; here the CA analog is an HMAC
    key held by the control plane).

    Token wire format: `ktpu.v1.<b64url(payload-json)>.<hex hmac-sha256>`
    with payload {"user": ..., "groups": [...], "exp": epoch-or-null}.
    mint() lives here too so the CSR signing controller and the verifier
    cannot drift."""

    PREFIX = "ktpu.v1."

    def __init__(self, key: bytes, now=None):
        import time

        self._key = key
        self._now = now or time.time

    def mint(self, user: str, groups: Sequence[str] = (),
             expiration_seconds: Optional[int] = None) -> str:
        import base64
        import hashlib
        import hmac
        import json

        payload = {"user": user, "groups": list(groups)}
        if expiration_seconds is not None:
            payload["exp"] = self._now() + expiration_seconds
        body = base64.urlsafe_b64encode(
            json.dumps(payload, sort_keys=True).encode()).decode().rstrip("=")
        sig = hmac.new(self._key, body.encode(), hashlib.sha256).hexdigest()
        return f"{self.PREFIX}{body}.{sig}"

    def authenticate(self, authorization_header: str) -> Optional[UserInfo]:
        import base64
        import hashlib
        import hmac
        import json

        if not authorization_header.startswith("Bearer "):
            return None
        token = authorization_header[len("Bearer "):].strip()
        if not token.startswith(self.PREFIX):
            return None
        rest = token[len(self.PREFIX):]
        body, _, sig = rest.rpartition(".")
        if not body or not sig:
            return None
        want = hmac.new(self._key, body.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            return None
        try:
            pad = "=" * (-len(body) % 4)
            payload = json.loads(base64.urlsafe_b64decode(body + pad))
        except Exception:
            return None
        exp = payload.get("exp")
        if exp is not None and self._now() > exp:
            return None
        return UserInfo(name=payload.get("user", ""),
                        groups=tuple(payload.get("groups") or ())
                        + ("system:authenticated",))


class AuthenticatorChain:
    """First authenticator to recognize the credential wins (the apiserver's
    union authenticator, authentication/request/union)."""

    def __init__(self, authenticators: Sequence):
        self._authns = list(authenticators)

    def authenticate(self, authorization_header: str) -> Optional[UserInfo]:
        for a in self._authns:
            user = a.authenticate(authorization_header)
            if user is not None:
                return user
        return None


@dataclass
class Rule:
    """rbac.PolicyRule subset: which verbs on which resources.
    `except_resources` carves names out of a wildcard resource match — how a
    broad read rule excludes secret payloads without enumerating every
    resource (incl. CRD-served plurals unknown at grant time)."""

    verbs: Tuple[str, ...]  # get/list/watch/create/update/patch/delete/bind or *
    resources: Tuple[str, ...]  # store kinds or *
    except_resources: Tuple[str, ...] = ()

    def allows(self, verb: str, resource: str) -> bool:
        if resource in self.except_resources:
            return False
        return (("*" in self.verbs or verb in self.verbs)
                and ("*" in self.resources or resource in self.resources))


class RBACAuthorizer:
    """Subject (user or `group:<name>`) -> list of rules. Deny by default."""

    def __init__(self):
        self._grants: Dict[str, List[Rule]] = {}

    def grant(self, subject: str, verbs: Sequence[str], resources: Sequence[str],
              except_resources: Sequence[str] = ()) -> "RBACAuthorizer":
        self._grants.setdefault(subject, []).append(
            Rule(tuple(verbs), tuple(resources), tuple(except_resources)))
        return self

    def authorize(self, user: UserInfo, verb: str, resource: str) -> bool:
        for subject in (user.name, *(f"group:{g}" for g in user.groups)):
            for rule in self._grants.get(subject, ()):
                if rule.allows(verb, resource):
                    return True
        return False


def default_component_authorizer() -> RBACAuthorizer:
    """Grants mirroring the reference's bootstrap cluster roles
    (plugin/pkg/auth/authorizer/rbac/bootstrappolicy): admins everything,
    scheduler binds + reads, nodes status + leases, controllers broad write."""
    a = RBACAuthorizer()
    a.grant("group:system:masters", ["*"], ["*"])
    a.grant("group:system:kube-scheduler",
            ["get", "list", "watch", "update", "patch", "bind"],
            ["pods", "nodes", "namespaces", "persistentvolumes",
             "persistentvolumeclaims", "storageclasses", "csinodes",
             "poddisruptionbudgets", "leases"])
    a.grant("group:system:nodes",
            ["get", "list", "watch", "create", "update", "patch", "delete"],
            ["pods", "nodes", "leases", "events", "podlogs",
             "pods/status", "nodes/status",
             # streaming session channels the kubelet answers
             "podexecs", "podportforwards"])
    # nodes may renew their own credential (certificatesigningrequests
    # recognizer allows requestor == requested node identity)
    a.grant("group:system:nodes", ["create", "get", "list", "watch"],
            ["certificatesigningrequests"])
    # nodes resolve pod config payloads (the node authorizer scopes these to
    # pods bound to the node in the reference; kind-level here)
    a.grant("group:system:nodes", ["get", "list", "watch"],
            ["configmaps", "secrets"])
    a.grant("group:system:kube-controller-manager", ["*"], ["*"])
    # authenticated read-all EXCLUDES secrets: no reference bootstrap role
    # puts secret payloads in a wildcard read grant (bootstrappolicy's
    # system:basic-user has nothing; even view/edit enumerate resources).
    # Wildcard-with-carve-out keeps CRD-served plurals readable by default
    # while secrets require an explicit grant.
    a.grant("group:system:authenticated", ["get", "list", "watch"], ["*"],
            # exec stdin/stdout and port-forward bytes are exactly as
            # sensitive as secret payloads: carved out of wildcard reads
            except_resources=("secrets", "podexecs", "podportforwards"))
    return a
