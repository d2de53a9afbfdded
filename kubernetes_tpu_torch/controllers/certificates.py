"""Certificates controllers: approve, sign, and clean up CSRs.

reference: pkg/controller/certificates/{approver,signer,cleaner} and kubeadm's
TLS bootstrap — a joining node authenticates with a bootstrap token
(system:bootstrappers group), files a CSR for its node identity, the approver
auto-approves recognized node-bootstrap requests, the signer issues the
credential, and the node re-connects with its real system:node:<name>
identity (which NodeRestriction then scopes). The issued credential is an
HMAC-signed bearer token (server/auth.py SignedTokenAuthenticator) — the
cluster-CA analog for a bearer-token transport.

The counterpart of `kubernetes_tpu/controllers/certificates.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Optional

from ..api.certificates import (
    APPROVED,
    CSRCondition,
    DENIED,
    FAILED,
    KUBE_APISERVER_CLIENT,
    KUBE_APISERVER_CLIENT_KUBELET,
)
from ..store import NotFoundError
from .base import Controller

BOOTSTRAP_GROUP = "system:bootstrappers"
NODE_GROUP = "system:nodes"
NODE_USER_PREFIX = "system:node:"

# default issued-credential lifetime (the reference kubelet rotates well
# before cert expiry; 1h mirrors its default client cert duration floor)
DEFAULT_EXPIRATION_SECONDS = 3600


def recognize_node_client(csr) -> Optional[str]:
    """The approver's recognizer for kubelet client CSRs
    (pkg/controller/certificates/approver/sarapprove.go): signer must be
    kube-apiserver-client-kubelet, the requested identity a system:node:<name>
    user in the system:nodes group, and the REQUESTOR a bootstrapper (or the
    node itself, for renewal). Returns the node name or None."""
    if csr.signer_name != KUBE_APISERVER_CLIENT_KUBELET:
        return None
    user = csr.request.get("user", "")
    groups = csr.request.get("groups") or []
    # groups must be EXACTLY [system:nodes] — membership alone would let a
    # bootstrap token smuggle system:masters into the issued credential
    # (sarapprove requires Organization == ["system:nodes"])
    if not user.startswith(NODE_USER_PREFIX) or set(groups) != {NODE_GROUP}:
        return None
    node = user[len(NODE_USER_PREFIX):]
    requestor_ok = (BOOTSTRAP_GROUP in csr.groups
                    or csr.username == user)  # renewal by the node itself
    return node if requestor_ok else None


class CSRApprovingController(Controller):
    """Auto-approves recognized node-bootstrap CSRs; denies kubelet-signer
    requests that ask for anything else (fail closed, like sarapprove's
    recognizer miss leaving the CSR pending — here made explicit so a bad
    request surfaces instead of hanging the join)."""

    watch_kinds = ("certificatesigningrequests",)

    def key_of_object(self, kind, obj):
        return obj.metadata.name

    def sync(self, name: str) -> None:
        try:
            csr = self.store.get("certificatesigningrequests", name)
        except NotFoundError:
            return
        if csr.approved or csr.denied or csr.signer_name != KUBE_APISERVER_CLIENT_KUBELET:
            return
        node = recognize_node_client(csr)

        def decide(obj):
            if obj.approved or obj.denied:
                return obj
            if node is not None:
                obj.conditions.append(CSRCondition(
                    type=APPROVED, reason="AutoApproved",
                    message="node client cert request recognized",
                    last_update_time=self.clock.now()))
            else:
                obj.conditions.append(CSRCondition(
                    type=DENIED, reason="Unrecognized",
                    message="not a recognized node client request",
                    last_update_time=self.clock.now()))
            return obj

        self.store.guaranteed_update("certificatesigningrequests", name, decide)


class CSRSigningController(Controller):
    """Issues the credential for approved CSRs
    (pkg/controller/certificates/signer). Holds the cluster signing key via a
    SignedTokenAuthenticator (mint + verify share one implementation)."""

    watch_kinds = ("certificatesigningrequests",)

    def __init__(self, store, signer, clock=None):
        super().__init__(store, clock)
        self.signer = signer

    def key_of_object(self, kind, obj):
        return obj.metadata.name

    def sync(self, name: str) -> None:
        try:
            csr = self.store.get("certificatesigningrequests", name)
        except NotFoundError:
            return
        if not csr.approved or csr.denied or csr.certificate:
            return
        if csr.signer_name not in (KUBE_APISERVER_CLIENT_KUBELET,
                                   KUBE_APISERVER_CLIENT):
            return  # foreign signerName: not ours to issue (signer.go filters)
        user = csr.request.get("user", "")
        groups = [g for g in (csr.request.get("groups") or [])
                  if g != "system:authenticated"]  # authn layer re-adds it
        ttl = csr.expiration_seconds or DEFAULT_EXPIRATION_SECONDS
        try:
            token = self.signer.mint(user, groups, expiration_seconds=ttl)
        except Exception as e:  # key unavailable etc. -> Failed condition
            def fail(obj):
                if not obj.condition(FAILED):
                    obj.conditions.append(CSRCondition(
                        type=FAILED, reason="SigningError", message=str(e),
                        last_update_time=self.clock.now()))
                return obj

            self.store.guaranteed_update("certificatesigningrequests", name, fail)
            return

        def fill(obj):
            if not obj.certificate:
                obj.certificate = token
            return obj

        self.store.guaranteed_update("certificatesigningrequests", name, fill)


class CSRCleanerController(Controller):
    """Deletes stale CSRs (pkg/controller/certificates/cleaner): denied/failed
    after 1h, issued after 1h, pending after 24h — drive via monitor()."""

    watch_kinds = ("certificatesigningrequests",)
    DENIED_TTL = 3600.0
    ISSUED_TTL = 3600.0
    PENDING_TTL = 86400.0
    SWEEP_INTERVAL = 60.0

    def __init__(self, store, clock=None):
        super().__init__(store, clock)
        self._last_sweep = float("-inf")

    def key_of_object(self, kind, obj):
        return obj.metadata.name

    def reconcile_once(self) -> int:
        # staleness is time-driven, not event-driven: the daemon loop must
        # re-examine quiet CSRs periodically or nothing ever ages out
        if self.clock.now() - self._last_sweep >= self.SWEEP_INTERVAL:
            self._last_sweep = self.clock.now()
            csrs, _ = self.store.list("certificatesigningrequests")
            for csr in csrs:
                self._mark(csr.metadata.name)
        return super().reconcile_once()

    def monitor(self) -> None:
        csrs, _ = self.store.list("certificatesigningrequests")
        for csr in csrs:
            self._mark(csr.metadata.name)
        self.process()

    def sync(self, name: str) -> None:
        try:
            csr = self.store.get("certificatesigningrequests", name)
        except NotFoundError:
            return
        age = self.clock.now() - csr.metadata.creation_timestamp
        stale = ((csr.denied or csr.condition(FAILED)) and age > self.DENIED_TTL
                 or csr.certificate and age > self.ISSUED_TTL
                 or not csr.conditions and age > self.PENDING_TTL)
        if stale:
            try:
                self.store.delete("certificatesigningrequests", name)
            except NotFoundError:
                pass
