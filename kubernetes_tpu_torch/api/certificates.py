"""CertificateSigningRequest API — the credential-issuance object.

reference: staging/src/k8s.io/api/certificates/v1/types.go
(CertificateSigningRequest{Spec,Status,Condition}) and the kubeadm TLS
bootstrap flow (node: bootstrap token -> CSR -> approval -> signed cert ->
real identity). This build's "certificate" is an HMAC-signed bearer
credential (server/auth.py SignedTokenAuthenticator) rather than x509 — the
object model, signer names, approval conditions, and the controller split
(approver / signer / cleaner) mirror the reference; only the crypto container
differs, because the transport here is bearer tokens, not mTLS.

The counterpart of `kubernetes_tpu/api/certificates.py`: the same names,
defaults and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .types import ObjectMeta

# the two signers the reference's kubelet bootstrap uses
# (pkg/apis/certificates/well_known.go)
KUBE_APISERVER_CLIENT_KUBELET = "kubernetes.io/kube-apiserver-client-kubelet"
KUBE_APISERVER_CLIENT = "kubernetes.io/kube-apiserver-client"

APPROVED = "Approved"
DENIED = "Denied"
FAILED = "Failed"


@dataclass
class CSRCondition:
    type: str  # Approved | Denied | Failed
    reason: str = ""
    message: str = ""
    last_update_time: float = 0.0

    @staticmethod
    def from_dict(d: Mapping) -> "CSRCondition":
        return CSRCondition(
            type=d.get("type", ""),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_update_time=float(d.get("lastUpdateTime", 0.0) or 0.0),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": self.type}
        if self.reason:
            out["reason"] = self.reason
        if self.message:
            out["message"] = self.message
        if self.last_update_time:
            out["lastUpdateTime"] = self.last_update_time
        return out


@dataclass
class CertificateSigningRequest:
    """Cluster-scoped. spec.request carries the requested identity
    ({"user": ..., "groups": [...]}) — the CSR subject/SAN analog.
    spec.username/groups are the REQUESTOR identity, set by the server from
    the authenticated user (clients cannot forge them, certificates/v1
    semantics)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    request: Dict[str, Any] = field(default_factory=dict)
    signer_name: str = KUBE_APISERVER_CLIENT_KUBELET
    usages: List[str] = field(default_factory=lambda: ["client auth"])
    expiration_seconds: Optional[int] = None
    username: str = ""  # requestor (server-populated)
    groups: List[str] = field(default_factory=list)  # requestor groups
    conditions: List[CSRCondition] = field(default_factory=list)
    certificate: str = ""  # issued credential (signer-populated)

    kind = "CertificateSigningRequest"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped: one store key scheme

    def condition(self, ctype: str) -> Optional[CSRCondition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    @property
    def approved(self) -> bool:
        return self.condition(APPROVED) is not None

    @property
    def denied(self) -> bool:
        return self.condition(DENIED) is not None

    @staticmethod
    def from_dict(d: Mapping) -> "CertificateSigningRequest":
        spec = d.get("spec") or {}
        st = d.get("status") or {}
        return CertificateSigningRequest(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            request=dict(spec.get("request") or {}),
            signer_name=spec.get("signerName", KUBE_APISERVER_CLIENT_KUBELET),
            usages=list(spec.get("usages") or ["client auth"]),
            expiration_seconds=spec.get("expirationSeconds"),
            username=spec.get("username", ""),
            groups=list(spec.get("groups") or []),
            conditions=[CSRCondition.from_dict(c) for c in st.get("conditions") or []],
            certificate=st.get("certificate", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        spec: Dict[str, Any] = {
            "request": self.request,
            "signerName": self.signer_name,
            "usages": list(self.usages),
        }
        if self.expiration_seconds is not None:
            spec["expirationSeconds"] = self.expiration_seconds
        if self.username:
            spec["username"] = self.username
        if self.groups:
            spec["groups"] = list(self.groups)
        status: Dict[str, Any] = {}
        if self.conditions:
            status["conditions"] = [c.to_dict() for c in self.conditions]
        if self.certificate:
            status["certificate"] = self.certificate
        return {
            "apiVersion": "certificates.k8s.io/v1",
            "kind": "CertificateSigningRequest",
            "metadata": self.metadata.to_dict(),
            "spec": spec,
            "status": status,
        }
