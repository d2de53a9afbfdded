"""Networking API types: Service, EndpointSlice.

reference: staging/src/k8s.io/api/core/v1/types.go (Service, ServicePort) and
staging/src/k8s.io/api/discovery/v1/types.go (EndpointSlice, Endpoint).

The counterpart of `kubernetes_tpu/api/networking.py`: the same names,
defaults and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .types import ObjectMeta


@dataclass(frozen=True)
class ServicePort:
    name: str = ""
    port: int = 0
    target_port: int = 0  # 0 = same as port
    protocol: str = "TCP"
    node_port: int = 0

    def resolved_target(self) -> int:
        return self.target_port or self.port


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""
    type: str = "ClusterIP"  # ClusterIP | NodePort | LoadBalancer | ExternalName
    external_name: str = ""
    session_affinity: str = "None"


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)

    kind = "Service"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "Service":
        sp = d.get("spec") or {}
        return Service(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=ServiceSpec(
                selector=dict(sp.get("selector") or {}),
                ports=[ServicePort(
                    name=p.get("name", ""),
                    port=int(p.get("port", 0) or 0),
                    target_port=int(p.get("targetPort", 0) or 0),
                    protocol=p.get("protocol", "TCP"),
                    node_port=int(p.get("nodePort", 0) or 0),
                ) for p in sp.get("ports") or []],
                cluster_ip=sp.get("clusterIP", ""),
                type=sp.get("type", "ClusterIP"),
                external_name=sp.get("externalName", ""),
                session_affinity=sp.get("sessionAffinity", "None"),
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "v1", "kind": "Service",
            "metadata": self.metadata.to_dict(),
            "spec": {
                **({"selector": dict(self.spec.selector)} if self.spec.selector else {}),
                "ports": [
                    {**({"name": p.name} if p.name else {}),
                     "port": p.port,
                     **({"targetPort": p.target_port} if p.target_port else {}),
                     "protocol": p.protocol,
                     **({"nodePort": p.node_port} if p.node_port else {})}
                    for p in self.spec.ports
                ],
                **({"clusterIP": self.spec.cluster_ip} if self.spec.cluster_ip else {}),
                "type": self.spec.type,
                **({"externalName": self.spec.external_name}
                   if self.spec.external_name else {}),
            },
        }


@dataclass
class Endpoint:
    addresses: List[str] = field(default_factory=list)
    ready: bool = True
    node_name: str = ""
    target_ref: str = ""  # "ns/pod-name"


@dataclass
class EndpointSlice:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    address_type: str = "IPv4"
    endpoints: List[Endpoint] = field(default_factory=list)
    ports: List[ServicePort] = field(default_factory=list)

    kind = "EndpointSlice"

    LABEL_SERVICE_NAME = "kubernetes.io/service-name"
    MAX_ENDPOINTS = 100  # discovery default maxEndpointsPerSlice

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "EndpointSlice":
        return EndpointSlice(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            address_type=d.get("addressType", "IPv4"),
            endpoints=[Endpoint(
                addresses=list(e.get("addresses") or []),
                ready=bool((e.get("conditions") or {}).get("ready", True)),
                node_name=e.get("nodeName", ""),
                target_ref=(f"{(e.get('targetRef') or {}).get('namespace', 'default')}/"
                            f"{(e.get('targetRef') or {}).get('name', '')}"
                            if e.get("targetRef") else ""),
            ) for e in d.get("endpoints") or []],
            ports=[ServicePort(
                name=p.get("name", ""),
                port=int(p.get("port", 0) or 0),
                protocol=p.get("protocol", "TCP"),
            ) for p in d.get("ports") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "discovery.k8s.io/v1", "kind": "EndpointSlice",
            "metadata": self.metadata.to_dict(),
            "addressType": self.address_type,
            "endpoints": [
                {"addresses": list(e.addresses),
                 "conditions": {"ready": e.ready},
                 **({"nodeName": e.node_name} if e.node_name else {}),
                 **({"targetRef": {"kind": "Pod",
                                   "namespace": e.target_ref.split("/", 1)[0],
                                   "name": e.target_ref.split("/", 1)[1]}}
                    if e.target_ref else {})}
                for e in self.endpoints
            ],
            "ports": [{**({"name": p.name} if p.name else {}),
                       "port": p.port, "protocol": p.protocol}
                      for p in self.ports],
        }


# ---- Ingress + NetworkPolicy ---------------------------------------------------
#
# reference: staging/src/k8s.io/api/networking/v1/types.go. Like the
# reference, these are API surface served by the control plane and consumed
# by OUT-OF-TREE dataplanes (ingress controllers, CNI plugins): the apiserver
# stores/validates/watches them; nothing in-tree programs the packets.


@dataclass
class IngressClass:
    """Cluster-scoped; the is_default annotation drives DefaultIngressClass
    admission (ingressclass.kubernetes.io/is-default-class)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    controller: str = ""

    kind = "IngressClass"
    DEFAULT_ANNOTATION = "ingressclass.kubernetes.io/is-default-class"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped

    @property
    def is_default(self) -> bool:
        return self.metadata.annotations.get(self.DEFAULT_ANNOTATION) == "true"

    @staticmethod
    def from_dict(d) -> "IngressClass":
        return IngressClass(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            controller=(d.get("spec") or {}).get("controller", ""),
        )

    def to_dict(self):
        return {"apiVersion": "networking.k8s.io/v1", "kind": "IngressClass",
                "metadata": self.metadata.to_dict(),
                "spec": {"controller": self.controller}}


@dataclass
class IngressRule:
    host: str = ""
    # [(path, pathType, serviceName, servicePort)]
    paths: list = field(default_factory=list)

    @staticmethod
    def from_dict(d) -> "IngressRule":
        paths = []
        for p in ((d.get("http") or {}).get("paths") or []):
            svc = ((p.get("backend") or {}).get("service") or {})
            paths.append((p.get("path", "/"), p.get("pathType", "Prefix"),
                          svc.get("name", ""),
                          int((svc.get("port") or {}).get("number", 0) or 0)))
        return IngressRule(host=d.get("host", ""), paths=paths)

    def to_dict(self):
        return {
            **({"host": self.host} if self.host else {}),
            "http": {"paths": [
                {"path": path, "pathType": ptype,
                 "backend": {"service": {"name": name,
                                         "port": {"number": port}}}}
                for path, ptype, name, port in self.paths]},
        }


@dataclass
class Ingress:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    ingress_class_name: Optional[str] = None
    rules: List[IngressRule] = field(default_factory=list)
    default_backend: str = ""  # service name

    kind = "Ingress"

    @staticmethod
    def from_dict(d) -> "Ingress":
        spec = d.get("spec") or {}
        db = (((spec.get("defaultBackend") or {}).get("service")) or {})
        return Ingress(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            ingress_class_name=spec.get("ingressClassName"),
            rules=[IngressRule.from_dict(r) for r in spec.get("rules") or []],
            default_backend=db.get("name", ""),
        )

    def to_dict(self):
        spec = {}
        if self.ingress_class_name is not None:
            spec["ingressClassName"] = self.ingress_class_name
        if self.rules:
            spec["rules"] = [r.to_dict() for r in self.rules]
        if self.default_backend:
            spec["defaultBackend"] = {"service": {"name": self.default_backend}}
        return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                "metadata": self.metadata.to_dict(), "spec": spec}


@dataclass
class NetworkPolicy:
    """Stored + watched; enforcement belongs to the CNI (out of tree in the
    reference too). Ingress/egress rules kept as raw dicts — the policy
    grammar (peers, ports, ipBlock) round-trips without loss."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_selector: dict = field(default_factory=dict)  # raw LabelSelector
    policy_types: List[str] = field(default_factory=list)
    ingress: list = field(default_factory=list)
    egress: list = field(default_factory=list)

    kind = "NetworkPolicy"

    @staticmethod
    def from_dict(d) -> "NetworkPolicy":
        spec = d.get("spec") or {}
        return NetworkPolicy(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            pod_selector=dict(spec.get("podSelector") or {}),
            policy_types=list(spec.get("policyTypes") or []),
            ingress=list(spec.get("ingress") or []),
            egress=list(spec.get("egress") or []),
        )

    def to_dict(self):
        spec = {"podSelector": self.pod_selector}
        if self.policy_types:
            spec["policyTypes"] = list(self.policy_types)
        if self.ingress:
            spec["ingress"] = self.ingress
        if self.egress:
            spec["egress"] = self.egress
        return {"apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
                "metadata": self.metadata.to_dict(), "spec": spec}
