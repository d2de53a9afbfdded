"""Fluent MakePod/MakeNode constructors for tests and the chip smoke
(reference: pkg/scheduler/testing/wrappers.go st.MakePod()/MakeNode()). The
same API as `kubernetes_tpu/testing.py`, so one workload generator can
create the same objects for both packages."""

from __future__ import annotations

from typing import Dict, Optional

from .api import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    Node,
    NodeSelector,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    Selector,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
    new_uid,
)


class MakePod:
    def __init__(self, name: str = "p", namespace: str = "default"):
        self._pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace, uid=new_uid()))

    def name(self, n: str) -> "MakePod":
        self._pod.metadata.name = n
        return self

    def namespace(self, ns: str) -> "MakePod":
        self._pod.metadata.namespace = ns
        return self

    def uid(self, uid: str) -> "MakePod":
        self._pod.metadata.uid = uid
        return self

    def labels(self, labels: Dict[str, str]) -> "MakePod":
        self._pod.metadata.labels.update(labels)
        return self

    def req(self, requests: Dict[str, str], image: str = "", host_port: int = 0) -> "MakePod":
        """Add a container with the given resource requests."""
        c = Container(
            name=f"c{len(self._pod.spec.containers)}",
            image=image,
            resources={"requests": dict(requests)} if requests else {},
        )
        if host_port:
            c.ports.append(ContainerPort(container_port=host_port, host_port=host_port))
        self._pod.spec.containers.append(c)
        return self

    def init_req(self, requests: Dict[str, str]) -> "MakePod":
        self._pod.spec.init_containers.append(
            Container(name=f"i{len(self._pod.spec.init_containers)}",
                      resources={"requests": dict(requests)})
        )
        return self

    def container(self, image: str) -> "MakePod":
        self._pod.spec.containers.append(
            Container(name=f"c{len(self._pod.spec.containers)}", image=image)
        )
        return self

    def node(self, node_name: str) -> "MakePod":
        self._pod.spec.node_name = node_name
        return self

    def node_selector(self, sel: Dict[str, str]) -> "MakePod":
        self._pod.spec.node_selector.update(sel)
        return self

    def node_affinity_in(self, key: str, values) -> "MakePod":
        self._affinity().node_affinity_required = NodeSelector.from_dict(
            {"nodeSelectorTerms": [{"matchExpressions": [
                {"key": key, "operator": "In", "values": list(values)}]}]}
        )
        return self

    def preferred_node_affinity(self, weight: int, key: str, values) -> "MakePod":
        self._affinity().node_affinity_preferred.append(
            PreferredSchedulingTerm.from_dict({
                "weight": weight,
                "preference": {"matchExpressions": [
                    {"key": key, "operator": "In", "values": list(values)}]},
            })
        )
        return self

    def pod_affinity(self, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_affinity_required.append(
            PodAffinityTerm(topology_key=topology_key,
                            selector=Selector.from_match_labels(match_labels))
        )
        return self

    def pod_anti_affinity(self, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_anti_affinity_required.append(
            PodAffinityTerm(topology_key=topology_key,
                            selector=Selector.from_match_labels(match_labels))
        )
        return self

    def preferred_pod_affinity(self, weight: int, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_affinity_preferred.append(
            WeightedPodAffinityTerm(weight, PodAffinityTerm(
                topology_key=topology_key, selector=Selector.from_match_labels(match_labels)))
        )
        return self

    def preferred_pod_anti_affinity(self, weight: int, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_anti_affinity_preferred.append(
            WeightedPodAffinityTerm(weight, PodAffinityTerm(
                topology_key=topology_key, selector=Selector.from_match_labels(match_labels)))
        )
        return self

    def toleration(self, key: str, value: str = "", operator: str = "Equal", effect: str = "") -> "MakePod":
        self._pod.spec.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect)
        )
        return self

    def topology_spread(self, max_skew: int, topology_key: str, when: str,
                        match_labels: Optional[Dict[str, str]] = None,
                        min_domains: Optional[int] = None) -> "MakePod":
        self._pod.spec.topology_spread_constraints.append(
            TopologySpreadConstraint(
                max_skew=max_skew, topology_key=topology_key, when_unsatisfiable=when,
                selector=Selector.from_match_labels(match_labels or {}),
                min_domains=min_domains,
            )
        )
        return self

    def priority(self, p: int) -> "MakePod":
        self._pod.spec.priority = p
        return self

    def claim(self, claim_name: str, ref_name: str = "") -> "MakePod":
        """Reference a DRA ResourceClaim (PodSpec.resourceClaims)."""
        self._pod.spec.resource_claims.append(
            (ref_name or claim_name, claim_name))
        return self

    def scheduling_gate(self, name: str) -> "MakePod":
        self._pod.spec.scheduling_gates.append(name)
        return self

    def phase(self, phase: str) -> "MakePod":
        self._pod.status.phase = phase
        return self

    def pvc(self, claim_name: str) -> "MakePod":
        self._pod.spec.volumes.append(
            Volume(name=f"vol-{len(self._pod.spec.volumes)}", pvc_claim_name=claim_name))
        return self

    def volume(self, **kwargs) -> "MakePod":
        kwargs.setdefault("name", f"vol-{len(self._pod.spec.volumes)}")
        self._pod.spec.volumes.append(Volume(**kwargs))
        return self

    def _affinity(self) -> Affinity:
        if self._pod.spec.affinity is None:
            self._pod.spec.affinity = Affinity()
        return self._pod.spec.affinity

    def obj(self) -> Pod:
        return self._pod


class MakeNode:
    def __init__(self, name: str = "n"):
        self._node = Node(metadata=ObjectMeta(name=name, namespace="", uid=new_uid()))
        self._node.metadata.labels["kubernetes.io/hostname"] = name

    def name(self, n: str) -> "MakeNode":
        self._node.metadata.name = n
        self._node.metadata.labels["kubernetes.io/hostname"] = n
        return self

    def labels(self, labels: Dict[str, str]) -> "MakeNode":
        self._node.metadata.labels.update(labels)
        return self

    def capacity(self, cap: Dict[str, str]) -> "MakeNode":
        cap = dict(cap)
        cap.setdefault("pods", "110")
        self._node.status.capacity = cap
        self._node.status.allocatable = dict(cap)
        return self

    def taints(self, taints) -> "MakeNode":
        self._node.spec.taints = [
            t if isinstance(t, Taint) else Taint.from_dict(t) for t in taints
        ]
        return self

    def unschedulable(self, v: bool = True) -> "MakeNode":
        self._node.spec.unschedulable = v
        return self

    def images(self, images: Dict[str, int]) -> "MakeNode":
        self._node.status.images = [
            ContainerImage(names=(name,), size_bytes=size) for name, size in images.items()
        ]
        return self

    def obj(self) -> Node:
        return self._node
