"""Shared helpers for pod-affinity-style term matching.

reference: pkg/scheduler/framework/types.go AffinityTerm.Matches + GetAffinityTerms
(namespace defaulting), and the matchLabelKeys merge semantics of
podtopologyspread/common.go + interpodaffinity.
"""

from __future__ import annotations

from typing import Mapping, Optional

from ...api import PodAffinityTerm, Selector
from ...api.labels import IN, Requirement


def term_namespaces_match(term: PodAffinityTerm, source_ns: str, target_ns: str,
                          ns_labels: Mapping[str, Mapping[str, str]]) -> bool:
    """Does `target_ns` fall in the term's namespace set?

    - If both `namespaces` and `namespaceSelector` are unset: defaults to the
      source pod's namespace.
    - `namespaceSelector` empty ({}) selects all namespaces; nil selects none.
    - The union of the explicit list and selector matches applies.
    """
    if term.namespaces:
        if target_ns in term.namespaces:
            return True
    if term.namespace_selector is not None:
        return term.namespace_selector.matches(ns_labels.get(target_ns, {}))
    if not term.namespaces:
        return target_ns == source_ns
    return False


def _merge_match_label_keys(sel: Optional[Selector], match_label_keys,
                            source_pod) -> Optional[Selector]:
    """matchLabelKeys merge shared by InterPodAffinity terms and PTS constraints:
    the source pod's value for each listed key is appended as an In requirement."""
    if not match_label_keys or sel is None:
        return sel
    extra = []
    for k in match_label_keys:
        if k in source_pod.metadata.labels:
            extra.append(Requirement(k, IN, (source_pod.metadata.labels[k],)))
    return Selector(sel.requirements + tuple(extra))


def effective_selector(term: PodAffinityTerm, source_pod) -> Optional[Selector]:
    """reference: interpodaffinity matchLabelKeys handling."""
    return _merge_match_label_keys(term.selector, term.match_label_keys, source_pod)


def term_matches_pod(term: PodAffinityTerm, source_pod, target_pod,
                     ns_labels: Mapping[str, Mapping[str, str]]) -> bool:
    """AffinityTerm.Matches: target pod's namespace in term namespaces AND labels
    match the (matchLabelKeys-merged) selector. A nil selector matches nothing."""
    if not term_namespaces_match(term, source_pod.metadata.namespace,
                                 target_pod.metadata.namespace, ns_labels):
        return False
    sel = effective_selector(term, source_pod)
    return sel is not None and sel.matches(target_pod.metadata.labels)


def pts_effective_selector(constraint, pod) -> Optional[Selector]:
    """PTS matchLabelKeys merge (reference: podtopologyspread/common.go)."""
    return _merge_match_label_keys(constraint.selector, constraint.match_label_keys, pod)


def count_pods_match_selector(pod_infos, selector: Optional[Selector], ns: str) -> int:
    """reference: podtopologyspread/common.go countPodsMatchSelector — counts
    non-terminating pods in `ns` matching selector."""
    if selector is None:
        return 0
    n = 0
    for pi in pod_infos:
        p = pi.pod
        if p.metadata.namespace == ns and p.metadata.deletion_timestamp is None \
                and selector.matches(p.metadata.labels):
            n += 1
    return n


def node_matches_node_selector_and_affinity(pod, node) -> bool:
    """Required node affinity = spec.nodeSelector AND
    affinity.nodeAffinity.required... (reference: component-helpers
    nodeaffinity.GetRequiredNodeAffinity)."""
    for k, v in pod.spec.node_selector.items():
        if node.metadata.labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity_required is not None:
        if not aff.node_affinity_required.matches(node):
            return False
    return True
