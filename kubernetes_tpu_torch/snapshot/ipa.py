"""InterPodAffinity -> dense tensors for the device solver.

The quadratic hard part of the north star (SURVEY.md §7 hard part 1): the
reference builds three topologyPair->count maps per pod
(interpodaffinity/filtering.go:44-110) and a weighted pair map for scoring
(scoring.go). The dense reframing replaces the maps with per-node count tensors
segment-summed over topology domains:

  selector-class counts  selcls_count[SC, N] — "pods matching predicate sc on
      node n" — serve the incoming pod's own terms (affinity / anti-affinity /
      preferred). Shared with PodTopologySpread.
  holder-group counts    grp_count[G, N] — "pods ON node n that themselves
      carry term-group g" — serve the symmetric rules: existing pods' required
      anti-affinity (filtering.go satisfyExistingPodsAntiAffinity) and
      existing pods' preferred/hard terms in scoring (scoring.go
      processExistingPod).

Both tensors are dynamic in the scan solver: committing a pod of class c adds
class_matches_selcls[c] and class_holds_grp[c] at the chosen node, which is
exactly the serial semantics where each bind feeds the next pod's PreFilter.

Term groups are keyed by (kind, topologyKey, namespace-semantics, effective
selector[, weight]); any (term, source-pod) pair in a group matches the same
set of target pods, so one representative per group decides per-class matching.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ..api import Pod
from ..scheduler.plugins.helpers import (
    effective_selector,
    term_matches_pod,
    term_namespaces_match,
)

# holder-group kinds
_KIND_REQ_ANTI = "rn"  # required anti-affinity (filter rule 1)
_KIND_PREF_AFF = "pa"  # preferred affinity (+w, symmetric score)
_KIND_PREF_ANTI = "pn"  # preferred anti-affinity (-w, symmetric score)
_KIND_REQ_AFF = "ra"  # required affinity (+hardPodAffinityWeight, score)


def _term_ns_canon(term, source_ns: str) -> tuple:
    """Canonical namespace-semantics key: two (term, source) pairs with equal
    keys match the same target namespaces (helpers.term_namespaces_match)."""
    default_ns = source_ns if (not term.namespaces
                               and term.namespace_selector is None) else ""
    return (tuple(sorted(term.namespaces)), repr(term.namespace_selector), default_ns)


def _term_matcher(term, source_pod, ns_labels) -> Callable[[Pod], bool]:
    """Pod predicate for an affinity term (AffinityTerm.Matches, types.go).
    Unlike PTS counting, terminating pods are NOT excluded — the reference
    counts every pod in NodeInfo.Pods (filtering.go:processExistingPod)."""
    eff = effective_selector(term, source_pod)
    src_ns = source_pod.metadata.namespace

    def match(p: Pod) -> bool:
        if eff is None:
            return False
        if not term_namespaces_match(term, src_ns, p.metadata.namespace, ns_labels):
            return False
        return eff.matches(p.metadata.labels)

    return match


@dataclass
class IPATensors:
    """Batch-scoped InterPodAffinity tensors (numpy; ops/ uploads).

    All term tables are PER-CLASS padded rows (-1 = inactive slot): the scan
    solver gathers one class row per pod step, so per-step device cost scales
    with the max term count of a single class, not the batch-wide total —
    the difference between O(C·N) and O(terms·N) per pod at bench scale.
    """

    # incoming pod's terms per class; *_sel indexes the shared selector-class
    # count tensor, *_key the topo_id rows; -1 pads
    ra_key: np.ndarray  # [C, RAm] — required affinity
    ra_sel: np.ndarray
    rn_key: np.ndarray  # [C, RNm] — required anti-affinity
    rn_sel: np.ndarray
    pp_key: np.ndarray  # [C, PPm] — preferred terms
    pp_sel: np.ndarray
    pp_weight: np.ndarray  # [C, PPm] signed; 0 on pads

    # holder groups
    grp_key: np.ndarray  # [G] int32 — topo_id row per group
    grp_count: np.ndarray  # [G, N] int32 — existing holders per node
    class_holds_grp: np.ndarray  # [C, G] int32 — terms of class c in group g

    # filter rule 1: required-anti groups matching each class (-1 pads)
    ea_grp: np.ndarray  # [C, Em] int32 (index into G)

    # symmetric score: groups whose terms match each class + signed weight
    sym_grp: np.ndarray  # [C, Sm] int32 (-1 pads)
    sym_weight: np.ndarray  # [C, Sm] int32 (0 on pads)

    class_self_ok: np.ndarray  # [C] bool — pod matches all own required terms
    class_has_ra: np.ndarray  # [C] bool
    # constraint-compilation metadata for the propose-and-repair solver
    # (models/repair.py): a class whose OWN required anti-affinity term
    # matches its own rep pod can place at most ONE member per topology
    # domain — the propose step caps it at one per node (the host-port cap
    # mechanism) and the repair loop resolves coarser-domain collisions
    class_rn_self: np.ndarray = None  # [C] bool

    @property
    def has_any(self) -> bool:
        return bool((self.ra_key >= 0).any() or (self.rn_key >= 0).any()
                    or (self.pp_key >= 0).any() or (self.ea_grp >= 0).any()
                    or (self.sym_grp >= 0).any())


def compile_ipa(
    rep_pods: Sequence[Pod],
    snapshot,
    topo_row: Callable[[str], int],
    selcls_row: Callable[[tuple, Callable[[Pod], bool]], int],
    ns_labels: Mapping[str, Mapping[str, str]],
    hard_pod_affinity_weight: int,
    node_name_to_idx: Dict[str, int],
    n_nodes: int,
) -> IPATensors:
    """Build the IPA tensors for one batch.

    topo_row registers a topology key on the cluster tensors and returns its
    row; selcls_row registers a (key, matcher) selector-class and returns its
    row in the shared count tensor.
    """
    c = len(rep_pods)

    # ---- incoming-term rows, grouped per class -----------------------------
    ra_rows: List[List[Tuple[int, int]]] = [[] for _ in range(c)]
    rn_rows: List[List[Tuple[int, int]]] = [[] for _ in range(c)]
    pp_rows: List[List[Tuple[int, int, int]]] = [[] for _ in range(c)]
    class_self_ok = np.zeros(c, dtype=bool)
    class_has_ra = np.zeros(c, dtype=bool)
    class_rn_self = np.zeros(c, dtype=bool)

    def _sel_row_for(term, source_pod) -> int:
        eff = effective_selector(term, source_pod)
        key = ("ipa", term.topology_key, _term_ns_canon(term, source_pod.metadata.namespace),
               repr(eff))
        return selcls_row(key, _term_matcher(term, source_pod, ns_labels))

    for ci, pod in enumerate(rep_pods):
        aff = pod.spec.affinity
        if aff is None:
            continue
        required = tuple(aff.pod_affinity_required)
        if required:
            class_has_ra[ci] = True
            class_self_ok[ci] = all(
                term_matches_pod(t, pod, pod, ns_labels) for t in required)
        for term in required:
            ra_rows[ci].append((topo_row(term.topology_key), _sel_row_for(term, pod)))
        for term in aff.pod_anti_affinity_required:
            rn_rows[ci].append((topo_row(term.topology_key), _sel_row_for(term, pod)))
            if term_matches_pod(term, pod, pod, ns_labels):
                class_rn_self[ci] = True
        for wt in aff.pod_affinity_preferred:
            pp_rows[ci].append((topo_row(wt.term.topology_key),
                                _sel_row_for(wt.term, pod), wt.weight))
        for wt in aff.pod_anti_affinity_preferred:
            pp_rows[ci].append((topo_row(wt.term.topology_key),
                                _sel_row_for(wt.term, pod), -wt.weight))

    # ---- holder groups -----------------------------------------------------
    # group key -> (index, representative (term, source_pod))
    grp_idx: Dict[tuple, int] = {}
    grp_reps: List[Tuple[object, Pod]] = []
    grp_kinds: List[str] = []
    grp_weights: List[int] = []
    grp_topo: List[int] = []
    count_rows: List[Dict[int, int]] = []  # node idx -> count, per group

    def group_row(kind: str, term, source_pod: Pod, weight: int) -> int:
        eff = effective_selector(term, source_pod)
        key = (kind, term.topology_key,
               _term_ns_canon(term, source_pod.metadata.namespace), repr(eff), weight)
        gi = grp_idx.get(key)
        if gi is None:
            gi = len(grp_reps)
            grp_idx[key] = gi
            grp_reps.append((term, source_pod))
            grp_kinds.append(kind)
            grp_weights.append(weight)
            grp_topo.append(topo_row(term.topology_key))
            count_rows.append({})
        return gi

    def pod_groups(pod_info_or_pod, get) -> List[int]:
        """Group rows for one pod's own terms (existing holder or batch class)."""
        out = []
        req_aff, req_anti, pref_aff, pref_anti = get(pod_info_or_pod)
        src = pod_info_or_pod if isinstance(pod_info_or_pod, Pod) else pod_info_or_pod.pod
        for t in req_anti:
            out.append(group_row(_KIND_REQ_ANTI, t, src, 0))
        for wt in pref_aff:
            out.append(group_row(_KIND_PREF_AFF, wt.term, src, wt.weight))
        for wt in pref_anti:
            out.append(group_row(_KIND_PREF_ANTI, wt.term, src, -wt.weight))
        if hard_pod_affinity_weight > 0:
            for t in req_aff:
                out.append(group_row(_KIND_REQ_AFF, t, src, hard_pod_affinity_weight))
        return out

    def _pi_terms(pi):
        return (pi.required_affinity_terms, pi.required_anti_affinity_terms,
                pi.preferred_affinity_terms, pi.preferred_anti_affinity_terms)

    def _pod_terms(p: Pod):
        aff = p.spec.affinity
        if aff is None:
            return ((), (), (), ())
        return (tuple(aff.pod_affinity_required), tuple(aff.pod_anti_affinity_required),
                tuple(aff.pod_affinity_preferred), tuple(aff.pod_anti_affinity_preferred))

    # existing pods with any affinity term seed the counts
    for ni in snapshot.node_info_list:
        nidx = node_name_to_idx[ni.node.metadata.name]
        for pi in ni.pods_with_affinity:
            for gi in pod_groups(pi, _pi_terms):
                count_rows[gi][nidx] = count_rows[gi].get(nidx, 0) + 1

    # batch classes register their groups (zero-seeded) for in-batch dynamics
    class_grp_rows: List[List[int]] = []
    for pod in rep_pods:
        class_grp_rows.append(pod_groups(pod, _pod_terms))

    g = len(grp_reps)
    grp_count = np.zeros((g, n_nodes), dtype=np.int32)
    for gi, row in enumerate(count_rows):
        for nidx, cnt in row.items():
            grp_count[gi, nidx] = cnt
    class_holds_grp = np.zeros((c, max(g, 1)), dtype=np.int32)
    for ci, rows in enumerate(class_grp_rows):
        for gi in rows:
            class_holds_grp[ci, gi] += 1

    # ---- per-class matching against group representatives ------------------
    # a group is relevant to class c only if its representative term matches
    # the class's rep pod; per-class index lists keep the device tables tight
    ea_lists: List[List[int]] = [[] for _ in range(c)]
    sym_lists: List[List[Tuple[int, int]]] = [[] for _ in range(c)]
    for gi in range(g):
        term, src = grp_reps[gi]
        for ci, pod in enumerate(rep_pods):
            if term_matches_pod(term, src, pod, ns_labels):
                if grp_kinds[gi] == _KIND_REQ_ANTI:
                    ea_lists[ci].append(gi)
                else:
                    sym_lists[ci].append((gi, grp_weights[gi]))

    def pad2(rows_per_class, width):
        """[[tuple...]] -> `width` arrays [C, m], -1/0-padded."""
        m = max((len(r) for r in rows_per_class), default=0)
        m = max(m, 1)
        out = [np.full((c, m), -1 if i < max(width - 1, 1) else 0, dtype=np.int32)
               for i in range(width)]
        # weights (last column of width-3 tables) pad with 0; keys/sels with -1
        for ci, rows in enumerate(rows_per_class):
            for j, row in enumerate(rows):
                vals = row if isinstance(row, tuple) else (row,)
                for i, v in enumerate(vals):
                    out[i][ci, j] = v
        return out

    ra_key_c, ra_sel_c = pad2(ra_rows, 2)
    rn_key_c, rn_sel_c = pad2(rn_rows, 2)
    pp_key_c, pp_sel_c, pp_w_c = pad2(pp_rows, 3)
    (ea_grp_c,) = pad2(ea_lists, 1)
    sym_grp_c, sym_w_c = pad2(sym_lists, 2)

    return IPATensors(
        ra_key=ra_key_c, ra_sel=ra_sel_c,
        rn_key=rn_key_c, rn_sel=rn_sel_c,
        pp_key=pp_key_c, pp_sel=pp_sel_c, pp_weight=pp_w_c,
        grp_key=np.array(grp_topo, dtype=np.int32),
        grp_count=grp_count,
        class_holds_grp=class_holds_grp,
        ea_grp=ea_grp_c,
        sym_grp=sym_grp_c, sym_weight=sym_w_c,
        class_self_ok=class_self_ok,
        class_has_ra=class_has_ra,
        class_rn_self=class_rn_self,
    )
