"""Compile pod equivalence classes x nodes into dense numpy predicate/score tables.

The dense reframing of the per-pod plugin loop (SURVEY.md §7 step 4): pods sharing
scheduling-relevant spec (selectors, affinity, tolerations, ports, images,
namespace) form an *equivalence class*; every class x node predicate that does
not depend on batch dynamics is evaluated once, vectorized over the node axis
with dictionary-encoded label columns. The per-pod x node device kernel then
just gathers class rows.

Static per class x node (this module, host numpy):
  - filter_ok: NodeName + NodeUnschedulable + NodeAffinity/selector +
    TaintToleration + NodePorts (reference filter semantics of
    nodename/node_name.go, nodeunschedulable, nodeaffinity, tainttoleration,
    nodeports — see scheduler/plugins for the per-formula citations)
  - node-affinity preferred raw weights (nodeaffinity Score)
  - intolerable PreferNoSchedule taint counts (tainttoleration Score)
  - ImageLocality final score (static: image states don't change intra-batch)

Dynamic (device, ops/): resource fit, least-allocated/balanced scores,
topology-spread counts, inter-pod affinity counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..api import Pod
from ..api.labels import DOES_NOT_EXIST, EXISTS, GT, IN, LT, NOT_IN
from ..api.types import (
    POD_GROUP_RANK_LABEL,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
)
from ..scheduler.framework import MAX_NODE_SCORE, NodeInfo

# ImageLocality thresholds (image_locality.go:36-40)
IMAGE_MIN_THRESHOLD = 23 * 1024 * 1024
IMAGE_MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024


def _normalized_image_name(name: str) -> str:
    """Image name with the implicit ":latest" tag (image_locality.go)."""
    if name.rfind(":") <= name.rfind("/"):
        name += ":latest"
    return name


class NodeColumns:
    """Columnar, dictionary-encoded node attributes (the L0->tensor bridge)."""

    def __init__(self, node_infos: Sequence[NodeInfo]):
        self.node_infos = list(node_infos)
        self.names = [ni.node.metadata.name for ni in self.node_infos]
        self.n = len(self.names)
        self.name_to_idx = {nm: i for i, nm in enumerate(self.names)}
        # per-label-key value ids: key -> (value_vocab dict, int32[N] ids, -1 absent)
        self._val_ids: Dict[str, Tuple[Dict[str, int], np.ndarray]] = {}
        self._numeric: Dict[str, np.ndarray] = {}
        self.unschedulable = np.array(
            [ni.node.spec.unschedulable for ni in self.node_infos], dtype=bool
        )
        # taint vocab: (key, value, effect) -> id
        self.taint_vocab: Dict[Tuple[str, str, str], int] = {}
        taints_per_node = []
        for ni in self.node_infos:
            ids = []
            for t in ni.node.spec.taints:
                k = (t.key, t.value, t.effect)
                if k not in self.taint_vocab:
                    self.taint_vocab[k] = len(self.taint_vocab)
                ids.append(self.taint_vocab[k])
            taints_per_node.append(ids)
        self.taint_matrix = np.zeros((self.n, max(len(self.taint_vocab), 1)), dtype=bool)
        for i, ids in enumerate(taints_per_node):
            for t in ids:
                self.taint_matrix[i, t] = True
        # port vocab: (proto, port) -> id (hostIP-specific matching is collapsed:
        # any same proto+port conflicts — conservative vs nodeports' hostIP rule)
        self.port_vocab: Dict[Tuple[str, int], int] = {}
        port_rows = []
        for ni in self.node_infos:
            row = set()
            for (ip, proto, port) in ni.used_ports:
                k = (proto, port)
                if k not in self.port_vocab:
                    self.port_vocab[k] = len(self.port_vocab)
                row.add(self.port_vocab[k])
            port_rows.append(row)
        self.port_matrix = np.zeros((self.n, max(len(self.port_vocab), 1)), dtype=bool)
        for i, row in enumerate(port_rows):
            for p in row:
                self.port_matrix[i, p] = True
        # image vocab
        self.image_vocab: Dict[str, int] = {}
        entries = {}
        for ni in self.node_infos:
            for nm, st in ni.image_states.items():
                if nm not in self.image_vocab:
                    self.image_vocab[nm] = len(self.image_vocab)
                entries[nm] = st
        ni_count = max(len(self.image_vocab), 1)
        self.image_matrix = np.zeros((self.n, ni_count), dtype=bool)
        self.image_value = np.zeros(ni_count, dtype=np.int64)
        for nm, idx in self.image_vocab.items():
            st = entries[nm]
            # scaledImageScore: int64(size * numNodes/totalNodes) (image_locality.go:111)
            self.image_value[idx] = int(st.size * st.num_nodes / self.n) if self.n else 0
        for i, ni in enumerate(self.node_infos):
            for nm in ni.image_states:
                self.image_matrix[i, self.image_vocab[nm]] = True

    def val_ids(self, key: str) -> Tuple[Dict[str, int], np.ndarray]:
        got = self._val_ids.get(key)
        if got is None:
            vocab: Dict[str, int] = {}
            ids = np.full(self.n, -1, dtype=np.int32)
            for i, ni in enumerate(self.node_infos):
                v = ni.node.metadata.labels.get(key)
                if v is not None:
                    if v not in vocab:
                        vocab[v] = len(vocab)
                    ids[i] = vocab[v]
            got = (vocab, ids)
            self._val_ids[key] = got
        return got

    def numeric(self, key: str) -> np.ndarray:
        got = self._numeric.get(key)
        if got is None:
            vals = np.full(self.n, np.nan)
            for i, ni in enumerate(self.node_infos):
                v = ni.node.metadata.labels.get(key)
                if v is not None:
                    try:
                        vals[i] = int(v)
                    except ValueError:
                        pass
            got = vals
            self._numeric[key] = got
        return got

    # -- requirement/selector vectorization ------------------------------------

    def match_requirement(self, req) -> np.ndarray:
        """Vectorized Requirement.matches over all nodes' labels."""
        if req.op in (IN, NOT_IN):
            vocab, ids = self.val_ids(req.key)
            wanted = np.array([vocab[v] for v in req.values if v in vocab], dtype=np.int32)
            hit = np.isin(ids, wanted) if wanted.size else np.zeros(self.n, dtype=bool)
            return hit if req.op == IN else ~hit  # NotIn matches absent keys too
        if req.op == EXISTS:
            _, ids = self.val_ids(req.key)
            return ids != -1
        if req.op == DOES_NOT_EXIST:
            _, ids = self.val_ids(req.key)
            return ids == -1
        if req.op in (GT, LT):
            if len(req.values) != 1:
                return np.zeros(self.n, dtype=bool)
            try:
                rhs = int(req.values[0])
            except ValueError:
                return np.zeros(self.n, dtype=bool)
            vals = self.numeric(req.key)
            with np.errstate(invalid="ignore"):
                return (vals > rhs) if req.op == GT else (vals < rhs)
        raise ValueError(f"unknown op {req.op}")

    def match_field_requirement(self, req) -> np.ndarray:
        if req.key != "metadata.name":
            return np.zeros(self.n, dtype=bool)
        hit = np.isin(np.array(self.names), np.array(list(req.values) or [""]))
        return hit if req.op == IN else ~hit if req.op == NOT_IN else np.zeros(self.n, dtype=bool)

    def match_node_selector_term(self, term) -> np.ndarray:
        if not term.match_expressions and not term.match_fields:
            return np.zeros(self.n, dtype=bool)  # empty term matches nothing
        ok = np.ones(self.n, dtype=bool)
        for r in term.match_expressions:
            ok &= self.match_requirement(r)
        for r in term.match_fields:
            ok &= self.match_field_requirement(r)
        return ok

    def match_node_selector(self, selector) -> np.ndarray:
        ok = np.zeros(self.n, dtype=bool)
        for term in selector.terms:
            ok |= self.match_node_selector_term(term)
        return ok

    def match_required_node_affinity(self, pod: Pod) -> np.ndarray:
        """spec.nodeSelector AND nodeAffinity.required (GetRequiredNodeAffinity)."""
        ok = np.ones(self.n, dtype=bool)
        for k, v in pod.spec.node_selector.items():
            vocab, ids = self.val_ids(k)
            ok &= (ids == vocab[v]) if v in vocab else np.zeros(self.n, dtype=bool)
        aff = pod.spec.affinity
        if aff and aff.node_affinity_required is not None:
            ok &= self.match_node_selector(aff.node_affinity_required)
        return ok


def pod_class_signature(pod: Pod) -> tuple:
    """Scheduling-relevant spec signature; pods with equal signatures schedule
    identically given equal resource requests (the equivalence-class dedupe).

    Hot: called once per pod per batch (100k at north-star scale), so the
    common empty cases (no labels/selector/affinity/constraints) short-circuit
    before any sort/repr work.

    Memoized on the pod (the ~6µs/pod build_pod_batch lever from the ROADMAP
    stage table): the tuple build runs once per pod LIFETIME instead of once
    per batch — re-solves of a churning backlog and requeued gangs hit the
    cache. The entry is keyed by the live spec/labels container identities:
    a spec replacement (queue.update parses a NEW Pod), a clone that swaps
    spec (bind/assume clones), or a labels rebuild all miss and recompute, so
    staleness cannot survive any mutation path the store contract allows."""
    cached = pod.__dict__.get("_class_sig")
    if (cached is not None and cached[0] is pod.spec
            and cached[1] is pod.metadata.labels):
        return cached[2]
    sig = _pod_class_signature(pod)
    pod.__dict__["_class_sig"] = (pod.spec, pod.metadata.labels, sig)
    return sig


def _pod_class_signature(pod: Pod) -> tuple:
    spec = pod.spec
    aff = spec.affinity
    labels = pod.metadata.labels
    any_ports = any(c.ports for c in spec.containers)
    ports = tuple(sorted(
        (p.protocol or "TCP", p.host_port)
        for c in spec.containers for p in c.ports if p.host_port > 0
    )) if any_ports else ()
    any_images = any(c.image for c in spec.containers) or any(
        c.image for c in spec.init_containers)
    images = tuple(sorted(
        c.image for c in list(spec.init_containers) + list(spec.containers) if c.image
    )) if any_images else ()
    # the gang RANK label is positional metadata, not a scheduling
    # constraint (api/podgroup.py POD_GROUP_RANK_LABEL): excluding it keeps
    # a 250-rank gang ONE equivalence class (one filter row, one solver
    # dispatch) — selectors keying on it are unsupported on the batched path
    if labels and POD_GROUP_RANK_LABEL in labels:
        label_sig = tuple(sorted(kv for kv in labels.items()
                                 if kv[0] != POD_GROUP_RANK_LABEL))
    else:
        label_sig = tuple(sorted(labels.items())) if labels else ()
    return (
        pod.metadata.namespace,
        label_sig,
        spec.node_name,
        tuple(sorted(spec.node_selector.items())) if spec.node_selector else (),
        repr(aff) if aff else "",
        tuple(spec.tolerations) if spec.tolerations else (),
        tuple(spec.topology_spread_constraints) if spec.topology_spread_constraints else (),
        ports,
        images,
        len(spec.containers) + len(spec.init_containers),
        tuple(spec.volumes) if spec.volumes else (),
        tuple(spec.resource_claims) if spec.resource_claims else (),
        tuple(spec.resource_claim_templates)
        if spec.resource_claim_templates else (),
    )


@dataclass
class ClassTables:
    """Static class x node tables (numpy, ready for device upload)."""

    rep_pods: List[Pod]  # one representative per class
    filter_ok: np.ndarray  # [C, N] bool
    aff_ok: np.ndarray  # [C, N] bool (nodeSelector+required affinity only — the
    #   PTS counting-eligibility set under the default Honor policy)
    napref_raw: np.ndarray  # [C, N] int32 (node-affinity preferred weight sums)
    has_napref: np.ndarray  # [C] bool
    taint_cnt: np.ndarray  # [C, N] int32 (intolerable PreferNoSchedule counts)
    img_score: np.ndarray  # [C, N] int32 (final ImageLocality score 0..100)
    # host-port state (dynamic on device: in-batch placements claim ports too)
    class_ports: np.ndarray  # [C, Pt] bool — ports each class requests
    node_ports: np.ndarray  # [N, Pt] bool — ports in use by existing pods


def compile_class_tables(rep_pods: Sequence[Pod], cols: NodeColumns) -> ClassTables:
    c, n = len(rep_pods), cols.n
    filter_ok = np.ones((c, n), dtype=bool)
    aff_ok = np.ones((c, n), dtype=bool)
    napref = np.zeros((c, n), dtype=np.int32)
    has_napref = np.zeros(c, dtype=bool)
    taint_cnt = np.zeros((c, n), dtype=np.int32)
    img_score = np.zeros((c, n), dtype=np.int32)

    taint_list = [None] * len(cols.taint_vocab)
    for (k, v, e), i in cols.taint_vocab.items():
        taint_list[i] = (k, v, e)
    hard_taints = np.array(
        [t is not None and t[2] in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE) for t in taint_list],
        dtype=bool,
    ) if taint_list else np.zeros(0, dtype=bool)
    prefer_taints = np.array(
        [t is not None and t[2] == TAINT_PREFER_NO_SCHEDULE for t in taint_list], dtype=bool
    ) if taint_list else np.zeros(0, dtype=bool)

    from ..api import Taint

    for ci, pod in enumerate(rep_pods):
        # NodeName (node_name.go)
        if pod.spec.node_name:
            filter_ok[ci] &= np.array(cols.names) == pod.spec.node_name
        # NodeUnschedulable (node_unschedulable.go)
        fake = Taint(key="node.kubernetes.io/unschedulable", effect=TAINT_NO_SCHEDULE)
        if not any(t.tolerates(fake) for t in pod.spec.tolerations):
            filter_ok[ci] &= ~cols.unschedulable
        # NodeAffinity + nodeSelector
        aff_ok[ci] = cols.match_required_node_affinity(pod)
        filter_ok[ci] &= aff_ok[ci]
        # TaintToleration filter + score
        if len(taint_list):
            tolerated = np.array(
                [t is not None and any(tol.tolerates(Taint(*t)) for tol in pod.spec.tolerations)
                 for t in taint_list],
                dtype=bool,
            )
            untol_hard = cols.taint_matrix[:, hard_taints & ~tolerated]
            filter_ok[ci] &= ~untol_hard.any(axis=1)
            # Score tolerations: only empty-effect or PreferNoSchedule tolerations
            # count (taint_toleration.go:133)
            score_tolerated = np.array(
                [t is not None and any(
                    tol.tolerates(Taint(*t)) for tol in pod.spec.tolerations
                    if tol.effect in ("", TAINT_PREFER_NO_SCHEDULE))
                 for t in taint_list],
                dtype=bool,
            )
            taint_cnt[ci] = cols.taint_matrix[:, prefer_taints & ~score_tolerated].sum(axis=1)
        # NodePorts: vocab registration only — conflicts are checked dynamically
        # on device (in-batch placements claim ports), seeded from existing usage.
        for p_ in {(p.protocol or "TCP", p.host_port)
                   for ctr in pod.spec.containers for p in ctr.ports if p.host_port > 0}:
            if p_ not in cols.port_vocab:
                cols.port_vocab[p_] = len(cols.port_vocab)
        # NodeAffinity preferred score (raw weights; normalized on device per pod)
        aff = pod.spec.affinity
        if aff and aff.node_affinity_preferred:
            has_napref[ci] = True
            acc = np.zeros(n, dtype=np.int32)
            for pref in aff.node_affinity_preferred:
                acc += pref.weight * cols.match_node_selector_term(pref.term).astype(np.int32)
            napref[ci] = acc
        # ImageLocality (static final score, image_locality.go:78)
        images = [c_.image for c_ in list(pod.spec.init_containers) + list(pod.spec.containers)
                  if c_.image]
        num_containers = len(pod.spec.containers) + len(pod.spec.init_containers)
        if images and num_containers and len(cols.image_vocab):
            ids = [cols.image_vocab[_normalized_image_name(im)] for im in images
                   if _normalized_image_name(im) in cols.image_vocab]
            sums = cols.image_matrix[:, ids].astype(np.int64) @ cols.image_value[ids] \
                if ids else np.zeros(n, dtype=np.int64)
            lo = IMAGE_MIN_THRESHOLD
            hi = IMAGE_MAX_CONTAINER_THRESHOLD * num_containers
            sums = np.clip(sums, lo, hi)
            img_score[ci] = (MAX_NODE_SCORE * (sums - lo) // (hi - lo)).astype(np.int32)

    # port tensors sized to the final (nodes + classes) vocab
    pt = max(len(cols.port_vocab), 1)
    class_ports = np.zeros((c, pt), dtype=bool)
    for ci, pod in enumerate(rep_pods):
        for p_ in {(p.protocol or "TCP", p.host_port)
                   for ctr in pod.spec.containers for p in ctr.ports if p.host_port > 0}:
            class_ports[ci, cols.port_vocab[p_]] = True
    node_ports = np.zeros((n, pt), dtype=bool)
    for i, ni in enumerate(cols.node_infos):
        for (ip, proto, port) in ni.used_ports:
            node_ports[i, cols.port_vocab[(proto, port)]] = True

    return ClassTables(
        rep_pods=list(rep_pods),
        filter_ok=filter_ok,
        aff_ok=aff_ok,
        napref_raw=napref,
        has_napref=has_napref,
        taint_cnt=taint_cnt,
        img_score=img_score,
        class_ports=class_ports,
        node_ports=node_ports,
    )
