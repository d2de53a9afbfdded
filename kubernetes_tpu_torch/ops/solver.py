"""The greedy-scan batch solver over the pods x nodes tensors.

The counterpart of `kubernetes_tpu/ops/solver.py` (reference:
pkg/scheduler/schedule_one.go:65,754 — the per-pod prioritizeNodes loop).
`greedy_scan_solve` walks the priority-ordered pod batch; each step runs all
filters and scores vectorized over nodes, takes the argmax (lowest index on
ties) and commits the pod into the carried capacity/spread state. Same
order, same integer formulas, same tie-break as the serial oracle, so parity
is exact.

Two implementations of the same function:
  greedy_scan_solve_plain  plain PyTorch: a Python loop over pods, each
                           step vectorized over nodes; the per-class term
                           tables (vmap in the JAX version) become explicit
                           loops over the class's active terms.
  kernel A                 csrc/greedy_scan.cu, one cluster launch per
                           batch (ops/kernels.py launch_greedy_scan).
`greedy_scan_solve` sends CPU tensors to the plain version and CUDA tensors
to the kernel; it never falls back from one to the other.

All arithmetic is int32 (Go's integer score math, JAX's 32-bit mode) except
BalancedAllocation and the PTS ScheduleAnyway weights (float32). Torch's
default int64 must never slip in: every reduction states its dtype.

Score composition: default weights (default_plugins.go:30): Fit(Least)x1 +
Balancedx1 + NodeAffinityx2(norm) + TaintTolerationx3(rev-norm) +
PodTopologySpreadx2 + InterPodAffinityx2 + ImageLocalityx1 (+ gang bonus).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..scheduler.framework import MAX_NODE_SCORE

INT_MIN = -(2**31) + 1  # the masked score of an infeasible node


class SolverInputs(NamedTuple):
    """Device-resident view of ClusterTensors + PodBatchTensors (torch)."""

    # node state
    alloc: torch.Tensor  # [N, R] int32
    used: torch.Tensor  # [N, R]
    used_nz: torch.Tensor  # [N, R]
    pod_count: torch.Tensor  # [N]
    max_pods: torch.Tensor  # [N]
    # class tables
    filter_ok: torch.Tensor  # [C, N] bool
    aff_ok: torch.Tensor  # [C, N] bool
    napref_raw: torch.Tensor  # [C, N] int32
    has_napref: torch.Tensor  # [C] bool
    taint_cnt: torch.Tensor  # [C, N] int32
    img_score: torch.Tensor  # [C, N] int32
    class_ports: torch.Tensor  # [C, Pt] bool
    node_ports: torch.Tensor  # [N, Pt] bool (existing usage; dynamic state seeds)
    # topology
    topo_id: torch.Tensor  # [Kk, N] int32
    selcls_count: torch.Tensor  # [SC, N] int32
    class_matches_selcls: torch.Tensor  # [C, SC] int32
    # constraints (padded to >=1 with class=-1 sentinels)
    ct_class: torch.Tensor
    ct_key: torch.Tensor
    ct_sel: torch.Tensor
    ct_max_skew: torch.Tensor
    ct_min_domains: torch.Tensor
    ct_self_match: torch.Tensor
    st_class: torch.Tensor
    st_key: torch.Tensor
    st_sel: torch.Tensor
    st_max_skew: torch.Tensor
    st_self_match: torch.Tensor
    # inter-pod affinity (snapshot/ipa.py; per-class padded tables, -1 pads)
    ra_key: torch.Tensor  # [C, RAm] incoming required affinity
    ra_sel: torch.Tensor
    rn_key: torch.Tensor  # [C, RNm] incoming required anti-affinity
    rn_sel: torch.Tensor
    pp_key: torch.Tensor  # [C, PPm] incoming preferred
    pp_sel: torch.Tensor
    pp_weight: torch.Tensor  # [C, PPm] signed, 0 pads
    grp_key: torch.Tensor  # [G] topo row per holder group
    grp_count: torch.Tensor  # [G, N] existing holders per node (dyn seed)
    class_holds_grp: torch.Tensor  # [C, G]
    ea_grp: torch.Tensor  # [C, Em] required-anti groups matching the class
    sym_grp: torch.Tensor  # [C, Sm] symmetric score groups matching the class
    sym_weight: torch.Tensor  # [C, Sm] signed, 0 pads
    class_self_ok: torch.Tensor  # [C] bool
    class_has_ra: torch.Tensor  # [C] bool
    # pod batch
    req: torch.Tensor  # [P, R]
    req_nz: torch.Tensor  # [P, R]
    class_of_pod: torch.Tensor  # [P]
    balanced_active: torch.Tensor  # [P] bool
    # gang slice-packing bonus, None for gang-free batches (has_gang gate)
    gang_bonus: Optional[torch.Tensor] = None  # [C, N] int32


# dtype of every SolverInputs field: int32 and bool exactly where JAX has them
BOOL_FIELDS = frozenset({"filter_ok", "aff_ok", "has_napref", "class_ports", "node_ports",
                         "class_self_ok", "class_has_ra", "balanced_active"})
FIELD_DTYPES = {f: (torch.bool if f in BOOL_FIELDS else torch.int32)
                for f in SolverInputs._fields}


def resolve_device(device="cuda") -> torch.device:
    """The port's device rule: "cuda" (the default everywhere) needs a card
    and raises without one; the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is "
                               "false; pass device='cpu' to run the plain versions")
        if dev.index is None:  # tensors report their index: compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device, dtype: torch.dtype) -> torch.Tensor:
    """A private, contiguous copy of a host array on `device`, cast to dtype
    (int64 -> int32 wraps, as jnp.asarray does in 32-bit mode)."""
    np_dtype = np.bool_ if dtype == torch.bool else np.int32
    host = torch.from_numpy(np.array(a, dtype=np_dtype, copy=True, order="C"))
    return host.to(device)


def _pad_ct(*arrays):
    """Constraint arrays padded to >= 1 row (class -1 never matches)."""
    if np.asarray(arrays[0]).size:
        return list(arrays)
    return [np.full(1, -1, np.int32)] + [np.zeros(1, np.int32) for _ in arrays[1:]]


def make_inputs(cluster, batch, device="cuda", views=None) -> Tuple[SolverInputs, int]:
    """numpy -> device tensors. Returns (inputs, d_max).

    views, when given, is TensorCache.device_views' dict of device-resident
    mirrors (alloc/used/used_nz/pod_count/max_pods, selcls_count) maintained
    by kernel B — those fields skip the upload here."""
    device = resolve_device(device)
    views = views or {}
    n = cluster.n
    t = batch.tables
    topo_id = cluster.topo_id if cluster.topo_id.size else np.full((1, n), -1, np.int32)
    selcls = cluster.selcls_count if cluster.selcls_count.size else np.zeros((1, n), np.int32)
    cms = batch.class_matches_selcls
    if cms.shape[1] == 0:
        cms = np.zeros((cms.shape[0], 1), np.int32)
    d_max = int(cluster.num_domains.max()) if cluster.num_domains.size else 1
    ct = _pad_ct(batch.ct_class, batch.ct_key, batch.ct_sel, batch.ct_max_skew,
                 batch.ct_min_domains, batch.ct_self_match)
    st = _pad_ct(batch.st_class, batch.st_key, batch.st_sel, batch.st_max_skew,
                 batch.st_self_match)
    ipa = batch.ipa
    g = max(ipa.grp_key.size, 1)
    if ipa.class_holds_grp.shape[1] != g:
        raise ValueError(f"class_holds_grp width {ipa.class_holds_grp.shape[1]} != {g}")
    host = dict(
        alloc=cluster.alloc, used=cluster.used, used_nz=cluster.used_nz,
        pod_count=cluster.pod_count, max_pods=cluster.max_pods,
        filter_ok=t.filter_ok, aff_ok=t.aff_ok, napref_raw=t.napref_raw,
        has_napref=t.has_napref, taint_cnt=t.taint_cnt, img_score=t.img_score,
        class_ports=t.class_ports, node_ports=t.node_ports,
        topo_id=topo_id, selcls_count=selcls, class_matches_selcls=cms,
        ct_class=ct[0], ct_key=ct[1], ct_sel=ct[2], ct_max_skew=ct[3],
        ct_min_domains=ct[4], ct_self_match=ct[5],
        st_class=st[0], st_key=st[1], st_sel=st[2], st_max_skew=st[3],
        st_self_match=st[4],
        ra_key=ipa.ra_key, ra_sel=ipa.ra_sel, rn_key=ipa.rn_key, rn_sel=ipa.rn_sel,
        pp_key=ipa.pp_key, pp_sel=ipa.pp_sel, pp_weight=ipa.pp_weight,
        grp_key=ipa.grp_key if ipa.grp_key.size else np.zeros(1, np.int32),
        grp_count=ipa.grp_count if ipa.grp_count.size else np.zeros((1, n), np.int32),
        class_holds_grp=ipa.class_holds_grp, ea_grp=ipa.ea_grp,
        sym_grp=ipa.sym_grp, sym_weight=ipa.sym_weight,
        class_self_ok=ipa.class_self_ok, class_has_ra=ipa.class_has_ra,
        req=batch.req, req_nz=batch.req_nz, class_of_pod=batch.class_of_pod,
        balanced_active=batch.balanced_active, gang_bonus=batch.gang_bonus,
    )
    fields = {}
    for name, dtype in FIELD_DTYPES.items():
        got = views.get(name)
        if got is not None:
            fields[name] = got
        elif host[name] is not None:
            fields[name] = to_device(host[name], device, dtype)
        else:
            fields[name] = None
    return SolverInputs(**fields), d_max


# ---------------------------------------------------------------------------
# vectorized plugin pieces (each mirrors a serial plugin formula exactly)
# ---------------------------------------------------------------------------


def fit_feasible(alloc, used, pod_count, max_pods, req):
    """NodeResourcesFit Filter (fit.go:499): req <= alloc - used per resource
    (zero requests always fit) AND pod count headroom."""
    ok = ((req[None, :] == 0) | (req[None, :] <= alloc - used)).all(dim=1)
    return ok & (pod_count + 1 <= max_pods)


def least_allocated_score(alloc2, used2, req2):
    """leastResourceScorer over cpu+memory (least_allocated.go:30), int math."""
    u = used2 + req2[None, :]
    pos = alloc2 > 0
    per = torch.where(pos & (u <= alloc2),
                      (alloc2 - u) * MAX_NODE_SCORE // alloc2.clamp(min=1), 0)
    wsum = pos.sum(dim=1, dtype=torch.int32).clamp(min=1)
    return (per * pos).sum(dim=1, dtype=torch.int32) // wsum


def balanced_score(alloc2, used2, req2, active):
    """balancedResourceScorer 2-resource shortcut (balanced_allocation.go:145),
    float32 like the JAX version."""
    u = (used2 + req2[None, :]).to(torch.float32)
    a = alloc2.to(torch.float32)
    frac = torch.where(a > 0, torch.clamp(u / a.clamp(min=1.0), max=1.0), 0.0)
    n_frac = (a > 0).sum(dim=1, dtype=torch.int32)
    std2 = (frac[:, 0] - frac[:, 1]).abs() / 2.0
    std = torch.where(n_frac == 2, std2, 0.0)
    score = ((1.0 - std) * MAX_NODE_SCORE).to(torch.int32)
    return torch.where(active, score, 0)


def default_normalize(raw, feasible, reverse: bool):
    """DefaultNormalizeScore over the feasible (scored) set (normalize_score.go)."""
    mx = torch.where(feasible, raw, 0).max()
    scaled = torch.where(mx > 0, MAX_NODE_SCORE * raw // mx.clamp(min=1), 0)
    if reverse:
        return torch.where(mx > 0, MAX_NODE_SCORE - scaled, MAX_NODE_SCORE)
    return scaled


def _segment_sum(per_node, topo_row, d_max):
    """[d_max] per-domain sums of per_node over nodes carrying the key."""
    has = topo_row >= 0
    seg = torch.where(has, topo_row, d_max).long()
    dom = torch.zeros(d_max + 1, dtype=torch.int32, device=per_node.device)
    dom.index_add_(0, seg, torch.where(has, per_node, 0).to(torch.int32))
    return dom[:d_max]


def _per_node(dom, topo_row, d_max):
    """Each node's view of its domain's value (0 where the key is missing)."""
    return torch.where(topo_row >= 0, dom[topo_row.clamp(0, d_max - 1).long()], 0)


def pts_counts(aff_row, dyn_selcls, topo_row, sel_idx, d_max):
    """Per-domain matching-pod counts for one constraint over counting-
    eligible nodes (filtering.go calPreFilterState)."""
    per_node = torch.where(aff_row & (topo_row >= 0), dyn_selcls[sel_idx], 0)
    return _segment_sum(per_node, topo_row, d_max)


def pts_domain_valid(aff_row, topo_row, d_max):
    """[d_max] bool: the domain holds at least one eligible node."""
    has = (aff_row & (topo_row >= 0)).to(torch.int32)
    return _segment_sum(has, topo_row, d_max) > 0


def _dom_node_count(per_node, topo_row, d_max):
    """Per-node view of the node's topology-domain total of `per_node`
    (nodes missing the key read 0)."""
    return _per_node(_segment_sum(per_node, topo_row, d_max), topo_row, d_max)


def pod_row_feasibility_score(inp: SolverInputs, req, req_nz, cls, bal_active):
    """F[N] bool, C[N] int32 for one pod row against the *initial* snapshot
    state (no intra-batch dynamics): filter_ok, fit, the node/class port
    conflict; LeastAllocated + Balanced + 2 NodeAffinity + 3 TaintToleration
    + ImageLocality (default_plugins.go:30, minus the dynamic PTS/IPA terms,
    whose batches callers route to the scan). The plain version of one row
    of kernel J (reference ops/solver.py:238)."""
    cls = max(int(cls), 0)
    feas = inp.filter_ok[cls].clone()
    feas &= fit_feasible(inp.alloc, inp.used, inp.pod_count, inp.max_pods, req)
    feas &= ~(inp.node_ports & inp.class_ports[cls][None, :]).any(dim=1)
    alloc2 = inp.alloc[:, :2]
    least = least_allocated_score(alloc2, inp.used_nz[:, :2], req_nz[:2])
    bal = balanced_score(alloc2, inp.used[:, :2], req[:2], bal_active)
    napref = torch.where(inp.has_napref[cls],
                         default_normalize(inp.napref_raw[cls], feas, reverse=False), 0)
    taint = default_normalize(inp.taint_cnt[cls], feas, reverse=True)
    total = least + bal + 2 * napref + 3 * taint + inp.img_score[cls]
    return feas, total.to(torch.int32)


def feasibility_rows(inp: SolverInputs, reqs, req_nzs, clss, bals):
    """F[Rw, N] bool and C[Rw, N] int32: pod_row_feasibility_score for each
    of Rw rows (the vmap of the reference's feasibility_cost_matrices and
    transport _group_rows). CPU tensors run the plain version; CUDA tensors
    launch kernel J; any other device raises."""
    dev = inp.alloc.device
    if dev.type == "cpu":
        return feasibility_rows_plain(inp, reqs, req_nzs, clss, bals)
    if dev.type == "cuda":
        from .kernels import launch_feasibility_rows

        return launch_feasibility_rows(inp, reqs, req_nzs, clss, bals)
    raise ValueError(f"feasibility_rows: no implementation for device {dev}")


def feasibility_rows_plain(inp: SolverInputs, reqs, req_nzs, clss, bals):
    """Plain PyTorch version of kernel J: one pod_row_feasibility_score per
    row (class ids read on the host once)."""
    n = inp.alloc.shape[0]
    rw = reqs.shape[0]
    feas = torch.empty((rw, n), dtype=torch.bool, device=inp.alloc.device)
    total = torch.empty((rw, n), dtype=torch.int32, device=inp.alloc.device)
    for i, cls in enumerate(clss.tolist()):
        feas[i], total[i] = pod_row_feasibility_score(inp, reqs[i], req_nzs[i], cls, bals[i])
    return feas, total


# ---------------------------------------------------------------------------
# the greedy scan solver
# ---------------------------------------------------------------------------


def greedy_scan_solve(inp: SolverInputs, d_max: int, has_ipa: bool = True,
                      has_ct: bool = True, has_st: bool = True, has_gang: bool = False):
    """Sequential-within-batch greedy assignment. Returns assignment[P] int32
    (node index, -1 unschedulable), the final used [N, R] and pod_count [N].

    CPU tensors run the plain version; CUDA tensors launch kernel A; any
    other device raises. has_ipa / has_ct / has_st / has_gang gate whole
    constraint families off for batches whose tables are empty (True is
    always semantically safe)."""
    dev = inp.alloc.device
    if dev.type == "cpu":
        return greedy_scan_solve_plain(inp, d_max, has_ipa, has_ct, has_st, has_gang)
    if dev.type == "cuda":
        from .kernels import launch_greedy_scan

        return launch_greedy_scan(inp, d_max, has_ipa, has_ct, has_st, has_gang)
    raise ValueError(f"greedy_scan_solve: no implementation for device {dev}")


def scan_class_rows(inp: SolverInputs, has_gang: bool = False):
    """Kernel A's per-class inputs, computed once per launch by its wrapper.

    rows [C, N, 4] int32: filter_ok, napref_raw, taint_cnt and img_score
    (plus gang_bonus when has_gang, a wrapping int32 sum: the two are only
    ever added into the total), so one 16-byte copy stages a node's class
    row. flags [C] int32: 1 = the class's preferred node affinity needs its
    max over the feasible set (has_napref and a positive entry), 2 = the
    taint row has a positive entry (else mx_taint is 0 whatever the
    feasible set), 4 = the class has a preferred or symmetric IPA term
    (else its IPA score is 0)."""
    img = inp.img_score + inp.gang_bonus if has_gang else inp.img_score
    rows = torch.stack([inp.filter_ok.to(torch.int32), inp.napref_raw, inp.taint_cnt,
                        img.to(torch.int32)], dim=-1).contiguous()
    napref = inp.has_napref & (inp.napref_raw > 0).any(dim=1)
    taint = (inp.taint_cnt > 0).any(dim=1)
    ipa = (inp.pp_key >= 0).any(dim=1) | (inp.sym_grp >= 0).any(dim=1)
    flags = (napref.to(torch.int32) | (taint.to(torch.int32) << 1)
             | (ipa.to(torch.int32) << 2))
    return rows, flags


def scan_key_domains(topo_id: torch.Tensor) -> torch.Tensor:
    """[Kk] int32: 1 + the largest domain id of each topology key (0 for a
    key no node carries), so kernel A scans only a key's own domains."""
    return (topo_id.max(dim=1).values + 1).clamp(min=0).to(torch.int32)


def greedy_scan_solve_plain(inp: SolverInputs, d_max: int, has_ipa: bool = True,
                            has_ct: bool = True, has_st: bool = True,
                            has_gang: bool = False):
    """Plain PyTorch version of kernel A (the reference the kernel is held
    against on the card, and the CPU path of greedy_scan_solve). Per-pod
    branching uses host copies of the small per-class tables, so the loop
    issues no device->host synchronization."""
    n = inp.alloc.shape[0]
    dev = inp.alloc.device
    used = inp.used.clone()
    used_nz = inp.used_nz.clone()
    pod_count = inp.pod_count.clone()
    dyn_selcls = inp.selcls_count.clone()
    dyn_grp = inp.grp_count.clone()
    port_used = inp.node_ports.clone()
    p_total = inp.req.shape[0]
    assignment = torch.empty(p_total, dtype=torch.int32, device=dev)
    arange = torch.arange(n, device=dev)

    h = {f: getattr(inp, f).tolist() for f in (
        "class_of_pod", "has_napref", "ct_class", "ct_key", "ct_sel", "ct_max_skew",
        "ct_min_domains", "ct_self_match", "st_class", "st_key", "st_sel",
        "st_max_skew", "ra_key", "ra_sel", "rn_key", "rn_sel", "pp_key", "pp_sel",
        "pp_weight", "grp_key", "ea_grp", "sym_grp", "sym_weight", "class_self_ok",
        "class_has_ra")}
    alloc2 = inp.alloc[:, :2]

    for p in range(p_total):
        cls = max(h["class_of_pod"][p], 0)
        req, req_nz = inp.req[p], inp.req_nz[p]

        feas = inp.filter_ok[cls].clone()
        feas &= fit_feasible(inp.alloc, used, pod_count, inp.max_pods, req)
        # NodePorts (node_ports.go), dynamic: in-batch placements claim ports
        feas &= ~(port_used & inp.class_ports[cls][None, :]).any(dim=1)
        aff_row = inp.aff_ok[cls]

        if has_ipa:
            # rule 1: existing/placed holders' required anti-affinity
            for g in h["ea_grp"][cls]:
                if g < 0:
                    continue
                topo_row = inp.topo_id[h["grp_key"][g]]
                cnt = _dom_node_count(dyn_grp[g], topo_row, d_max)
                feas &= (topo_row < 0) | (cnt == 0)
            # rule 2: incoming required affinity, with the first-pod
            # exception (no matching pod anywhere, pod matches itself)
            if h["class_has_ra"][cls]:
                pos_all = torch.ones(n, dtype=torch.bool, device=dev)
                keys_all = torch.ones(n, dtype=torch.bool, device=dev)
                glob0_all = torch.ones((), dtype=torch.bool, device=dev)
                for k_, s_ in zip(h["ra_key"][cls], h["ra_sel"][cls]):
                    if k_ < 0:
                        continue
                    s_ = max(s_, 0)
                    topo_row = inp.topo_id[k_]
                    cnt = _dom_node_count(dyn_selcls[s_], topo_row, d_max)
                    has_key = topo_row >= 0
                    glob = torch.where(has_key, dyn_selcls[s_], 0).sum(dtype=torch.int32)
                    pos_all &= has_key & (cnt > 0)
                    keys_all &= has_key
                    glob0_all &= glob == 0
                feas &= keys_all & (pos_all | (glob0_all & bool(h["class_self_ok"][cls])))
            # rule 3: incoming required anti-affinity
            for k_, s_ in zip(h["rn_key"][cls], h["rn_sel"][cls]):
                if k_ < 0:
                    continue
                topo_row = inp.topo_id[k_]
                cnt = _dom_node_count(dyn_selcls[max(s_, 0)], topo_row, d_max)
                feas &= (topo_row < 0) | (cnt == 0)

        if has_ct:
            # PodTopologySpread DoNotSchedule (filtering.go:340)
            for c, c_cls in enumerate(h["ct_class"]):
                if c_cls != cls:
                    continue
                topo_row = inp.topo_id[h["ct_key"][c]]
                dc = pts_counts(aff_row, dyn_selcls, topo_row, h["ct_sel"][c], d_max)
                valid = pts_domain_valid(aff_row, topo_row, d_max)
                n_valid = valid.sum(dtype=torch.int32)
                mmn = torch.where(valid, dc, 2**30).min()
                mind = h["ct_min_domains"][c]
                mmn = torch.where((mind > 0) & (mind > n_valid), 0, mmn)
                mmn = torch.where(n_valid == 0, 0, mmn)
                node_dc = _per_node(dc, topo_row, d_max)
                skew = node_dc + h["ct_self_match"][c] - mmn
                feas &= (topo_row >= 0) & (skew <= h["ct_max_skew"][c])

        # --- scores ---
        least = least_allocated_score(alloc2, used_nz[:, :2], req_nz[:2])
        bal = balanced_score(alloc2, used[:, :2], req[:2], inp.balanced_active[p])
        napref = (default_normalize(inp.napref_raw[cls], feas, reverse=False)
                  if h["has_napref"][cls] else 0)
        taint = default_normalize(inp.taint_cnt[cls], feas, reverse=True)
        img = inp.img_score[cls]

        pts = 0
        if has_st:
            # PTS ScheduleAnyway score (scoring.go)
            st_sum = torch.zeros(n, dtype=torch.float32, device=dev)
            ignored = torch.zeros(n, dtype=torch.bool, device=dev)
            any_st = False
            for c, c_cls in enumerate(h["st_class"]):
                if c_cls != cls:
                    continue
                any_st = True
                topo_row = inp.topo_id[h["st_key"][c]]
                dc = pts_counts(aff_row, dyn_selcls, topo_row, h["st_sel"][c], d_max)
                # domain set/size from the *feasible* nodes (initPreScoreState)
                size = pts_domain_valid(feas, topo_row, d_max).sum(dtype=torch.int32)
                w = torch.log(size.to(torch.float32) + 2.0)
                node_dc = _per_node(dc, topo_row, d_max)
                # two rounded ops, never a fused multiply-add
                st_sum = st_sum + (node_dc.to(torch.float32) * w
                                   + float(h["st_max_skew"][c] - 1))
                # nodes missing the topology key are "IgnoredNodes"
                ignored |= topo_row < 0
            if any_st:
                pts_raw = torch.round(st_sum).to(torch.int32)  # half to even
                norm_mask = feas & ~ignored
                pmx = torch.where(norm_mask, pts_raw, -(2**30)).max()
                pmn = torch.where(norm_mask, pts_raw, 2**30).min()
                pts = torch.where(
                    pmx > 0,
                    MAX_NODE_SCORE * (pmx + pmn - pts_raw) // pmx.clamp(min=1),
                    MAX_NODE_SCORE)
                pts = torch.where(~ignored & norm_mask.any(), pts, 0)

        ipa_score = 0
        if has_ipa:
            # InterPodAffinity Score (scoring.go): incoming preferred terms
            # plus the symmetric terms of existing/placed pods
            ipa_raw = torch.zeros(n, dtype=torch.int32, device=dev)
            for k_, s_, w_ in zip(h["pp_key"][cls], h["pp_sel"][cls], h["pp_weight"][cls]):
                if k_ < 0:
                    continue
                cnt = _dom_node_count(dyn_selcls[max(s_, 0)], inp.topo_id[k_], d_max)
                ipa_raw += w_ * cnt
            for g, w_ in zip(h["sym_grp"][cls], h["sym_weight"][cls]):
                if g < 0:
                    continue
                cnt = _dom_node_count(dyn_grp[g], inp.topo_id[h["grp_key"][g]], d_max)
                ipa_raw += w_ * cnt
            imx = torch.where(feas, ipa_raw, -(2**30)).max()
            imn = torch.where(feas, ipa_raw, 2**30).min()
            idiff = imx - imn
            ipa_score = torch.where(
                feas & (idiff > 0),
                (MAX_NODE_SCORE * (ipa_raw - imn)) // idiff.clamp(min=1), 0)

        total = least + bal + 2 * napref + 3 * taint + 2 * pts + 2 * ipa_score + img
        if has_gang:
            total = total + inp.gang_bonus[cls]

        # --- selectHost: argmax, lowest index on ties ---
        masked = torch.where(feas, total.to(torch.int32), INT_MIN)
        best = torch.argmax(masked)
        ok = feas[best]
        assignment[p] = torch.where(ok, best, -1)

        # --- commit ---
        hit = (arange == best) & ok
        hit_i = hit.to(torch.int32)
        used += hit_i[:, None] * req[None, :]
        used_nz += hit_i[:, None] * req_nz[None, :]
        pod_count += hit_i
        dyn_selcls += inp.class_matches_selcls[cls][:, None] * hit_i[None, :]
        dyn_grp += inp.class_holds_grp[cls][:, None] * hit_i[None, :]
        port_used |= hit[:, None] & inp.class_ports[cls][None, :]

    return assignment, used, pod_count
