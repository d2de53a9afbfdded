"""Propose-and-repair constraint solver — constrained batches on the fast path.

The counterpart of `kubernetes_tpu/models/repair.py`. Three phases:

  compile  per-class hard masks and soft penalty rows from the live count
           tensors (selcls_count / grp_count / the PTS tables), in host
           numpy with int64 arithmetic, re-evaluated as groups commit.
  propose  each identical-pod group runs waterfill_group (kernel C on the
           card) with its mask ANDed into the filter row and its penalty
           added to the image row; a self-anti class rides the host-port
           cap (at most one member per node).
  repair   repair_check (kernel D on the card) marks final-state violators;
           up to REPAIR_MAX_ROUNDS rip-and-repropose rounds re-route them;
           what still violates joins the residual, which the exact scan
           (greedy_scan_solve, kernel A on the card) places against the
           committed counts. If the residual leaves a pod unplaced, the
           whole batch re-solves with the full scan, so unschedulable
           verdicts are always the scan's own.

Two implementations of `repair_check`:
  repair_check_plain  plain PyTorch
  kernel D            csrc/repair_check.cu (ops/kernels.py launch_repair_check)
`repair_check_packed` sends CPU tensors to the plain version and CUDA
tensors to the kernel, and never falls back from one to the other; it
returns the four masks as one [4, Pb] tensor (the check reads it back with
one copy), and `repair_check` returns them as its four rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.solver import (SolverInputs, _per_node, _segment_sum, greedy_scan_solve,
                          pts_counts, pts_domain_valid, to_device)
from .waterfill import bucket_j_max, host, k_slots_for, make_groups, waterfill_group

# rip-and-repropose rounds before the residual goes to the scan
REPAIR_MAX_ROUNDS = 4
# sort-key slot budget: base score 800 + soft penalty 200 + gang bonus 100
# must keep max_total_score * slots < 2^31 (the waterfill key encoding)
REPAIR_MAX_SLOTS = 1_900_000

# violation kinds
KIND_ANTI = "anti_affinity"
KIND_EXISTING_ANTI = "existing_anti_affinity"
KIND_AFFINITY = "affinity"
KIND_SPREAD = "topology_spread"
_KINDS = (KIND_ANTI, KIND_EXISTING_ANTI, KIND_AFFINITY, KIND_SPREAD)


@dataclass
class RepairStats:
    """One batch's trip through the repair pipeline."""

    rounds: int = 0  # rip-and-repropose rounds executed
    proposed: int = 0  # pods placed by the masked waterfill propose
    repaired: int = 0  # pods re-placed by a repair round
    residual: int = 0  # pods handed to the scan
    full_scan: bool = False  # residual scan left pods unplaced -> full scan
    groups: int = 0  # identical-pod groups in the batch
    propose_calls: int = 0  # waterfill_group dispatches (merged runs)
    violations: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {
            "rounds": self.rounds,
            "proposed": self.proposed,
            "repaired": self.repaired,
            "residual": self.residual,
            "full_scan": self.full_scan,
            "groups": self.groups,
            "propose_calls": self.propose_calls,
            "violations": {k: v for k, v in self.violations.items() if v},
        }


def _dom_view(counts: np.ndarray, topo_row: np.ndarray, d_max: int) -> np.ndarray:
    """Per-node view of each node's topology-domain total of `counts` [N]
    (nodes missing the key read 0)."""
    valid = topo_row >= 0
    if not valid.any():
        return np.zeros(topo_row.shape[0], dtype=np.int64)
    dom = np.bincount(topo_row[valid], weights=counts[valid],
                      minlength=d_max).astype(np.int64)
    out = np.zeros(topo_row.shape[0], dtype=np.int64)
    out[valid] = dom[topo_row[valid]]
    return out


def repair_check(node_of, cls_of, dyn_selcls, dyn_grp, topo_id,
                 rn_key, rn_sel, ea_grp, ra_key, ra_sel,
                 class_matches, class_holds, grp_key, aff_ok,
                 ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains,
                 d_max: int, has_affinity: bool = True, has_ct: bool = True):
    """FINAL-STATE violation check over one placed batch. Returns four [Pb]
    bool masks (required anti-affinity, existing anti-affinity, required
    affinity, DoNotSchedule spread).

    node_of [Pb] is the assignment padded to a pow2 bucket (-1 rows never
    violate); dyn_selcls / dyn_grp are the committed counts INCLUDING every
    placed pod, so each pod's own contribution is subtracted before the
    anti-affinity zero-tests. has_affinity / has_ct gate whole families.

    CPU tensors run the plain version; CUDA tensors launch kernel D; any
    other device raises. The masks are the rows of repair_check_packed's
    tensor."""
    return tuple(repair_check_packed(
        node_of, cls_of, dyn_selcls, dyn_grp, topo_id, rn_key, rn_sel, ea_grp, ra_key, ra_sel,
        class_matches, class_holds, grp_key, aff_ok, ct_class, ct_key, ct_sel, ct_max_skew,
        ct_min_domains, d_max, has_affinity, has_ct).unbind(0))


def repair_check_packed(node_of, cls_of, dyn_selcls, dyn_grp, topo_id,
                        rn_key, rn_sel, ea_grp, ra_key, ra_sel,
                        class_matches, class_holds, grp_key, aff_ok,
                        ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains,
                        d_max: int, has_affinity: bool = True,
                        has_ct: bool = True) -> torch.Tensor:
    """repair_check's four masks as the rows of one [4, Pb] bool tensor, so
    a caller reads them back with one copy: kernel D writes that tensor on
    the card; on the CPU the plain version's masks are stacked."""
    args = (node_of, cls_of, dyn_selcls, dyn_grp, topo_id, rn_key, rn_sel, ea_grp, ra_key,
            ra_sel, class_matches, class_holds, grp_key, aff_ok, ct_class, ct_key, ct_sel,
            ct_max_skew, ct_min_domains, d_max, has_affinity, has_ct)
    dev = node_of.device
    if dev.type == "cpu":
        return torch.stack(repair_check_plain(*args))
    if dev.type == "cuda":
        from ..ops.kernels import launch_repair_check_packed

        return launch_repair_check_packed(*args)
    raise ValueError(f"repair_check: no implementation for device {dev}")


def repair_check_plain(node_of, cls_of, dyn_selcls, dyn_grp, topo_id,
                       rn_key, rn_sel, ea_grp, ra_key, ra_sel,
                       class_matches, class_holds, grp_key, aff_ok,
                       ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains,
                       d_max: int, has_affinity: bool = True, has_ct: bool = True):
    """Plain PyTorch version of kernel D. The per-pod term loops (vmap in the
    JAX version) are loops over the term slots, vectorized over pods; the
    per-node domain totals are gathered from [d_max] domain sums instead of
    a materialized [Kk, M, N] view."""
    pb = node_of.shape[0]
    dev = node_of.device
    placed = node_of >= 0
    nn = node_of.clamp(min=0).long()
    cc = cls_of.clamp(min=0).long()
    false_row = torch.zeros(pb, dtype=torch.bool, device=dev)
    v_rn = v_ea = v_ra = v_ct = false_row

    if has_affinity:
        kk = topo_id.shape[0]

        def dom_tables(counts):
            """[Kk, M, d_max] domain sums of every count row under every key."""
            return torch.stack([torch.stack([_segment_sum(row, topo_id[k], d_max)
                                             for row in counts]) for k in range(kk)])

        sel_dom, grp_dom = dom_tables(dyn_selcls), dom_tables(dyn_grp)

        def tot(dom, k0, m0):
            """Per pod: the domain total of row m0 under key k0 at its node."""
            t = topo_id[k0, nn]
            return torch.where(t >= 0, dom[k0, m0, t.clamp(0, d_max - 1).long()], 0)

        p_rn = p_ea = p_ra = false_row
        for j in range(rn_key.shape[1]):
            k, s = rn_key[cc, j], rn_sel[cc, j]
            k0, s0 = k.clamp(min=0).long(), s.clamp(min=0).long()
            other = tot(sel_dom, k0, s0) - class_matches[cc, s0]
            p_rn = p_rn | ((k >= 0) & (topo_id[k0, nn] >= 0) & (other > 0))
        for j in range(ea_grp.shape[1]):
            g = ea_grp[cc, j]
            g0 = g.clamp(min=0).long()
            k0 = grp_key[g0].long()
            other = tot(grp_dom, k0, g0) - class_holds[cc, g0]
            p_ea = p_ea | ((g >= 0) & (topo_id[k0, nn] >= 0) & (other > 0))
        for j in range(ra_key.shape[1]):
            # final-state affinity counts INCLUDE the pod itself: a legal
            # first-pod-exception seed satisfies its own term
            k, s = ra_key[cc, j], ra_sel[cc, j]
            k0, s0 = k.clamp(min=0).long(), s.clamp(min=0).long()
            p_ra = p_ra | ((k >= 0) & ((topo_id[k0, nn] < 0) | (tot(sel_dom, k0, s0) <= 0)))
        v_rn, v_ea, v_ra = placed & p_rn, placed & p_ea, placed & p_ra

    if has_ct:
        n = topo_id.shape[1]
        bad_rows = torch.zeros((ct_class.shape[0], n), dtype=torch.bool, device=dev)
        for t in range(ct_class.shape[0]):
            c0 = ct_class[t].clamp(min=0)
            trow = topo_id[ct_key[t]]
            arow = aff_ok[c0]
            dc = pts_counts(arow, dyn_selcls, trow, ct_sel[t], d_max)
            valid = pts_domain_valid(arow, trow, d_max)
            n_valid = valid.sum(dtype=torch.int32)
            mmn = torch.where(valid, dc, 2**30).min()
            tmind = ct_min_domains[t]
            mmn = torch.where((tmind > 0) & (tmind > n_valid), 0, mmn)
            mmn = torch.where(n_valid == 0, 0, mmn)
            node_dc = _per_node(dc, trow, d_max)
            # the pod itself is in dc already: no self term here
            bad = (trow < 0) | (node_dc - mmn > ct_max_skew[t])
            bad_rows[t] = bad & (ct_class[t] >= 0)
        row_cls = ct_class.clamp(min=0)
        hit = ((ct_class >= 0)[None, :] & (row_cls[None, :] == cc[:, None])
               & bad_rows[:, nn].T)
        v_ct = placed & hit.any(dim=1)

    return v_rn, v_ea, v_ra, v_ct


class _RepairContext:
    """Host-side dynamic state + per-class compile products for one batch:
    the live count tensors (numpy, int64), the class tables the masks read,
    and the node state on the inputs' device that the propose kernel
    updates."""

    def __init__(self, inp: SolverInputs, batch, d_max: int, has_gang: bool):
        self.inp = inp
        self.d_max = d_max
        self.has_gang = has_gang
        self.n = int(inp.alloc.shape[0])
        self.device = inp.alloc.device
        ipa = batch.ipa
        # live counts, padded to the device shapes (make_inputs pads empty
        # selcls/grp tables to one row)
        self.selcls = host(inp.selcls_count).astype(np.int64).copy()
        self.grp = host(inp.grp_count).astype(np.int64).copy()
        self.topo = host(inp.topo_id)
        # class tables (host numpy, pre-upload: no device readbacks)
        t = batch.tables
        self.filter_np = t.filter_ok
        self.aff_np = t.aff_ok
        self.class_ports_np = t.class_ports
        self.cm = batch.class_matches_selcls  # [C, max(SC,1)] int32
        self.chg = ipa.class_holds_grp  # [C, max(G,1)] int32
        self.rn_key, self.rn_sel = ipa.rn_key, ipa.rn_sel
        self.ra_key, self.ra_sel = ipa.ra_key, ipa.ra_sel
        self.pp_key, self.pp_sel, self.pp_w = ipa.pp_key, ipa.pp_sel, ipa.pp_weight
        self.ea = ipa.ea_grp
        self.sym, self.sym_w = ipa.sym_grp, ipa.sym_weight
        self.grp_key = ipa.grp_key if ipa.grp_key.size else np.zeros(1, np.int32)
        self.rn_self = ipa.class_rn_self
        self.ct_class, self.ct_key, self.ct_sel = batch.ct_class, batch.ct_key, batch.ct_sel
        self.ct_skew, self.ct_mind, self.ct_self = (
            batch.ct_max_skew, batch.ct_min_domains, batch.ct_self_match)
        self.st_class, self.st_key, self.st_sel = batch.st_class, batch.st_key, batch.st_sel
        self.req_np = batch.req
        self.req_nz_np = batch.req_nz
        self.cls_np = np.asarray(batch.class_of_pod)
        self.bal_np = np.asarray(batch.balanced_active)
        self.tables_napref = t.napref_raw
        self.tables_taint = t.taint_cnt
        self.tables_img = t.img_score
        self.gang_bonus_np = (np.asarray(batch.gang_bonus)
                              if has_gang and batch.gang_bonus is not None else None)
        # node state on the device that the propose kernel consumes/updates
        self.used = inp.used
        self.used_nz = inp.used_nz
        self.pod_count = inp.pod_count
        self.port_taken = inp.node_ports
        self.any_ports = bool(self.class_ports_np.any())
        # start-of-batch free capacity (host): upper-bounds how many copies
        # of any request can stack on one node this batch
        self.free0 = np.maximum(host(inp.alloc).astype(np.int64)
                                - host(inp.used).astype(np.int64), 0)

    # -- constraint compile: per-class masks + penalties against live counts

    def class_mask(self, c: int) -> np.ndarray:
        """Nodes where a pod of class c can be placed RIGHT NOW without
        violating any hard term (the scan's placement-time feasibility row,
        once per class per propose pass)."""
        ok = np.ones(self.n, dtype=bool)
        for j in range(self.rn_key.shape[1]):
            k = int(self.rn_key[c, j])
            if k < 0:
                continue
            trow = self.topo[k]
            cnt = _dom_view(self.selcls[self.rn_sel[c, j]], trow, self.d_max)
            ok &= (trow < 0) | (cnt == 0)
        for j in range(self.ea.shape[1]):
            g = int(self.ea[c, j])
            if g < 0:
                continue
            trow = self.topo[self.grp_key[g]]
            cnt = _dom_view(self.grp[g], trow, self.d_max)
            ok &= (trow < 0) | (cnt == 0)
        for j in range(self.ra_key.shape[1]):
            k = int(self.ra_key[c, j])
            if k < 0:
                continue
            trow = self.topo[k]
            cnt = _dom_view(self.selcls[self.ra_sel[c, j]], trow, self.d_max)
            # first-pod-exception classes see an all-False mask here and
            # land in the residual, where the scan owns the exception
            ok &= (trow >= 0) & (cnt > 0)
        for t in np.nonzero(self.ct_class == c)[0]:
            trow = self.topo[self.ct_key[t]]
            elig = self.aff_np[c] & (trow >= 0)
            if not elig.any():
                ok &= False
                continue
            dc = np.bincount(trow[elig], weights=self.selcls[self.ct_sel[t]][elig],
                             minlength=self.d_max).astype(np.int64)
            n_valid = np.unique(trow[elig]).size
            mmn = dc[np.unique(trow[elig])].min() if n_valid else 0
            if self.ct_mind[t] > 0 and self.ct_mind[t] > n_valid:
                mmn = 0
            node_dc = np.zeros(self.n, dtype=np.int64)
            node_dc[trow >= 0] = dc[trow[trow >= 0]]
            ok &= (trow >= 0) & (node_dc + int(self.ct_self[t]) - mmn <= int(self.ct_skew[t]))
        return ok

    def soft_row(self, c: int, feas: np.ndarray) -> Optional[np.ndarray]:
        """Preferred terms + symmetric weights + ScheduleAnyway spread as ONE
        normalized 0..200 preference row, added to the waterfill image row.
        Approximate by design: soft scores steer, hard masks decide."""
        raw = np.zeros(self.n, dtype=np.int64)
        any_soft = False
        for j in range(self.pp_key.shape[1]):
            k = int(self.pp_key[c, j])
            if k < 0:
                continue
            any_soft = True
            raw += int(self.pp_w[c, j]) * _dom_view(
                self.selcls[self.pp_sel[c, j]], self.topo[k], self.d_max)
        for j in range(self.sym.shape[1]):
            g = int(self.sym[c, j])
            if g < 0:
                continue
            any_soft = True
            raw += int(self.sym_w[c, j]) * _dom_view(
                self.grp[g], self.topo[self.grp_key[g]], self.d_max)
        for t in np.nonzero(self.st_class == c)[0]:
            any_soft = True
            raw -= _dom_view(self.selcls[self.st_sel[t]], self.topo[self.st_key[t]], self.d_max)
        if not any_soft or not feas.any():
            return None
        lo = int(raw[feas].min())
        hi = int(raw[feas].max())
        if hi <= lo:
            return None
        return ((raw - lo) * 200 // (hi - lo)).clip(0, 200).astype(np.int32)

    # -- dynamic count bookkeeping --------------------------------------------

    def bump(self, c: int, placed_per_node: np.ndarray, sign: int = 1) -> None:
        """Fold `placed_per_node` pods of class c into the live counts."""
        for s in np.nonzero(self.cm[c])[0]:
            self.selcls[s] += sign * int(self.cm[c, s]) * placed_per_node
        for g in np.nonzero(self.chg[c])[0]:
            self.grp[g] += sign * int(self.chg[c, g]) * placed_per_node

    def commit_resources(self, placed_j: torch.Tensor, req_row: int) -> None:
        placed_col = placed_j[:, None]
        self.used = self.used + placed_col * self.inp.req[req_row][None, :]
        self.used_nz = self.used_nz + placed_col * self.inp.req_nz[req_row][None, :]
        self.pod_count = self.pod_count + placed_j

    def _apply_resources(self, rows: np.ndarray, nodes: np.ndarray, sign: int) -> None:
        """Vectorized resource/pod-count delta for `rows` at `nodes`: one
        device op per tensor, never per pod."""
        d_used = np.zeros((self.n, self.req_np.shape[1]), dtype=np.int64)
        d_used_nz = np.zeros_like(d_used)
        np.add.at(d_used, nodes, self.req_np[rows].astype(np.int64))
        np.add.at(d_used_nz, nodes, self.req_nz_np[rows].astype(np.int64))
        d_count = np.bincount(nodes, minlength=self.n)
        self.used = self.used + sign * to_device(d_used.astype(np.int32), self.device, torch.int32)
        self.used_nz = self.used_nz + sign * to_device(d_used_nz.astype(np.int32), self.device,
                                                       torch.int32)
        self.pod_count = self.pod_count + sign * to_device(d_count.astype(np.int32), self.device,
                                                           torch.int32)

    def rip(self, rows: np.ndarray, assignment: np.ndarray) -> None:
        """Remove placed pods (batch rows) from every piece of dynamic state:
        resources, pod counts, and the live count tensors."""
        nodes = assignment[rows]
        self._apply_resources(rows, nodes, -1)
        for c in np.unique(self.cls_np[rows]):
            per_node = np.bincount(nodes[self.cls_np[rows] == c],
                                   minlength=self.n).astype(np.int64)
            self.bump(int(c), per_node, sign=-1)
        assignment[rows] = -1

    def recommit(self, rows: np.ndarray, nodes: np.ndarray) -> None:
        """Restore reprieved pods' resource state in one vectorized pass
        (their count bumps already happened per keep decision)."""
        self._apply_resources(rows, nodes, 1)

    def rebuild_ports(self, assignment: np.ndarray) -> None:
        """Port rows cannot be decremented (two placed pods of one class on a
        node share the row): rebuild them from the surviving placements."""
        taken = host(self.inp.node_ports).copy()
        placed = np.nonzero(assignment >= 0)[0]
        for c in np.unique(self.cls_np[placed]):
            crow = self.class_ports_np[c]
            if not crow.any():
                continue
            nodes = np.unique(assignment[placed[self.cls_np[placed] == c]])
            taken[nodes] |= crow[None, :]
        self.port_taken = to_device(taken, self.device, torch.bool)


def _class_fingerprint(ctx: _RepairContext, c: int, req_bytes: bytes, bal: bool) -> tuple:
    """Classes with byte-identical constraint rows, score rows and request
    vectors propose identically and may share ONE kernel call (one
    anti-affine group split over N namespaces compiles to N classes that
    differ only in namespace)."""
    score_rows = [ctx.tables_napref[c].tobytes(), ctx.tables_taint[c].tobytes(),
                  ctx.tables_img[c].tobytes(), ctx.class_ports_np[c].tobytes()]
    if ctx.gang_bonus_np is not None:
        score_rows.append(ctx.gang_bonus_np[c].tobytes())
    return (
        ctx.rn_key[c].tobytes(), ctx.rn_sel[c].tobytes(),
        ctx.ra_key[c].tobytes(), ctx.ra_sel[c].tobytes(),
        ctx.ea[c].tobytes(), ctx.pp_key[c].tobytes(),
        ctx.pp_sel[c].tobytes(), ctx.pp_w[c].tobytes(),
        ctx.sym[c].tobytes(), ctx.sym_w[c].tobytes(),
        ctx.cm[c].tobytes(), ctx.chg[c].tobytes(),
        tuple((int(ctx.ct_key[t]), int(ctx.ct_sel[t]), int(ctx.ct_skew[t]),
               int(ctx.ct_mind[t]), int(ctx.ct_self[t]))
              for t in np.nonzero(ctx.ct_class == c)[0]),
        tuple((int(ctx.st_key[t]), int(ctx.st_sel[t]))
              for t in np.nonzero(ctx.st_class == c)[0]),
        ctx.filter_np[c].tobytes(), ctx.aff_np[c].tobytes(),
        tuple(score_rows),
        req_bytes, bal, bool(ctx.rn_self[c]),
    )


def repair_solve(inp: SolverInputs, batch, d_max: int, *, has_gang: bool = False,
                 max_rounds: int = REPAIR_MAX_ROUNDS
                 ) -> Optional[Tuple[np.ndarray, RepairStats]]:
    """Solve a constrained batch: masked-waterfill propose, bounded repair,
    scan residual. Returns (assignment [P] int32 host numpy, RepairStats), or
    None when the problem shape exceeds the fast path's sort-key range (the
    caller falls back to the scan, exactly like waterfill_solve declining)."""
    p = int(inp.req.shape[0])
    if p == 0:
        return np.zeros(0, dtype=np.int32), RepairStats()
    groups = make_groups(batch)
    n = inp.alloc.shape[0]
    max_group = max(len(m) for m, _ in groups)
    j_max = bucket_j_max(inp.max_pods, inp.pod_count, n, REPAIR_MAX_SLOTS, cap_hint=max_group)
    if j_max is None:
        return None

    ctx = _RepairContext(inp, batch, d_max, has_gang)
    stats = RepairStats(groups=len(groups), violations={k: 0 for k in _KINDS})
    assignment = np.full(p, -1, dtype=np.int32)
    residual: List[int] = []

    def propose(members: np.ndarray, cls: int) -> None:
        """One masked waterfill_group call for `members` (all of class cls,
        or of byte-identical classes: the fingerprint merge)."""
        mask = ctx.class_mask(cls)
        if not mask.any():
            residual.extend(int(i) for i in members)
            return
        soft = ctx.soft_row(cls, mask & ctx.filter_np[cls])
        has_port = bool(ctx.class_ports_np[cls].any())
        cap_one = has_port or bool(ctx.rn_self[cls])
        port_conflict = (ctx.port_taken & inp.class_ports[cls][None, :]).any(dim=1)
        frow = inp.filter_ok[cls] & to_device(mask, ctx.device, torch.bool)
        img = inp.img_score[cls]
        if soft is not None:
            img = img + to_device(soft, ctx.device, torch.int32)
        pi0 = int(members[0])
        # per-run slot depth: kernel cost is linear in j_max, so cap-one
        # groups run J=1 and everything else buckets to pow2(min(batch
        # j_max, group size, start-of-batch stack bound over the eligible
        # nodes))
        if cap_one:
            run_j = 1
        else:
            req_row = ctx.req_np[pi0].astype(np.int64)
            nz = req_row > 0
            elig = mask & ctx.filter_np[cls]
            if nz.any():
                free_elig = ctx.free0[elig][:, nz]
                stack = (int((free_elig // req_row[nz]).min(axis=1).max(initial=0))
                         if free_elig.size else 0)
            else:
                stack = j_max
            run_j = 1 << (max(1, min(j_max, len(members), stack)) - 1).bit_length()
        k_per_node, chosen_nodes = waterfill_group(
            inp.alloc, ctx.used, ctx.used_nz, ctx.pod_count, inp.max_pods,
            frow, port_conflict, cap_one,
            inp.napref_raw[cls], inp.has_napref[cls], inp.taint_cnt[cls], img,
            inp.req[pi0], inp.req_nz[pi0], inp.balanced_active[pi0], len(members),
            j_max=run_j, k_slots=k_slots_for(len(members), n, run_j),
            gang_row=inp.gang_bonus[cls] if ctx.gang_bonus_np is not None else None,
            has_gang=ctx.gang_bonus_np is not None)
        stats.propose_calls += 1
        chosen = np.full(len(members), -1, dtype=np.int32)
        # the repair masks need the placements on the host at once: two
        # reads a call (waterfill_solve reads once a batch)
        got = host(chosen_nodes[:len(members)])
        chosen[:len(got)] = got
        assignment[np.asarray(members)] = chosen
        residual.extend(int(i) for i in np.asarray(members)[chosen < 0])
        ctx.commit_resources(k_per_node, pi0)
        # members may span merged classes with identical cm/chg rows; any one
        # of them attributes the count bump correctly
        ctx.bump(cls, host(k_per_node).astype(np.int64))
        if ctx.device.type == "cuda":
            from ..ops import kernels

            kernels.HOST_SYNCS["waterfill"] += 2
        if has_port:
            ctx.port_taken = ctx.port_taken | (
                (k_per_node > 0)[:, None] & inp.class_ports[cls][None, :])

    # ---- propose: merged runs of byte-identical consecutive classes --------
    runs: List[Tuple[np.ndarray, int]] = []
    last_fp = None
    for members, cls in groups:
        pi0 = int(members[0])
        fp = _class_fingerprint(ctx, cls, ctx.req_np[pi0].tobytes(), bool(ctx.bal_np[pi0]))
        if runs and fp == last_fp:
            prev_m, prev_c = runs[-1]
            runs[-1] = (np.concatenate([prev_m, members]), prev_c)
        else:
            runs.append((np.asarray(members), cls))
            last_fp = fp
    for members, cls in runs:
        propose(members, cls)
    stats.proposed = int((assignment >= 0).sum())

    # ---- repair: check -> rip -> repropose, bounded ------------------------
    has_affinity = bool(batch.ipa.has_any)
    has_ct = bool(batch.ct_class.size)
    rounds = 0
    while has_affinity or has_ct:
        viol_rows = _check(ctx, inp, assignment, p, d_max, has_affinity, has_ct, stats)
        if viol_rows.size == 0:
            break
        # reprieve pass: the final-state check marks EVERY party to a
        # collision; rip them all, then re-admit each violator in batch
        # (priority) order when its node is still feasible
        old_nodes = assignment[viol_rows].copy()
        ctx.rip(viol_rows, assignment)
        kept_rows: List[int] = []
        kept_nodes: List[int] = []
        # per-class mask cache: only a keep's count bump invalidates it
        mask_cache: Dict[int, np.ndarray] = {}
        for pos, i in enumerate(viol_rows.tolist()):
            c = int(ctx.cls_np[i])
            node = int(old_nodes[pos])
            mask = mask_cache.get(c)
            if mask is None:
                mask = mask_cache[c] = ctx.class_mask(c)
            if mask[node]:
                assignment[i] = node
                one = np.zeros(ctx.n, dtype=np.int64)
                one[node] = 1
                ctx.bump(c, one)
                mask_cache.clear()  # counts moved: every mask is stale
                kept_rows.append(i)
                kept_nodes.append(node)
        if kept_rows:
            ctx.recommit(np.asarray(kept_rows), np.asarray(kept_nodes, dtype=np.int64))
        if ctx.any_ports:
            ctx.rebuild_ports(assignment)
        still = viol_rows[assignment[viol_rows] < 0]
        if still.size == 0:
            break  # every violator reprieved: nothing moves
        if rounds >= max_rounds:
            residual.extend(int(i) for i in still)
            break
        rounds += 1
        # re-propose by the FULL make_groups key, never class alone: one
        # class can span request vectors, and propose() sizes capacity and
        # commits resources with members[0]'s request
        regroups: Dict[tuple, List[int]] = {}
        order: List[tuple] = []
        for i in still.tolist():
            k = (int(ctx.cls_np[i]), ctx.req_np[i].tobytes(), ctx.req_nz_np[i].tobytes(),
                 bool(ctx.bal_np[i]))
            if k not in regroups:
                regroups[k] = []
                order.append(k)
            regroups[k].append(i)
        for k in order:
            propose(np.asarray(regroups[k], dtype=np.int64), k[0])
        stats.repaired += int((assignment[still] >= 0).sum())
    stats.rounds = rounds

    # ---- residual: the scan against the committed counts -------------------
    residual = sorted(set(i for i in residual if assignment[i] < 0))
    gates = dict(has_ipa=has_affinity, has_ct=has_ct, has_st=bool(batch.st_class.size),
                 has_gang=ctx.gang_bonus_np is not None)
    if residual:
        stats.residual = len(residual)
        res = torch.as_tensor(residual, dtype=torch.long, device=ctx.device)
        # row-indexed pod fields come out contiguous (kernel A requires it)
        res_inp = inp._replace(
            used=ctx.used, used_nz=ctx.used_nz, pod_count=ctx.pod_count,
            selcls_count=to_device(ctx.selcls.astype(np.int32), ctx.device, torch.int32),
            grp_count=to_device(ctx.grp.astype(np.int32), ctx.device, torch.int32),
            node_ports=ctx.port_taken,
            req=inp.req[res], req_nz=inp.req_nz[res], class_of_pod=inp.class_of_pod[res],
            balanced_active=inp.balanced_active[res])
        res_assign, _, _ = greedy_scan_solve(res_inp, d_max, **gates)
        ra = host(res_assign)
        assignment[np.asarray(residual)] = ra
        if (ra < 0).any():
            # repair never invents unschedulability: re-solve the WHOLE
            # batch on the untouched scan, whose verdict then stands
            stats.full_scan = True
            full, _, _ = greedy_scan_solve(inp, d_max, **gates)
            return host(full).astype(np.int32), stats
    return assignment, stats


def _check(ctx: _RepairContext, inp: SolverInputs, assignment: np.ndarray, p: int,
           d_max: int, has_affinity: bool, has_ct: bool, stats: RepairStats) -> np.ndarray:
    """Run the final-state check; returns the violating batch rows."""
    pb = max(256, 1 << (p - 1).bit_length())
    node_pad = np.full(pb, -1, dtype=np.int32)
    node_pad[:p] = assignment
    cls_pad = np.zeros(pb, dtype=np.int32)
    cls_pad[:p] = ctx.cls_np
    dev = ctx.device
    masks = repair_check_packed(
        to_device(node_pad, dev, torch.int32), to_device(cls_pad, dev, torch.int32),
        to_device(ctx.selcls.astype(np.int32), dev, torch.int32),
        to_device(ctx.grp.astype(np.int32), dev, torch.int32),
        inp.topo_id, inp.rn_key, inp.rn_sel, inp.ea_grp, inp.ra_key, inp.ra_sel,
        inp.class_matches_selcls, inp.class_holds_grp, inp.grp_key, inp.aff_ok,
        inp.ct_class, inp.ct_key, inp.ct_sel, inp.ct_max_skew, inp.ct_min_domains,
        d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
    v_rn, v_ea, v_ra, v_ct = host(masks)[:, :p]  # the one read back
    stats.violations[KIND_ANTI] += int(v_rn.sum())
    stats.violations[KIND_EXISTING_ANTI] += int(v_ea.sum())
    stats.violations[KIND_AFFINITY] += int(v_ra.sum())
    stats.violations[KIND_SPREAD] += int(v_ct.sum())
    return np.nonzero(v_rn | v_ea | v_ra | v_ct)[0]
