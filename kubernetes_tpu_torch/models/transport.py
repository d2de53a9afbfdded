"""Global batch solvers: auction and Sinkhorn on the group-level
transportation problem.

The counterpart of `kubernetes_tpu/models/transport.py` (reference:
pkg/scheduler/schedule_one.go:754, the north star's "auction/Sinkhorn over a
dense feasibility/cost tensor"). Batch pods collapse into G groups of
identical pods (make_groups); the problem is a transportation problem on a
[G, N] utility matrix:

    max sum x_gn C_gn  s.t.  sum_n x_gn <= supply_g,  sum_g x_gn <= slots_n,
                             0 <= x_gn <= jcap_gn   (per-cell multi-resource fit)

Cross-group resource coupling is not in the relaxation: `repair_plan`
enforces it exactly afterwards, and pods it cannot seat return -1 (device
rejects). Both solvers carry their duals across calls (`TransportState`,
remapped by node name).

Three device functions, each with a plain PyTorch version beside its
dispatcher (CPU tensors run the plain version, CUDA tensors launch the
kernel, any other device raises; there is no fallback between the two):
  feasibility_rows  kernel J (ops/solver.py, csrc/feasibility_rows.cu): the
                    [G, N] feasibility and utility rows of the group
                    representatives (`_group_rows`)
  _auction_phase    kernel E (csrc/auction_phase.cu): one eps-phase of the
                    forward auction, rounds on the device
  _sinkhorn_iters   kernel F (csrc/sinkhorn.cu): the log-domain iterations
                    and the plan
The problem's jcap/slots/supply, `_effective_cap` and the eps schedule are
eager torch ops and Python floats, as the reference keeps them outside its
jitted functions; `round_plan`, `repair_plan` and `assignment_from_plan`
are host numpy, copied from the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.solver import SolverInputs, feasibility_rows
from .waterfill import host

NEG_INF = np.float32(-1e30)  # the masked value, float32 as in the reference
_HALF = np.float32(NEG_INF / np.float32(2))  # NEG_INF / 2, the "is it masked" line
_FLT_MIN = float(np.finfo(np.float32).tiny)  # the smallest normal float32


class GroupProblem(NamedTuple):
    """The [G, N] transportation problem (tensors on the solve's device
    except members)."""

    utility: torch.Tensor  # [G, N] float32 (int scores cast)
    feasible: torch.Tensor  # [G, N] bool
    jcap: torch.Tensor  # [G, N] int32, per-cell max placements (single group)
    supply: torch.Tensor  # [G] int32
    slots: torch.Tensor  # [N] int32, pod-count headroom
    req: torch.Tensor  # [G, R] int32
    alloc: torch.Tensor  # [N, R] int32
    used: torch.Tensor  # [N, R] int32
    members: Tuple[np.ndarray, ...]  # per-group pod indices (queue order), host


class TransportState(NamedTuple):
    """Warm-startable duals. price doubles as the Sinkhorn node potential g."""

    price: np.ndarray  # [N] float32
    node_names: Tuple[str, ...]
    iterations: int  # iterations spent by the last solve (observability)


def _group_rows(inp: SolverInputs, groups) -> Tuple[torch.Tensor, torch.Tensor]:
    """F[G, N], C[G, N] from each group's representative pod (kernel J)."""
    reps = torch.as_tensor(np.array([int(m[0]) for m, _ in groups], dtype=np.int64),
                           device=inp.req.device)
    return feasibility_rows(inp, inp.req[reps].contiguous(), inp.req_nz[reps].contiguous(),
                            inp.class_of_pod[reps].contiguous(),
                            inp.balanced_active[reps].contiguous())


def build_group_problem(inp: SolverInputs, groups) -> Optional[GroupProblem]:
    """groups: make_groups(batch) output. Returns None when any group's class
    declares host ports (per-port exclusion is not in the relaxation; the
    scheduler then runs the scan)."""
    if not groups:
        return None
    classes = torch.as_tensor([int(cls) for _, cls in groups], dtype=torch.int64,
                              device=inp.class_ports.device)
    if bool(inp.class_ports[classes].any()):
        return None
    feas, util = _group_rows(inp, groups)
    dev = inp.alloc.device
    reps = torch.as_tensor(np.array([int(m[0]) for m, _ in groups], dtype=np.int64), device=dev)
    req = inp.req[reps]  # [G, R]
    free = inp.alloc[None, :, :] - inp.used[None, :, :]  # [1, N, R]
    per_res = torch.where(req[:, None, :] > 0, free // req[:, None, :].clamp(min=1),
                          torch.tensor(2**30, dtype=torch.int32, device=dev))
    jcap = per_res.min(dim=2).values.to(torch.int32)  # [G, N]
    slots = (inp.max_pods - inp.pod_count).to(torch.int32)
    jcap = torch.minimum(jcap, slots[None, :])
    jcap = torch.where(feas, jcap.clamp(min=0), 0).to(torch.int32)
    supply = torch.tensor([len(m) for m, _ in groups], dtype=torch.int32, device=dev)
    return GroupProblem(
        utility=util.to(torch.float32).contiguous(),
        feasible=feas,
        jcap=jcap.contiguous(),
        supply=supply,
        slots=slots.clamp(min=0).contiguous(),
        req=req.contiguous(),
        alloc=inp.alloc,
        used=inp.used,
        members=tuple(np.asarray(m) for m, _ in groups),
    )


# ---------------------------------------------------------------------------
# auction
# ---------------------------------------------------------------------------


def _auction_phase(utility, jcap, supply, slots, req, free, x0, price0, level0,
                   eps: float, max_rounds: int):
    """One eps-phase of the forward auction. Returns (x [G, N] int32, price
    [N] float32, level [G, N] float32, rounds int). CPU tensors run
    _auction_phase_plain; CUDA tensors launch kernel E; any other device
    raises."""
    args = (utility, jcap, supply, slots, req, free, x0, price0, level0, eps, max_rounds)
    dev = utility.device
    if dev.type == "cpu":
        return _auction_phase_plain(*args)
    if dev.type == "cuda":
        from ..ops.kernels import launch_auction_phase

        return launch_auction_phase(*args)
    raise ValueError(f"_auction_phase: no implementation for device {dev}")


def _auction_phase_plain(utility, jcap, supply, slots, req, free, x0, price0, level0,
                         eps: float, max_rounds: int):
    """Plain PyTorch version of kernel E (the reference's while_loop body,
    op for op).

    State: x[G, N] units held, level[G, N] the bid level the cell's units
    were acquired at (mixed-level cells keep the min), price[N]. Acceptance
    is resource-exact: per node, holder and bid units are taken in level
    order (a stable sort: holders before bids on equal levels) while the
    cumulative multi-resource usage fits free = alloc - used and the slot
    bound holds, so the auction never over-commits a node."""
    g, n = utility.shape
    dev = utility.device
    neg = torch.tensor(NEG_INF, device=dev)
    half = torch.tensor(_HALF, device=dev)
    eps_t = torch.tensor(np.float32(eps), device=dev)
    big = torch.tensor(2**30, dtype=torch.int32, device=dev)
    req2 = torch.cat([req, req], dim=0)  # [2G, R] rows for both halves
    k = min(16, n)
    x, price, level = x0.clone(), price0.clone(), level0.clone()
    rounds, progress = 0, True
    while True:
        unassigned = supply - x.sum(dim=1, dtype=torch.int32)
        if not (bool((unassigned > 0).any()) and progress and rounds < max_rounds):
            break
        v = torch.where(jcap > x, utility - price[None, :], neg)
        # lax.top_k: value desc, lowest index on ties (a stable descending sort)
        vs, order_v = torch.sort(v, dim=1, descending=True, stable=True)
        vk, jk = vs[:, :k], order_v[:, :k]
        v1 = vk[:, 0]
        v_next = v.scatter(1, jk, neg.expand(g, k)).max(dim=1).values
        v_next = torch.where(v_next <= half, torch.where(vk[:, k - 1] > half, vk[:, k - 1], v1),
                             v_next)
        bidding = (unassigned > 0) & (v1 > half)
        avail = (jcap.gather(1, jk) - x.gather(1, jk)).clamp(min=0)
        avail = torch.where(vk > half, avail, 0)
        prefix = avail.cumsum(dim=1, dtype=torch.int32) - avail  # exclusive prefix
        units_k = torch.minimum((unassigned[:, None] - prefix).clamp(min=0), avail)
        units_k = torch.where(bidding[:, None], units_k, 0).to(torch.int32)
        beta_k = (utility.gather(1, jk) - v_next[:, None]) + eps_t
        bids = torch.zeros_like(x).scatter(1, jk, units_k)
        bid_level = torch.full_like(level, NEG_INF).scatter_reduce(
            1, jk, torch.where(units_k > 0, beta_k, neg), "amax", include_self=True)

        units = torch.cat([x, bids], dim=0)  # [2G, N]
        levels = torch.cat([torch.where(x > 0, level, neg),
                            torch.where(bids > 0, bid_level, neg)], dim=0)
        order = torch.argsort(-levels, dim=0, stable=True)  # rows by level desc
        u_sorted = units.gather(0, order)
        l_sorted = levels.gather(0, order)
        req_sorted = req2[order]  # [2G, N, R]
        used_acc = torch.zeros_like(free)
        cnt_acc = torch.zeros(n, dtype=torch.int32, device=dev)
        keep = torch.zeros_like(u_sorted)
        # a sorted row without units keeps nothing and changes no carry
        for i in torch.nonzero((u_sorted > 0).any(dim=1)).flatten().tolist():
            rq = req_sorted[i]
            room = free - used_acc
            per = torch.where(rq > 0, room // rq.clamp(min=1), big)
            fit = slots - cnt_acc
            for r in range(per.shape[1]):
                fit = torch.minimum(fit, per[:, r])
            kk = torch.minimum(fit.clamp(min=0), u_sorted[i])
            kk = torch.where(l_sorted[i] > half, kk, 0).to(torch.int32)
            used_acc = used_acc + kk[:, None] * rq
            cnt_acc = cnt_acc + kk
            keep[i] = kk

        # the price rises to the highest rejected level
        rejected = u_sorted - keep
        any_rej = (rejected > 0).any(dim=0)
        top_rej_level = torch.where(rejected > 0, l_sorted, neg).max(dim=0).values
        price = torch.where(any_rej, torch.maximum(price, top_rej_level), price)
        kept = torch.zeros_like(units).scatter(0, order, keep)
        kept_levels = torch.where(kept > 0, levels, -neg)
        x_new = kept[:g] + kept[g:]
        level_new = torch.minimum(kept_levels[:g], kept_levels[g:])
        level = torch.where(x_new > 0, level_new, neg)
        x = x_new
        progress = bool((units_k > 0).any())
        rounds += 1
    return x, price, level, rounds


def auction_solve(problem: GroupProblem, state: Optional[TransportState] = None,
                  node_names: Optional[List[str]] = None, eps_start: Optional[float] = None,
                  eps_final: float = 0.9, scale: float = 4.0,
                  max_rounds: int = 400) -> Tuple[np.ndarray, TransportState]:
    """eps-scaling forward auction. Returns (x [G, N] int counts on the host,
    state). Every phase starts from x = 0 and level = NEG_INF with the price
    carried over; eps is computed in Python floats and passed as float32."""
    g, n = problem.utility.shape
    dev = problem.utility.device
    price0 = np.zeros(n, np.float32)
    if state is not None and node_names is not None:
        remapped = _remap_price(state, node_names)
        price0[:len(remapped)] = remapped
    util_range = float(torch.where(problem.feasible, problem.utility, 0.0).max())
    eps = eps_start if eps_start is not None else max(util_range / 8.0, eps_final)
    price = torch.from_numpy(price0).to(dev)
    free = (problem.alloc - problem.used).contiguous()
    x0 = torch.zeros((g, n), dtype=torch.int32, device=dev)
    level0 = torch.full((g, n), NEG_INF, dtype=torch.float32, device=dev)
    total_rounds = 0
    while True:
        x, price, _level, rounds = _auction_phase(
            problem.utility, problem.jcap, problem.supply, problem.slots, problem.req, free,
            x0, price, level0, eps, max_rounds)
        total_rounds += int(rounds)
        if eps <= eps_final:
            break
        eps = max(eps / scale, eps_final)
    names = tuple(node_names) if node_names else tuple(str(i) for i in range(n))
    new_state = TransportState(price=host(price)[:len(names)].copy(), node_names=names,
                               iterations=total_rounds)
    return host(x), new_state


def _remap_price(state: TransportState, node_names: List[str]) -> np.ndarray:
    """Carry duals across snapshots by node name (nodes come and go; new
    ones start at 0)."""
    idx = {nm: i for i, nm in enumerate(state.node_names)}
    out = np.zeros(len(node_names), np.float32)
    for j, nm in enumerate(node_names):
        i = idx.get(nm)
        if i is not None:
            out[j] = state.price[i]
    return out


# ---------------------------------------------------------------------------
# sinkhorn
# ---------------------------------------------------------------------------


def _effective_cap(problem: GroupProblem) -> torch.Tensor:
    """Scalarized per-node capacity for the Sinkhorn column marginal: the
    slot bound tightened by each resource's headroom over the
    supply-weighted mean request (float32)."""
    supply = problem.supply.to(torch.float32)  # [G]
    total = supply.sum().clamp(min=1.0)
    mean_req = (problem.req.to(torch.float32) * supply[:, None]).sum(dim=0) / total
    free = (problem.alloc - problem.used).to(torch.float32)  # [N, R]
    per_res = torch.where(mean_req[None, :] > 0, free / mean_req[None, :].clamp(min=1e-9),
                          torch.tensor(float("inf"), device=free.device))
    cap = torch.minimum(per_res.min(dim=1).values, problem.slots.to(torch.float32))
    return cap.clamp(min=0.0)


def _sinkhorn_iters(utility, feasible, supply, cap, f0, g0, eps: float, iters: int):
    """`iters` clamped row/column log-sum-exp updates of the duals, then the
    plan. Returns (f [G], g [N], plan [G, N]) float32. CPU tensors run
    _sinkhorn_iters_plain; CUDA tensors launch kernel F; any other device
    raises."""
    args = (utility, feasible, supply, cap, f0, g0, eps, iters)
    dev = utility.device
    if dev.type == "cpu":
        return _sinkhorn_iters_plain(*args)
    if dev.type == "cuda":
        from ..ops.kernels import launch_sinkhorn_iters

        return launch_sinkhorn_iters(*args)
    raise ValueError(f"_sinkhorn_iters: no implementation for device {dev}")


def _logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.scipy.special.logsumexp: the max (a non-finite max taken as 0),
    then log(|sum(exp(a - max))|) + max."""
    amax = a.max(dim=dim, keepdim=True).values
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = torch.exp(a - amax).sum(dim=dim).abs()
    return torch.log(s) + amax.squeeze(dim)


def _sinkhorn_iters_plain(utility, feasible, supply, cap, f0, g0, eps: float, iters: int):
    """Plain PyTorch version of kernel F. Log-domain scaling for
    max <C, x> + eps H(x) s.t. rows <= supply, cols <= cap, x >= 0; each
    update is a clamped-at-zero exact solve:
        f = max(0, eps (lse_n((C - g) / eps) - log supply))
        g = max(0, eps (lse_g((C - f) / eps) - log cap))"""
    dev = utility.device
    eps_t = torch.tensor(np.float32(eps), device=dev)
    neg = torch.tensor(NEG_INF, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    logmask = torch.where(feasible, zero, neg)
    logs = torch.log(supply.to(torch.float32).clamp(min=1e-9))
    logc = torch.log(cap.to(torch.float32).clamp(min=1e-9))
    z = (utility + logmask) / eps_t  # [G, N]
    f, g = f0.clone(), g0.clone()
    for _ in range(iters):
        row_lse = _logsumexp(z - g[None, :] / eps_t, dim=1)
        f = torch.maximum(zero, eps_t * (row_lse - logs))
        col_lse = _logsumexp(z - f[:, None] / eps_t, dim=0)
        g = torch.maximum(zero, eps_t * (col_lse - logc))
    plan = torch.exp((utility + logmask - f[:, None] - g[None, :]) / eps_t)
    # XLA (CPU and TPU) flushes subnormal results to zero; a subnormal plan
    # entry would be a positive remainder that round_plan fills
    plan = torch.where(plan < _FLT_MIN, zero, plan)
    return f, g, plan


def sinkhorn_solve(problem: GroupProblem, state: Optional[TransportState] = None,
                   node_names: Optional[List[str]] = None, eps: float = 2.0,
                   iters: int = 60) -> Tuple[np.ndarray, TransportState]:
    """Entropic relaxation; returns (fractional plan [G, N] on the host,
    state). The node dual g (a price: >= 0, rising on contended nodes) is
    carried in TransportState.price, interchangeable with the auction's."""
    gdim, n = problem.utility.shape
    dev = problem.utility.device
    g0 = np.zeros(n, np.float32)
    if state is not None and node_names is not None:
        remapped = np.maximum(_remap_price(state, node_names), 0.0)
        g0[:len(remapped)] = remapped
    f0 = torch.zeros(gdim, dtype=torch.float32, device=dev)
    f, g, plan = _sinkhorn_iters(problem.utility, problem.feasible, problem.supply,
                                 _effective_cap(problem).contiguous(), f0,
                                 torch.from_numpy(g0).to(dev), eps, iters)
    names = tuple(node_names) if node_names else tuple(str(i) for i in range(n))
    new_state = TransportState(price=host(g)[:len(names)].copy(), node_names=names,
                               iterations=iters)
    return host(plan), new_state


# ---------------------------------------------------------------------------
# rounding, repair, per-pod assignment (host numpy, as in the reference)
# ---------------------------------------------------------------------------


def round_plan(problem: GroupProblem, frac: np.ndarray) -> np.ndarray:
    """Fractional [G, N] -> integer counts: floor, then largest-remainder fill
    per group under remaining column capacity and cell caps."""
    jcap = host(problem.jcap)
    frac = np.minimum(frac, jcap)
    x = np.floor(frac).astype(np.int32)
    # column headroom after floors
    col_room = host(problem.slots) - x.sum(axis=0)
    supply = host(problem.supply)
    rema = frac - x
    for gi in range(x.shape[0]):
        want = int(supply[gi] - x[gi].sum())
        if want <= 0:
            continue
        order = np.argsort(-rema[gi])
        for n_i in order:
            if want == 0:
                break
            if rema[gi, n_i] <= 0:
                break
            if col_room[n_i] > 0 and x[gi, n_i] < jcap[gi, n_i]:
                x[gi, n_i] += 1
                col_room[n_i] -= 1
                want -= 1
    return x


def repair_plan(problem: GroupProblem, x: np.ndarray) -> np.ndarray:
    """Enforce the exact multi-resource constraint sum_g x_gn req_g <=
    alloc - used and the slot bound, dropping units from the lowest-utility
    cells first. Returns a feasible integer plan (a batch assignment never
    violates Filter — fit.go:499)."""
    x = np.minimum(np.asarray(x, np.int64), host(problem.jcap))
    req = host(problem.req).astype(np.int64)  # [G, R]
    free = host(problem.alloc).astype(np.int64) - host(problem.used).astype(np.int64)
    slots = host(problem.slots).astype(np.int64)
    util = host(problem.utility)
    # clamp supply per group (defensive)
    supply = host(problem.supply).astype(np.int64)
    for gi in range(x.shape[0]):
        over = int(x[gi].sum() - supply[gi])
        if over > 0:
            order = np.argsort(util[gi])  # drop worst first
            for n_i in order:
                if over <= 0:
                    break
                d = min(over, int(x[gi, n_i]))
                x[gi, n_i] -= d
                over -= d
    node_used = x.T @ req  # [N, R]
    node_cnt = x.sum(axis=0)
    bad = np.nonzero((node_used > free).any(axis=1) | (node_cnt > slots))[0]
    for n_i in bad:
        order = np.argsort(util[:, n_i])  # worst utility first
        for gi in order:
            while x[gi, n_i] > 0 and (
                    (node_used[n_i] > free[n_i]).any() or node_cnt[n_i] > slots[n_i]):
                x[gi, n_i] -= 1
                node_used[n_i] -= req[gi]
                node_cnt[n_i] -= 1
            if not (node_used[n_i] > free[n_i]).any() and node_cnt[n_i] <= slots[n_i]:
                break
    return x.astype(np.int32)


def assignment_from_plan(problem: GroupProblem, x: np.ndarray, n_pods: int) -> np.ndarray:
    """Integer plan -> per-pod node index (queue order within each group);
    -1 for units the plan could not seat."""
    out = np.full(n_pods, -1, np.int32)
    for gi, members in enumerate(problem.members):
        nodes = np.repeat(np.arange(x.shape[1]), x[gi])
        k = min(len(nodes), len(members))
        out[members[:k]] = nodes[:k].astype(np.int32)
    return out


def transport_solve(inp: SolverInputs, groups, method: str = "auction",
                    state: Optional[TransportState] = None,
                    node_names: Optional[List[str]] = None,
                    mesh=None) -> Optional[Tuple[np.ndarray, TransportState]]:
    """End to end: build -> solve -> round -> repair -> per-pod assignment.
    Returns None when the batch is not transport-eligible (host ports).
    Node-axis sharding over several cards (mesh=) is ROADMAP.md queue 1
    item 6 and raises."""
    if mesh is not None:
        raise NotImplementedError("transport over a node-axis mesh is not yet ported "
                                  "(ROADMAP.md queue 1 item 6)")
    problem = build_group_problem(inp, groups)
    if problem is None:
        return None
    if method == "sinkhorn":
        frac, new_state = sinkhorn_solve(problem, state, node_names)
        x = round_plan(problem, frac)
    else:
        x, new_state = auction_solve(problem, state, node_names)
    x = repair_plan(problem, x)
    n_pods = inp.req.shape[0]
    return assignment_from_plan(problem, x, n_pods), new_state
