#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # on a machine with a CUDA card

Phases, each printing one JSON line:
  device     card name, count, nvidia-smi name and power limit
  build      nvcc builds every kernel from csrc/, one nvcc per source, all
             started together (ptxas register, shared-memory and spill lines)
  kernel_A   the greedy-scan kernel (one thread-block cluster) against
             greedy_scan_solve_plain on the card, on tensors the port's
             tensorizer built from seeded inputs: (a) SchedulingBasic 5,000
             nodes x 10,000 pods, (b) TopologySpreading 5,000 nodes / 10
             zones x 5,000 pods, (c) a mixed case that turns on all four
             gates; then seeded synthetic cases (testing.scan_problem): one
             node, seven, a node count no multiple of the cluster size,
             identical nodes (ties across CTA boundaries to the lowest
             index), pods that fit nowhere, the hostname key (d_max = N) and
             70,000 nodes (the global-scratch path); exact equality of
             assignment, used and pod_count; each line gives the cluster
             plan and us a pod step. kernel_A_timing: the main path's 5,000 x
             4,096 batch (one node a thread) and device time
  kernel_B   the mirror-scatter kernel: one mirror (scatter_rows /
             scatter_cols) against scatter_rows_plain / scatter_cols_plain,
             and the fused form (every mirror in one launch) against
             scatter_mirrors_plain, after seeded churn rounds (k = 1 and k = N
             among them, with and without the selector-class columns);
             exact equality; one call (one descriptor, on rows packed as
             [k, 1 + 3]) against Tensor.index_copy_, and one
             incremental device_views (SchedulingBasic's five fields,
             TopologySpreading's with its columns) against the library route
             on the same pinned copy, wall and device times
  kernel_C   the waterfill kernel (one thread-block cluster a group) against
             waterfill_group_plain on the card, on tensorizer inputs: (a)
             SchedulingBasic 5,000 nodes, a 4,096-pod group, (b) a
             10,000-pod group (k_slots 16,384), (c) host ports, preferred
             node affinity, taints, a seeded gang row and a group below the
             256-slot floor, (d) a node over-committed by a bound pod (free <
             0); exact equality of k_per_node and chosen_nodes in order; each
             line gives the CUDA launches of the call (1), the cluster plan
             and the device time
  kernel_D   the repair-check kernel (one thread-block cluster a call)
             against repair_check_plain on seeded placed batches
             (TopologySpreading, hostname anti-affinity, a mixed batch with
             all four kinds and minDomains, and 70,000 nodes of their own
             domains, the global-scratch route), under all four gate
             combinations; exact equality, every mask non-empty on the mixed
             batch, one CUDA launch a call, the plan's route per gate pair.
             kernel_D_timing: the TopologySpreading batch (5,000 nodes, 4,096
             pods, one spread row) and the PodAntiAffinity one (hostname key,
             has_affinity): wall and device time, the plan
  main_path  APIStore -> BatchScheduler(device="cuda", solver="exact") ->
             run_until_idle on the SchedulingBasic and TopologySpreading
             shapes: every pod bound through the store, no node
             over-committed, zone skew <= 1, kernel launch counts > 0 (kernel
             B: one launch per incremental batch), solve seconds a batch;
             the SchedulingBasic store (columnar, the default) carries one
             per-object and one coalescing pods watcher
  main_path_store
             exact SchedulingBasic once more on APIStore(columnar=False), held
             against main_path's columnar run: equal {pod: node} maps, equal
             resourceVersions for every pod, and the same sequence of (key,
             rv, node) bind transitions in history_events(); the columnar
             leg's two watchers drained with no dropped delivery (20,000
             per-object events, every pod's ADDED and bind in the coalesced
             batches); kernels A and B launched in both legs; reported:
             pods/s, stage_seconds and the commit stage of both legs,
             store_bind_many_duration's count and mean, columnar_stats() and
             watch_telemetry() (subscriber rv lag, drops by reason,
             propagation count and p50/p99), each leg's full garbage
             collections and the phase's seconds
  main_path_commit
             the host commit: main_path's SchedulingBasic run (the default
             pipeline: columnar cache rows, binds on the supervised worker
             thread with retry, the g++ commit engines) against the same
             shape on the object-path oracle (columnar=False,
             pipeline_binds=False, APIStore(native_commit=False)): equal
             map, pod resourceVersions and bind transitions, kernels A and B
             launched in both; under armed store.bind_many=fail:count=2 and
             native.commit=fail:count=1: every pod bound once, three bind
             retries counted, no assume left; and solver="native" (the host
             C engine, no kernel launched by design): the scan's map.
             Reported per run: pods/s, stage_seconds, the bind worker's
             seconds and flush_binds' wait, store_bind_many_duration,
             restarts and retries, the cache rows, full garbage collections
  main_path_fast
             BatchScheduler(solver="fast") on SchedulingBasic,
             TopologySpreading, PodAntiAffinity and PodAffinity (and
             solver="auto" on SchedulingBasic): every pod bound, every
             constraint holding, no breaker failure, kernels C and D
             launched where the workload routes to them, and the same
             {pod: node} map as a rerun on the CPU (the plain versions),
             kernel C's host reads a batch (one in waterfill_solve, two a
             propose call in repair);
             SchedulingBasic and TopologySpreading also run the exact mode
             right after, as the fast mode's comparison partner
  main_path_preempt
             per-pod preemption on the batch path: BatchScheduler(store,
             Framework(default_plugins()), device="cuda") on PreemptionBasic
             (the JAX rung's shape, bench.py:2766-2838: 500 nodes of 4 cpu /
             32Gi / 110 pods, 500 bound priority-1 pods of 3 cpu, then 500
             priority-100 pods of 2 cpu) in solver="auto" (kernels B, C) and
             "exact" (B, A), victims prepared synchronously and on the async
             worker; the same shape at 5,000 nodes (auto, sync and async,
             batches of 4,096, so the preemptors span two batches);
             and a constrained case (500 nodes in 10 zones, 50 preemptors
             with a zone spread, exact: the serial PostFilter). Gates: every
             high pod bound, no node over-committed, every victim lower in
             priority than its preemptor and on the node it was narrated on,
             the Preempted events, victims and nominations consistent, the
             kernels launched, and the map, the victims and the events equal
             to a CPU rerun; reported: seconds to bound, pods/s,
             preemption_count, victims and the solve stage
  main_path_fallback
             the fallback classes on the batch path (after scheduler_perf's
             volume and DRA suites): the 5,000 nodes of 8 cpu / 32Gi / 110
             pods in 10 zones, 250 tainted NoSchedule, a CSINode a node (3
             CSI attachments), a WaitForFirstConsumer StorageClass that
             provisions in five zones and one for static PVs, one
             DeviceClass and ResourceSlices of 8 devices on 500 nodes; one
             create_many wave of 4,096 SchedulingBasic pods and 136
             fallback pods spread through it by a seeded permutation (48
             with a pre-bound PVC whose PV has zone affinity and a CSI
             source, 16 provisioned through the class, 8 matched to static
             PVs, 32 + 16 with a ResourceClaim of one / two devices, 16 with
             a zone spread and nodeTaintsPolicy Honor), batches of 4,096,
             solver="auto", DynamicResourceAllocation on: the device pods
             ride kernels B and C, the fallback pods the per-pod cycle after
             each batch's device commit. Gates: every pod bound, no node
             over-committed, PV affinity, each PV bound once, CSINode
             limits, claims allocated on the pod's node from its slice and
             reserved for it, no device in two claims, spread skew <= 1 over
             the untainted nodes, and the map, the PV/PVC writes, the claim
             allocations and the events equal to a CPU rerun; reported:
             seconds to bound, the fallback counts and clock, the per-class
             counts, the solve stage a batch and the kernels' launches
  kernel_G   the gang cover-curve kernel against cover_curve_plain: (a) one
             250-node slice (n_slots 256) with 1,000 victims (k_max 1,024),
             (b) k = 0, pad victims and ineligible nodes, (c) a shape above
             the JAX wrapper's 4,000,000-element budget, (d) one cover
             attempt of GangPreemption_5000's 20 slices through
             cover_curves_batched (one launch, one read) beside the
             per-slice route; exact equality
  kernel_H   the rank-align kernel (one cluster launch a call) against
             rank_align_plain: (a) p_max 4,096, 16 gangs of 256 ranked
             members at shuffled positions, (b) ties, unplaced members and
             non-members, (c) p_max 16,384 (the parent's global merge),
             (d) GangScheduling_2k_250's p_max 2,048, (e) p_max 65,536, (f)
             case e sorted in chunks of 2,048 rows; exact equality, one CUDA
             launch a call, the plan; wall and device time of a, c and d
  main_path_gang
             BatchScheduler(solver="fast") on GangScheduling_2k_250 (256 nodes
             of 16 cpu / 64Gi in 4 slices, 8 PodGroups x 250 ranked members,
             the JAX rung's shape) and GangScheduling_5000 (the 5,000 nodes in
             20 slices, 16 PodGroups x 256 ranked members, one batch), and the
             latter again with solver="exact": every member bound, no node
             over-committed, 0 vetoes, kernels H and C (A in exact) launched,
             the same map as a CPU rerun; reported: the slices each gang spans
             and the ring adjacency beside a rank_align=False run
  main_path_gang_preempt
             GangPreemption (2 slices x 8 nodes of 6-cpu priority-1 fillers, a
             12 x 3-cpu priority-100 gang, then a 40-member one) and
             GangPreemption_5000 (5,000 nodes in 20 slices, 4 x 1500m fillers
             a node, a 400-member gang, then a 600-member one): the DELETED
             events are exactly the min-cost cover the script computes with
             the host curve, the gang binds whole on that slice, the second
             gang is vetoed with zero further evictions, pods are conserved,
             kernel G launched at most once a cover attempt (reported: its
             launches an attempt), the covers of 6 and 799 victims, and a CPU
             rerun evicts and places the same
  kernel_J   the feasibility-row kernel (one thread-block cluster a row)
             against feasibility_rows_plain: (a) TransportMixed's 8 group
             rows x 5,000 nodes, (b) 512 pod rows, (c) over-committed nodes
             (free < 0), zero-alloc dimensions, used host ports and rows
             nothing fits, (d) Transport_50k's one row; exact equality; each
             line gives the CUDA launches of the call (1), the plan and the
             device time, cases a and d the wall time
  kernel_E   the auction-phase kernel (one thread-block cluster a phase)
             against _auction_phase_plain: (a) the first Transport_50k batch
             (G = 1, supply 4,096 far above one node) at the first and the
             final eps, (b) a TransportMixed batch (G = 8), (c) scarce
             capacity, equal levels (holder/bid ties), a NEG_INF row, a warm
             price, the max_rounds cut, a warm x0 that overfills nodes and
             G = 2,100 (the exchange and the candidates in global memory);
             exact x, price, level, rounds; each line gives the CUDA launches
             and host syncs of the call and the cluster plan, the timed case
             us a round
  kernel_F   the Sinkhorn kernel (one thread-block cluster a call) against
             _sinkhorn_iters_plain on the Transport_50k and TransportMixed
             batch problems and on ample, scarce, all-infeasible-row and
             warm-g problems, G 128 x N 10,000 (z in global memory) and G
             2,100 x N 40 (the exchange in global memory): f and g after 60
             iterations, and the plan from the same duals, to a relative
             error of 1e-5 (|a - b| / max(|b|, 1e-6)), and the 60-iteration
             plan to 1e-4 (PLAN_TOL); launches, host syncs and the plan per
             line, the timed case us an iteration
  main_path_transport
             BatchScheduler(solver="auction" and "sinkhorn") on Transport_50k
             (5,000 nodes of 16 cpu / 64Gi / 110 pods, 50,000 pods of
             500m/1Gi: 13 batches of one group, warm duals across them) and
             TransportMixed (5,000 nodes of 8 cpu / 16Gi, even ones
             disk=ssd, 10,000 pods in four shapes, every fourth with
             nodeSelector disk=ssd: 8 groups a batch): every pod bound, no
             over-commit, ssd pods on ssd nodes, the transport path with no
             solver failure, kernels J and E/F launched; a CPU rerun places
             the auction identically and the sinkhorn the same count; the
             initial-state utility beside fast and exact on the same card;
             the solve stage per batch split into the kernels' device time
             (CUDA events around each E/F and J call) and the rest
  transport_direct
             one transport_solve per method on the 50,000 pods (G = 1) and
             on the 100k-pod / 10k-node two-shape problem (bench.py:2594),
             unsharded: pods/s, the kernels' device time, and the plain
             versions' solution on the card (auction identical)
  main_path_defrag
             Defrag_5000, the JAX Defrag rung (bench.py:1757-1930) at the gang
             phases' 5,000 nodes: 20 slices of 250 nodes of 8 cpu / 32Gi /
             110 pods, a bound 3-cpu priority-1 filler on every node, a
             PodGroup of 250 ranked 6-cpu priority-100 members, under
             BatchScheduler(solver="fast"). ON: enable_rebalancer(0.25, 64 a
             wave, 256 a cycle, ceiling 50), cycles until one migrates
             nothing, then the gang; OFF: no rebalancer, the gang admits
             through the victim cover. Gates: the gang bound on both legs, ON
             0 victims and OFF more, ON migrated and no cycle over 256, a
             donor slice wholly drained, conservation through resolve_keys,
             kernel I launched, and the ON leg's maps, cycles and migration
             chain equal to a CPU rerun; the ON line names the rebalancer's
             candidate route (the store's columnar view, or a list) and
             reports the admission window's own store.list polls apart
             (admission_poll_s)
  kernel_I   the defrag-assign kernel (a tournament tree) against
             defrag_assign_plain: (a) the Defrag_5000 cycle's own tensors
             (n_slots 8,192, v_max 256, R 3), (b) the cap, 1,024 seeded
             victims on 5,000 nodes, some unplaceable, (c) ties, headroom 0,
             no target, pad rows and slots, negative free, a wrapping waste
             sum, (d) n_slots 32,768 x R 4, beyond the shared-memory path,
             (e) 1,024 victims in runs of 1-64 identical requests; exact
             equality; each line gives the CUDA launches (1), the plan, the
             tree's rebuilds and leaf updates as the kernel counts them
             (checked against testing.defrag_tree_model's) and the device
             time, cases a, b and e the wall time
  kernels    one line per kernel: launches on its main path, error against
             the plain version, times (CUDA events) and the bound
Then the nvidia-smi line, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. A failed phase exits non-zero before the
last line. Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.

Sizes are scheduler_perf's SchedulingBasic 5000Nodes_10000Pods and the
TopologySpreading shape (test/integration/scheduler_perf/misc/
performance-config.yaml), nodes 8 cpu / 32Gi / 110 pods; the gang shapes
are the JAX package's gang rungs (bench.py:1529-1660) and their scale-up
to those 5,000 nodes; the transport shapes are the JAX Transport rung's
(bench.py:2561-2640) and the reference's node-selector test at that size;
Defrag_5000 is the JAX Defrag rung scaled to those 5,000 nodes. Inputs are made from --seed. --small runs every phase
at a reduced size.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import subprocess
import sys
import time

import numpy as np

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_A_SRC = "kubernetes_tpu_torch/csrc/greedy_scan.cu"
KERNEL_B_SRC = "kubernetes_tpu_torch/csrc/row_scatter.cu"
KERNEL_C_SRC = "kubernetes_tpu_torch/csrc/waterfill.cu"
KERNEL_D_SRC = "kubernetes_tpu_torch/csrc/repair_check.cu"
KERNEL_G_SRC = "kubernetes_tpu_torch/csrc/cover_curve.cu"
KERNEL_H_SRC = "kubernetes_tpu_torch/csrc/rank_align.cu"
KERNEL_J_SRC = "kubernetes_tpu_torch/csrc/feasibility_rows.cu"
KERNEL_E_SRC = "kubernetes_tpu_torch/csrc/auction_phase.cu"
KERNEL_F_SRC = "kubernetes_tpu_torch/csrc/sinkhorn.cu"
KERNEL_I_SRC = "kubernetes_tpu_torch/csrc/defrag_assign.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# workloads (seeded)
# ---------------------------------------------------------------------------


def make_nodes(n, zones=0, taints=False, seed=0):
    from kubernetes_tpu_torch.testing import MakeNode

    rng = random.Random(seed)
    out = []
    for i in range(n):
        labels = {HOST: f"node-{i}"}
        if zones:
            labels[ZONE] = f"zone-{i % zones}"
        b = MakeNode(f"node-{i}").labels(labels).capacity(
            {"cpu": "8", "memory": "32Gi", "pods": "110"})
        if taints and i % 7 == 0:
            b = b.taints([{"key": "spot", "value": "true", "effect": "NoSchedule"}])
        elif taints and rng.random() < 0.1:
            b = b.taints([{"key": "old", "value": "1", "effect": "PreferNoSchedule"}])
        out.append(b.obj())
    return out


def basic_pods(p, prefix="pod"):
    from kubernetes_tpu_torch.testing import MakePod

    return [MakePod(f"{prefix}-{i}").req({"cpu": "500m", "memory": "1Gi"}).obj()
            for i in range(p)]


def spread_pods(p, prefix="sp"):
    from kubernetes_tpu_torch.testing import MakePod

    return [MakePod(f"{prefix}-{i}").labels({"app": "spread"})
            .req({"cpu": "200m", "memory": "256Mi"})
            .topology_spread(1, ZONE, "DoNotSchedule", {"app": "spread"}).obj()
            for i in range(p)]


def anti_pods(groups, size, prefix="anti"):
    from kubernetes_tpu_torch.testing import MakePod

    return [MakePod(f"{prefix}-{g}-{i}").labels({"grp": f"g{g}"})
            .pod_anti_affinity(HOST, {"grp": f"g{g}"}).req({"cpu": "200m"}).obj()
            for g in range(groups) for i in range(size)]


def affinity_seeds(zones):
    from kubernetes_tpu_torch.testing import MakePod

    return [MakePod(f"seed-{z}").labels({"svc": f"s{z}"}).node(f"node-{z}")
            .req({"cpu": "100m"}).obj() for z in range(zones)]


def affinity_pods(p, zones, prefix="aff"):
    from kubernetes_tpu_torch.testing import MakePod

    return [MakePod(f"{prefix}-{i}").labels({"peer": "1"})
            .pod_affinity(ZONE, {"svc": f"s{i % zones}"}).req({"cpu": "200m"}).obj()
            for i in range(p)]


def mixed_pods(p, seed):
    """IPA required anti-affinity and preferred (anti-)affinity, PTS
    ScheduleAnyway and DoNotSchedule, host ports, taints/tolerations,
    preferred node affinity."""
    from kubernetes_tpu_torch.testing import MakePod

    rng = random.Random(seed)
    out = []
    for i in range(p):
        kind = i % 5
        b = MakePod(f"mx-{i}").req({"cpu": f"{rng.choice([100, 250, 500])}m",
                                    "memory": f"{rng.choice([128, 512, 1024])}Mi"})
        if kind == 0:
            b = b.labels({"app": "db"}).pod_anti_affinity(HOST, {"app": "db"})
        elif kind == 1:
            b = (b.labels({"app": "web"}).preferred_pod_affinity(50, ZONE, {"app": "db"})
                 .topology_spread(1, ZONE, "ScheduleAnyway", {"app": "web"}))
        elif kind == 2:
            b = MakePod(f"mx-{i}").req({"cpu": "100m"}, host_port=8080 + i % 3) \
                .toleration("spot", "true", effect="NoSchedule")
        elif kind == 3:
            b = (b.labels({"app": "cache"}).preferred_pod_anti_affinity(30, HOST, {"app": "cache"})
                 .topology_spread(2, ZONE, "DoNotSchedule", {"app": "cache"})
                 .toleration("old", "1", effect="PreferNoSchedule"))
        else:
            b = b.preferred_node_affinity(10, ZONE, [f"zone-{rng.randrange(10)}"])
        out.append(b.obj())
    return out


def tensorize(nodes, pods, device, bound=()):
    """The port's host pipeline on a fixed cluster: cache -> snapshot ->
    tensorizer -> make_inputs. Returns (inputs, d_max, gates, batch)."""
    from kubernetes_tpu_torch.ops.solver import make_inputs
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.snapshot.tensorizer import TensorCache, build_pod_batch

    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster, _ = TensorCache().cluster_tensors(snap)
    batch = build_pod_batch(pods, snap, cluster)
    inputs, d_max = make_inputs(cluster, batch, device)
    gates = dict(has_ipa=bool(batch.ipa.has_any), has_ct=bool(batch.ct_class.size),
                 has_st=bool(batch.st_class.size), has_gang=False)
    return inputs, d_max, gates, batch


def pod_slice(inp, k):
    return inp._replace(req=inp.req[:k].contiguous(), req_nz=inp.req_nz[:k].contiguous(),
                        class_of_pod=inp.class_of_pod[:k].contiguous(),
                        balanced_active=inp.balanced_active[:k].contiguous())


def kernel_a_work(inp, d_max, gates):
    """(bytes, operations) kernel A needs for these inputs: every input read
    once and every output written once; operations counted per (pod, node)
    step from the terms this batch's classes actually carry."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in inp if isinstance(t, torch.Tensor))
    p, n = inp.req.shape[0], inp.alloc.shape[0]
    r, pt = inp.alloc.shape[1], inp.class_ports.shape[1]
    nbytes += p * 4 + n * r * 4 + n * 4  # assignment, used, pod_count
    cls = inp.class_of_pod.clamp(min=0).cpu()
    terms = torch.zeros(inp.filter_ok.shape[0], dtype=torch.int64)
    if gates["has_ipa"]:
        for t in (inp.ra_key, inp.rn_key, inp.pp_key, inp.ea_grp, inp.sym_grp):
            terms += (t.cpu() >= 0).sum(dim=1)
    for flag, col in (("has_ct", inp.ct_class), ("has_st", inp.st_class)):
        if gates[flag]:
            cc = col.cpu()
            terms += torch.stack([(cc == c).sum() for c in range(terms.shape[0])])
    # base step: fit 3R, ports 2Pt, least/balanced/normalizers/total/argmax ~40;
    # each active term: segment add, domain read, compare/accumulate ~4
    ops = int((p * (3 * r + 2 * pt + 40) + 4 * int(terms[cls].sum())) * n)
    return nbytes, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def timed_ms(fn, iters, device, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, prefixes, device, iters=50, contains=False, with_count=False,
              per_call=1):
    """Device time per call of fn (ms), from the CUDA kernels whose names
    start with (contains: hold) one of `prefixes` in one torch.profiler trace
    of `iters` calls: the median duration of the kernel records the trace
    holds times `per_call`, the kernels a call launches (None: the summed
    durations over `iters`, for calls whose kernels differ). Before it, two
    calls outside any trace and a discarded trace of up to three calls. A
    trace can miss the records of its first kernels (one of 10-50 in most
    phases; late in a run, every record of kernel I's traces, while a second
    trace right after held them) and hold one of them cut short, so the
    median of the records held, not their sum over `iters`. None on the CPU,
    when the trace holds no such kernel, or when it holds more than `iters`
    x `per_call` (the time is then not measured).
    with_count: (ms, such kernels the trace held a call)."""
    import torch

    if device.type != "cuda":
        return (None, None) if with_count else None
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(min(3, iters)):
            fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def match(name):
        name = name.removeprefix("void ")
        return (any(x in name for x in prefixes) if contains
                else name.startswith(tuple(prefixes)))

    durations = sorted(ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type.name == "CUDA" and match(ev.name))
    count = len(durations)
    ms = None
    if per_call and count > iters * per_call:
        # more such kernels than the calls launch: the median would be one
        # kernel's time, not a call's
        print(f"chip_smoke: the trace held {count} {prefixes} kernels, more than "
              f"{iters} calls x {per_call}: device time not measured", file=sys.stderr)
    elif count:
        ms = (durations[count // 2] * per_call if per_call else sum(durations) / iters) / 1e3
        if per_call and count < iters * per_call:
            print(f"chip_smoke: the trace held {count} of {iters * per_call} {prefixes} kernels",
                  file=sys.stderr)
    else:
        keys = [(ev.key[:60], ev.count) for ev in prof.key_averages()]
        print(f"chip_smoke: the profiler saw no {prefixes} kernel: {keys[:12]}", file=sys.stderr)
    return (ms, count / iters) if with_count else ms


class KernelClock:
    """While active, each call of the named launch wrappers of
    kubernetes_tpu_torch.ops.kernels is bracketed by two CUDA events on the
    current stream; ms() gives the summed event time per wrapper (the kernels'
    device time, with nothing else queued between the events). A no-op off
    the card."""

    def __init__(self, device, names=("launch_auction_phase", "launch_sinkhorn_iters",
                                      "launch_feasibility_rows")):
        self.device, self.names, self.events, self.saved = device, names, {}, {}

    def __enter__(self):
        import torch

        from kubernetes_tpu_torch.ops import kernels

        if self.device.type != "cuda":
            return self
        for name in self.names:
            fn = self.saved[name] = getattr(kernels, name)
            pairs = self.events.setdefault(name, [])

            def timed(*args, _fn=fn, _pairs=pairs, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kw)
                end.record()
                _pairs.append((start, end))
                return out

            setattr(kernels, name, timed)
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.ops import kernels

        for name, fn in self.saved.items():
            setattr(kernels, name, fn)
        self.saved = {}
        return False

    def ms(self):
        import torch

        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize()
        return {name.removeprefix("launch_"): sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(device):
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": out,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from kubernetes_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill", "smem", "bytes stack"))]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3), "ptxas": ptxas})


def scan_plan():
    from kubernetes_tpu_torch.ops import kernels

    plan = kernels.LAST_SCAN_PLAN
    return {k: plan.get(k) for k in ("cluster_size", "ctas", "threads", "nodes_per_cta",
                                     "smem_bytes", "in_smem", "global_bytes_per_cta")}


def compare_a(name, inp, d_max, gates, device, plain_pods, iters):
    from kubernetes_tpu_torch.ops.solver import greedy_scan_solve, greedy_scan_solve_plain

    p = inp.req.shape[0]
    pp = min(p, plain_pods)
    sub = pod_slice(inp, pp)
    got = greedy_scan_solve(sub, d_max, **gates)
    sync(device)
    t0 = time.perf_counter()
    ref = greedy_scan_solve_plain(sub, d_max, **gates)
    sync(device)
    plain_s = time.perf_counter() - t0
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, ref))
    equal = all(bool((a == b).all()) for a, b in zip(got, ref))
    kernel_ms = timed_ms(lambda: greedy_scan_solve(inp, d_max, **gates), iters, device)
    placed = int((got[0] >= 0).sum())
    line = {"phase": "kernel_A", "case": name, "nodes": inp.alloc.shape[0], "pods": p,
            "plain_pods": pp, "gates": gates, "d_max": d_max, "equal": equal,
            "max_abs_err": err, "placed_of_plain_pods": placed,
            "kernel_ms_all_pods": kernel_ms, "us_per_pod_step": kernel_ms * 1e3 / max(p, 1),
            "plan": scan_plan(), "plain_s": round(plain_s, 3)}
    if pp < p:
        line["note"] = f"plain version compared on the first {pp} of {p} pods"
    emit(line)
    check(equal, f"kernel A differs from its plain version on case {name}")
    return err, got[0].cpu()


def scan_edge_cases(sizes, seed):
    """Kernel A's cluster edge cases as seeded synthetic problems
    (kubernetes_tpu_torch.testing.scan_problem, every gate on): one node and
    seven (fewer than the cluster's CTAs), a node count that is no multiple
    of the cluster size, identical nodes (every argmax ties across CTA
    boundaries), pods that fit nowhere, the hostname key (d_max = N: the
    domain tables in global memory) and a node axis past shared memory (the
    global-scratch path)."""
    n = sizes["nodes"]
    return [("d_one_node", dict(n=1, p=16)), ("e_seven_nodes", dict(n=7, p=48)),
            ("f_n_not_multiple", dict(n=n // 5 + 3, p=200)),
            ("g_identical_ties", dict(n=n, p=512, identical=True)),
            ("h_fits_nowhere", dict(n=64, p=60, huge_every=3)),
            ("i_hostname_key", dict(n=n + 3, p=256)),
            ("j_global_scratch", dict(n=sizes["scan_global_nodes"], p=24))]


def phase_kernel_a(device, sizes, seed):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy
    from kubernetes_tpu_torch.testing import scan_problem

    n, p_basic, p_spread, p_mixed = sizes["nodes"], sizes["basic"], sizes["spread"], sizes["mixed"]
    errs = []
    inp_a, d_a, g_a, _ = tensorize(make_nodes(n), basic_pods(p_basic), device)
    errs.append(compare_a("a_scheduling_basic", inp_a, d_a, g_a, device, sizes["plain"], 3)[0])
    inp_b, d_b, g_b, _ = tensorize(make_nodes(n, zones=10), spread_pods(p_spread), device)
    errs.append(compare_a("b_topology_spreading", inp_b, d_b, g_b, device, sizes["plain"], 3)[0])
    # mixed: pre-bound anti-affine holders seed the holder groups (rule 1 and
    # the symmetric score); a synthetic gang-bonus row turns on the last gate
    from kubernetes_tpu_torch.testing import MakePod

    bound = []
    for i in range(0, n, max(n // 50, 1)):
        b = MakePod(f"held-{i}").labels({"app": "db"}).req({"cpu": "250m"}) \
            .pod_anti_affinity(HOST, {"app": "db"}).obj()
        b.spec.node_name = f"node-{i}"
        bound.append(b)
    inp_c, d_c, g_c, _ = tensorize(make_nodes(n, zones=10, taints=True, seed=seed),
                                   mixed_pods(p_mixed, seed), device, bound=bound)
    rng = np.random.default_rng(seed)
    bonus = rng.integers(0, 30, size=tuple(inp_c.filter_ok.shape)).astype(np.int32)
    inp_c = inp_c._replace(gang_bonus=torch.from_numpy(bonus).to(device))
    g_c = dict(g_c, has_gang=True)
    check(all(g_c.values()), f"mixed case does not turn on every gate: {g_c}")
    errs.append(compare_a("c_mixed_all_gates", inp_c, d_c, g_c, device, sizes["plain"], 3)[0])
    all_gates = dict(has_ipa=True, has_ct=True, has_st=True, has_gang=True)
    for name, kw in scan_edge_cases(sizes, seed):
        f, d_max = scan_problem(seed + kw["n"], **kw)
        gates = dict(all_gates, has_gang=f["gang_bonus"] is not None)
        inp = solver_inputs_from_numpy(f, device)
        err, got = compare_a(name, inp, d_max, gates, device, kw["p"], 1)
        errs.append(err)
        if name == "g_identical_ties":
            k = min(kw["n"], kw["p"])
            check(got[:k].tolist() == list(range(k)),
                  "kernel A: identical nodes did not tie to the lowest index")
        if name == "h_fits_nowhere":
            check(bool((got[::3] == -1).all()), "kernel A placed a pod that fits nowhere")
        if name == "j_global_scratch" and device.type == "cuda":
            check("class_rows" not in kernels.LAST_SCAN_PLAN["in_smem"],
                  "kernel A case j does not leave shared memory")

    # the main path's shape: the first batch_size pods of SchedulingBasic
    k = min(sizes["batch"], p_basic)
    first = pod_slice(inp_a, k)
    from kubernetes_tpu_torch.ops.solver import greedy_scan_solve, greedy_scan_solve_plain

    ms = timed_ms(lambda: greedy_scan_solve(first, d_a, **g_a), 5, device)
    plan = scan_plan()
    dev_ms = device_ms(lambda: greedy_scan_solve(first, d_a, **g_a), ["greedy_scan_kernel"],
                       device, iters=3)
    plain_ms = timed_ms(lambda: greedy_scan_solve_plain(first, d_a, **g_a), 1, device, warmup=0)
    nbytes, ops = kernel_a_work(first, d_a, g_a)
    b_ms, b_by = bound_ms(nbytes, ops)
    timing = {"phase": "kernel_A_timing", "shape": f"{first.alloc.shape[0]} nodes x {k} pods",
              "ms": ms, "us_per_pod_step": ms * 1e3 / k, "device_ms": dev_ms,
              "plan": plan, "plain_ms": plain_ms,
              "bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by}
    emit(timing)
    return max(errs), timing


def phase_kernel_b(device, sizes, seed):
    import torch

    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.snapshot.tensorizer import (
        MirrorSegment, TensorCache, pack_mirror_rows, scatter_cols, scatter_cols_plain,
        scatter_mirrors_plain, scatter_rows, scatter_rows_plain)
    from kubernetes_tpu_torch.testing import mirror_churn_rounds

    rng = np.random.default_rng(seed)
    n, r, sc = sizes["nodes"], 3, 4
    # single-mirror entry (scatter_rows / scatter_cols: one descriptor)
    base = rng.integers(0, 1 << 20, size=(n, r), dtype=np.int32)
    rows_k = rng.integers(0, 1 << 20, size=n, dtype=np.int32)
    cols_m = rng.integers(0, 100, size=(sc, n), dtype=np.int32)
    dst = {"2d": torch.from_numpy(base.copy()).to(device),
           "1d": torch.from_numpy(rows_k.copy()).to(device),
           "cols": torch.from_numpy(cols_m.copy()).to(device)}
    ref = {k: v.clone() for k, v in dst.items()}
    err = 0
    for _ in range(8):
        k = int(rng.integers(1, n))
        idx = torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)).to(device)
        src2 = torch.from_numpy(rng.integers(0, 1 << 20, size=(k, r), dtype=np.int32)).to(device)
        src1 = torch.from_numpy(rng.integers(0, 1 << 20, size=k, dtype=np.int32)).to(device)
        srcc = torch.from_numpy(rng.integers(0, 100, size=(sc, k), dtype=np.int32)).to(device)
        scatter_rows(dst["2d"], idx, src2)
        scatter_rows_plain(ref["2d"], idx, src2)
        scatter_rows(dst["1d"], idx, src1)
        scatter_rows_plain(ref["1d"], idx, src1)
        scatter_cols(dst["cols"], idx, srcc)
        scatter_cols_plain(ref["cols"], idx, srcc)
    sync(device)
    for key in dst:
        err = max(err, int((dst[key].long() - ref[key].long()).abs().max()))
    equal = all(bool((dst[key] == ref[key]).all()) for key in dst)
    # fused: seeded churn rounds, k = 1 and k = N among them, with and
    # without the selector-class columns; kernel B against its plain version
    fused_equal = True
    for with_sc in (False, True):
        ks = [n // 2, 1, n, *rng.integers(1, n, size=4).tolist()]
        rounds = mirror_churn_rounds(seed + int(with_sc), n, r, sc, rounds=len(ks), ks=ks)
        cl, _ = next(rounds)
        names = list(TensorCache.DEVICE_FIELDS) + (["selcls_count"] if with_sc else [])
        got = {f: torch.from_numpy(getattr(cl, f).copy()).to(device) for f in names}
        want = {f: t.clone() for f, t in got.items()}
        for cl, rows in rounds:
            packed, segs = pack_mirror_rows(cl, rows, with_sc)
            dev_packed = torch.from_numpy(packed).to(device)
            if device.type == "cuda":
                mset = kernels.MirrorSet([(got[g.name], g.offset, g.width, g.col_mode)
                                          for g in segs], packed.shape[1])
                kernels.launch_mirror_scatter(mset, dev_packed, len(rows))
            else:
                scatter_mirrors_plain([got[g.name] for g in segs], dev_packed, segs)
            scatter_mirrors_plain([want[g.name] for g in segs], dev_packed, segs)
        sync(device)
        for f in names:
            err = max(err, int((got[f].long() - want[f].long()).abs().max()))
            fused_equal &= bool((got[f] == want[f]).all())
            fused_equal &= bool((got[f].cpu().numpy() == getattr(cl, f)).all())

    # (a) one call at the main path's shape: one [N, 3] field, batch_size
    # rows, already packed as [k, 1 + 3] (indices in column 0) and scattered
    # with a one-descriptor set; index_copy_ takes the same rows and values
    k = min(sizes["batch"], n)
    idx = torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)).to(device)
    src = torch.from_numpy(rng.integers(0, 1 << 20, size=(k, r), dtype=np.int32)).to(device)
    idx_long = idx.long()
    one = torch.cat([idx.view(k, 1), src], dim=1)
    if device.type == "cuda":
        mset_one = kernels.MirrorSet([(dst["2d"], 1, r, False)], 1 + r)

        def one_call():
            kernels.launch_mirror_scatter(mset_one, one, k)
    else:
        def one_call():
            scatter_mirrors_plain([dst["2d"]], one, [MirrorSegment("alloc", 1, r, False)])
    ms = timed_ms(one_call, 200, device)
    plain_ms = timed_ms(lambda: scatter_rows_plain(ref["2d"], idx, src), 200, device)
    library_ms = timed_ms(lambda: ref["2d"].index_copy_(0, idx_long, src), 200, device)
    ms_again = timed_ms(one_call, 200, device)
    sync(device)
    check(bool((dst["2d"] == ref["2d"]).all()),
          "kernel B (one descriptor) differs from index_copy_")
    dev_ms = device_ms(one_call, ["mirror_scatter_kernel"], device)
    lib_dev_ms = device_ms(lambda: ref["2d"].index_copy_(0, idx_long, src), ["index"], device,
                           contains=True, per_call=None)
    nbytes = k * 4 + 2 * k * r * 4  # indices + source read, destination rows written
    b_ms, b_by = bound_ms(nbytes, 0)
    # (b) the whole mirror update of one incremental batch at the main
    # path's shape (batch_size dirty rows of N): SchedulingBasic's five
    # fields, and TopologySpreading's with its selector-class columns
    batches = {}
    for name, n_sc in (("SchedulingBasic", 0), ("TopologySpreading", 1)):
        cl, _ = next(mirror_churn_rounds(seed, n, r, max(n_sc, 1)))
        if not n_sc:
            cl.selcls_count = np.zeros((0, n), np.int32)
        batches[name] = batch_update_times(cl, k, device, rng)
    line = {"phase": "kernel_B", "nodes": n, "rounds": 8, "equal": equal,
            "fused_equal": fused_equal, "max_abs_err": err,
            "timing_shape": f"[{n},{r}] int32, {k} rows packed [{k},{1 + r}], one descriptor",
            "ms": ms, "ms_again": ms_again,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": lib_dev_ms, "library_call": "Tensor.index_copy_",
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by, "batch": batches}
    emit(line)
    check(equal, "kernel B (one mirror) differs from its plain version")
    check(fused_equal, "kernel B (fused) differs from its plain version")
    check(all(b["same_mirrors"] for b in batches.values()),
          "kernel B: the fused batch update and the library route differ")
    if device.type == "cuda":
        check(all(b["launches_per_batch"] == 1 for b in batches.values()),
              f"kernel B: an incremental batch is not one launch: {batches}")
    return err, line


def batch_update_times(cl, k, device, rng, iters=50):
    """Wall ms of one incremental TensorCache.device_views (the dirty set,
    pack, one pinned copy, one kernel-B launch, synchronized) against the
    library route through the same path (the same pack and copy, then
    index_copy_ per field and index_copy_(1, ...) for the columns), both
    device times, and kernel B's launches per batch."""
    import torch

    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.snapshot.tensorizer import TensorCache

    class LibraryRoute(TensorCache):
        def _scatter_packed(self, packed, segs):
            idx = packed[:, 0].long()
            for t, g in zip(self._mirrors(segs), segs):
                part = packed[:, g.offset:g.offset + g.width]
                if g.col_mode:
                    t.index_copy_(1, idx, part.t())
                elif t.dim() == 1:
                    t.index_copy_(0, idx, part[:, 0])
                else:
                    t.index_copy_(0, idx, part)

    row_sets = [np.sort(rng.choice(cl.alloc.shape[0], size=k, replace=False)).tolist()
                for _ in range(4)]

    def route(cache):
        cache.device_views(cl, device)
        step = [0]

        def one():
            cache._dirty_rows.update(row_sets[step[0] % 4])
            step[0] += 1
            return cache.device_views(cl, device)

        return one

    ours, library = route(TensorCache()), route(LibraryRoute())

    def wall(fn):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            sync(device)
        return (time.perf_counter() - t0) * 1e3 / iters

    before = kernels.LAUNCHES["row_scatter"]
    views = ours()
    launches = kernels.LAUNCHES["row_scatter"] - before
    lib_views = library()
    sync(device)
    same = all(bool((views[f] == lib_views[f]).all()) for f in views)
    names = sorted(views)
    return {"k": k, "fields": names, "ms": wall(ours), "library_ms": wall(library),
            "ms_again": wall(ours), "library_ms_again": wall(library),
            "launches_per_batch": launches, "same_mirrors": same,
            "device_ms": device_ms(ours, ["mirror_scatter_kernel"], device, iters=20),
            "library_device_ms": device_ms(library, ["index"], device, iters=20, contains=True,
                                           per_call=None)}


# ---------------------------------------------------------------------------
# kernel C: waterfill
# ---------------------------------------------------------------------------


def group_call(inp, members, cls, j_max, gang_row=None):
    """The arguments of one waterfill_group call for a group of a tensorized
    batch, as models/waterfill.py waterfill_solve makes them."""
    from kubernetes_tpu_torch.models.waterfill import k_slots_for

    n = inp.alloc.shape[0]
    pi0 = int(members[0])
    cports = inp.class_ports[cls]
    port_conflict = (inp.node_ports & cports[None, :]).any(dim=1)
    args = (inp.alloc, inp.used, inp.used_nz, inp.pod_count, inp.max_pods, inp.filter_ok[cls],
            port_conflict, bool(cports.any()), inp.napref_raw[cls], inp.has_napref[cls],
            inp.taint_cnt[cls], inp.img_score[cls], inp.req[pi0], inp.req_nz[pi0],
            inp.balanced_active[pi0], len(members))
    kw = dict(j_max=j_max, k_slots=k_slots_for(len(members), n, j_max), gang_row=gang_row,
              has_gang=gang_row is not None)
    return args, kw


def kernel_c_work(args, kw, placed):
    """(bytes, operations) of one waterfill group: every input read once and
    every output written once; operations: the per-node fit depth and
    normalizers, ~32 per slot for LeastAllocated + Balanced + running min +
    key, one comparison per slot for the selection, and m log2 m to order
    the m placed slots."""
    import math

    import torch

    alloc = args[0]
    n, r = alloc.shape
    j_max, k = kw["j_max"], kw["k_slots"]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if kw["gang_row"] is not None:
        tensors.append(kw["gang_row"])
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + n * 4 + k * 4
    slots = n * j_max
    ops = n * (3 * r + 20) + slots * 33 + int(placed * max(1.0, math.log2(max(placed, 1))))
    return nbytes, ops


def compare_c(name, args, kw, device, iters):
    from kubernetes_tpu_torch.models.waterfill import waterfill_group, waterfill_group_plain
    from kubernetes_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["waterfill"]
    cuda_before = kernels.CUDA_LAUNCHES["waterfill"]
    got = waterfill_group(*args, **kw)
    sync(device)
    launched = kernels.LAUNCHES["waterfill"] - before
    cuda_launched = kernels.CUDA_LAUNCHES["waterfill"] - cuda_before
    ref = waterfill_group_plain(*args, **kw)
    sync(device)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref))
    equal = all(a.dtype == b.dtype and bool((a == b).all()) for a, b in zip(got, ref))
    placed = int(got[0].sum())
    ms = timed_ms(lambda: waterfill_group(*args, **kw), iters, device)
    plain_ms = timed_ms(lambda: waterfill_group_plain(*args, **kw), max(iters // 5, 1), device)
    nbytes, ops = kernel_c_work(args, kw, placed)
    b_ms, b_by = bound_ms(nbytes, ops)
    line = {"phase": "kernel_C", "case": name, "nodes": args[0].shape[0], "group": args[-1],
            "j_max": kw["j_max"], "k_slots": kw["k_slots"], "has_port": args[7],
            "has_gang": kw["has_gang"], "equal": equal, "max_abs_err": err, "placed": placed,
            "chosen_in_order": int((got[1] >= 0).sum()), "launches": launched,
            "cuda_launches": cuda_launched, "plan": dict(kernels.LAST_WATERFILL_PLAN),
            "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms(lambda: waterfill_group(*args, **kw), ("waterfill_kernel",),
                                   device, iters=20),
            "bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by}
    emit(line)
    check(equal, f"kernel C differs from its plain version on case {name}")
    check(device.type != "cuda" or launched == cuda_launched == 1,
          f"kernel C did not launch once on case {name}: {launched} calls, "
          f"{cuda_launched} CUDA launches")
    check(placed > 0 and placed == line["chosen_in_order"], f"kernel C placed nothing on {name}")
    return line


def phase_kernel_c(device, sizes, seed):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models.waterfill import bucket_j_max, make_groups
    from kubernetes_tpu_torch.testing import MakePod

    n = sizes["nodes"]
    lines = []

    def first_group(nodes, pods, bound=(), gang=False):
        inp, _, _, batch = tensorize(nodes, pods, device, bound=bound)
        members, cls = make_groups(batch)[0]
        j_max = bucket_j_max(inp.max_pods, inp.pod_count, n, 2_600_000)
        gang_row = None
        if gang:
            rng = np.random.default_rng(seed)
            gang_row = torch.from_numpy(rng.integers(0, 100, size=n).astype(np.int32)).to(device)
        return group_call(inp, members, cls, j_max, gang_row)

    # (a) the main path's group: SchedulingBasic, batch_size identical pods
    args, kw = first_group(make_nodes(n), basic_pods(sizes["batch"], "ca"))
    lines.append(compare_c("a_scheduling_basic", args, kw, device, 20))
    # (b) a group past the shared-memory sort: the global merge path
    args, kw = first_group(make_nodes(n), basic_pods(sizes["group_big"], "cb"))
    check(kw["k_slots"] > 4096, f"case b does not reach the global sort: k_slots {kw['k_slots']}")
    lines.append(compare_c("b_global_sort", args, kw, device, 5))
    # (c) host ports (some taken by bound pods), preferred node affinity,
    # PreferNoSchedule taints, a seeded gang row, a group below 256 slots
    holders = []
    for i in range(0, n, 13):
        h = MakePod(f"port-holder-{i}").req({"cpu": "100m"}, host_port=9090).obj()
        h.spec.node_name = f"node-{i}"
        holders.append(h)
    pods = [MakePod(f"cc-{i}").req({"cpu": "300m", "memory": "512Mi"}, host_port=9090)
            .preferred_node_affinity(20, ZONE, ["zone-3", "zone-5"]).obj() for i in range(100)]
    args, kw = first_group(make_nodes(n, zones=10, taints=True, seed=seed), pods, holders,
                           gang=True)
    check(args[7] and kw["k_slots"] > args[-1], "case c misses the port cap or the 256 floor")
    lines.append(compare_c("c_ports_napref_taints_gang", args, kw, device, 20))
    # (d) nodes over-committed by bound pods: negative free capacity
    hogs = []
    for i, req in enumerate(({"cpu": "12"}, {"memory": "40Gi"}, {"cpu": "7900m"})):
        h = MakePod(f"hog-{i}").req(req).obj()
        h.spec.node_name = f"node-{i}"
        hogs.append(h)
    args, kw = first_group(make_nodes(n), basic_pods(sizes["batch"] // 2, "cd"), hogs)
    check(int((args[0] - args[1]).min()) < 0, "case d has no over-committed node")
    lines.append(compare_c("d_overcommitted", args, kw, device, 20))
    return max(ln["max_abs_err"] for ln in lines), lines[0]


# ---------------------------------------------------------------------------
# kernel D: repair_check
# ---------------------------------------------------------------------------


def placed_check_args(inp, batch, rng, frac=0.95):
    """A seeded random placement of a tensorized batch as repair_check's
    arguments (device tensors): the pod axis padded to a pow2 >= 256, the
    count rows including every placed pod."""
    import numpy as np
    import torch

    device = inp.alloc.device
    p, n = len(batch.pods), inp.alloc.shape[0]
    cls = np.asarray(batch.class_of_pod, dtype=np.int32)
    node_of = rng.integers(0, n, size=p).astype(np.int32)
    node_of[rng.random(p) > frac] = -1
    placed = node_of >= 0
    sel = inp.selcls_count.cpu().numpy().astype(np.int64)
    grp = inp.grp_count.cpu().numpy().astype(np.int64)
    np.add.at(sel.T, node_of[placed], inp.class_matches_selcls.cpu().numpy()[cls[placed]])
    np.add.at(grp.T, node_of[placed], inp.class_holds_grp.cpu().numpy()[cls[placed]])
    pb = max(256, 1 << (p - 1).bit_length())
    node_pad = np.full(pb, -1, np.int32)
    node_pad[:p] = node_of
    cls_pad = np.zeros(pb, np.int32)
    cls_pad[:p] = cls

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(node_pad), t(cls_pad), t(sel.astype(np.int32)), t(grp.astype(np.int32)),
            inp.topo_id, inp.rn_key, inp.rn_sel, inp.ea_grp, inp.ra_key, inp.ra_sel,
            inp.class_matches_selcls, inp.class_holds_grp, inp.grp_key, inp.aff_ok,
            inp.ct_class, inp.ct_key, inp.ct_sel, inp.ct_max_skew, inp.ct_min_domains)


def kernel_d_work(args, has_affinity, has_ct):
    """(bytes, operations) of one check: the inputs its gates read, once,
    and the four masks written; operations: segment sums of every count row
    under every key, the spread rows' domain pass, ~8 per pod term."""
    node_of, cls_of, sel, grp, topo = args[:5]
    pb = node_of.numel()
    kk, n = topo.shape
    ct = args[14].numel()
    nbytes = 2 * pb * 4 + topo.numel() * 4 + 4 * pb
    ops = 4 * pb
    if has_affinity:
        tables = args[5:13]
        nbytes += (sel.numel() + grp.numel()) * 4 + sum(t.numel() * 4 for t in tables)
        terms = args[5].shape[1] + args[7].shape[1] + args[8].shape[1]
        ops += 2 * kk * (sel.shape[0] + grp.shape[0]) * n + 8 * pb * terms
    if has_ct:
        nbytes += ct * n * 5 + ct * 5 * 4
        ops += 8 * ct * n + 3 * pb * ct
    return nbytes, ops


def compare_d(name, args, d_max, device, gates, require_all=False):
    from kubernetes_tpu_torch.models.repair import repair_check, repair_check_plain
    from kubernetes_tpu_torch.ops import kernels

    err, counts, modes = 0, {}, {}
    for has_affinity, has_ct in gates:
        before = kernels.LAUNCHES["repair_check"]
        cuda_before = kernels.CUDA_LAUNCHES["repair_check"]
        got = repair_check(*args, d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
        sync(device)
        launched = kernels.LAUNCHES["repair_check"] - before
        cuda_launched = kernels.CUDA_LAUNCHES["repair_check"] - cuda_before
        modes[f"affinity={int(has_affinity)},ct={int(has_ct)}"] = (
            kernels.LAST_REPAIR_PLAN.get("mode") if device.type == "cuda" else None)
        ref = repair_check_plain(*args, d_max=d_max, has_affinity=has_affinity, has_ct=has_ct)
        sync(device)
        equal = all(a.dtype == b.dtype and bool((a == b).all()) for a, b in zip(got, ref))
        e = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref))
        err = max(err, e)
        key = f"affinity={int(has_affinity)},ct={int(has_ct)}"
        counts[key] = [int(m.sum()) for m in got]
        check(equal, f"kernel D differs from its plain version on {name} {key}")
        check(device.type != "cuda" or (launched == 1 and cuda_launched == 1),
              f"kernel D did not launch once on {name} {key}")
    emit({"phase": "kernel_D", "case": name, "pods": int((args[0] >= 0).sum()),
          "pb": args[0].numel(), "d_max": d_max, "equal": True, "max_abs_err": err,
          "violations_rn_ea_ra_ct": counts, "cuda_launches_per_call": 1, "modes": modes})
    if require_all:
        full = counts["affinity=1,ct=1"]
        check(all(c > 0 for c in full), f"{name}: a violation kind never fires: {full}")
    return err


def d_timing_cases(n, batch_size, spread, anti_groups, affinity, device, rng):
    """kernel_D_timing's cases, the fast main path's checks at its shapes:
    (case, check args, d_max, has_affinity, has_ct, shape) for one
    TopologySpreading batch (10 zones, one spread row, has_ct), the
    PodAntiAffinity batch (hostname key, d_max = nodes, has_affinity) and one
    PodAffinity batch (50 zones, 50 bound seeds, has_affinity)."""
    k = min(batch_size, spread)
    inp, d_s, _, batch = tensorize(make_nodes(n, zones=10), spread_pods(k, "dt"), device)
    cases = [("topology_spreading", placed_check_args(inp, batch, rng), d_s, False, True,
              f"{n} nodes, {k} placed pods, one spread row, has_ct")]
    inp, d_a, _, batch = tensorize(make_nodes(n), anti_pods(anti_groups, 40, "dx"), device)
    cases.append(("pod_anti_affinity", placed_check_args(inp, batch, rng), d_a, True, False,
                  f"{n} nodes, {len(batch.pods)} placed pods, hostname key, has_affinity"))
    k = min(batch_size, affinity)
    inp, d_f, _, batch = tensorize(make_nodes(n, zones=50), affinity_pods(k, 50, "dy"), device,
                                   bound=affinity_seeds(50))
    cases.append(("pod_affinity", placed_check_args(inp, batch, rng), d_f, True, False,
                  f"{n} nodes, {k} placed pods, 50 zones, 50 seeds, has_affinity"))
    return cases


def phase_kernel_d(device, sizes, seed):
    import numpy as np
    import torch

    import kubernetes_tpu_torch.testing as tt

    from kubernetes_tpu_torch.models.repair import repair_check, repair_check_plain
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing import MakePod

    n = sizes["nodes"]
    rng = np.random.default_rng(seed)
    all_gates = [(True, True), (True, False), (False, True), (False, False)]
    errs = []
    inp, d_max, _, batch = tensorize(make_nodes(n, zones=10), spread_pods(sizes["spread"], "ds"),
                                        device)
    spread_args = placed_check_args(inp, batch, rng)
    errs.append(compare_d("topology_spreading", spread_args, d_max, device, all_gates))
    inp, d_a, _, batch = tensorize(make_nodes(n), anti_pods(sizes["anti_groups"], 40, "da"),
                                      device)
    errs.append(compare_d("hostname_anti_affinity", placed_check_args(inp, batch, rng), d_a,
                          device, all_gates))
    # mixed: every kind, minDomains above the zone count, nodes without the
    # zone key, holders in zone-0 whose zone anti-affinity repels "web"
    nodes = make_nodes(n, zones=10)
    for i in range(0, n, 20):
        del nodes[i].metadata.labels[ZONE]
    holders = []
    for i in (10, 30, 50):  # zone-0 nodes that keep the key (every 20th lost it)
        h = MakePod(f"guard-{i}").labels({"app": "guard"}).req({"cpu": "100m"}) \
            .pod_anti_affinity(ZONE, {"app": "web"}).obj()
        h.spec.node_name = f"node-{i}"
        holders.append(h)
    pods = []
    for i in range(sizes["mixed"]):
        b = MakePod(f"dm-{i}").req({"cpu": "100m"})
        kind = i % 5
        if kind == 0:
            b = b.labels({"app": "db"}).pod_anti_affinity(HOST, {"app": "db"})
        elif kind == 1:
            b = b.labels({"app": "web"})
        elif kind == 2:
            b = b.labels({"app": "aff"}).pod_affinity(ZONE, {"app": "db"})
        elif kind == 3:
            b = b.labels({"app": "sp"}).topology_spread(1, ZONE, "DoNotSchedule", {"app": "sp"},
                                                         min_domains=20)
        else:
            b = b.labels({"app": "sq"}).topology_spread(1, ZONE, "DoNotSchedule", {"app": "sq"})
        pods.append(b.obj())
    inp, d_m, _, batch = tensorize(nodes, pods, device, bound=holders)
    errs.append(compare_d("mixed_all_kinds_min_domains", placed_check_args(inp, batch, rng), d_m,
                          device, all_gates, require_all=True))
    # beyond the cluster's shared memory (the global-scratch route): seeded
    # tables of 70,000 nodes, each its own domain, with wrapping sums
    big = tt.repair_problem(seed, 70000, 300, 70000, kk=2, sc=5, g=2, wrap=True)
    errs.append(compare_d("global_d70000", [torch.from_numpy(a).to(device) for a in big], 70000,
                          device, all_gates))
    lines = []
    for case, args, dm, has_affinity, has_ct, shape in d_timing_cases(
            n, sizes["batch"], sizes["spread"], sizes["anti_groups"], sizes["affinity"], device,
            rng):
        def call(args=args, dm=dm, ha=has_affinity, hc=has_ct):
            return repair_check(*args, d_max=dm, has_affinity=ha, has_ct=hc)

        before = kernels.CUDA_LAUNCHES["repair_check"]
        call()
        sync(device)
        cuda_launches = kernels.CUDA_LAUNCHES["repair_check"] - before
        plan = dict(kernels.LAST_REPAIR_PLAN) if device.type == "cuda" else None
        ms = timed_ms(call, 50, device)
        plain_ms = timed_ms(lambda args=args, dm=dm, ha=has_affinity, hc=has_ct:
                            repair_check_plain(*args, d_max=dm, has_affinity=ha, has_ct=hc),
                            5, device)
        nbytes, ops = kernel_d_work(args, has_affinity, has_ct)
        b_ms, b_by = bound_ms(nbytes, ops)
        line = {"phase": "kernel_D_timing", "case": case,
                "shape": f"{shape} (pb {args[0].numel()}, d_max {dm})",
                "ms": ms, "device_ms": device_ms(call, ("repair_check",), device),
                "cuda_launches": cuda_launches, "plan": plan, "plain_ms": plain_ms,
                "bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by}
        check(device.type != "cuda" or cuda_launches == 1,
              f"kernel D took {cuda_launches} CUDA launches on {case}")
        emit(line)
        lines.append(line)
    return max(errs), lines


# the last drive_main_path run's kernels.CUDA_LAUNCHES and HOST_SYNCS
RUN_COUNTS = {}


def drive_main_path(name, nodes, pods, device, batch_size, solver="exact", bound=(),
                    store=None, sched_kw=None, faults=None):
    """One main-path run through a store (APIStore() unless one is given),
    returning (store, sched, the listed pods, launches, create s, schedule
    s). sched_kw passes to BatchScheduler; faults (FaultPlans) are armed for
    the timed run and disarmed after it."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    store = APIStore() if store is None else store
    store.create_many("nodes", nodes)
    if bound:
        store.create_many("pods", list(bound))
    # the call a user makes: device="cuda" (the default), not a pinned index
    sched = BatchScheduler(store, device=device.type, solver=solver, batch_size=batch_size,
                           **(sched_kw or {}))
    sched.sync()
    # start each timed run from a collected heap: the garbage of the phases
    # before it must not land in this run's stage clocks
    gc.collect()
    if faults:
        from kubernetes_tpu_torch.chaos import faultinject

        faultinject.arm(faults)
    kernels.reset_launch_counts()
    gc0, gcs0 = gc_full_collections(), gc_full_seconds()
    t0 = time.perf_counter()
    store.create_many("pods", pods)
    t1 = time.perf_counter()
    try:
        sched.run_until_idle()
    finally:
        if faults:
            faultinject.disarm()
    sync(device)
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    # full collections (count, host seconds) inside the timed run
    RUN_COUNTS.update(cuda_launches=dict(kernels.CUDA_LAUNCHES),
                      host_syncs=dict(kernels.HOST_SYNCS),
                      gc_full=(gc_full_collections() - gc0, gc_full_seconds() - gcs0))
    sched.stop()
    bound, _ = store.list("pods")
    return store, sched, bound, launches, t1 - t0, t2 - t1


def check_no_overcommit(bound, nodes):
    from kubernetes_tpu_torch.api import Resource, compute_pod_resource_request

    cap = {n.metadata.name: Resource.from_resource_list(n.status.allocatable) for n in nodes}
    used = {}
    for p in bound:
        r = compute_pod_resource_request(p)
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for node, (cpu, mem, cnt) in used.items():
        c = cap[node]
        check(cpu <= c.milli_cpu and mem <= c.memory and cnt <= c.allowed_pod_number,
              f"node {node} over-committed: cpu {cpu}m mem {mem} pods {cnt}")


# main_path's columnar SchedulingBasic run (store, scheduler, watchers, bind
# latency), which main_path_store holds its dict-store run against
COLUMNAR_LEG = {}


def phase_main_path(device, sizes, card):
    from kubernetes_tpu_torch.server import metrics
    from kubernetes_tpu_torch.store import APIStore

    n, batch = sizes["nodes"], sizes["batch"]
    out = {}
    for name, nodes, pods in (
            ("SchedulingBasic", make_nodes(n), basic_pods(sizes["basic"], "mp")),
            ("TopologySpreading", make_nodes(n, zones=10), spread_pods(sizes["spread"], "ms"))):
        store = APIStore()
        if name == "SchedulingBasic":
            # the store phase's columnar leg: one per-object and one
            # coalescing watcher, unbounded, drained after the run
            COLUMNAR_LEG.update(per=store.watch("pods", maxsize=0),
                                coal=store.watch("pods", maxsize=0, coalesce=True),
                                bind_before=metrics.store_bind_many_duration.snapshot())
        store, sched, got, launches, create_s, sched_s = drive_main_path(
            name, nodes, pods, device, batch, store=store)
        placed = [p for p in got if p.spec.node_name]
        check(len(placed) == len(pods),
              f"{name}: {len(placed)}/{len(pods)} pods bound through the store")
        check_no_overcommit(placed, nodes)
        line = {"phase": "main_path", "workload": name, "nodes": n, "pods": len(pods),
                "bound": len(placed), "batches": sched.batches_solved,
                "launches": launches, "row_scatter_launches": launches["row_scatter"],
                "pods_per_s": len(pods) / sched_s,
                "schedule_s": sched_s, "create_s": create_s,
                "solve_s_per_batch": sum(sched.solve_seconds) / max(len(sched.solve_seconds), 1),
                "stage_seconds": sched.stage_seconds, "card": card}
        if name == "TopologySpreading":
            zones = {}
            for p in placed:
                z = int(p.spec.node_name.rsplit("-", 1)[1]) % 10
                zones[z] = zones.get(z, 0) + 1
            line["zone_skew"] = max(zones.values()) - min(zones.values())
            check(len(zones) == 10 and line["zone_skew"] <= 1,
                  f"{name}: zone skew {line['zone_skew']} > 1")
        emit(line)
        if device.type == "cuda":  # the plain versions run on a CPU rehearsal
            check(launches["greedy_scan"] > 0, f"{name}: kernel A never launched")
            check(launches["row_scatter"] > 0, f"{name}: kernel B never launched")
        out[name] = line
        if name == "SchedulingBasic":
            COLUMNAR_LEG.update(store=store, sched=sched, got=got, line=line,
                                bind_after=metrics.store_bind_many_duration.snapshot(),
                                gc_full=RUN_COUNTS["gc_full"])
    return out


def gc_full_collections():
    """The interpreter's full (generation 2) garbage collections so far: a
    full collection over a large heap is a host pause that lands in
    whichever stage clock is running."""
    return gc.get_stats()[2]["collections"]


_GC_FULL = {"s": 0.0, "t0": None}


def _gc_full_timer(phase, info):
    if info.get("generation") != 2:
        return
    if phase == "start":
        _GC_FULL["t0"] = time.perf_counter()
    elif _GC_FULL["t0"] is not None:
        _GC_FULL["s"] += time.perf_counter() - _GC_FULL["t0"]
        _GC_FULL["t0"] = None


def gc_full_seconds():
    """Host seconds spent in full garbage collections so far (timed by a
    gc callback installed on the first call)."""
    if _gc_full_timer not in gc.callbacks:
        gc.callbacks.append(_gc_full_timer)
    return _GC_FULL["s"]


def bind_transitions(store):
    """(key, rv, node) of every unbound -> bound transition in the store's
    history, in rv order (columnar bind batches flattened)."""
    return [(ev.obj.key, ev.resource_version, ev.obj.spec.node_name)
            for ev in store.history_events()
            if ev.kind == "pods" and ev.type == "MODIFIED" and ev.obj.spec.node_name
            and (ev.prev is None or not ev.prev.spec.node_name)]


def bind_latency(before, after):
    """store_bind_many_duration between two (sum, count) snapshots."""
    count = after[1] - before[1]
    return {"count": count, "mean_s": (after[0] - before[0]) / count if count else None}


def phase_main_path_store(device, sizes, card, leg):
    """main_path's columnar SchedulingBasic run against the same run on a
    dict store: equal maps, pod resourceVersions and bind transitions; the
    columnar leg's watchers drained without a dropped delivery."""
    from kubernetes_tpu_torch.server import metrics
    from kubernetes_tpu_torch.store import APIStore

    t_phase = time.perf_counter()
    n, batch, p = sizes["nodes"], sizes["batch"], sizes["basic"]
    col = leg["store"]
    check(col.columnar, "main_path_store: main_path's store is not columnar")
    per, coal = leg["per"].drain(), leg["coal"].drain()
    tel = col.watch_telemetry()
    check(not tel["dropped"], f"main_path_store: dropped deliveries {tel['dropped']}")
    check(not leg["per"].terminated and not leg["coal"].terminated,
          "main_path_store: a columnar-leg watcher was terminated")
    check(len(per) == 2 * p and [e.type for e in per].count("MODIFIED") == p,
          f"main_path_store: the per-object watcher saw {len(per)} events, not {2 * p}")
    coal_n = sum(len(c.events) for c in coal)
    check(coal_n == 2 * p, f"main_path_store: the coalesced batches held {coal_n} events")
    stats = col.columnar_stats()
    before = metrics.store_bind_many_duration.snapshot()
    gc.collect()
    dstore, dsched, dgot, dlaunches, dcreate_s, dsched_s = drive_main_path(
        "SchedulingBasic", make_nodes(n), basic_pods(p, "mp"), device, batch,
        store=APIStore(columnar=False))
    after = metrics.store_bind_many_duration.snapshot()
    dgc = RUN_COUNTS["gc_full"]
    check(not dstore.columnar, "main_path_store: the dict leg's store is columnar")
    cmap = {q.metadata.name: q.spec.node_name for q in leg["got"]}
    dmap = {q.metadata.name: q.spec.node_name for q in dgot}
    check(len(cmap) == p and all(cmap.values()), "main_path_store: columnar leg not all bound")
    check(cmap == dmap, "main_path_store: the dict leg placed differently")
    crv = {q.metadata.name: q.metadata.resource_version for q in leg["got"]}
    drv = {q.metadata.name: q.metadata.resource_version for q in dgot}
    check(crv == drv, "main_path_store: pod resourceVersions differ between the legs")
    ctr, dtr = bind_transitions(col), bind_transitions(dstore)
    check(len(ctr) == p and ctr == dtr,
          f"main_path_store: bind transitions differ ({len(ctr)} against {len(dtr)})")
    if device.type == "cuda":
        check(dlaunches["greedy_scan"] > 0, "main_path_store: dict leg: kernel A never launched")
        check(dlaunches["row_scatter"] > 0, "main_path_store: dict leg: kernel B never launched")
    cline = leg["line"]
    prop = tel["propagation"]
    line = {"phase": "main_path_store", "workload": "SchedulingBasic", "nodes": n, "pods": p,
            "equal": {"map": True, "pod_rvs": True, "bind_transitions": len(ctr)},
            "columnar": {"pods_per_s": cline["pods_per_s"], "schedule_s": cline["schedule_s"],
                         "commit_s": cline["stage_seconds"]["commit"],
                         "stage_seconds": cline["stage_seconds"],
                         "launches": cline["launches"],
                         "store_bind_many": bind_latency(leg["bind_before"],
                                                         leg["bind_after"]),
                         "gc_full_collections": leg["gc_full"][0],
                         "gc_full_s": leg["gc_full"][1],
                         "bind_seconds": dict(leg["sched"].bind_seconds)},
            "dict": {"pods_per_s": p / dsched_s, "schedule_s": dsched_s,
                     "commit_s": dsched.stage_seconds["commit"],
                     "stage_seconds": dsched.stage_seconds, "launches": dlaunches,
                     "store_bind_many": bind_latency(before, after),
                     "gc_full_collections": dgc[0], "gc_full_s": dgc[1],
                     "bind_seconds": dict(dsched.bind_seconds)},
            "columnar_stats": {k: stats[k] for k in ("rows", "diverged", "materialized_total",
                                                     "bound", "sig_captured")},
            "watch": {"per_object_events": len(per), "coalesced_deliveries": len(coal),
                      "coalesced_events": coal_n, "dropped": tel["dropped"],
                      "rv_lag": [s["rv_lag"] for s in tel["subscribers"]],
                      "propagation": {k: prop[k] for k in ("count", "p50_s", "p99_s")}},
            "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(line)
    return line


def commit_leg(sched, p, sched_s, launches, bind_before, bind_after, gc_full):
    """One run's host-commit numbers: pods/s, the stage clocks, the bind
    path's own clocks (bind on the worker, flush_binds' wait), the store's
    bind_many latency, the worker's restarts and retries, the columnar cache
    rows, full garbage collections and the kernel launches."""
    return {"pods_per_s": p / sched_s, "schedule_s": sched_s,
            "stage_seconds": dict(sched.stage_seconds), "bind_seconds": dict(sched.bind_seconds),
            "store_bind_many": bind_latency(bind_before, bind_after),
            "bind_worker_restarts": sched.bind_worker_restarts,
            "retry_counts": dict(sched.retry_counts),
            "bind_failures": len(sched.take_bind_failures()),
            "assumed_left": sched.cache.assumed_count(),
            "cache_rows": sched.cache.columnar_rows(),
            "gc_full_collections": gc_full[0], "gc_full_s": gc_full[1], "launches": launches}


def phase_main_path_commit(device, sizes, card, leg):
    """main_path's exact SchedulingBasic run (the default host commit:
    columnar cache rows, pipelined binds, the native commit engine) held
    against three more runs of the same shape: the object-path oracle
    (columnar=False, pipeline_binds=False, APIStore(native_commit=False)),
    equal map, pod resourceVersions and bind transitions, kernels A and B
    launched in both; the default pipeline under an armed
    store.bind_many=fail:count=2 and native.commit=fail:count=1, every pod
    bound, the three retries counted, no assume left; and solver="native",
    the host C engine, whose map equals the scan's and which launches no
    kernel by design."""
    from kubernetes_tpu_torch.chaos.faultinject import FaultPlan
    from kubernetes_tpu_torch.server import metrics
    from kubernetes_tpu_torch.store import APIStore

    t_phase = time.perf_counter()
    n, batch, p = sizes["nodes"], sizes["batch"], sizes["basic"]
    main_sched, main_line = leg["sched"], leg["line"]
    main_map = {q.metadata.name: q.spec.node_name for q in leg["got"]}
    main_rv = {q.metadata.name: q.metadata.resource_version for q in leg["got"]}
    main_tr = bind_transitions(leg["store"])
    check(len(main_map) == p and all(main_map.values()), "main_path_commit: main run not bound")
    check(main_sched.columnar and main_sched.pipeline_binds and main_sched.store._native_commit,
          "main_path_commit: main_path did not run the default host commit")
    out = {"main": commit_leg(main_sched, p, main_line["schedule_s"], main_line["launches"],
                              leg["bind_before"], leg["bind_after"],
                              leg["gc_full"])}
    out["main"]["watchers"] = 2
    runs = (("oracle", dict(sched_kw={"columnar": False, "pipeline_binds": False},
                            store=APIStore(native_commit=False))),
            ("faults", dict(faults=[FaultPlan("store.bind_many", "fail", count=2),
                                    FaultPlan("native.commit", "fail", count=1)])),
            ("native", dict(solver="native")))
    for name, kw in runs:
        gc.collect()
        before = metrics.store_bind_many_duration.snapshot()
        store, sched, got, launches, _create_s, sched_s = drive_main_path(
            f"SchedulingBasic/{name}", make_nodes(n), basic_pods(p, "mp"), device, batch, **kw)
        after = metrics.store_bind_many_duration.snapshot()
        ln = out[name] = commit_leg(sched, p, sched_s, launches, before, after,
                                    RUN_COUNTS["gc_full"])
        gmap = {q.metadata.name: q.spec.node_name for q in got}
        check(len(gmap) == p and all(gmap.values()), f"main_path_commit: {name}: not all bound")
        check(gmap == main_map, f"main_path_commit: {name}: the map differs from main_path's")
        check(ln["assumed_left"] == 0 and ln["bind_failures"] == 0,
              f"main_path_commit: {name}: assumes left or bind failures")
        if name == "oracle":
            check(store.columnar and not store._native_commit and ln["cache_rows"] == 0,
                  "main_path_commit: the oracle ran columnar rows or the native commit")
            ln["equal"] = {"map": True,
                           "pod_rvs": {q.metadata.name: q.metadata.resource_version
                                       for q in got} == main_rv,
                           "bind_transitions": bind_transitions(store) == main_tr}
            check(ln["equal"]["pod_rvs"], "main_path_commit: oracle: pod RVs differ")
            check(ln["equal"]["bind_transitions"] and len(main_tr) == p,
                  "main_path_commit: oracle: bind transitions differ")
            if device.type == "cuda":
                check(launches["greedy_scan"] > 0 and launches["row_scatter"] > 0,
                      "main_path_commit: oracle: kernel A or B never launched")
        elif name == "faults":
            check(ln["retry_counts"]["bind"] == 3,
                  f"main_path_commit: faults: {ln['retry_counts']} retries, not 3")
            ln["bind_transitions"] = len(bind_transitions(store))
            check(ln["bind_transitions"] == p, "main_path_commit: faults: a pod bound twice")
        else:
            check(sched._solve_path == "native" and not any(launches.values()),
                  f"main_path_commit: native: path {sched._solve_path}, launches {launches}")
    if device.type == "cuda":
        check(main_line["launches"]["greedy_scan"] > 0 and main_line["launches"]["row_scatter"] > 0,
              "main_path_commit: main: kernel A or B never launched")
    line = {"phase": "main_path_commit", "workload": "SchedulingBasic", "nodes": n, "pods": p,
            "batch": batch, **out, "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(line)
    return line


def fast_workloads(sizes):
    """name -> a function making (nodes, bound pods, pending pods): the scheduler_perf
    shapes bench.py:205-260 uses, 8 cpu / 32Gi / 110-pod nodes."""
    n, zones_aff = sizes["nodes"], 50
    return {
        "SchedulingBasic": lambda: (make_nodes(n), [], basic_pods(sizes["basic"], "fb")),
        "TopologySpreading": lambda: (make_nodes(n, zones=10), [],
                                      spread_pods(sizes["spread"], "fs")),
        "PodAntiAffinity": lambda: (make_nodes(n), [], anti_pods(sizes["anti_groups"], 40, "fa")),
        "PodAffinity": lambda: (make_nodes(n, zones=zones_aff), affinity_seeds(zones_aff),
                                affinity_pods(sizes["affinity"], zones_aff, "ff")),
    }


def check_fast_constraints(name, placed, n_zones_aff=50):
    """The workload's own constraint on the final placements."""
    mine = [p for p in placed if not p.metadata.name.startswith("seed-")]
    if name == "TopologySpreading":
        zones = {}
        for p in mine:
            z = int(p.spec.node_name.rsplit("-", 1)[1]) % 10
            zones[z] = zones.get(z, 0) + 1
        skew = max(zones.values()) - min(zones.values())
        check(len(zones) == 10 and skew <= 1, f"{name}: zone skew {skew} > 1")
        return {"zone_skew": skew}
    if name == "PodAntiAffinity":
        groups = {}
        for p in mine:
            groups.setdefault(p.metadata.labels["grp"], []).append(p.spec.node_name)
        worst = max(len(v) - len(set(v)) for v in groups.values())
        check(worst == 0, f"{name}: {worst} pods share a node with their anti-affine group")
        return {"groups": len(groups), "shared_nodes": worst}
    if name == "PodAffinity":
        off = [p.metadata.name for p in mine
               if int(p.spec.node_name.rsplit("-", 1)[1]) % n_zones_aff
               != int(p.metadata.name.rsplit("-", 1)[1]) % n_zones_aff]
        check(not off, f"{name}: {len(off)} pods outside their seed's zone, e.g. {off[:3]}")
        return {"outside_seed_zone": 0}
    return {}


def phase_main_path_fast(device, sizes, card):
    import torch

    batch = sizes["batch"]
    out = {}
    for name, build in fast_workloads(sizes).items():
        nodes, seeds, pods = build()
        store, sched, got, launches, create_s, sched_s = drive_main_path(
            name, nodes, pods, device, batch, solver="fast", bound=seeds)
        placed = [p for p in got if p.spec.node_name]
        check(len(placed) == len(pods) + len(seeds),
              f"{name}: {len(placed) - len(seeds)}/{len(pods)} pods bound through the store")
        check_no_overcommit(placed, nodes)
        br = sched.breaker
        check(br.failures_total == 0 and br.trips == 0,
              f"{name}: solver failures {br.failures_total}, trips {br.trips}: "
              f"{sched.last_solver_error}")
        constrained = name != "SchedulingBasic"
        if constrained:
            check(sched.repair_totals["batches"] > 0, f"{name}: no batch rode propose-and-repair")
        if device.type == "cuda":
            check(launches["waterfill"] > 0, f"{name}: kernel C never launched")
            check(RUN_COUNTS["cuda_launches"]["waterfill"] == launches["waterfill"],
                  f"{name}: kernel C made {RUN_COUNTS['cuda_launches']['waterfill']} CUDA "
                  f"launches in {launches['waterfill']} calls")
            if constrained:
                check(launches["repair_check"] > 0, f"{name}: kernel D never launched")
        counts = dict(RUN_COUNTS)
        card_map = {p.metadata.name: p.spec.node_name for p in got}
        # the same workload with the port on the CPU: the plain versions
        t0 = time.perf_counter()
        nodes_c, seeds_c, pods_c = build()
        _, sched_c, got_c, _, _, _ = drive_main_path(name, nodes_c, pods_c, torch.device("cpu"),
                                                     batch, solver="fast", bound=seeds_c)
        cpu_s = time.perf_counter() - t0
        cpu_map = {p.metadata.name: p.spec.node_name for p in got_c}
        differ = [k for k in card_map if card_map[k] != cpu_map.get(k)]
        check(not differ, f"{name}: {len(differ)} placements differ from the CPU run, "
                          f"e.g. {[(k, card_map[k], cpu_map.get(k)) for k in differ[:3]]}")
        check(sched_c.repair_totals == sched.repair_totals,
              f"{name}: repair totals differ from the CPU run")
        line = {"phase": "main_path_fast", "workload": name, "solver": "fast",
                "nodes": len(nodes), "pods": len(pods), "bound": len(placed) - len(seeds),
                "batches": sched.batches_solved, "launches": launches,
                "pods_per_s": len(pods) / sched_s, "schedule_s": sched_s, "create_s": create_s,
                "solve_s_per_batch": sum(sched.solve_seconds) / max(len(sched.solve_seconds), 1),
                "stage_seconds": sched.stage_seconds, "repair_totals": sched.repair_totals,
                "last_path": sched._solve_path, "breaker": br.describe(),
                "waterfill_cuda_launches": counts["cuda_launches"]["waterfill"],
                "waterfill_host_syncs": counts["host_syncs"]["waterfill"],
                "waterfill_host_syncs_per_batch":
                    counts["host_syncs"]["waterfill"] / max(sched.batches_solved, 1),
                "cpu_rerun_s": cpu_s, "cpu_map_equal": True, "card": card}
        line.update(check_fast_constraints(name, placed))
        if name in ("SchedulingBasic", "TopologySpreading"):
            # the exact mode on the same shape right after, on the same card:
            # the comparison partner for the fast mode's pods/s
            nodes_x, seeds_x, pods_x = build()
            _, sched_x, got_x, _, _, sched_s_x = drive_main_path(
                name, nodes_x, pods_x, device, batch, solver="exact", bound=seeds_x)
            check(all(p.spec.node_name for p in got_x), f"{name} exact: pods left unbound")
            line["exact_adjacent"] = {"pods_per_s": len(pods_x) / sched_s_x,
                                      "schedule_s": sched_s_x,
                                      "stage_seconds": sched_x.stage_seconds}
        emit(line)
        out[name] = line
        if name == "SchedulingBasic":
            # the daemon's mode: auto routes as fast does
            nodes_a, seeds_a, pods_a = build()
            _, sched_a, got_a, launches_a, _, sched_s_a = drive_main_path(
                name, nodes_a, pods_a, device, batch, solver="auto", bound=seeds_a)
            auto_map = {p.metadata.name: p.spec.node_name for p in got_a}
            check(auto_map == card_map, f"{name}: solver auto places differently from fast")
            check(sched_a.breaker.failures_total == 0, f"{name} auto: solver failures")
            check(device.type != "cuda" or launches_a["waterfill"] > 0,
                  f"{name} auto: kernel C never launched")
            emit({"phase": "main_path_fast", "workload": name, "solver": "auto",
                  "pods": len(pods_a), "bound": sum(1 for p in got_a if p.spec.node_name),
                  "launches": launches_a, "pods_per_s": len(pods_a) / sched_s_a,
                  "stage_seconds": sched_a.stage_seconds, "same_map_as_fast": True,
                  "card": card})
    return out


# ---------------------------------------------------------------------------
# gangs: workloads (the JAX package's gang rungs, bench.py:1529-1660, and the
# same shapes on the 5,000-node cluster)
# ---------------------------------------------------------------------------

SLICE = "tpu.scheduling/slice"
SLICE_INDEX = "tpu.scheduling/slice-index"


def _testing(m):
    if m is None:
        import kubernetes_tpu_torch.testing as m
    return m


def slice_nodes(n, n_slices, cpu, mem, m=None):
    """n nodes, node i in slice i % n_slices at ring index i // n_slices."""
    m = _testing(m)
    return [m.MakeNode(f"node-{i}").tpu_slice(i % n_slices, index=i // n_slices)
            .capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj() for i in range(n)]


def gang_pods(name, n, cpu, mem=None, prio=0, m=None):
    """PodGroup `name` (quorum n) and its n ranked members."""
    m = _testing(m)
    req = {"cpu": cpu}
    if mem:
        req["memory"] = mem
    pods = [m.MakePod(f"{name}-{i}").gang(name, rank=i).priority(prio).req(req).obj()
            for i in range(n)]
    return m.make_pod_group(name, n), pods


def gang_workloads(sizes):
    """name -> (nodes, [(PodGroup, members)], batch_size) for main_path_gang."""
    def build(m=None):
        g2k = [gang_pods(f"train-{g}", 250, "500m", "1Gi", m=m) for g in range(8)]
        big = [gang_pods(f"job-{g}", sizes["gang_members"], "500m", "1Gi", m=m)
               for g in range(16)]
        return {"GangScheduling_2k_250": (slice_nodes(256, 4, "16", "64Gi", m), g2k, 4096),
                "GangScheduling_5000": (slice_nodes(sizes["nodes"], 20, "8", "32Gi", m), big,
                                        sizes["batch"])}
    return build


def preempt_workloads(sizes):
    """name -> (nodes, bound fillers, gang size, uncoverable gang size) for
    main_path_gang_preempt. GangPreemption: 2 slices x 8 nodes full of 6-cpu
    priority-1 fillers, a 12 x 3-cpu gang (fits one slice after 6 evictions)
    and a 40 x 3-cpu gang (never). GangPreemption_5000: 20 slices, 4 fillers
    of 1500m per node (2 cpu left, no 3-cpu pod fits anywhere), a gang that
    fits one slice only after evictions (at most 2 members a node) and one
    no slice can ever hold."""
    def fillers(nodes, per_node, cpu, m):
        out = []
        for node in nodes:
            name = node.metadata.name
            for j in range(per_node):
                f = m.MakePod(f"low-{name}-{j}").priority(1).req({"cpu": cpu}).obj()
                f.spec.node_name = name
                out.append(f)
        return out

    def build(m=None):
        m = _testing(m)
        small = [m.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                 .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj()
                 for s in range(2) for i in range(8)]
        big = slice_nodes(sizes["nodes"], 20, "8", "32Gi", m)
        per_slice = sizes["nodes"] // 20
        return {"GangPreemption": (small, fillers(small, 1, "6", m), 12, 40),
                "GangPreemption_5000": (big, fillers(big, 4, "1500m", m),
                                        sizes["preempt_members"], 2 * per_slice + 100)}
    return build


def ring_adjacency(pods, nodes):
    """The JAX rung's placement-quality column from the objects themselves:
    mean ring distance between consecutive ranks of each gang (a cross-slice
    pair pays the longest ring)."""
    from kubernetes_tpu_torch.api.podgroup import pod_gang_rank, pod_group_key
    from kubernetes_tpu_torch.models.gangcover import mean_neighbor_distance

    where = {n.metadata.name: (int(n.metadata.labels[SLICE]), int(n.metadata.labels[SLICE_INDEX]))
             for n in nodes}
    ring = {}
    for s, i in where.values():
        ring[s] = max(ring.get(s, 0), i + 1)
    groups, ranks, slices, pos = [], [], [], []
    gid = {}
    for p in pods:
        g = pod_group_key(p)
        if g and p.spec.node_name:
            s, i = where[p.spec.node_name]
            groups.append(gid.setdefault(g, len(gid)))
            ranks.append(pod_gang_rank(p))
            slices.append(s)
            pos.append(i)
    return mean_neighbor_distance(groups, ranks, slices, pos, ring)


def drive_gang(nodes, bound, gangs, device, batch_size, solver="fast", rank_align=True,
               watch=False, backoff=(1.0, 10.0)):
    """Store -> BatchScheduler -> PodGroups and members in one create_many ->
    run_until_idle. Returns (store, sched, launches, seconds, watch)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    store = APIStore()
    store.create_many("nodes", nodes)
    if bound:
        store.create_many("pods", bound)
    sched = BatchScheduler(store, device=device.type, solver=solver, batch_size=batch_size,
                           rank_align=rank_align, pod_initial_backoff=backoff[0],
                           pod_max_backoff=backoff[1])
    sched.sync()
    w = store.watch(kind="pods", maxsize=1_000_000) if watch else None
    gc.collect()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for pg, _members in gangs:
        store.create("podgroups", pg)
    store.create_many("pods", [p for _pg, members in gangs for p in members])
    sched.run_until_idle()
    sync(device)
    return store, sched, dict(kernels.LAUNCHES), time.perf_counter() - t0, w


def gang_spans(pods):
    """Slices each gang's bound members span, per gang."""
    from kubernetes_tpu_torch.api.podgroup import pod_group_key

    spans = {}
    for p in pods:
        g = pod_group_key(p)
        if g and p.spec.node_name:
            spans.setdefault(g, set()).add(p.spec.node_name)
    return spans


def phase_main_path_gang(device, sizes, card):
    import torch

    out = {}
    build = gang_workloads(sizes)
    for name in ("GangScheduling_2k_250", "GangScheduling_5000"):
        for solver in (("fast", "exact") if name == "GangScheduling_5000" else ("fast",)):
            nodes, gangs, batch = build()[name]
            n_members = sum(len(ms) for _pg, ms in gangs)
            store, sched, launches, sched_s, _ = drive_gang(nodes, [], gangs, device, batch,
                                                            solver)
            pods, _ = store.list("pods")
            placed = [p for p in pods if p.spec.node_name]
            check(len(placed) == n_members,
                  f"{name} {solver}: {len(placed)}/{n_members} gang members bound")
            check_no_overcommit(placed, nodes)
            check(sched.gang_vetoes == 0, f"{name} {solver}: {sched.gang_vetoes} vetoes")
            check(sched.breaker.failures_total == 0,
                  f"{name} {solver}: solver failures: {sched.last_solver_error}")
            if device.type == "cuda":
                check(launches["rank_align"] > 0, f"{name} {solver}: kernel H never launched")
                kernel = "waterfill" if solver == "fast" else "greedy_scan"
                check(launches[kernel] > 0, f"{name} {solver}: {kernel} never launched")
            card_map = {p.metadata.name: p.spec.node_name for p in pods}
            t0 = time.perf_counter()
            nodes_c, gangs_c, _ = build()[name]
            store_c, _, _, _, _ = drive_gang(nodes_c, [], gangs_c, torch.device("cpu"), batch,
                                             solver)
            cpu_s = time.perf_counter() - t0
            cpu_map = {p.metadata.name: p.spec.node_name for p in store_c.list("pods")[0]}
            differ = [k for k in card_map if card_map[k] != cpu_map.get(k)]
            check(not differ, f"{name} {solver}: {len(differ)} placements differ from the CPU "
                              f"run, e.g. {[(k, card_map[k], cpu_map.get(k)) for k in differ[:3]]}")
            slice_of = {n.metadata.name: n.metadata.labels[SLICE] for n in nodes}
            spans = sorted(len({slice_of[x] for x in v}) for v in gang_spans(pods).values())
            line = {"phase": "main_path_gang", "workload": name, "solver": solver,
                    "nodes": len(nodes), "gangs": len(gangs), "members": n_members,
                    "bound": len(placed), "vetoes": sched.gang_vetoes,
                    "batches": sched.batches_solved, "launches": launches,
                    "pods_per_s": n_members / sched_s, "schedule_s": sched_s,
                    "solve_s_per_batch": sum(sched.solve_seconds) / max(len(sched.solve_seconds), 1),
                    "stage_seconds": sched.stage_seconds, "slices_spanned_per_gang": spans,
                    "adjacency": ring_adjacency(pods, nodes),
                    "cpu_rerun_s": cpu_s, "cpu_map_equal": True, "card": card}
            if solver == "fast":
                # the rank-blind partner: the same workload without kernel H
                nodes_b, gangs_b, _ = build()[name]
                store_b, sched_b, _, _, _ = drive_gang(nodes_b, [], gangs_b, device, batch,
                                                       solver, rank_align=False)
                pods_b, _ = store_b.list("pods")
                check(sum(1 for p in pods_b if p.spec.node_name) == n_members,
                      f"{name}: the rank-blind run left members unbound")
                line["adjacency_rank_blind"] = ring_adjacency(pods_b, nodes_b)
                line["last_gang"] = sched.last_gang
            emit(line)
            out[f"{name}/{solver}"] = line
    return out


def phase_main_path_gang_preempt(device, sizes, card):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import compute_pod_resource_request
    from kubernetes_tpu_torch.models.gangcover import cover_curve_host, victim_order

    out = {}
    build = preempt_workloads(sizes)

    def settle(sched, until, deadline_s):
        """Drive cycles (eviction, parking, release and the re-solve take
        several) until `until()` or the wall deadline."""
        deadline = time.perf_counter() + deadline_s
        while time.perf_counter() < deadline and not until():
            sched.run_until_idle()
            sched.queue.flush_backoff_completed()
            sched.pump_events()
            time.sleep(0.02)

    def run(name, dev):
        from kubernetes_tpu_torch.ops import kernels

        nodes, bound, n_gang, n_big = build()[name]
        pg, members = gang_pods("gp", n_gang, "3", prio=100)
        store, sched, _, sched_s, w = drive_gang(nodes, bound, [(pg, members)], dev,
                                                 sizes["batch"], watch=True,
                                                 backoff=(0.05, 0.2))

        def gang_bound():
            return sum(1 for p in store.list("pods")[0]
                       if p.metadata.name.startswith("gp-") and p.spec.node_name)

        t0 = time.perf_counter()
        settle(sched, lambda: gang_bound() >= n_gang, 120.0)
        sync(dev)
        seconds = sched_s + time.perf_counter() - t0
        deleted = sorted(ev.obj.metadata.name for ev in w.drain() if ev.type == "DELETED")
        gang_map = {p.metadata.name: p.spec.node_name for p in store.list("pods")[0]
                    if p.metadata.name.startswith("gp-")}
        stats = sched.gangpreempt.stats()
        # the uncoverable gang: vetoed on every retry, zero further evictions
        pg2, big = gang_pods("gbig", n_big, "3", prio=100)
        store.create("podgroups", pg2)
        store.create_many("pods", big)
        settle(sched, lambda: False, 1.0)
        sync(dev)
        launches = dict(kernels.LAUNCHES)
        deleted_after = [ev.obj.metadata.name for ev in w.drain() if ev.type == "DELETED"]
        vetoed = [e for e in store.list("events")[0] if e.reason == "GangPreemptionVetoed"
                  and e.involved_name.startswith("gbig-")]
        big_bound = sum(1 for p in store.list("pods")[0]
                        if p.metadata.name.startswith("gbig-") and p.spec.node_name)
        w.stop()
        return dict(nodes=nodes, bound=bound, n_gang=n_gang, store=store, sched=sched,
                    deleted=deleted, gang_map=gang_map, stats=stats, seconds=seconds,
                    launches=launches, deleted_after=deleted_after, vetoed=vetoed,
                    big_bound=big_bound, members=members + big)

    for name in ("GangPreemption", "GangPreemption_5000"):
        r = run(name, device)
        nodes, n_gang, sched = r["nodes"], r["n_gang"], r["sched"]
        slice_of = {n.metadata.name: int(n.metadata.labels[SLICE]) for n in nodes}
        placed = {slice_of[v] for v in r["gang_map"].values() if v}
        check(sum(1 for v in r["gang_map"].values() if v) == n_gang,
              f"{name}: {sum(1 for v in r['gang_map'].values() if v)}/{n_gang} gang members bound")
        check(len(placed) == 1, f"{name}: the gang spans slices {sorted(placed)}")
        chosen = placed.pop()
        # the script's own cover: the chosen slice's fillers in eviction
        # order, the host curve, the smallest k reaching the quorum
        victims = [p for p in r["bound"] if slice_of[p.spec.node_name] == chosen]
        local = {n.metadata.name: i for i, n in enumerate(
            [n for n in nodes if slice_of[n.metadata.name] == chosen])}
        req = np.array([3000, 0, 0])
        v_req = np.array([[compute_pod_resource_request(v).milli_cpu, 0, 0] for v in victims])
        order = victim_order(np.array([v.spec.priority for v in victims]),
                             (v_req[:, :1] * 1000 // 3000).sum(axis=1))
        node_objs = [n for n in nodes if slice_of[n.metadata.name] == chosen]
        used = {}
        for v in r["bound"]:
            used[v.spec.node_name] = used.get(v.spec.node_name, 0) + \
                compute_pod_resource_request(v).milli_cpu
        free = np.array([[8000 - used.get(n.metadata.name, 0), 0, 0] for n in node_objs])
        head = np.array([110 - sum(1 for v in victims if v.spec.node_name == n.metadata.name)
                         for n in node_objs])
        caps = cover_curve_host(free, head, np.ones(len(node_objs), bool),
                                np.array([local[victims[i].spec.node_name] for i in order]),
                                v_req[order], req)
        k = int(np.nonzero(caps >= n_gang)[0][0])
        want = sorted(victims[i].metadata.name for i in order[:k])
        check(r["deleted"] == want, f"{name}: deleted {len(r['deleted'])} pods, the cover is "
                                    f"{k}: {sorted(set(r['deleted']) ^ set(want))[:5]}")
        check(not r["deleted_after"], f"{name}: the uncoverable gang evicted "
                                      f"{len(r['deleted_after'])} pods")
        check(r["vetoed"] and r["big_bound"] == 0,
              f"{name}: the uncoverable gang was not vetoed ({r['big_bound']} bound)")
        stats = r["stats"]
        check(stats["preempted"] == 1 and stats["victims"] == k,
              f"{name}: preemptor totals {stats}")
        if not sizes.get("small"):
            want_k = {"GangPreemption": 6, "GangPreemption_5000": 799}[name]
            check(k == want_k, f"{name}: a cover of {k} victims, not {want_k}")
        attempts = sched.gangpreempt.stats()["attempts"]
        from kubernetes_tpu_torch.testing import assert_pod_conservation

        keys = [p.key for p in r["members"]]
        cons = assert_pod_conservation(r["store"], sched, keys)["counts"]
        if device.type == "cuda":
            check(0 < r["launches"]["cover_curve"] <= attempts,
                  f"{name}: kernel G launched {r['launches']['cover_curve']} times in "
                  f"{attempts} cover attempts")
        t0 = time.perf_counter()
        c = run(name, torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        check(c["deleted"] == r["deleted"] and c["gang_map"] == r["gang_map"],
              f"{name}: the CPU rerun evicted or placed differently")
        line = {"phase": "main_path_gang_preempt", "workload": name, "nodes": len(nodes),
                "fillers": len(r["bound"]), "gang": n_gang, "uncoverable_gang": len(
                    r["members"]) - n_gang, "slice": chosen, "cover_k": k,
                "deleted": len(r["deleted"]), "deleted_by_veto_leg": len(r["deleted_after"]),
                "vetoed_events": len(r["vetoed"]), "preemption": stats,
                "preemption_after_veto_leg": sched.gangpreempt.stats(),
                "conservation": cons, "launches": r["launches"], "cover_attempts": attempts,
                "cover_launches_per_attempt": r["launches"]["cover_curve"] / max(attempts, 1),
                "seconds_to_bound": r["seconds"], "batches": sched.batches_solved,
                "stage_seconds": sched.stage_seconds, "cpu_rerun_s": cpu_s,
                "cpu_equal": True, "card": card}
        emit(line)
        out[name] = line
        sched.stop()
    return out


# ---------------------------------------------------------------------------
# main_path_preempt: per-pod preemption on the batch path
# ---------------------------------------------------------------------------


def preempt_case(n, pending, zones=0):
    """scheduler_perf PreemptionBasic (the JAX rung, bench.py:2766-2838): n
    nodes of 4 cpu / 32Gi / 110 pods, n bound priority-1 pods of 3 cpu (one
    a node), then `pending` priority-100 pods of 2 cpu. With zones, the nodes
    carry a zone label (node i in zone i % zones) and the pending pods a
    zone spread (DoNotSchedule, maxSkew 1): a constrained batch, whose
    device rejects take the serial PostFilter."""
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    nodes, low = [], []
    for i in range(n):
        b = MakeNode(f"node-{i}").capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
        if zones:
            b = b.labels({ZONE: f"z{i % zones}"})
        nodes.append(b.obj())
        low.append(MakePod(f"low-{i}").priority(1).req({"cpu": "3"}).node(f"node-{i}").obj())
    high = []
    for i in range(pending):
        b = MakePod(f"high-{i}").priority(100).req({"cpu": "2"})
        if zones:
            b = b.labels({"app": "spread"}).topology_spread(1, ZONE, "DoNotSchedule",
                                                             {"app": "spread"})
        high.append(b.obj())
    return nodes, low, high


def drive_preempt(case, device, solver, async_prep, batch_size, deadline_s=120.0):
    """BatchScheduler(store, Framework(default_plugins()), device=...) through
    sync, create_many and the JAX rung's loop: run_until_idle, then flush
    the backoff and unschedulable tiers, until every pending pod is bound or
    the deadline passes. The scheduler's clock is a FakeClock the loop steps
    past every backoff (10 s) a round, so a flush admits all the waiting
    preemptors together and the run is the same on the card and on the CPU;
    the seconds are wall time and hold no backoff wait."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.scheduler.plugins import default_plugins
    from kubernetes_tpu_torch.scheduler.runtime import Framework
    from kubernetes_tpu_torch.store import APIStore
    from kubernetes_tpu_torch.utils import FakeClock

    nodes, low, high = case()
    store, clock = APIStore(), FakeClock(1000.0)
    store.create_many("nodes", nodes)
    store.create_many("pods", low)
    sched = BatchScheduler(store, Framework(default_plugins()), device=device.type,
                           solver=solver, batch_size=batch_size, clock=clock)
    sched.preemption.async_preparation = async_prep
    sched.sync()
    gc.collect()
    kernels.reset_launch_counts()
    names = {p.metadata.name for p in high}
    t0 = time.perf_counter()
    store.create_many("pods", high)
    rounds = 0
    while True:
        sched.run_until_idle()
        sched.preemption.wait_for_preparation(timeout=60.0)
        sched.pump_events()
        rounds += 1
        # an empty queue: every pending pod is bound (checked on the store
        # after the loop)
        if sum(sched.queue.lengths()) == 0 or time.perf_counter() - t0 > deadline_s:
            break
        clock.step(11.0)
        sched.queue.flush_backoff_completed()
        sched.queue.flush_unschedulable_left_over()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    pods = store.list("pods")[0]
    events = sorted((e.reason, e.involved_name, e.message) for e in store.list("events")[0])
    sched.stop()
    return dict(nodes=nodes, low=low, high=high, sched=sched, seconds=seconds, rounds=rounds,
                launches=launches, events=events,
                placement={p.metadata.name: p.spec.node_name for p in pods},
                nominated={p.metadata.name: p.status.nominated_node_name for p in pods
                           if p.metadata.name in names},
                victims=sorted({p.metadata.name for p in low} - {p.metadata.name for p in pods}),
                placed=[p for p in pods if p.spec.node_name])


def check_preempt_run(name, r, device, solver):
    """The gates of one main_path_preempt run."""
    high = r["high"]
    bound = [p for p in high if r["placement"].get(p.metadata.name)]
    check(len(bound) == len(high), f"{name}: {len(bound)}/{len(high)} high pods bound "
                                   f"in {r['seconds']:.1f} s")
    check_no_overcommit(r["placed"], r["nodes"])
    prio = {p.metadata.name: p.spec.priority for p in r["low"] + high}
    node_of = {p.metadata.name: p.spec.node_name for p in r["low"]}
    preempted = [e for e in r["events"] if e[0] == "Preempted"]
    victims_seen, nominated_to = set(), {}
    for _reason, victim, msg in preempted:
        # "Preempted by pod <preemptor> on node <node>"
        words = msg.split()
        preemptor, node = words[3], words[-1]
        check(prio[victim] < prio[preemptor],
              f"{name}: {victim} (priority {prio[victim]}) evicted for {preemptor} "
              f"(priority {prio[preemptor]})")
        check(node_of[victim] == node, f"{name}: {victim} on {node_of[victim]} narrated on {node}")
        victims_seen.add(victim)
        nominated_to.setdefault(preemptor, set()).add(node)
    check(sorted(victims_seen) == r["victims"],
          f"{name}: {len(r['victims'])} pods deleted, {len(victims_seen)} narrated Preempted")
    sched = r["sched"]
    if not r["high"][0].spec.topology_spread_constraints:
        # the tiered batch preemption counts its victims; the serial
        # PostFilter of a constrained batch does not
        check(sched.preempt_victims_total == len(r["victims"]),
              f"{name}: {sched.preempt_victims_total} victims chosen, "
              f"{len(r['victims'])} deleted")
    for pod, node in r["nominated"].items():
        if node:
            check(node in nominated_to.get(pod, ()),
                  f"{name}: {pod} nominated to {node} without a preemption there")
    check(sum(1 for v in r["nominated"].values() if v) == len(nominated_to),
          f"{name}: {len(nominated_to)} preemptors, "
          f"{sum(1 for v in r['nominated'].values() if v)} nominations")
    check(sched.preemption_count >= len(nominated_to),
          f"{name}: preemption_count {sched.preemption_count}")
    if device.type == "cuda":
        check(r["launches"]["row_scatter"] > 0, f"{name}: kernel B never launched")
        solver_kernel = "waterfill" if solver == "auto" else "greedy_scan"
        check(r["launches"][solver_kernel] > 0, f"{name}: {solver_kernel} never launched")


def phase_main_path_preempt(device, sizes, card):
    """PreemptionBasic (auto and exact, async victim preparation off and on),
    PreemptionBasic at 5,000 nodes (auto, async off and on, batches of
    sizes["batch"]) and the constrained case (exact): every high pod bound,
    the gates of check_preempt_run, and the map, the victims and the events
    equal to a CPU rerun."""
    import torch

    n, n_big = sizes["preempt_nodes"], sizes["nodes"]
    cases = [(f"PreemptionBasic/{solver}/{'async' if a else 'sync'}",
              lambda: preempt_case(n, n), solver, a, sizes["batch"])
             for solver in ("auto", "exact") for a in (False, True)]
    # at the other main paths' batch size: the preemptors span two batches,
    # and the second pumps whatever victim deletions have landed by then
    # (all of them in sync mode, those the worker has finished in async)
    cases += [(f"PreemptionBasic_{n_big}/auto/{'async' if a else 'sync'}",
               lambda: preempt_case(n_big, n_big), "auto", a, sizes["batch"])
              for a in (False, True)]
    cases.append(("PreemptionConstrained/exact/async",
                  lambda: preempt_case(n, sizes["preempt_constrained"], zones=10),
                  "exact", True, sizes["batch"]))
    out = {}
    for name, case, solver, async_prep, batch in cases:
        r = drive_preempt(case, device, solver, async_prep, batch)
        check_preempt_run(name, r, device, solver)
        t0 = time.perf_counter()
        c = drive_preempt(case, torch.device("cpu"), solver, async_prep, batch)
        cpu_s = time.perf_counter() - t0
        check(c["placement"] == r["placement"],
              f"{name}: the CPU rerun placed differently: " + str(sorted(
                  k for k in r["placement"] if r["placement"][k] != c["placement"].get(k))[:5]))
        check(c["victims"] == r["victims"], f"{name}: the CPU rerun evicted differently")
        check(c["events"] == r["events"], f"{name}: the CPU rerun narrated differently")
        sched = r["sched"]
        n_high = len(r["high"])
        line = {"phase": "main_path_preempt", "workload": name, "nodes": len(r["nodes"]),
                "low_pods": len(r["low"]), "high_pods": n_high, "solver": solver,
                "async_preparation": async_prep, "batch_size": batch,
                "bound": sum(1 for p in r["high"] if r["placement"][p.metadata.name]),
                "seconds_to_bound": r["seconds"], "pods_per_s": n_high / r["seconds"],
                "rounds": r["rounds"], "batches": sched.batches_solved,
                "preemption_count": sched.preemption_count,
                "victims": len(r["victims"]), "batch_victims_total": sched.preempt_victims_total,
                "preempted_events": sum(1 for e in r["events"] if e[0] == "Preempted"),
                "nominated": sum(1 for v in r["nominated"].values() if v),
                "solve_s": sched.stage_seconds["solve"],
                "solve_s_per_batch": [round(x, 6) for x in sched.solve_seconds],
                "stage_seconds": sched.stage_seconds, "launches": r["launches"],
                "cpu_rerun_s": cpu_s, "cpu_equal": True, "card": card}
        emit(line)
        out[name] = line
    return out


FALLBACK_KINDS = ("nodes", "csinodes", "storageclasses", "persistentvolumes",
                  "persistentvolumeclaims", "deviceclasses", "resourceslices", "resourceclaims")


def fallback_case(sizes, seed):
    """The fallback classes beside SchedulingBasic (testing.fallback_workload,
    after scheduler_perf's volume and DRA suites): the other main paths'
    nodes (8 cpu / 32Gi / 110 pods) in 10 zones, one in 20 tainted
    NoSchedule, a CSINode a node (3 attachments), ResourceSlices of 8
    devices on every 10th node; sizes["batch"] plain 500m/1Gi pods and the
    fallback pods of sizes["fallback"] spread through them by a seeded
    permutation (one create_many wave, two batches)."""
    from kubernetes_tpu_torch.testing import fallback_workload

    n = sizes["nodes"]
    return fallback_workload(seed, n, sizes["batch"], zones=10, tainted=n // 20, slice_every=10,
                             devices_per_slice=8, csi_limit=3, **sizes["fallback"])


def drive_fallback(w, device, batch_size, deadline_s=300.0):
    """BatchScheduler(solver="auto", DynamicResourceAllocation on) over the
    storage and DRA objects, then the pod wave; run_until_idle and a
    FakeClock stepped past every backoff until the queue is empty."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore
    from kubernetes_tpu_torch.utils import FakeClock
    from kubernetes_tpu_torch.utils.featuregate import feature_gates

    feature_gates.set("DynamicResourceAllocation", True)
    try:
        store, clock = APIStore(), FakeClock(1000.0)
        for kind in FALLBACK_KINDS:
            store.create_many(kind, w[kind])
        sched = BatchScheduler(store, device=device.type, solver="auto", batch_size=batch_size,
                               clock=clock)
        sched.sync()
        gc.collect()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        store.create_many("pods", w["pods"])
        rounds = 0
        while True:
            sched.run_until_idle()
            rounds += 1
            if sum(sched.queue.lengths()) == 0 or time.perf_counter() - t0 > deadline_s:
                break
            clock.step(11.0)
            sched.queue.flush_backoff_completed()
            sched.queue.flush_unschedulable_left_over()
        sync(device)
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        pods = store.list("pods")[0]
        written = {k: store.list(k)[0]
                   for k in ("persistentvolumes", "persistentvolumeclaims", "resourceclaims")}
        events = sorted((e.reason, e.involved_name, e.message) for e in store.list("events")[0])
        sched.stop()
    finally:
        feature_gates.set("DynamicResourceAllocation", False)
    dump = {k: sorted(json.dumps(o.to_dict(), sort_keys=True) for o in objs)
            for k, objs in written.items()}
    return dict(sched=sched, seconds=seconds, rounds=rounds, launches=launches, pods=pods,
                written=written, dump=dump, events=events,
                placement={p.metadata.name: p.spec.node_name for p in pods})


def check_fallback_run(w, r):
    """The gates of main_path_fallback: every pod bound, no node
    over-committed, each pre-bound PVC pod where its PV admits it, each
    WaitForFirstConsumer PVC bound to one PV that admits the pod's node and
    no PV bound twice, no node over its CSINode limit, each DRA pod on a
    node with a slice and its claim allocated there from that slice and
    reserved for it, no device in two claims, the Honor spread pods at zone
    skew <= 1 over the untainted nodes. Returns the per-class counts."""
    nodes = {n.metadata.name: n for n in w["nodes"]}
    pods = {p.metadata.name: p for p in r["pods"]}
    unbound = [n for n, node in r["placement"].items() if not node]
    check(not unbound, f"fallback: {len(unbound)} pods unbound, e.g. {unbound[:5]}")
    check_no_overcommit(r["pods"], w["nodes"])
    pvcs, pvs, claims = ({o.metadata.name: o for o in r["written"][k]} for k in (
        "persistentvolumeclaims", "persistentvolumes", "resourceclaims"))
    limits = {c.metadata.name: c.drivers for c in w["csinodes"]}
    slices = {s.node_name: {d.name for d in s.devices} for s in w["resourceslices"]}
    pv_owner, attached, used = {}, {}, []
    counts = {}
    for name, cls in w["class_of"].items():
        counts[cls] = counts.get(cls, 0) + 1
        pod = pods[name]
        node = nodes[pod.spec.node_name]
        for v in pod.spec.volumes:
            cn = v.pvc_claim_name or (f"{name}-{v.name}" if v.ephemeral else "")
            if not cn:
                continue
            pvc = pvcs[cn]
            pv = pvs.get(pvc.spec.volume_name)
            check(pv is not None and pv.spec.claim_ref == f"default/{cn}",
                  f"fallback: {name}'s PVC {cn} bound to {pvc.spec.volume_name!r}")
            check(pv.spec.node_affinity is None or pv.spec.node_affinity.matches(node),
                  f"fallback: {name} on {node.metadata.name}, outside PV {pv.metadata.name}")
            check(pv_owner.setdefault(pv.metadata.name, cn) == cn,
                  f"fallback: PV {pv.metadata.name} bound twice")
            if pv.spec.csi_driver:
                attached.setdefault((node.metadata.name, pv.spec.csi_driver), set()).add(
                    pv.spec.volume_handle or pv.metadata.name)
        for _ref, cn in pod.spec.resource_claims:
            c = claims[cn]
            check(c.allocation is not None and c.allocation.node_name == node.metadata.name,
                  f"fallback: {name}'s claim {cn} not allocated on {node.metadata.name}")
            devs = c.allocation.all_devices()
            check(set(devs) <= slices.get(node.metadata.name, set()) and devs,
                  f"fallback: {name}'s claim {cn} holds {devs} off {node.metadata.name}'s slice")
            check(name in c.reserved_for, f"fallback: claim {cn} not reserved for {name}")
            used += [f"{node.metadata.name}/{d}" for d in devs]
    check(len(used) == len(set(used)), "fallback: a device is in two claims")
    for (node, driver), handles in attached.items():
        limit = limits.get(node, {}).get(driver)
        check(limit is None or len(handles) <= limit,
              f"fallback: {node} attaches {len(handles)} {driver} volumes, limit {limit}")
    untainted = {n: node.metadata.labels[ZONE] for n, node in nodes.items()
                 if not node.spec.taints}
    zones = {z: 0 for z in untainted.values()}
    for name, cls in w["class_of"].items():
        if cls == "spread":
            node = pods[name].spec.node_name
            check(node in untainted, f"fallback: spread pod {name} on tainted {node}")
            zones[untainted[node]] += 1
    skew = max(zones.values()) - min(zones.values()) if counts.get("spread") else 0
    check(skew <= 1, f"fallback: Honor spread skew {skew} > 1")
    return counts, skew


def phase_main_path_fallback(device, sizes, card):
    """main_path_fallback: the fallback classes (volumes, DRA, a non-default
    spread policy) beside SchedulingBasic on the batch path; their pods take
    the per-pod cycle after each batch's device commit. The gates of
    check_fallback_run, kernels B and C launched, and the map, the PV/PVC
    writes, the claim allocations and the events equal to a CPU rerun."""
    import torch

    w = fallback_case(sizes, 0)
    batch = sizes["batch"]
    r = drive_fallback(w, device, batch)
    counts, skew = check_fallback_run(w, r)
    t0 = time.perf_counter()
    c = drive_fallback(fallback_case(sizes, 0), torch.device("cpu"), batch)
    cpu_s = time.perf_counter() - t0
    check(c["placement"] == r["placement"], "fallback: the CPU rerun placed differently: " + str(
        sorted(k for k in r["placement"] if r["placement"][k] != c["placement"].get(k))[:5]))
    check(c["dump"] == r["dump"], "fallback: the CPU rerun wrote PVs, PVCs or claims differently")
    check(c["events"] == r["events"], "fallback: the CPU rerun narrated differently")
    sched = r["sched"]
    n = len(r["pods"])
    if device.type == "cuda":
        check(r["launches"]["row_scatter"] > 0, "fallback: kernel B never launched")
        check(r["launches"]["waterfill"] > 0, "fallback: kernel C never launched")
    check(sched.fallback_pods == len(w["class_of"]) == sched.serial_scheduled,
          f"fallback: {sched.fallback_pods} routed, {sched.serial_scheduled} bound by the "
          f"per-pod cycle, {len(w['class_of'])} fallback pods")
    line = {"phase": "main_path_fallback", "workload": "SchedulingBasic+fallback",
            "nodes": len(w["nodes"]), "pods": n, "device_pods": n - len(w["class_of"]),
            "batch_size": batch, "solver": "auto", "bound": n,
            "seconds_to_bound": r["seconds"], "pods_per_s": n / r["seconds"],
            "rounds": r["rounds"], "batches": sched.batches_solved,
            "fallback": sched.fallback_pods, "serial_scheduled": sched.serial_scheduled,
            "per_class": counts, "spread_skew": skew,
            "fallback_s_per_pod": sched.stage_seconds["fallback"] / max(sched.fallback_pods, 1),
            "stage_seconds": sched.stage_seconds,
            "solve_s_per_batch": [round(x, 6) for x in sched.solve_seconds],
            "launches": r["launches"], "cpu_rerun_s": cpu_s, "cpu_equal": True, "card": card}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# kernel G: cover_curve, kernel H: rank_align
# ---------------------------------------------------------------------------


def cover_case(rng, ns, k, r, device, pads=0, inelig=0.0):
    """Seeded padded arguments of one cover_curve call on `device`, with
    magnitudes of the main path (millicores, MiB, pods)."""
    import numpy as np
    import torch

    n_slots = 1 << max(0, ns - 1).bit_length()
    k_max = 1 << max(0, k + pads - 1).bit_length()
    free = np.zeros((n_slots, r), np.int32)
    free[:ns] = rng.integers(-500, 4000, size=(ns, r))
    head = np.zeros(n_slots, np.int32)
    head[:ns] = rng.integers(0, 110, size=ns)
    elig = np.zeros(n_slots, bool)
    elig[:ns] = rng.random(ns) >= inelig
    vn = np.full(k_max, -1, np.int32)
    vn[:k] = rng.integers(0, ns, size=k)
    vr = np.zeros((k_max, r), np.int32)
    vr[:k] = rng.integers(0, 2000, size=(k, r))
    req = rng.integers(0, 3000, size=r).astype(np.int32)
    req[0] = 3000

    def t(a):
        return torch.from_numpy(a).to(device)

    return tuple(t(a) for a in (free, head, elig, vn, vr, req))


def kernel_g_work(args):
    """(bytes, operations): inputs read once, caps written once; per node
    the capacity (3 ops a dimension), per victim its node's update and
    capacity (~4 ops a dimension + 4), one add per curve entry."""
    free, head, elig, vn, vr, req = args
    n_slots, r = free.shape
    k_max = vn.shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args) + (k_max + 1) * 4
    ops = n_slots * 3 * r + k_max * (4 * r + 4) + k_max + 1
    return nbytes, ops


def phase_kernel_g(device, sizes, seed):
    import numpy as np

    from kubernetes_tpu_torch.models.gangcover import cover_curve, cover_curve_plain
    from kubernetes_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    cases = {
        "a_full_width_slice": cover_case(rng, sizes["slice_nodes"], sizes["cover_victims"], 3,
                                         device),
        "b_k0_pads_ineligible": cover_case(rng, 37, 0, 3, device, pads=5, inelig=0.4),
        "b_pads_ineligible": cover_case(rng, 200, 300, 4, device, pads=200, inelig=0.3),
        "c_above_jax_budget": cover_case(rng, sizes["budget_nodes"], 1000, 3, device),
    }
    err, lines = 0, {}
    for name, args in cases.items():
        before = kernels.LAUNCHES["cover_curve"]
        got = cover_curve(*args)
        sync(device)
        launched = kernels.LAUNCHES["cover_curve"] - before
        ref = cover_curve_plain(*args)
        sync(device)
        e = int((got.long() - ref.long()).abs().max())
        equal = got.dtype == ref.dtype and bool((got == ref).all())
        n_slots, r = args[0].shape
        line = {"phase": "kernel_G", "case": name, "n_slots": n_slots, "k_max": args[3].shape[0],
                "R": r, "prefix_elems": (args[3].shape[0] + 1) * n_slots * r, "equal": equal,
                "max_abs_err": e, "launches": launched, "caps_last": int(got[-1])}
        err = max(err, e)
        check(equal, f"kernel G differs from its plain version on case {name}")
        check(device.type != "cuda" or launched == 1, f"kernel G did not launch on case {name}")
        if name.startswith("a_"):
            line["ms"] = timed_ms(lambda: cover_curve(*args), 200, device)
            line["plain_ms"] = timed_ms(lambda: cover_curve_plain(*args), 20, device)
            # the kernel's own device time, apart from the wrapper's host work
            line["device_ms"] = device_ms(lambda: cover_curve(*args), ("cover_curve",), device)
            nbytes, ops = kernel_g_work(args)
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"n_slots {n_slots}, k_max {args[3].shape[0]}, R {r}"
        emit(line)
        lines[name] = line
    check(cases["c_above_jax_budget"][0].shape[0] * 1025 * 3 > 4_000_000,
          "case c is not above the JAX wrapper's 4M-element budget")
    lines["d_batched_attempt"] = batched_attempt(device, sizes, rng)
    err = max(err, lines["d_batched_attempt"]["max_abs_err"])
    return err, lines["a_full_width_slice"], lines["d_batched_attempt"]


def batched_attempt(device, sizes, rng):
    """(d) One cover attempt of GangPreemption_5000's shape: 20 slices of
    `slice_nodes` nodes, up to `cover_victims` victims each, through
    cover_curves_batched (one packed copy, one launch, one read) against the
    plain version on the CPU and against the route it replaces (one
    cover_curves call a slice) on the card."""
    import numpy as np

    from kubernetes_tpu_torch.models.gangcover import cover_curves, cover_curves_batched
    from kubernetes_tpu_torch.ops import kernels

    r, ns = 3, sizes["slice_nodes"]
    req = np.array([3000, 0, 0])
    slices = []
    for i in range(20):
        k = sizes["cover_victims"] if i % 4 else int(rng.integers(0, sizes["cover_victims"]))
        slices.append((rng.integers(-500, 4000, size=(ns, r)), rng.integers(0, 110, size=ns),
                       rng.random(ns) > 0.05, rng.integers(0, ns, size=k),
                       rng.integers(0, 2000, size=(k, r))))
    kernels.reset_launch_counts()
    got = cover_curves_batched(slices, req, device=device)
    counts = (kernels.LAUNCHES["cover_curve"], kernels.CUDA_LAUNCHES["cover_curve"],
              kernels.HOST_SYNCS["cover_curve"])
    want = cover_curves_batched(slices, req, device="cpu")
    err = max(int(np.abs(a - b).max()) for a, b in zip(got, want))
    equal = all(np.array_equal(a, b) for a, b in zip(got, want))
    line = {"phase": "kernel_G", "case": "d_batched_attempt", "slices": len(slices),
            "n_slots": 1 << (ns - 1).bit_length(), "k_max": 1 << (max(len(x[3]) for x in slices)
                                                                  - 1).bit_length(),
            "R": r, "equal": equal, "max_abs_err": err, "launches": counts[0],
            "cuda_launches": counts[1], "host_syncs": counts[2],
            "ms": timed_ms(lambda: cover_curves_batched(slices, req, device=device), 20, device),
            "per_slice_route_ms": timed_ms(lambda: [cover_curves(*x, req, device=device)
                                                    for x in slices], 5, device),
            "plain_ms": timed_ms(lambda: cover_curves_batched(slices, req, device="cpu"), 2,
                                 device),
            "device_ms": device_ms(lambda: cover_curves_batched(slices, req, device=device),
                                   ("cover_curve",), device, iters=20)}
    emit(line)
    check(equal, "kernel G's batched attempt differs from its plain version")
    check(device.type != "cuda" or counts == (1, 1, 1),
          f"kernel G's batched attempt took {counts} launches, CUDA launches and host reads")
    return line


def align_case(rng, p, p_max, groups, device, ties=False):
    """Seeded padded arguments of one rank_align call: `groups` gangs of
    ranked members with shuffled ring positions, the rest non-members."""
    import numpy as np
    import torch

    a = np.full(p_max, -1, np.int32)
    g = np.arange(p_max, dtype=np.int32) + np.int32(2**30)
    rank = np.zeros(p_max, np.int32)
    pos = np.zeros(p_max, np.int32)
    a[:p] = rng.integers(0, 5000, size=p)
    members = p if not ties else (3 * p) // 4
    g[:members] = rng.integers(0, groups, size=members)
    g[members:p] = 2**29 + np.arange(members, p)
    rank[:p] = rng.permutation(p) if not ties else rng.integers(0, 8, size=p)
    pos[:p] = rng.permutation(p) if not ties else rng.integers(0, 8, size=p)
    if ties:
        unplaced = rng.random(p) < 0.1
        a[:p][unplaced] = -1
        pos[:p][unplaced] = 2**30

    def t(x):
        return torch.from_numpy(x).to(device)

    return tuple(t(x) for x in (a, g, rank, pos))


def kernel_h_work(args):
    """(bytes, operations): four inputs read once, the output written once;
    two sorts of p_max rows at ~3 ops per comparison, p_max log2 p_max
    comparisons each, and the scatter."""
    import math

    p_max = args[0].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args) + p_max * 4
    ops = int(2 * 3 * p_max * max(1.0, math.log2(p_max)) + p_max)
    return nbytes, ops


def phase_kernel_h(device, sizes, seed):
    import numpy as np

    from kubernetes_tpu_torch.models.gangcover import rank_align_kernel, rank_align_plain
    from kubernetes_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed + 1)
    pm = sizes["align_p_max"]
    cases = {
        "a_16_gangs_of_256": align_case(rng, pm, pm, 16, device),
        "b_ties_unplaced_nonmembers": align_case(rng, pm - pm // 4 - 3, pm, 5, device, ties=True),
        "c_global_merge": align_case(rng, 4 * pm - 100, 4 * pm, 64, device),
        # GangScheduling_2k_250's batch: 8 gangs of 250 at p_max 2,048
        "d_gang_2k_250": align_case(rng, 2000, pm // 2, 8, device),
        # p_max 65,536, and again in chunks of 2,048 rows (each CTA's slice
        # sorted as four chunks, two more team levels)
        "e_p65536": align_case(rng, 16 * pm - 500, 16 * pm, 128, device, ties=True),
    }
    cases["f_p65536_chunks_of_2048"] = cases["e_p65536"]
    err, lines = 0, {}
    for name, args in cases.items():
        before = kernels.LAUNCHES["rank_align"]
        cuda_before = kernels.CUDA_LAUNCHES["rank_align"]
        if name.startswith("f_") and device.type == "cuda":
            got = kernels.launch_rank_align(*args, _smem_rows=2048)
        else:
            got = rank_align_kernel(*args)
        sync(device)
        launched = kernels.LAUNCHES["rank_align"] - before
        cuda_launched = kernels.CUDA_LAUNCHES["rank_align"] - cuda_before
        ref = rank_align_plain(*args)
        sync(device)
        e = int((got.long() - ref.long()).abs().max())
        equal = got.dtype == ref.dtype and bool((got == ref).all())
        line = {"phase": "kernel_H", "case": name, "p_max": args[0].shape[0], "equal": equal,
                "max_abs_err": e, "launches": launched, "cuda_launches": cuda_launched,
                "plan": dict(kernels.LAST_RANK_ALIGN_PLAN) if device.type == "cuda" else None,
                "moved": int((got != args[0]).sum())}
        err = max(err, e)
        check(equal, f"kernel H differs from its plain version on case {name}")
        check(device.type != "cuda" or (launched == 1 and cuda_launched == 1),
              f"kernel H did not launch once on case {name}")
        if name[0] in "acd":
            line["ms"] = timed_ms(lambda: rank_align_kernel(*args), 200, device)
            line["plain_ms"] = timed_ms(lambda: rank_align_plain(*args), 50, device)
            line["device_ms"] = device_ms(lambda: rank_align_kernel(*args),
                                          ("rank_align_kernel",), device)
            nbytes, ops = kernel_h_work(args)
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"p_max {args[0].shape[0]}, {name.split('_')[1]} gangs"
        emit(line)
        lines[name] = line
    check(cases["c_global_merge"][0].shape[0] > 4096 or device.type == "cpu",
          "case c is not above the main path's p_max")
    check(device.type == "cpu" or lines["f_p65536_chunks_of_2048"]["plan"]["chunk"] <
          lines["f_p65536_chunks_of_2048"]["plan"]["slice"], "case f sorts a slice in one chunk")
    return err, lines["a_16_gangs_of_256"], lines["d_gang_2k_250"], lines["c_global_merge"]


# ---------------------------------------------------------------------------
# transport: kernels J, E, F and the auction/sinkhorn main path
# ---------------------------------------------------------------------------

SHAPES = [("100m", "128Mi"), ("250m", "512Mi"), ("500m", "1Gi"), ("1000m", "2Gi")]


def transport_nodes(n, cpu="16", mem="64Gi", ssd=False):
    """n nodes of cpu / mem / 110 pods; with ssd, even-indexed nodes carry
    disk=ssd (the NodeAffinity rung's label)."""
    from kubernetes_tpu_torch.testing import MakeNode

    out = []
    for i in range(n):
        labels = {HOST: f"node-{i}"}
        if ssd and i % 2 == 0:
            labels["disk"] = "ssd"
        out.append(MakeNode(f"node-{i}").labels(labels)
                   .capacity({"cpu": cpu, "memory": mem, "pods": "110"}).obj())
    return out


def transport_workloads(sizes):
    """name -> a function making (nodes, pods). Transport_50k: the JAX
    rung's shape (bench.py:2574-2577), 5,000 nodes of 16 cpu / 64Gi / 110
    pods and 50,000 pods of 500m/1Gi, one group a batch. TransportMixed: the
    reference's heterogeneous node-selector test (tests/test_transport.py:119)
    at 5,000 nodes of its 8 cpu / 16Gi / 110 pods: 10,000 pods in four
    shapes, every fourth pod with nodeSelector disk=ssd (8 groups a batch)."""
    from kubernetes_tpu_torch.testing import MakePod

    def t50k():
        return (transport_nodes(sizes["nodes"]),
                [MakePod(f"tr-{i}").req({"cpu": "500m", "memory": "1Gi"}).obj()
                 for i in range(sizes["transport_pods"])])

    def mixed():
        pods = []
        for i in range(sizes["mixed_transport_pods"]):
            cpu, mem = SHAPES[(i // 4) % 4]
            b = MakePod(f"tm-{i}").req({"cpu": cpu, "memory": mem})
            if i % 4 == 0:
                b = b.node_selector({"disk": "ssd"})
            pods.append(b.obj())
        return transport_nodes(sizes["nodes"], "8", "16Gi", ssd=True), pods

    return {"Transport_50k": t50k, "TransportMixed": mixed}


def tensorize_groups(nodes, pods, device, bound=()):
    """The port's host pipeline for one batch plus its groups: (inputs,
    d_max, batch, groups, node names)."""
    from kubernetes_tpu_torch.models.waterfill import make_groups
    from kubernetes_tpu_torch.ops.solver import make_inputs
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.snapshot.tensorizer import TensorCache, build_pod_batch

    cache = Cache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    snap = cache.update_snapshot()
    cluster, _ = TensorCache().cluster_tensors(snap)
    batch = build_pod_batch(pods, snap, cluster)
    inputs, d_max = make_inputs(cluster, batch, device)
    return inputs, d_max, batch, make_groups(batch), list(cluster.node_names)


def group_problem(nodes, pods, device):
    from kubernetes_tpu_torch.models.transport import build_group_problem

    inputs, _, _, groups, names = tensorize_groups(nodes, pods, device)
    return build_group_problem(inputs, groups), inputs, groups, names


def rel_err(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


def kernel_j_work(inp, clss):
    """(bytes, operations): the node state read once, each row's request
    read once and each class row the rows use (filter, napref, taint, image
    score, ports) read once, the [Rw, N] bool and int32 written once; ~40
    integer operations a (row, node) cell plus 2 a port column."""
    n, r = inp.alloc.shape
    pt = inp.class_ports.shape[1]
    rows = clss.shape[0]
    classes = int(clss.clamp(min=0).unique().numel())
    nbytes = n * r * 4 * 3 + n * 4 * 2 + n * pt + rows * (r * 8 + 5) \
        + classes * (pt + n * (1 + 4 + 4 + 4)) + rows * n * (1 + 4)
    return nbytes, rows * n * (40 + 2 * pt)


def phase_kernel_j(device, sizes, seed):
    import torch

    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.solver import feasibility_rows, feasibility_rows_plain
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    wl = transport_workloads(sizes)
    nodes_m, pods_m = wl["TransportMixed"]()
    inp_m, _, _, groups_m, _ = tensorize_groups(nodes_m, pods_m[:sizes["batch"]], device)
    reps = torch.tensor([int(m[0]) for m, _ in groups_m], device=device)
    nodes_t, pods_t = wl["Transport_50k"]()
    inp_t, _, _, groups_t, _ = tensorize_groups(nodes_t, pods_t[:sizes["batch"]], device)
    rep_t = torch.tensor([int(m[0]) for m, _ in groups_t], device=device)
    # edge cases: over-committed nodes (free < 0), nodes without memory
    # (a zero-alloc dimension), used host ports, and rows nothing fits
    rng = random.Random(seed)
    edge_nodes = []
    for i in range(300):
        cap = {"cpu": str(rng.choice([2, 4, 8])), "pods": str(rng.choice([3, 110]))}
        if i % 5:
            cap["memory"] = f"{rng.choice([4, 16])}Gi"
        edge_nodes.append(MakeNode(f"e-{i}").labels({"disk": "ssd" if i % 3 else "hdd"})
                          .capacity(cap).obj())
    bound = []
    for i in range(0, 300, 7):
        b = MakePod(f"hog-{i}").req({"cpu": "9"}, host_port=8080 + i % 2).obj()
        b.spec.node_name = f"e-{i}"
        bound.append(b)
    edge_pods = []
    for i in range(120):
        kind = i % 4
        b = MakePod(f"q-{i}").req({"cpu": f"{rng.choice([100, 500, 1500])}m",
                                   "memory": f"{rng.choice([256, 2048])}Mi"})
        if kind == 1:
            b = MakePod(f"q-{i}").req({"cpu": "200m"}, host_port=8080 + i % 3)
        elif kind == 2:
            b = MakePod(f"q-{i}").req({"cpu": "64", "memory": "512Gi"})  # fits nowhere
        elif kind == 3:
            b = b.node_selector({"disk": "ssd"})
        edge_pods.append(b.obj())
    inp_e, _, _, _, _ = tensorize_groups(edge_nodes, edge_pods, device, bound=bound)
    cases = {
        "a_transport_mixed_groups": (inp_m, inp_m.req[reps].contiguous(),
                                     inp_m.req_nz[reps].contiguous(),
                                     inp_m.class_of_pod[reps].contiguous(),
                                     inp_m.balanced_active[reps].contiguous()),
        "b_first_512_pods": (inp_m, inp_m.req[:512].contiguous(), inp_m.req_nz[:512].contiguous(),
                             inp_m.class_of_pod[:512].contiguous(),
                             inp_m.balanced_active[:512].contiguous()),
        "c_overcommit_zero_alloc_ports_infeasible": (inp_e, inp_e.req, inp_e.req_nz,
                                                     inp_e.class_of_pod, inp_e.balanced_active),
        # Transport_50k's first batch: one group, one row (26 of the 32
        # launches on the transport main paths are such rows)
        "d_transport_50k_row": (inp_t, inp_t.req[rep_t].contiguous(),
                                inp_t.req_nz[rep_t].contiguous(),
                                inp_t.class_of_pod[rep_t].contiguous(),
                                inp_t.balanced_active[rep_t].contiguous()),
    }
    err, lines = 0, {}
    for name, args in cases.items():
        before = kernels.LAUNCHES["feasibility_rows"]
        cuda_before = kernels.CUDA_LAUNCHES["feasibility_rows"]
        got = feasibility_rows(*args)
        sync(device)
        launched = kernels.LAUNCHES["feasibility_rows"] - before
        cuda_launched = kernels.CUDA_LAUNCHES["feasibility_rows"] - cuda_before
        plan = dict(kernels.LAST_FEASIBILITY_PLAN) if device.type == "cuda" else None
        ref = feasibility_rows_plain(*args)
        sync(device)
        e = int((got[1].long() - ref[1].long()).abs().max()) if got[1].numel() else 0
        e = max(e, int((got[0] != ref[0]).sum()))
        equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        line = {"phase": "kernel_J", "case": name, "rows": args[1].shape[0],
                "nodes": args[0].alloc.shape[0], "equal": equal, "max_abs_err": e,
                "launches": launched, "cuda_launches": cuda_launched,
                "feasible_cells": int(got[0].sum()),
                "infeasible_rows": int((~got[0].any(dim=1)).sum()), "plan": plan,
                "device_ms": device_ms(lambda: feasibility_rows(*args), ("feasibility_rows",),
                                       device, iters=50 if name[0] in "ad" else 20)}
        err = max(err, e)
        check(equal, f"kernel J differs from its plain version on case {name}")
        check(device.type != "cuda" or (launched == 1 and cuda_launched == 1),
              f"kernel J did not launch once on case {name}")
        if name[0] in "ad":
            line["ms"] = timed_ms(lambda: feasibility_rows(*args), 200, device)
            line["plain_ms"] = timed_ms(lambda: feasibility_rows_plain(*args), 20, device)
            nbytes, ops = kernel_j_work(args[0], args[3])
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"{args[1].shape[0]} rows x {args[0].alloc.shape[0]} nodes"
        if name.startswith("c_"):
            check(line["infeasible_rows"] > 0, "case c has no all-infeasible row")
            check(bool((inp_e.alloc[:, 1] == 0).any()), "case c has no zero-alloc node")
            check(bool(((inp_e.alloc - inp_e.used) < 0).any()), "case c has no negative free")
            check(bool(inp_e.node_ports.any()), "case c has no used port")
        emit(line)
        lines[name] = line
    return err, lines["a_transport_mixed_groups"], lines["d_transport_50k_row"]


def synthetic_problem(seed, device, **kw):
    """The seeded [G, N] problem of the CPU tests (testing.transport_problem)
    as tensors on `device`."""
    import torch

    from kubernetes_tpu_torch.testing import transport_problem

    return {k: torch.from_numpy(v).to(device) for k, v in transport_problem(seed, **kw).items()}


def phase_args(p, price0=None, start=None):
    """_auction_phase's arguments for a GroupProblem or a synthetic problem's
    dict: cold x and level, or start = (x0, level0) as numpy arrays."""
    import torch

    from kubernetes_tpu_torch.models.transport import NEG_INF

    if not isinstance(p, dict):
        p = dict(utility=p.utility, jcap=p.jcap, supply=p.supply, slots=p.slots, req=p.req,
                 free=(p.alloc - p.used).contiguous())
    g, n = p["utility"].shape
    dev = p["utility"].device
    price = torch.zeros(n, device=dev) if price0 is None else price0.to(dev)
    if start is None:
        x0 = torch.zeros((g, n), dtype=torch.int32, device=dev)
        level0 = torch.full((g, n), float(NEG_INF), device=dev)
    else:
        x0, level0 = (torch.from_numpy(a).to(dev) for a in start)
    return (p["utility"], p["jcap"], p["supply"], p["slots"], p["req"], p["free"], x0, price,
            level0)


def cluster_counts(kernels, name, before):
    """(CUDA launches, host syncs) of the wrapper `name` since `before`."""
    return (kernels.CUDA_LAUNCHES[name] - before[0], kernels.HOST_SYNCS[name] - before[1])


def plan_summary(plan):
    return {k: plan.get(k) for k in ("cluster_size", "threads", "nodes_per_cta", "smem_bytes",
                                     "in_smem", "in_global", "global_bytes_per_cta", "exchange")}


def kernel_e_work(args, rounds, candidates):
    """(bytes, operations) for one phase on these inputs: every input read
    once, x/price/level written once; per round the bids (~6 operations a
    [G, N] cell for the value and its top-16 selection) and the accepted
    candidates (~4R + 8 operations each), for the rounds this run took."""
    g, n = args[0].shape
    r = args[4].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in args) + g * n * 8 + n * 4
    return nbytes, rounds * (g * n * 6 + candidates * (4 * r + 8))


def phase_kernel_e(device, sizes, seed):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing import overfilled_start, transport_problem

    wl = transport_workloads(sizes)
    nodes_t, pods_t = wl["Transport_50k"]()
    prob_t, _, _, _ = group_problem(nodes_t, pods_t[:sizes["batch"]], device)
    nodes_m, pods_m = wl["TransportMixed"]()
    prob_m, _, _, _ = group_problem(nodes_m, pods_m[:sizes["batch"]], device)
    overfilled = overfilled_start(transport_problem(seed + 11, g=5, n=300, scarce=True), seed)
    eps0 = max(float(torch.where(prob_t.feasible, prob_t.utility, 0.0).max()) / 8.0, 0.9)
    warm = torch.from_numpy(np.random.default_rng(seed).integers(0, 5, size=64)
                            .astype(np.float32))
    cases = {
        "a_transport_50k_batch_first_phase": (phase_args(prob_t), eps0, 400),
        "a_transport_50k_batch_final_phase": (phase_args(prob_t), 0.9, 400),
        "b_transport_mixed_batch": (phase_args(prob_m), 0.9, 400),
        "c_scarce": (phase_args(synthetic_problem(seed + 1, device, g=5, n=300,
                                                            scarce=True)), 0.9, 400),
        "c_equal_levels": (phase_args(synthetic_problem(seed + 2, device, g=8, n=64,
                                                                  ties=True)), 0.9, 400),
        "c_neg_inf_row": (phase_args(synthetic_problem(seed + 3, device, g=5, n=64,
                                                                 dead_group=True)), 3.0, 400),
        "c_warm_price": (phase_args(synthetic_problem(seed + 4, device, g=4, n=64,
                                                                ties=True), warm), 0.9, 400),
        "c_max_rounds_cut": (phase_args(synthetic_problem(seed + 5, device, g=5, n=300,
                                                                    scarce=True)), 0.9, 3),
        "c_warm_x0_overfill": (phase_args(synthetic_problem(seed + 11, device, g=5, n=300,
                                                            scarce=True), start=overfilled),
                               0.9, 400),
        "c_2g_beyond_shared_memory": (phase_args(synthetic_problem(
            seed + 6, device, g=2100, n=40, supply_hi=8)), 0.9, 4),
    }
    err, lines = 0, {}
    for name, (args, eps, max_rounds) in cases.items():
        before = kernels.LAUNCHES["auction_phase"]
        counts = (kernels.CUDA_LAUNCHES["auction_phase"], kernels.HOST_SYNCS["auction_phase"])
        got = ttr._auction_phase(*args, eps, max_rounds)
        sync(device)
        launched = kernels.LAUNCHES["auction_phase"] - before
        cuda_launches, host_syncs = cluster_counts(kernels, "auction_phase", counts)
        plan = plan_summary(kernels.LAST_AUCTION_PLAN) if device.type == "cuda" else None
        ref = ttr._auction_phase_plain(*args, eps, max_rounds)
        sync(device)
        e = max(int((got[0].long() - ref[0].long()).abs().max()),
                float((got[1] - ref[1]).abs().max()), float((got[2] - ref[2]).abs().max()),
                abs(got[3] - ref[3]))
        equal = (all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
                 and got[3] == ref[3])
        g, n = args[0].shape
        line = {"phase": "kernel_E", "case": name, "G": g, "N": n, "eps": eps,
                "max_rounds": max_rounds, "rounds": got[3], "units": int(got[0].sum()),
                "supply": int(args[2].sum()), "equal": equal, "max_abs_err": e,
                "launches": launched, "cuda_launches": cuda_launches, "host_syncs": host_syncs,
                "plan": plan}
        err = max(err, e)
        check(equal, f"kernel E differs from its plain version on case {name}")
        check(device.type != "cuda" or (launched, cuda_launches, host_syncs) == (1, 1, 1),
              f"kernel E on case {name}: {launched} wrapper calls, {cuda_launches} CUDA "
              f"launches, {host_syncs} host syncs (want one each)")
        if device.type == "cuda" and name == "c_2g_beyond_shared_memory":
            check("exchange" in plan["in_global"], f"kernel E's plan for G 2,100: {plan}")
        if name == "a_transport_50k_batch_first_phase":
            line["ms"] = timed_ms(lambda: ttr._auction_phase(*args, eps, max_rounds), 20, device)
            line["plain_ms"] = timed_ms(lambda: ttr._auction_phase_plain(*args, eps, max_rounds),
                                        2, device, warmup=0)
            line["device_ms"] = device_ms(lambda: ttr._auction_phase(*args, eps, max_rounds),
                                          ("auction_phase_kernel",), device, iters=10)
            line["us_per_round"] = line["ms"] * 1e3 / max(got[3], 1)
            if line["device_ms"] is not None:
                line["device_us_per_round"] = line["device_ms"] * 1e3 / max(got[3], 1)
            # candidates per round: holders and bidders the accept step walks
            nbytes, ops = kernel_e_work(args, got[3], 2 * min(16, n) * g)
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"G {g} x N {n}, supply {int(args[2].sum())}, {got[3]} rounds"
        emit(line)
        lines[name] = line
    return err, lines["a_transport_50k_batch_first_phase"]


def f_exchange_groups(device):
    """Groups whose row-maximum and partial slots (2 x CS x G x 4 bytes at N
    40) exceed a CTA's shared memory: 2,100 on a 16-CTA cluster, 3,600 on an
    8-CTA one (below 4,096, where torch would split the column sums across
    blocks)."""
    if device.type != "cuda":
        return 2100
    from kubernetes_tpu_torch.ops import kernels

    return 2100 if kernels._cluster_size(kernels._lib("sinkhorn"), "sinkhorn") == 16 else 3600


# The 60-iteration Sinkhorn plan against its plain version: the largest
# reading so far is 1.53e-5 (a scarce warm problem, the card against its
# plain version and XLA against torch on the CPU), so a bound of 1e-4.
PLAN_TOL = 1e-4


def kernel_f_work(args, iters):
    """(bytes, operations): inputs read once, f/g/plan written once; the
    formula's operations: z = (C + mask) / eps once (2 a cell); per
    iteration g / eps once a node and f / eps once a group, and in each of
    the two passes 5 a cell (the shift, the max, the subtraction, the exp,
    the sum) and ~6 a row or column (log, shift, clamp); the plan's ~6 a
    cell."""
    g, n = args[0].shape
    nbytes = sum(t.numel() * t.element_size() for t in args) + (g + n + g * n) * 4
    return nbytes, g * n * 2 + iters * (2 * g * n * 5 + 7 * (g + n)) + g * n * 6


def phase_kernel_f(device, sizes, seed):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels

    wl = transport_workloads(sizes)
    nodes_t, pods_t = wl["Transport_50k"]()
    prob_t, _, _, _ = group_problem(nodes_t, pods_t[:sizes["batch"]], device)
    nodes_m, pods_m = wl["TransportMixed"]()
    prob_m, _, _, _ = group_problem(nodes_m, pods_m[:sizes["batch"]], device)

    def from_problem(p, warm=False):
        g, n = p.utility.shape
        g0 = (torch.from_numpy(np.random.default_rng(seed).random(n).astype(np.float32)) * 50
              if warm else torch.zeros(n))
        return (p.utility, p.feasible, p.supply, ttr._effective_cap(p).contiguous(),
                torch.zeros(g, device=p.utility.device), g0.to(p.utility.device))

    def from_synthetic(t, warm=False):
        g, n = t["utility"].shape
        rng = np.random.default_rng(seed + 3)
        cap = np.maximum(t["slots"].cpu().numpy().astype(np.float32)
                         - rng.random(n).astype(np.float32), 0)
        g0 = (rng.random(n) * 50).astype(np.float32) if warm else np.zeros(n, np.float32)
        return (t["utility"], t["feasible"], t["supply"], torch.from_numpy(cap).to(device),
                torch.zeros(g, device=device), torch.from_numpy(g0).to(device))

    cases = {
        "a_transport_50k_batch": from_problem(prob_t),
        "b_transport_mixed_batch": from_problem(prob_m),
        "c_ample": from_synthetic(synthetic_problem(seed + 7, device, g=3, n=300)),
        "c_scarce": from_synthetic(synthetic_problem(seed + 8, device, g=5, n=300, scarce=True,
                                                     supply_hi=200)),
        "c_all_infeasible_row": from_synthetic(synthetic_problem(seed + 9, device, g=4, n=300,
                                                                 dead_group=True)),
        "c_warm_g": from_synthetic(synthetic_problem(seed + 10, device, g=5, n=300, scarce=True,
                                                     supply_hi=200), warm=True),
        "c_warm_g_mixed": from_problem(prob_m, warm=True),
        "c_z_beyond_shared_memory": from_synthetic(synthetic_problem(
            seed + 12, device, g=128, n=10000, scarce=True, supply_hi=200)),
        "c_exchange_beyond_shared_memory": from_synthetic(synthetic_problem(
            seed + 13, device, g=f_exchange_groups(device), n=40, supply_hi=50)),
    }
    err, lines = 0.0, {}
    for name, args in cases.items():
        before = kernels.LAUNCHES["sinkhorn"]
        counts = (kernels.CUDA_LAUNCHES["sinkhorn"], kernels.HOST_SYNCS["sinkhorn"])
        got = ttr._sinkhorn_iters(*args, 2.0, 60)
        sync(device)
        launched = kernels.LAUNCHES["sinkhorn"] - before
        cuda_launches, host_syncs = cluster_counts(kernels, "sinkhorn", counts)
        plan = plan_summary(kernels.LAST_SINKHORN_PLAN) if device.type == "cuda" else None
        ref = ttr._sinkhorn_iters_plain(*args, 2.0, 60)
        sync(device)
        # the duals after 60 iterations and the plan from the same duals to
        # 1e-5; the 60-iteration plan to PLAN_TOL (the plan's exp turns a
        # dual drift d of a few ulps into a relative error ~d / eps)
        same = tuple(args[:4]) + (ref[0], ref[1])
        got0 = ttr._sinkhorn_iters(*same, 2.0, 0)
        ref0 = ttr._sinkhorn_iters_plain(*same, 2.0, 0)
        sync(device)
        errs = {"f": rel_err(got[0], ref[0]), "g": rel_err(got[1], ref[1]),
                "plan_same_duals": rel_err(got0[2], ref0[2])}
        worst = max(errs.values())
        g, n = args[0].shape
        plan_err = rel_err(got[2], ref[2])
        line = {"phase": "kernel_F", "case": name, "G": g, "N": n, "rel_err": errs,
                "plan_60_iterations_rel_err": plan_err, "plan_60_iterations_tolerance": PLAN_TOL,
                "max_rel_err": worst, "tolerance": 1e-5, "launches": launched,
                "cuda_launches": cuda_launches, "host_syncs": host_syncs, "plan": plan,
                "plan_mass": float(got[2].sum())}
        err = max(err, worst)
        check(worst <= 1e-5, f"kernel F differs from its plain version on case {name}: {errs}")
        check(plan_err <= PLAN_TOL, f"kernel F's 60-iteration plan differs from its plain "
              f"version on case {name}: {plan_err}")
        check(device.type != "cuda" or (launched, cuda_launches, host_syncs) == (1, 1, 0),
              f"kernel F on case {name}: {launched} wrapper calls, {cuda_launches} CUDA "
              f"launches, {host_syncs} host syncs (want 1, 1, 0)")
        if device.type == "cuda" and name.endswith("beyond_shared_memory"):
            region = "z" if name.startswith("c_z") else "exchange"
            check(region in plan["in_global"], f"kernel F's plan on case {name}: {plan}")
        if name.startswith("b_"):
            line["ms"] = timed_ms(lambda: ttr._sinkhorn_iters(*args, 2.0, 60), 20, device)
            line["plain_ms"] = timed_ms(lambda: ttr._sinkhorn_iters_plain(*args, 2.0, 60), 5,
                                        device)
            line["device_ms"] = device_ms(lambda: ttr._sinkhorn_iters(*args, 2.0, 60),
                                          ("sinkhorn_kernel",), device, iters=10)
            line["us_per_iteration"] = line["ms"] * 1e3 / 60
            if line["device_ms"] is not None:
                line["device_us_per_iteration"] = line["device_ms"] * 1e3 / 60
            nbytes, ops = kernel_f_work(args, 60)
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"G {g} x N {n}, 60 iterations"
        emit(line)
        lines[name] = line
    return err, lines["b_transport_mixed_batch"]


def initial_utility(nodes, pods, placement, device):
    """The reference rung's quality column: the sum over bound pods of their
    row score (kernel J's C) on their node against the initial state."""
    from kubernetes_tpu_torch.models.transport import _group_rows

    inputs, _, batch, groups, names = tensorize_groups(nodes, pods, device)
    _, util = _group_rows(inputs, groups)
    util = util.cpu().numpy()
    index = {nm: i for i, nm in enumerate(names)}
    total = 0
    for gi, (members, _cls) in enumerate(groups):
        for p in members.tolist():
            node = placement.get(batch.pods[p].metadata.name)
            if node:
                total += int(util[gi, index[node]])
    return total


def check_ssd(name, placed):
    off = [p.metadata.name for p in placed if p.spec.node_selector
           and int(p.spec.node_name.rsplit("-", 1)[1]) % 2]
    check(not off, f"{name}: {len(off)} ssd pods off the ssd nodes, e.g. {off[:3]}")


def solve_split(sched, kernel_ms):
    """The solve stage per batch (ms, host clock) split into the kernels'
    device time (CUDA events, KernelClock) and the rest: the host's problem
    build, rounding, repair and assignment, and the wrappers' own work."""
    n = len(sched.solve_seconds)
    solve_ms = sum(sched.solve_seconds) * 1e3 / max(n, 1)
    out = {"batches": n, "solve_ms_per_batch": solve_ms}
    if kernel_ms is not None:
        per = {k: v / max(n, 1) for k, v in kernel_ms.items()}
        out["kernel_device_ms_per_batch"] = per
        out["rest_ms_per_batch"] = solve_ms - sum(per.values())
    return out


def phase_main_path_transport(device, sizes, card):
    import torch

    from kubernetes_tpu_torch.ops import kernels

    out = {}
    for name, build in transport_workloads(sizes).items():
        nodes, pods = build()
        quality = {}
        for solver in ("auction", "sinkhorn"):
            with KernelClock(device) as clock:
                store, sched, got, launches, create_s, sched_s = drive_main_path(
                    name, nodes, pods, device, sizes["batch"], solver=solver)
            cluster = {"cuda_launches": dict(kernels.CUDA_LAUNCHES),
                       "host_syncs": dict(kernels.HOST_SYNCS)}
            split = solve_split(sched, clock.ms())
            placed = [p for p in got if p.spec.node_name]
            check(len(placed) == len(pods),
                  f"{name} {solver}: {len(placed)}/{len(pods)} pods bound through the store")
            check_no_overcommit(placed, nodes)
            check_ssd(name, placed)
            br = sched.breaker
            check(br.failures_total == 0 and sched._solve_path == solver,
                  f"{name} {solver}: path {sched._solve_path}, solver failures "
                  f"{br.failures_total}: {sched.last_solver_error}")
            if device.type == "cuda":
                check(launches["feasibility_rows"] > 0, f"{name} {solver}: kernel J never launched")
                kernel = "auction_phase" if solver == "auction" else "sinkhorn"
                check(launches[kernel] > 0, f"{name} {solver}: {kernel} never launched")
            card_map = {p.metadata.name: p.spec.node_name for p in got}
            t0 = time.perf_counter()
            nodes_c, pods_c = build()
            _, sched_c, got_c, _, _, _ = drive_main_path(name, nodes_c, pods_c,
                                                         torch.device("cpu"), sizes["batch"],
                                                         solver=solver)
            cpu_s = time.perf_counter() - t0
            placed_c = [p for p in got_c if p.spec.node_name]
            check_no_overcommit(placed_c, nodes_c)
            cpu_map = {p.metadata.name: p.spec.node_name for p in got_c}
            differ = [k for k in card_map if card_map[k] != cpu_map.get(k)]
            if solver == "auction":
                check(not differ, f"{name} auction: {len(differ)} placements differ from the CPU "
                                  f"run, e.g. {[(k, card_map[k], cpu_map[k]) for k in differ[:3]]}")
            else:
                check(len(placed_c) == len(placed), f"{name} sinkhorn: {len(placed)} bound on "
                                                    f"the card, {len(placed_c)} on the CPU")
            quality[solver] = initial_utility(nodes, pods, card_map, device)
            line = {"phase": "main_path_transport", "workload": name, "solver": solver,
                    "nodes": len(nodes), "pods": len(pods), "bound": len(placed),
                    "batches": sched.batches_solved, "launches": launches,
                    "pods_per_s": len(pods) / sched_s, "schedule_s": sched_s,
                    "create_s": create_s,
                    "solve_s_per_batch": sum(sched.solve_seconds) / len(sched.solve_seconds),
                    "solve_split": split, **cluster,
                    "stage_seconds": sched.stage_seconds,
                    "rounds_last_batch": sched.transport_state.iterations,
                    "initial_state_utility": quality[solver], "cpu_rerun_s": cpu_s,
                    "cpu_map_equal": not differ, "cpu_map_differs": len(differ),
                    "last_path": sched._solve_path, "breaker": br.describe(), "card": card}
            emit(line)
            out[f"{name}/{solver}"] = line
        # the comparison partners on the same card: fast and exact
        partners = {}
        for solver in ("fast", "exact"):
            nodes_x, pods_x = build()
            _, sched_x, got_x, _, _, sched_s_x = drive_main_path(
                name, nodes_x, pods_x, device, sizes["batch"], solver=solver)
            check(all(p.spec.node_name for p in got_x), f"{name} {solver}: pods left unbound")
            partners[solver] = {
                "pods_per_s": len(pods_x) / sched_s_x, "schedule_s": sched_s_x,
                "stage_seconds": sched_x.stage_seconds,
                "initial_state_utility": initial_utility(
                    nodes_x, pods_x, {p.metadata.name: p.spec.node_name for p in got_x}, device)}
        emit({"phase": "main_path_transport_partners", "workload": name, "partners": partners,
              "transport_utility": quality, "card": card})
        for solver in ("auction", "sinkhorn"):
            out[f"{name}/{solver}"]["partners"] = partners
    kernels.reset_launch_counts()
    return out


def plain_transport(fn):
    """Run fn with the transport module's three device functions swapped for
    their plain versions (on whatever device the tensors are)."""
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops.solver import feasibility_rows_plain

    saved = (ttr._auction_phase, ttr._sinkhorn_iters, ttr.feasibility_rows)
    ttr._auction_phase, ttr._sinkhorn_iters = ttr._auction_phase_plain, ttr._sinkhorn_iters_plain
    ttr.feasibility_rows = feasibility_rows_plain
    try:
        return fn()
    finally:
        ttr._auction_phase, ttr._sinkhorn_iters, ttr.feasibility_rows = saved


def phase_transport_direct(device, sizes, card):
    """One transport_solve at the JAX rung's one-call shapes: the 50,000
    pods of Transport_50k (G = 1) and the 100k/10k two-shape problem
    (bench.py:2594-2599, unsharded on one card); the card's solution held
    against the plain versions' on the card."""
    import numpy as np

    from kubernetes_tpu_torch.models.transport import transport_solve
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing import MakePod

    nodes_t, pods_t = transport_workloads(sizes)["Transport_50k"]()
    big_pods = [MakePod(f"ts-{i}").req({"cpu": "500m" if i % 2 else "250m", "memory": "1Gi"})
                .obj() for i in range(sizes["direct_pods"])]
    out = {}
    for name, nodes, pods in (("Transport_50k_one_call", nodes_t, pods_t),
                              ("Transport_100k_10k", transport_nodes(sizes["direct_nodes"]),
                               big_pods)):
        inputs, _, _, groups, names = tensorize_groups(nodes, pods, device)
        for method in ("auction", "sinkhorn"):
            def solve():
                return transport_solve(inputs, groups, method=method, node_names=names)

            solve()  # warm-up: the first call's allocations
            sync(device)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            a, state = solve()
            sync(device)
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            dev_ms = device_ms(solve, ("auction_phase_kernel", "sinkhorn_kernel",
                                       "feasibility_rows"), device, iters=2, per_call=None)
            t1 = time.perf_counter()
            a_plain, _ = plain_transport(solve)
            sync(device)
            plain_s = time.perf_counter() - t1
            placed, placed_plain = int((a >= 0).sum()), int((a_plain >= 0).sum())
            same = bool(np.array_equal(a, a_plain))
            if method == "auction":
                check(same, f"{name} auction: the card's assignment differs from the plain one")
            else:
                check(placed == placed_plain,
                      f"{name} sinkhorn: {placed} placed on the card, {placed_plain} plain")
            line = {"phase": "transport_direct", "problem": name, "method": method,
                    "nodes": len(nodes), "pods": len(pods), "groups": len(groups),
                    "placed": placed, "solve_s": dt, "pods_per_s": len(pods) / dt,
                    "kernel_device_ms": dev_ms, "launches": launches,
                    "iterations": state.iterations, "plain_s": plain_s,
                    "plain_assignment_equal": same, "card": card}
            emit(line)
            out[f"{name}/{method}"] = line
    kernels.reset_launch_counts()
    return out


# ---------------------------------------------------------------------------
# the rebalancer: Defrag_5000 (ON and OFF legs) and kernel I
# ---------------------------------------------------------------------------

DEFRAG_BUDGET_WAVE, DEFRAG_BUDGET_CYCLE = 64, 256


def defrag_cluster(sizes, m=None):
    """Defrag_5000 (the JAX Defrag rung, bench.py:1757-1930, at the gang
    phases' 5,000 nodes): 20 TPU slices of nodes of 8 cpu / 32Gi / 110 pods
    (MakeNode(...).tpu_slice(s, index=i)), one bound 3-cpu priority-1 filler
    on every node, and a PodGroup of one slice's worth of ranked 6-cpu
    priority-100 members, which no node can host as the cluster starts.
    Returns (nodes, fillers, (PodGroup, members))."""
    m = _testing(m)
    per = sizes["nodes"] // 20
    nodes = [m.MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
             .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj()
             for s in range(20) for i in range(per)]
    fillers = [m.MakePod(f"low-{s}-{i}").priority(1).req({"cpu": "3"}).node(f"node-{s}-{i}")
               .obj() for s in range(20) for i in range(per)]
    return nodes, fillers, gang_pods("train", per, "6", prio=100, m=m)


class DefragInputs:
    """Records kernel I's padded inputs (clones) while the main path runs, so
    kernel_I can hold the kernel to its plain version on the very tensors the
    Defrag_5000 cycle gave it. The wrapped call is defrag_plan's own call."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import kubernetes_tpu_torch.models.defrag as dfg

        self._real = real = dfg.defrag_assign

        def recording(*args):
            self.calls.append(tuple(a.clone() for a in args))
            return real(*args)

        dfg.defrag_assign = recording
        return self

    def __exit__(self, *exc):
        import kubernetes_tpu_torch.models.defrag as dfg

        dfg.defrag_assign = self._real


def defrag_leg(sizes, device, rebalance):
    """One leg of Defrag_5000 through the entry points a user calls:
    BatchScheduler(device=..., solver="fast"), on the ON leg
    enable_rebalancer(...) and cycle() until a cycle migrates nothing, then
    the gang driven as the rung's drive does (run_until_idle, which paces
    the rebalancer at idle, backoff flushes, event pumps)."""
    from kubernetes_tpu_torch.obs import tracebuf
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore
    from kubernetes_tpu_torch.testing import pod_conservation_report

    nodes, fillers, (pg, members) = defrag_cluster(sizes)
    store = APIStore()
    store.create_many("nodes", nodes)
    store.create_many("pods", fillers)
    sched = BatchScheduler(store, device=device.type, solver="fast", pod_initial_backoff=0.05,
                           pod_max_backoff=0.2)
    sched.sync()
    gc.collect()
    kernels.reset_launch_counts()
    out = {"cycles": [], "consolidate_s": 0.0}
    rb = None
    if rebalance:
        rb = sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=DEFRAG_BUDGET_WAVE,
                                     budget_per_cycle=DEFRAG_BUDGET_CYCLE, priority_ceiling=50)
        real_cycle = rb.cycle

        def audited_cycle():  # every cycle, the idle path's included, is audited
            res = real_cycle()
            out["cycles"].append(res)
            return res

        rb.cycle = audited_cycle
        # the trace ring times every cycle (a span each), the idle path's too
        buf = tracebuf.arm()
        t0 = time.perf_counter()
        for _ in range(16):
            r = rb.cycle()
            sched.pump_events()
            if not r.get("migrations"):
                break
        sync(device)
        out["consolidate_s"] = time.perf_counter() - t0
        out["map_after_cycles"] = {p.metadata.name: p.spec.node_name
                                   for p in store.list("pods")[0]}
        out["chain_after_cycles"] = sorted(rb._moves.items())
        out["candidates_route"] = rb.candidates_route
        out["consolidation_cycles"] = len(out["cycles"])
        out["stats_after_cycles"] = rb.stats()
    store.create("podgroups", pg)
    t0 = time.perf_counter()
    store.create_many("pods", members)
    want = len(members)
    bound = 0
    deadline = time.perf_counter() + 120.0
    poll_s = 0.0
    while time.perf_counter() < deadline:
        sched.run_until_idle()
        sched.queue.flush_backoff_completed()
        sched.pump_events()
        # this script's own poll: a LIST (a copy of every pod) each turn,
        # timed apart so the scheduler's share of admission_s reads alone
        tp = time.perf_counter()
        bound = sum(1 for p in store.list("pods")[0]
                    if p.metadata.name.startswith("train-") and p.spec.node_name)
        poll_s += time.perf_counter() - tp
        if bound >= want:
            break
        time.sleep(0.02)
    sync(device)
    out["admission_s"] = time.perf_counter() - t0
    out["admission_poll_s"] = poll_s
    out["launches"] = dict(kernels.LAUNCHES)
    out["bound"], out["members"] = bound, want
    out["victims"] = sched.gangpreempt.stats()["victims"]
    live = {p.key for p in store.list("pods")[0]}
    filler_keys = [f.key for f in fillers]
    if rb is not None:
        tracebuf.disarm()
        out["cycle_ms"] = [ev["dur"] / 1e3 for ev in buf.events() if ev["name"] == "cycle"]
        out["trace"] = buf.status()
        filler_keys = rb.resolve_keys(filler_keys)
        out["stats"] = rb.stats()
        out["chain"] = sorted(rb._moves.items())
        rb.release()
    # fillers the OFF leg's cover evicted are gone by design; the rest, and
    # every gang member, must be bound exactly once
    out["deleted_fillers"] = sum(1 for k in filler_keys if k not in live)
    rep = pod_conservation_report(store, sched, [p.key for p in members]
                                  + [k for k in filler_keys if k in live])
    out["conservation"] = rep["counts"]
    out["map"] = {p.metadata.name: p.spec.node_name for p in store.list("pods")[0]}
    out["slice_pods"] = {}
    for p in store.list("pods")[0]:
        if p.spec.node_name:
            s = p.spec.node_name.split("-")[1]
            out["slice_pods"][s] = out["slice_pods"].get(s, 0) + 1
    out["stage_seconds"] = dict(sched.stage_seconds)
    out["batches"] = sched.batches_solved
    sched.stop()
    return out


def phase_main_path_defrag(device, sizes, card, inputs):
    import torch

    t0 = time.perf_counter()
    with inputs:
        on = defrag_leg(sizes, device, True)
    on_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    off = defrag_leg(sizes, device, False)
    off_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = defrag_leg(sizes, torch.device("cpu"), True)
    cpu_s = time.perf_counter() - t0
    per = sizes["nodes"] // 20
    for name, leg in (("ON", on), ("OFF", off)):
        check(leg["bound"] == leg["members"],
              f"Defrag_5000 {name}: {leg['bound']}/{leg['members']} gang members bound")
        c = leg["conservation"]
        check(c["lost"] == 0 and c["double_bound"] == 0,
              f"Defrag_5000 {name}: conservation {c}")
    check(on["victims"] == 0 and on["deleted_fillers"] == 0,
          f"Defrag_5000 ON evicted {on['victims']} victims ({on['deleted_fillers']} fillers gone)")
    check(off["victims"] > 0 and off["deleted_fillers"] == off["victims"],
          f"Defrag_5000 OFF: {off['victims']} victims, {off['deleted_fillers']} fillers gone")
    check(on["stats"]["migrations"] > 0, "Defrag_5000 ON migrated nothing")
    over = [r.get("migrations", 0) for r in on["cycles"]
            if r.get("migrations", 0) > DEFRAG_BUDGET_CYCLE]
    check(not over, f"Defrag_5000 ON: cycles over the {DEFRAG_BUDGET_CYCLE} budget: {over}")
    # the donor slice drains wholly (with 20 slices the score stays high by
    # construction, so the rung's frag_after < 0.25 does not carry over)
    after = {}
    for name, node in on["map_after_cycles"].items():
        s = node.split("-")[1]
        after[s] = after.get(s, 0) + 1
    empty = [s for s in range(20) if after.get(str(s), 0) == 0]
    check(empty, f"Defrag_5000 ON: no slice drained by the consolidation cycles: {after}")
    if device.type == "cuda":
        check(on["launches"]["defrag_assign"] > 0, "Defrag_5000 ON: kernel I never launched")
    check(on["map_after_cycles"] == cpu["map_after_cycles"]
          and on["chain_after_cycles"] == cpu["chain_after_cycles"]
          and on["map"] == cpu["map"] and on["chain"] == cpu["chain"]
          and on["cycles"] == cpu["cycles"],
          "Defrag_5000 ON: the CPU rerun migrated or placed differently")
    migrations = on["stats_after_cycles"]["migrations"]
    lines = {}
    for name, leg, seconds in (("ON", on, on_s), ("OFF", off, off_s)):
        line = {"phase": "main_path_defrag", "workload": "Defrag_5000", "leg": name,
                "nodes": 20 * per, "slices": 20, "fillers": 20 * per, "gang": leg["members"],
                "bound": leg["bound"], "victims": leg["victims"],
                "admission_s": leg["admission_s"], "admission_poll_s": leg["admission_poll_s"],
                "conservation": leg["conservation"],
                "launches": leg["launches"], "batches": leg["batches"],
                "stage_seconds": leg["stage_seconds"], "pods_per_slice": leg["slice_pods"],
                "leg_s": seconds, "card": card}
        if name == "ON":
            cyc = leg["cycles"]
            line.update({
                "frag_before": cyc[0]["frag"], "frag_after": cyc[leg["consolidation_cycles"] - 1]
                ["frag"], "consolidation_cycles": leg["consolidation_cycles"],
                "consolidation_migrations": migrations,
                "consolidate_s": leg["consolidate_s"],
                "candidates_route": leg["candidates_route"],
                "pods_moved_per_s": migrations / leg["consolidate_s"],
                "drained_slices": empty, "cycles": cyc, "cycle_ms": leg["cycle_ms"],
                "trace": leg["trace"], "rebalance": leg["stats"],
                "budget_per_wave": DEFRAG_BUDGET_WAVE, "budget_per_cycle": DEFRAG_BUDGET_CYCLE,
                "cpu_rerun_s": cpu_s, "cpu_equal": True})
        emit(line)
        lines[name] = line
    return lines


def kernel_i_work(args, counts):
    """(bytes, operations): inputs read once, the targets written once; per
    slot key the fit test and the waste sum (2R) and the key, mask and
    minimum (3), for the keys this run's data needs: every slot at a tree
    rebuild (a victim whose request differs from the last one's), one
    leaf's group at a placement followed by the same request (`counts`,
    testing.defrag_tree_model's)."""
    from kubernetes_tpu_torch.ops.kernels import defrag_group

    free, head, ok, v_req, valid = args
    n_slots, r = free.shape
    v_max = v_req.shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in args) + v_max * 4
    keys = counts["rebuilds"] * n_slots + counts["leaf_updates"] * defrag_group(n_slots)
    return nbytes, keys * (2 * r + 3)


def phase_kernel_i(device, sizes, seed, inputs):
    import numpy as np
    import torch

    import kubernetes_tpu_torch.testing as tt
    from kubernetes_tpu_torch.models import defrag as dfg
    from kubernetes_tpu_torch.ops import kernels

    check(inputs.calls, "kernel_I: the Defrag_5000 ON leg planned nothing")

    def t(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    cases = {"a_defrag_5000_cycle": inputs.calls[0],
             "b_cap_1024_victims": t(tt.defrag_problem(seed, sizes["nodes"],
                                                       dfg.DEFRAG_MAX_VICTIMS))}
    for name, arrays in sorted(tt.defrag_edge_cases().items()):
        cases[f"c_{name}"] = t(arrays)
    cases["d_global_state"] = t(tt.defrag_problem(seed + 1, 30000, sizes["defrag_wide_v"], r=4,
                                                  n_slots=32768))
    # runs of 1-64 identical requests (kernel I's tree rebuilds at a change)
    cases["e_request_runs"] = t(tt.defrag_request_runs(seed + 2, sizes["nodes"],
                                                       dfg.DEFRAG_MAX_VICTIMS))
    err, lines = 0, {}
    for name, args in cases.items():
        before = kernels.LAUNCHES["defrag_assign"]
        cuda_before = kernels.CUDA_LAUNCHES["defrag_assign"]
        got = dfg.defrag_assign(*args)
        sync(device)
        launched = kernels.LAUNCHES["defrag_assign"] - before
        cuda_launched = kernels.CUDA_LAUNCHES["defrag_assign"] - cuda_before
        plan = dict(kernels.LAST_DEFRAG_PLAN) if device.type == "cuda" else None
        # the schedule as the kernel counted it (tree rebuilds, leaf updates)
        sched = kernels.LAST_DEFRAG_COUNTS.tolist() if device.type == "cuda" else None
        ref = dfg.defrag_assign_plain(*args)
        sync(device)
        e = int((got.long() - ref.long()).abs().max())
        equal = got.dtype == ref.dtype and bool((got == ref).all())
        n_slots, r = args[0].shape
        v_max = args[3].shape[0]
        real = int(args[4].sum())
        # what this run's data needs (the bound's work), by the numpy model
        model = tt.defrag_tree_model(*(a.cpu().numpy() for a in args))[1]
        timed = name[0] in "abe"
        iters = 20 if name[0] == "a" else 10 if timed else 5
        line = {"phase": "kernel_I", "case": name, "n_slots": n_slots, "v_max": v_max, "R": r,
                "victims": real, "placed": int((got >= 0).sum()),
                "unplaceable": real - int((got >= 0).sum()),
                "state_bytes": n_slots * (r + 1) * 4, "equal": equal, "max_abs_err": e,
                "launches": launched, "cuda_launches": cuda_launched, "plan": plan,
                "rebuilds": None if sched is None else sched[0],
                "leaf_updates": None if sched is None else sched[1],
                "model_rebuilds": model["rebuilds"], "model_leaf_updates": model["leaf_updates"],
                "device_ms": device_ms(lambda: dfg.defrag_assign(*args), ("defrag_assign",),
                                       device, iters=iters)}
        err = max(err, e)
        check(equal, f"kernel I differs from its plain version on case {name}")
        check(device.type != "cuda" or (launched == 1 and cuda_launched == 1),
              f"kernel I did not launch once on case {name}")
        check(sched is None or sched == [model["rebuilds"], model["leaf_updates"]],
              f"kernel I's schedule {sched} differs from the model's on case {name}")
        if timed:
            line["ms"] = timed_ms(lambda: dfg.defrag_assign(*args), iters, device)
            line["plain_ms"] = timed_ms(lambda: dfg.defrag_assign_plain(*args), 2, device,
                                        warmup=0)
            nbytes, ops = kernel_i_work(args, model)
            line["bytes"], line["ops"] = nbytes, ops
            line["bound_ms"], line["bound_by"] = bound_ms(nbytes, ops)
            line["shape"] = f"n_slots {n_slots}, v_max {v_max}, R {r}"
        emit(line)
        lines[name] = line
    check(lines["b_cap_1024_victims"]["unplaceable"] > 0,
          "kernel_I case b has no unplaceable victim")
    check(lines["d_global_state"]["state_bytes"] > 227 * 1024,
          "kernel_I case d does not leave the shared-memory path")
    return (err, lines["a_defrag_5000_cycle"], lines["b_cap_1024_victims"],
            lines["e_request_runs"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true", help="reduced sizes (rehearsal)")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    try:
        import kubernetes_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the kubernetes_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    sizes = ({"small": True, "nodes": 500, "basic": 1000, "spread": 500, "mixed": 300, "plain": 1000,
              "batch": 400, "group_big": 5000, "anti_groups": 10, "affinity": 500,
              "gang_members": 25, "preempt_members": 40, "slice_nodes": 250,
              "cover_victims": 1000, "budget_nodes": 1400, "align_p_max": 4096,
              "transport_pods": 5000, "mixed_transport_pods": 1000, "direct_pods": 10000,
              "direct_nodes": 1000, "defrag_wide_v": 64, "scan_global_nodes": 70000,
              "preempt_nodes": 100, "preempt_constrained": 20,
              "fallback": {"prebound": 8, "provision": 4, "static": 2, "dra_one": 4,
                           "dra_two": 2, "spread": 4}}
             if args.small else
             {"small": False, "nodes": 5000, "basic": 10000, "spread": 5000, "mixed": 2000, "plain": 10000,
              "batch": 4096, "group_big": 10000, "anti_groups": 50, "affinity": 5000,
              "gang_members": 256, "preempt_members": 400, "slice_nodes": 250,
              "cover_victims": 1000, "budget_nodes": 4000, "align_p_max": 4096,
              "transport_pods": 50000, "mixed_transport_pods": 10000, "direct_pods": 100000,
              "direct_nodes": 10000, "defrag_wide_v": 256, "scan_global_nodes": 70000,
              "preempt_nodes": 500, "preempt_constrained": 50,
              "fallback": {"prebound": 48, "provision": 16, "static": 8, "dra_one": 32,
                           "dra_two": 16, "spread": 16}})
    try:
        info = phase_device(device)
        phase_build()
        err_a, timing_a = phase_kernel_a(device, sizes, args.seed)
        err_b, line_b = phase_kernel_b(device, sizes, args.seed)
        err_c, line_c = phase_kernel_c(device, sizes, args.seed)
        err_d, (timing_d, *timing_d_more) = phase_kernel_d(device, sizes, args.seed)
        err_g, line_g, line_g_batch = phase_kernel_g(device, sizes, args.seed)
        err_h, line_h, line_h_2k, line_h_c = phase_kernel_h(device, sizes, args.seed)
        err_j, line_j, line_j_row = phase_kernel_j(device, sizes, args.seed)
        err_e, line_e = phase_kernel_e(device, sizes, args.seed)
        err_f, line_f = phase_kernel_f(device, sizes, args.seed)
        main = phase_main_path(device, sizes, info["nvidia_smi"])
        phase_main_path_store(device, sizes, info["nvidia_smi"], COLUMNAR_LEG)
        phase_main_path_commit(device, sizes, info["nvidia_smi"], COLUMNAR_LEG)
        COLUMNAR_LEG.clear()
        fast = phase_main_path_fast(device, sizes, info["nvidia_smi"])
        gang = phase_main_path_gang(device, sizes, info["nvidia_smi"])
        preempt = phase_main_path_gang_preempt(device, sizes, info["nvidia_smi"])
        pod_preempt = phase_main_path_preempt(device, sizes, info["nvidia_smi"])
        fallback = phase_main_path_fallback(device, sizes, info["nvidia_smi"])
        transport = phase_main_path_transport(device, sizes, info["nvidia_smi"])
        phase_transport_direct(device, sizes, info["nvidia_smi"])
        inputs = DefragInputs()
        defrag = phase_main_path_defrag(device, sizes, info["nvidia_smi"], inputs)
        err_i, line_i, line_i_cap, line_i_runs = phase_kernel_i(device, sizes, args.seed,
                                                                inputs)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # A and B: the exact main path (SchedulingBasic); C and D: the fast main
    # path, summed over its four workloads; G: the gang preemption path, H:
    # the gang path; J: the transport path's four runs, E: its auction runs,
    # F: its sinkhorn runs; I: the Defrag_5000 legs; each summed over its
    # runs (counts reset before each run)
    transport_sum = {k: sum(ln["launches"][k] for ln in transport.values())
                     for k in ("feasibility_rows", "auction_phase", "sinkhorn")}
    # the per-pod preemption path's launches of A, B and C, summed over its runs
    preempt_sum = {k: sum(ln["launches"][k] for ln in pod_preempt.values())
                   for k in ("greedy_scan", "row_scatter", "waterfill")}
    launches = main["SchedulingBasic"]["launches"]
    kernels = [
        {"name": "greedy_scan", "route": "cuda", "source": KERNEL_A_SRC,
         "replaces": "kubernetes_tpu/ops/solver.py:265", "launches": launches["greedy_scan"],
         "max_abs_err": err_a, "ms": timing_a["ms"], "plain_ms": timing_a["plain_ms"],
         "bound_ms": timing_a["bound_ms"], "bound_by": timing_a["bound_by"],
         "library_ms": None, "checked": True, "shape": timing_a["shape"],
         "device_ms": timing_a["device_ms"], "us_per_pod_step": timing_a["us_per_pod_step"],
         "cluster_size": timing_a["plan"]["cluster_size"],
         "threads_per_cta": timing_a["plan"]["threads"],
         "preempt_path_launches": preempt_sum["greedy_scan"]},
        {"name": "row_scatter", "route": "cuda", "source": KERNEL_B_SRC,
         "replaces": "kubernetes_tpu/snapshot/tensorizer.py:399",
         "launches": launches["row_scatter"], "max_abs_err": err_b, "ms": line_b["ms"],
         "plain_ms": line_b["plain_ms"], "bound_ms": line_b["bound_ms"],
         "bound_by": line_b["bound_by"], "library_ms": line_b["library_ms"],
         "checked": True, "shape": line_b["timing_shape"], "device_ms": line_b["device_ms"],
         "library_device_ms": line_b["library_device_ms"],
         "batch_ms": {k: v["ms"] for k, v in line_b["batch"].items()},
         "batch_library_ms": {k: v["library_ms"] for k, v in line_b["batch"].items()},
         "preempt_path_launches": preempt_sum["row_scatter"],
         "fallback_path_launches": fallback["launches"]["row_scatter"]},
        {"name": "waterfill", "route": "cuda", "source": KERNEL_C_SRC,
         "replaces": "kubernetes_tpu/models/waterfill.py:79",
         "launches": sum(ln["launches"]["waterfill"] for ln in fast.values()),
         "max_abs_err": err_c, "ms": line_c["ms"], "plain_ms": line_c["plain_ms"],
         "bound_ms": line_c["bound_ms"], "bound_by": line_c["bound_by"], "library_ms": None,
         "library": "none: torch.topk computes only the selection, not the whole function",
         "checked": True,
         "shape": f"{line_c['nodes']} nodes x j_max {line_c['j_max']}, group {line_c['group']}",
         "device_ms": line_c["device_ms"], "cuda_launches_per_call": line_c["cuda_launches"],
         "plan": line_c["plan"],
         "host_syncs_per_batch": {k: ln["waterfill_host_syncs_per_batch"]
                                  for k, ln in fast.items()},
         "preempt_path_launches": preempt_sum["waterfill"],
         "fallback_path_launches": fallback["launches"]["waterfill"]},
        {"name": "repair_check", "route": "cuda", "source": KERNEL_D_SRC,
         "replaces": "kubernetes_tpu/models/repair.py:121",
         "launches": sum(ln["launches"]["repair_check"] for ln in fast.values()),
         "max_abs_err": err_d, "ms": timing_d["ms"], "plain_ms": timing_d["plain_ms"],
         "bound_ms": timing_d["bound_ms"], "bound_by": timing_d["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call computes the violation check",
         "checked": True, "shape": timing_d["shape"], "device_ms": timing_d["device_ms"],
         "cuda_launches_per_call": timing_d["cuda_launches"], "plan": timing_d["plan"],
         "more_shapes": {ln["case"]: {k: ln[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                                        "bound_ms", "bound_by", "plan")}
                         for ln in timing_d_more}},
        {"name": "cover_curve", "route": "cuda", "source": KERNEL_G_SRC,
         "replaces": "kubernetes_tpu/models/gangcover.py:78",
         "launches": sum(ln["launches"]["cover_curve"] for ln in preempt.values()),
         "max_abs_err": err_g, "ms": line_g["ms"], "plain_ms": line_g["plain_ms"],
         "bound_ms": line_g["bound_ms"], "bound_by": line_g["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call computes the curve",
         "checked": True, "shape": line_g["shape"], "device_ms": line_g["device_ms"],
         "attempt_ms": line_g_batch["ms"], "attempt_device_ms": line_g_batch["device_ms"],
         "attempt_per_slice_route_ms": line_g_batch["per_slice_route_ms"],
         "attempt_shape": f"{line_g_batch['slices']} slices, n_slots {line_g_batch['n_slots']}, "
                          f"k_max {line_g_batch['k_max']}",
         "launches_per_attempt": {k: ln["cover_launches_per_attempt"]
                                  for k, ln in preempt.items()}},
        {"name": "rank_align", "route": "cuda", "source": KERNEL_H_SRC,
         "replaces": "kubernetes_tpu/models/gangcover.py:174",
         "launches": sum(ln["launches"]["rank_align"] for ln in gang.values()),
         "max_abs_err": err_h, "ms": line_h["ms"], "plain_ms": line_h["plain_ms"],
         "bound_ms": line_h["bound_ms"], "bound_by": line_h["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call computes the aligned permutation "
                    "(two lexsorts and a scatter)",
         "checked": True, "shape": line_h["shape"], "device_ms": line_h["device_ms"],
         "cuda_launches_per_call": line_h["cuda_launches"], "plan": line_h["plan"],
         "p2048_ms": line_h_2k["ms"], "p2048_device_ms": line_h_2k["device_ms"],
         "p2048_bound_ms": line_h_2k["bound_ms"], "p16384_ms": line_h_c["ms"],
         "p16384_device_ms": line_h_c["device_ms"]},
        {"name": "feasibility_rows", "route": "cuda", "source": KERNEL_J_SRC,
         "replaces": "kubernetes_tpu/parallel/sharded.py:108",
         "launches": transport_sum["feasibility_rows"], "max_abs_err": err_j,
         "ms": line_j["ms"], "plain_ms": line_j["plain_ms"], "bound_ms": line_j["bound_ms"],
         "bound_by": line_j["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call computes the filtered, normalized rows",
         "checked": True, "shape": line_j["shape"], "device_ms": line_j["device_ms"],
         "cuda_launches_per_call": line_j["cuda_launches"], "plan": line_j["plan"],
         "row_ms": line_j_row["ms"], "row_device_ms": line_j_row["device_ms"],
         "row_plain_ms": line_j_row["plain_ms"], "row_bound_ms": line_j_row["bound_ms"],
         "row_shape": line_j_row["shape"], "row_plan": line_j_row["plan"]},
        {"name": "auction_phase", "route": "cuda", "source": KERNEL_E_SRC,
         "replaces": "kubernetes_tpu/models/transport.py:130",
         "launches": transport_sum["auction_phase"], "max_abs_err": err_e, "ms": line_e["ms"],
         "plain_ms": line_e["plain_ms"], "bound_ms": line_e["bound_ms"],
         "bound_by": line_e["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call runs an auction phase",
         "checked": True, "shape": line_e["shape"], "device_ms": line_e["device_ms"],
         "us_per_round": line_e["us_per_round"], "cuda_launches_per_call": line_e["cuda_launches"],
         "host_syncs_per_call": line_e["host_syncs"], "plan": line_e["plan"]},
        {"name": "sinkhorn", "route": "cuda", "source": KERNEL_F_SRC,
         "replaces": "kubernetes_tpu/models/transport.py:326",
         "launches": transport_sum["sinkhorn"], "max_abs_err": err_f, "ms": line_f["ms"],
         "plain_ms": line_f["plain_ms"], "bound_ms": line_f["bound_ms"],
         "bound_by": line_f["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call runs the 60 iterations "
                    "(torch.logsumexp is one of their reductions)",
         "tolerance": "relative 1e-5 on f, g and the plan from the same duals, "
                      "1e-4 on the 60-iteration plan",
         "checked": True, "shape": line_f["shape"], "device_ms": line_f["device_ms"],
         "us_per_iteration": line_f["us_per_iteration"],
         "cuda_launches_per_call": line_f["cuda_launches"],
         "host_syncs_per_call": line_f["host_syncs"], "plan": line_f["plan"]},
        {"name": "defrag_assign", "route": "cuda", "source": KERNEL_I_SRC,
         "replaces": "kubernetes_tpu/models/defrag.py:99",
         "launches": sum(ln["launches"]["defrag_assign"] for ln in defrag.values()),
         "max_abs_err": err_i, "ms": line_i["ms"], "plain_ms": line_i["plain_ms"],
         "bound_ms": line_i["bound_ms"], "bound_by": line_i["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call runs the sequential best-fit",
         "checked": True, "shape": line_i["shape"], "device_ms": line_i["device_ms"],
         "cuda_launches_per_call": line_i["cuda_launches"], "plan": line_i["plan"],
         "cap_ms": line_i_cap["ms"], "cap_device_ms": line_i_cap["device_ms"],
         "cap_bound_ms": line_i_cap["bound_ms"], "cap_shape": line_i_cap["shape"],
         "runs_ms": line_i_runs["ms"], "runs_device_ms": line_i_runs["device_ms"],
         "runs_rebuilds": line_i_runs["rebuilds"]},
    ]
    emit({"phase": "kernels", "card": info["nvidia_smi"], "kernels": kernels})
    for ln in info["nvidia_smi"]:
        print(ln)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
