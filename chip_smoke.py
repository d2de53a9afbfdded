#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # on a machine with a CUDA card

Phases, each printing one JSON line:
  device     card name, count, nvidia-smi name and power limit
  build      nvcc builds kernels A and B from csrc/ (ptxas register,
             shared-memory and spill lines)
  kernel_A   the greedy-scan kernel against greedy_scan_solve_plain on the
             card, on tensors the port's tensorizer built from seeded
             inputs: (a) SchedulingBasic 5,000 nodes x 10,000 pods,
             (b) TopologySpreading 5,000 nodes / 10 zones x 5,000 pods,
             (c) a mixed case that turns on all four gates; exact equality
             of assignment, used and pod_count
  kernel_B   the row-scatter kernel against scatter_rows_plain /
             scatter_cols_plain after seeded churn rounds; exact equality
  main_path  APIStore -> BatchScheduler(device="cuda", solver="exact") ->
             run_until_idle on the SchedulingBasic and TopologySpreading
             shapes: every pod bound through the store, no node
             over-committed, zone skew <= 1, kernel launch counts > 0
  kernels    one line per kernel: launches on the main path, error against
             the plain version, times (CUDA events) and the bound
Then the nvidia-smi line, the {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. A failed phase exits non-zero before the
last line. Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.

Sizes are scheduler_perf's SchedulingBasic 5000Nodes_10000Pods and the
TopologySpreading shape (test/integration/scheduler_perf/misc/
performance-config.yaml), nodes 8 cpu / 32Gi / 110 pods. Inputs are made
from --seed. --small runs every phase at a reduced size.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_A_SRC = "kubernetes_tpu_torch/csrc/greedy_scan.cu"
KERNEL_B_SRC = "kubernetes_tpu_torch/csrc/row_scatter.cu"


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
    tensorizer -> make_inputs."""
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
    return inputs, d_max, gates, cluster


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
            "kernel_ms_all_pods": round(kernel_ms, 4), "plain_s": round(plain_s, 3)}
    if pp < p:
        line["note"] = f"plain version compared on the first {pp} of {p} pods"
    emit(line)
    check(equal, f"kernel A differs from its plain version on case {name}")
    return err


def phase_kernel_a(device, sizes, seed):
    import numpy as np
    import torch

    n, p_basic, p_spread, p_mixed = sizes["nodes"], sizes["basic"], sizes["spread"], sizes["mixed"]
    errs = []
    inp_a, d_a, g_a, _ = tensorize(make_nodes(n), basic_pods(p_basic), device)
    errs.append(compare_a("a_scheduling_basic", inp_a, d_a, g_a, device, sizes["plain"], 3))
    inp_b, d_b, g_b, _ = tensorize(make_nodes(n, zones=10), spread_pods(p_spread), device)
    errs.append(compare_a("b_topology_spreading", inp_b, d_b, g_b, device, sizes["plain"], 3))
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
    errs.append(compare_a("c_mixed_all_gates", inp_c, d_c, g_c, device, sizes["plain"], 3))

    # the main path's shape: the first batch_size pods of SchedulingBasic
    k = min(sizes["batch"], p_basic)
    first = pod_slice(inp_a, k)
    from kubernetes_tpu_torch.ops.solver import greedy_scan_solve, greedy_scan_solve_plain

    ms = timed_ms(lambda: greedy_scan_solve(first, d_a, **g_a), 5, device)
    plain_ms = timed_ms(lambda: greedy_scan_solve_plain(first, d_a, **g_a), 1, device, warmup=0)
    nbytes, ops = kernel_a_work(first, d_a, g_a)
    b_ms, b_by = bound_ms(nbytes, ops)
    timing = {"phase": "kernel_A_timing", "shape": f"{first.alloc.shape[0]} nodes x {k} pods",
              "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
              "bound_ms": b_ms, "bound_by": b_by}
    emit(timing)
    return max(errs), timing


def phase_kernel_b(device, sizes, seed):
    import numpy as np
    import torch

    from kubernetes_tpu_torch.snapshot.tensorizer import (
        scatter_cols, scatter_cols_plain, scatter_rows, scatter_rows_plain)

    rng = np.random.default_rng(seed)
    n, r, sc = sizes["nodes"], 3, 4
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
    # timing at the main path's shape: one [N, 3] field, batch_size dirty rows
    k = min(sizes["batch"], n)
    idx = torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)).to(device)
    src = torch.from_numpy(rng.integers(0, 1 << 20, size=(k, r), dtype=np.int32)).to(device)
    idx_long = idx.long()
    ms = timed_ms(lambda: scatter_rows(dst["2d"], idx, src), 200, device)
    plain_ms = timed_ms(lambda: scatter_rows_plain(ref["2d"], idx, src), 200, device)
    library_ms = timed_ms(lambda: ref["2d"].index_copy_(0, idx_long, src), 200, device)
    nbytes = k * 4 + 2 * k * r * 4  # indices + source read, destination rows written
    b_ms, b_by = bound_ms(nbytes, 0)
    line = {"phase": "kernel_B", "nodes": n, "rounds": 8, "equal": equal, "max_abs_err": err,
            "timing_shape": f"[{n},{r}] int32, {k} rows", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_call": "Tensor.index_copy_",
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by}
    emit(line)
    check(equal, "kernel B differs from its plain version")
    return err, line


def drive_main_path(name, nodes, pods, device, batch_size):
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    store = APIStore()
    store.create_many("nodes", nodes)
    # the call a user makes: device="cuda" (the default), not a pinned index
    sched = BatchScheduler(store, device=device.type, solver="exact", batch_size=batch_size)
    sched.sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    store.create_many("pods", pods)
    t1 = time.perf_counter()
    sched.run_until_idle()
    sync(device)
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
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


def phase_main_path(device, sizes, card):
    n, batch = sizes["nodes"], sizes["batch"]
    out = {}
    for name, nodes, pods in (
            ("SchedulingBasic", make_nodes(n), basic_pods(sizes["basic"], "mp")),
            ("TopologySpreading", make_nodes(n, zones=10), spread_pods(sizes["spread"], "ms"))):
        store, sched, got, launches, create_s, sched_s = drive_main_path(
            name, nodes, pods, device, batch)
        placed = [p for p in got if p.spec.node_name]
        check(len(placed) == len(pods),
              f"{name}: {len(placed)}/{len(pods)} pods bound through the store")
        check_no_overcommit(placed, nodes)
        line = {"phase": "main_path", "workload": name, "nodes": n, "pods": len(pods),
                "bound": len(placed), "batches": sched.batches_solved,
                "launches": launches, "pods_per_s": len(pods) / sched_s,
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
    return out


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
    sizes = ({"nodes": 500, "basic": 1000, "spread": 500, "mixed": 300, "plain": 1000,
              "batch": 400} if args.small else
             {"nodes": 5000, "basic": 10000, "spread": 5000, "mixed": 2000, "plain": 10000,
              "batch": 4096})
    try:
        info = phase_device(device)
        phase_build()
        err_a, timing_a = phase_kernel_a(device, sizes, args.seed)
        err_b, line_b = phase_kernel_b(device, sizes, args.seed)
        main = phase_main_path(device, sizes, info["nvidia_smi"])
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    launches = main["SchedulingBasic"]["launches"]
    kernels = [
        {"name": "greedy_scan", "route": "cuda", "source": KERNEL_A_SRC,
         "replaces": "kubernetes_tpu/ops/solver.py:265", "launches": launches["greedy_scan"],
         "max_abs_err": err_a, "ms": timing_a["ms"], "plain_ms": timing_a["plain_ms"],
         "bound_ms": timing_a["bound_ms"], "bound_by": timing_a["bound_by"],
         "library_ms": None, "checked": True, "shape": timing_a["shape"]},
        {"name": "row_scatter", "route": "cuda", "source": KERNEL_B_SRC,
         "replaces": "kubernetes_tpu/snapshot/tensorizer.py:399",
         "launches": launches["row_scatter"], "max_abs_err": err_b, "ms": line_b["ms"],
         "plain_ms": line_b["plain_ms"], "bound_ms": line_b["bound_ms"],
         "bound_by": line_b["bound_by"], "library_ms": line_b["library_ms"],
         "checked": True, "shape": line_b["timing_shape"]},
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
