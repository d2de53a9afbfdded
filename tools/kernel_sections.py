#!/usr/bin/env python3
"""Where kernels E, F, C, G, I, J, D and H spend their cycles.

    python3 tools/kernel_sections.py [--kernels E,F,C,G,I,J,D,H]

Writes copies of the kernels' sources (csrc/auction_phase.cu, sinkhorn.cu,
waterfill.cu, cover_curve.cu, defrag_assign.cu, feasibility_rows.cu,
repair_check.cu, rank_align.cu) into
build/tools/ with a clock64 mark on
thread 0 of every CTA at each section boundary (the marks are inserted
before fixed lines of the sources, so an edit that moves one makes this
script stop with the line it missed), builds them with nvcc for sm_90a, runs
them on the inputs chip_smoke.py gives them (E and F: the first
Transport_50k batch and a TransportMixed batch, at 5,000 nodes; C: kernel_C
cases a and b, SchedulingBasic at 5,000 nodes; G: kernel_G case a and one
cover attempt of 20 slices; I: one request for 250 victims on 5,000 nodes
(Defrag_5000's cycle) and the 1,024-victim cap of mixed requests; J: one
and eight rows of 5,000 nodes and 512 rows; D: kernel_D_timing's
TopologySpreading, PodAntiAffinity and PodAffinity checks; H: p_max 4,096, 2,048 and
16,384) and prints one JSON line per
case: cycles a round (E), an iteration (F), a call (C, G, J, D, H) or a
victim (I) per section, on CTA 0 and the most over the CTAs, and the SM
clock. A section's time on thread 0 includes
its waits at CTA barriers. Needs a CUDA card; the kernels themselves are
untouched.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tools"
MARK = ('#define PROF(k) do { if (tid == 0) { long long _t = clock64(); prof_s[pk] += _t - prof_t; '
        'pk = (k); prof_t = _t; } } while (0)')
END = "  cluster.sync();  // no CTA leaves while another may still use its slots\n}"

# (source, section names in mark order, the marks: (section, the line it
# goes before), where the timer starts, the args struct's last line, the
# kernel's last line, the CTA's index)
KERNELS = {
    "auction_phase": dict(
        sections=["message_build", "message_select", "message_send", "wait", "cond",
                  "merge_select", "bids", "sync_rearm", "touched", "accept", "writeback",
                  "init"],
        marks=[(0, "    if (tid == 0) n_touched = 0;"),
               (1, "      int from, at;\n      const unsigned long long m = warp_select"),
               (2, "      int4 e = make_int4(0, 0, 0, 0);  // lane t's entry"),
               (3, "    xchg_wait(xc, p);"),
               (4, "    // ---- the loop condition on the summed changes"),
               (5, "    // ---- bids: merge every bidding group's CS lists"),
               (6, "      const int tav ="),
               (7, "    if (rounds == 0)  // the reference's fold"),
               (8, "    for (int i = tid; i < cnt; i += AU_THREADS)\n      if (tflag[i])"),
               (9, "    // ---- accept: one warp a walked node ----"),
               (10, "  // ---- write the phase's result back ----")],
        start="  int rounds = 0, progress = 1, p = 0;",
        tail="  int4* xslots;          // [2][cs][G][AU_LIST]: the exchange when it is global\n"),
    "sinkhorn": dict(
        sections=["ge_max_publish", "wait0", "accumulators", "tree_publish", "wait1", "f",
                  "columns", "writeback", "init"],
        marks=[(0, "    for (int i = tid; i < L; i += T) ge[i] = __fdiv_rn(gv[i], eps);"),
               (1, "    xchg_wait(xc, 0);"),
               (2, "    // ---- rows: each row thread's four accumulators"),
               (3, "    for (int j = warp; j < G * by; j += nw) {"),
               (4, "    xchg_wait(xc, 1);"),
               (5, "    const float* fer = fe;"),
               (6, "    // ---- columns: each node over its groups"),
               (7, "  // ---- f, this CTA's g and plan entries ----")],
        start="  for (int it = 0; it < a.iters; ++it) {",
        tail="  float* xslots;                  // [cs][G] maxima, then [cs][G * by] partials, when global\n"),
    "waterfill": dict(
        sections=["node_pass", "maxima_sync", "static_carve", "rows", "radix_count",
                  "radix_send", "radix_wait_sum", "radix_select", "c_n", "list_sort", "lists_sync",
                  "describe", "corank", "tail", "exit_sync"],
        marks=[(1, "  cluster.sync();  // every CTA's maxima are in its shared memory"),
               (2, "  unsigned* keys = (unsigned*)carve((size_t)K_c * 4, g_keys_off(a), nullptr);"),
               (3, "  // ---- 2. rows: ordered keys of j < j_cap"),
               (4, "    const int shift = 24 - 8 * pass, par = pass & 1;"),
               (5, "    // push this CTA's histogram into every CTA's slots of this parity"),
               (6, "    xchg_wait(xc, par);  // every CTA's histogram of this pass has arrived"),
               (7, "    if (warp == 0) {\n      unsigned s8 = 0;"),
               (8, "  // ---- 4. c_n = keys of the row at or above T"),
               (9, "  // ---- 5. the greedy order"),
               (10, "    cluster.sync();  // every CTA's list is sorted and described"),
               (11, "    if (tid < cs) {\n      const int len"),
               (12, "    const int steps = steps_s;"),
               (13, "  for (int i = m + rank * WF_THREADS + tid; i < a.k_slots;")],
        start="  // ---- 1. node pass",
        tail="  unsigned char* gscratch;\n};",
        end="  cluster.sync();  // no CTA leaves while another may still read its shared memory\n}",
        first=0, cta="rank"),
    "cover_curve": dict(
        sections=["stage", "sort_turns", "starts_scatter", "prefix_scans", "deltas", "cap0",
                  "curve_scan", "write"],
        marks=[(1, "  // ---- 2. stable counting sort by node ----"),
               (2, "  const int V = (int)block_scan<CC_THREADS>(cnt, NS, false, ws);"),
               (3, "  // ---- 3. prefix sums of the node-sorted requests, per resource ----"),
               (4, "  // ---- 4. capacity deltas, caps[0], the curve ----"),
               (5, "  unsigned cap0 = 0u;"),
               (6, "  block_scan<CC_THREADS>(curve, K + 1, true, ws);"),
               (7, "  for (int i = tid; i <= K; i += CC_THREADS) caps[i] = (int)curve[i];")],
        start="  // ---- 1. stage",
        tail="  unsigned* gscratch;             // S slices of slice_words, when !in_smem\n};",
        end="caps[i] = (int)curve[i];\n}", first=0, cta="s"),
    "defrag_assign": dict(
        sections=["loop_stage", "decide", "rebuild_wait", "rebuild_leaves", "rebuild_load",
                  "leaf_and_root", "place", "init"],
        marks=[(0, "    if (kc == 0) {  // stage the next victims"),
               (1, "    if (!vval_s[kc]) {  // a pad: -1, nothing changes"),
               (2, "      // rebuild for this request: warp 0's state updates are visible past"),
               (3, "      // two leaves a warp at a time (their loads in flight together)"),
               (4, "          leaf[e] = g < n_leaves ? leaf_s[g] : ~0ull;"),
               (5, "    // ---- warp 0: the stale leaf and the root in one pass, then place ----"),
               (6, "    const unsigned hi = (unsigned)(root >> 32), lo = (unsigned)root;")],
        start="  for (int n = tid; n < stride; n += DA_THREADS) {",
        tail="  int* counts;                     // [2] out: tree rebuilds, leaf updates\n};",
        end="    a.counts[1] = leaf_updates;\n  }\n}", cta="0"),
    "repair_check": dict(
        sections=["zero", "node_pass", "reduce", "pods", "exit"],
        marks=[(1, "  // ---- 1. this CTA's nodes into the domain sums"),
               (2, "  // ---- 2. the cluster's totals, the spread rows' minima"),
               (3, "  // ---- 3. this CTA's pods"),
               (4, "  // mode 1: no CTA leaves while another may still read its table")],
        start="  // ---- 0. zero this CTA's table",
        tail="  int* gtab;     // mode 2: [cs][rows][slice] domain totals\n};",
        end="    cluster_arrive();\n    cluster_wait();\n  }\n}", first=0, cta="rank"),
    # the sort's timer runs through chunk_sort
    "rank_align": dict(
        sections=["runs", "local_merges", "chunk_write", "sorted_sync", "team_merges",
                  "scatter"],
        extra=[("                          const int* group, const int* key, int base) {",
                "                          const int* group, const int* key, int base, "
                "long long& prof_t, long long* prof_s, int& pk) {"),
               ("const int b = chunk_sort(K, X, n, a.group_id, key, base);",
                "const int b = chunk_sort(K, X, n, a.group_id, key, base, prof_t, prof_s, pk)"
                ";")],
        marks=[(1, "  for (int L = 32; L < n; L <<= 1, b ^= 1) {"),
               (2, "      for (int i = tid; i < n; i += RA_THREADS) {\n        gk[base + i]"),
               (3, "  cluster_sync_all();  // every chunk is sorted"),
               (4, "  // ---- 2. the team's merge levels"),
               (5, "  // ---- 3. the scatter")],
        start="  // ---- 1. this CTA's slice, sorted a chunk at a time",
        tail="  unsigned* gidx;            // scratch [2 sorts][2 buffers][p_max]\n};",
        end="    a.out[ord_rank[i]] = a.assignment[ord_pos[i]];\n}", first=0, cta="rank"),
    "feasibility_rows": dict(
        sections=["row_data", "rows", "next_row", "cta_reduce", "push_wait",
                  "remote_max", "write", "load_state"],
        marks=[(0, "    const int cls = p.cls;"),
               (1, "    int mx_nap = 0, mx_taint = 0;  // max(where(feas, raw, 0)) starts at 0"),
               (2, "    const bool has_nap = p.has_nap;"),
               (3, "    // the CTA's maxima, pushed into every CTA's slot of this parity"),
               (4, "    xchg_wait(xc, par);"),
               (5, "    int mxn = 0, mxt = 0;"),
               (6, "    // feas and the finished totals, written once")],
        start="  RowParams p;\n",
        tail="  int* total;                        // [Rw, N] out\n};",
        end="  // no CTA leaves while another may still push into it\n  cluster_wait();\n}",
        cta="blockIdx.x"),
}


def instrument(name: str) -> Path:
    spec = KERNELS[name]
    n = len(spec["sections"])
    end = spec.get("end", END)
    s = (ROOT / "kubernetes_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    last_include = s.rindex('#include ')
    s = (s[:last_include] + s[last_include:].replace("\n", "\n" + MARK + "\n", 1))
    s = s.replace('#include "', '#include "../../kubernetes_tpu_torch/csrc/')
    tail = spec["tail"]
    for old, new in spec.get("extra", ()):
        if s.count(old) != 1:
            sys.exit(f"kernel_sections: {name}.cu no longer has the line {old!r}")
        s = s.replace(old, new)
    for anchor in (tail, spec["start"], end):
        if s.count(anchor) != 1:
            sys.exit(f"kernel_sections: {name}.cu no longer has the line {anchor!r}")
    if tail.endswith("};"):
        s = s.replace(tail, tail[:-2] + "  long long* prof;\n};")
    else:
        s = s.replace(tail, tail + "  long long* prof;\n")
    s = s.replace(spec["start"], f"  long long prof_t = clock64(), prof_s[{n}] = {{0}};\n"
                  f"  int pk = {spec.get('first', n - 1)};\n" + spec["start"])
    for k, anchor in spec["marks"]:
        if s.count(anchor) != 1:
            sys.exit(f"kernel_sections: {name}.cu no longer has the line {anchor!r}")
        s = s.replace(anchor, f"PROF({k});\n" + anchor)
    write = (f"  PROF({n - 1});\n  if (tid == 0)\n    for (int k = 0; k < {n}; ++k) "
             f"a.prof[{spec.get('cta', 'rank')} * {n} + k] = prof_s[k];\n")
    if "end" in spec:  # after the kernel's last line
        s = s.replace(end, end[:-1] + write + end[-1])
    else:  # before its closing cluster barrier
        s = s.replace(end, write + end)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}_sections.cu", OUT / f"lib{name}_sections.so"
    src.write_text(s)
    from kubernetes_tpu_torch.ops import kernels

    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kernels._nvcc(), *flags, "-o", str(lib), str(src)], check=True)
    return lib


UNITS = {"auction_phase": "cycles a round", "sinkhorn": "cycles an iteration",
         "waterfill": "cycles a call", "cover_curve": "cycles a call",
         "repair_check": "cycles a call", "rank_align": "cycles a call",
         "defrag_assign": "cycles a victim", "feasibility_rows": "cycles a call"}


def sections_line(name, label, prof, n_cta, per):
    import numpy as np

    names = KERNELS[name]["sections"]
    p = prof.view(-1, len(names)).cpu().numpy()[:n_cta].astype(np.float64)
    return {"kernel": name, "case": label, "unit": UNITS[name],
            "cta0": {nm: round(p[0, k] / per, 1) for k, nm in enumerate(names)},
            "max_over_ctas": {nm: round(p[:, k].max() / per, 1) for k, nm in enumerate(names)}}


def sections_c_g(which, dev):
    """Kernels C, G, I, J, D and H through their own wrappers, bound to the
    instrumented libraries (the args structs gain the trailing `prof`
    pointer)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import kubernetes_tpu_torch.testing as tt
    from kubernetes_tpu_torch.models import gangcover
    from kubernetes_tpu_torch.models.waterfill import bucket_j_max, make_groups, waterfill_group
    from kubernetes_tpu_torch.ops import kernels as K

    def bind(name, base, attr):
        n = len(KERNELS[name]["sections"])
        prof = torch.zeros(4096 * n, dtype=torch.int64, device=dev)

        class Args(base):
            _fields_ = [("prof", ctypes.c_void_p)]

            def __init__(self, **kw):
                super().__init__(**kw)
                self.prof = prof.data_ptr()

        setattr(K, attr, Args)
        lib_path = instrument(name)
        real = K._lib_path
        K._lib_path = lambda nm: lib_path if nm == name else real(nm)
        K._LIBS.pop(name, None)
        K._lib(name)
        K._lib_path = real
        return prof

    def run(fn, prof):
        for _ in range(3):  # the last of three back-to-back calls
            prof.zero_()
            fn()
            torch.cuda.synchronize()

    if "C" in which:
        prof = bind("waterfill", K._WaterfillArgs, "_WaterfillArgs")
        for case, group in (("a_scheduling_basic", 4096), ("b_global_sort", 10000)):
            inp, _, _, batch = cs.tensorize(cs.make_nodes(5000), cs.basic_pods(group, "ks"), dev)
            members, cls = make_groups(batch)[0]
            j_max = bucket_j_max(inp.max_pods, inp.pod_count, 5000, 2_600_000)
            args, kw = cs.group_call(inp, members, cls, j_max)
            run(lambda: waterfill_group(*args, **kw), prof)
            line = sections_line("waterfill", case, prof,
                                 K.LAST_WATERFILL_PLAN["cluster_size"], 1)
            line.update(nodes=5000, group=group, j_max=j_max, k_slots=kw["k_slots"])
            print(json.dumps(line), flush=True)
    if "G" in which:
        prof = bind("cover_curve", K._CoverCurveArgs, "_CoverCurveArgs")
        rng = np.random.default_rng(0)
        curve = cs.cover_case(rng, 250, 1000, 3, dev)
        run(lambda: gangcover.cover_curve(*curve), prof)
        print(json.dumps(sections_line("cover_curve", "a_full_width_slice", prof, 1, 1)),
              flush=True)
        req = np.array([3000, 0, 0])
        slices = [(rng.integers(-500, 4000, size=(250, 3)), rng.integers(0, 110, size=250),
                   rng.random(250) > 0.05, rng.integers(0, 250, size=1000),
                   rng.integers(0, 2000, size=(1000, 3))) for _ in range(20)]
        run(lambda: gangcover.cover_curves_batched(slices, req, device=dev), prof)
        print(json.dumps(sections_line("cover_curve", "attempt_20_slices", prof, 20, 1)),
              flush=True)
    if "I" in which:
        from kubernetes_tpu_torch.models import defrag as dfg

        prof = bind("defrag_assign", K._DefragArgs, "_DefragArgs")
        one = list(tt.defrag_request_runs(23, 5000, 250, max_run=1000, pads=0.0))
        one[3][:] = np.array([3000, 0, 0], np.int32)
        one[4][:250] = True
        for case, arrays, victims in (("one_request_250_victims", one, 250),
                                      ("b_cap_1024_victims", tt.defrag_problem(0, 5000, 1024),
                                       1024)):
            args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
            run(lambda: dfg.defrag_assign(*args), prof)
            line = sections_line("defrag_assign", case, prof, 1, victims)
            line.update(n_slots=args[0].shape[0], victims=victims, plan=K.LAST_DEFRAG_PLAN)
            print(json.dumps(line), flush=True)
    if "D" in which:
        from kubernetes_tpu_torch.models.repair import repair_check

        prof = bind("repair_check", K._RepairCheckArgs, "_RepairCheckArgs")
        rng = np.random.default_rng(0)
        for case, args, dm, ha, hc, _ in cs.d_timing_cases(5000, 4096, 4096, 50, 5000, dev, rng):
            run(lambda: repair_check(*args, d_max=dm, has_affinity=ha, has_ct=hc), prof)
            plan = K.LAST_REPAIR_PLAN
            line = sections_line("repair_check", case, prof, plan["cluster_size"], 1)
            line.update(nodes=5000, pb=int(args[0].numel()), d_max=dm, plan=plan)
            print(json.dumps(line), flush=True)
    if "H" in which:
        prof = bind("rank_align", K._RankAlignArgs, "_RankAlignArgs")
        rng = np.random.default_rng(1)
        for case, p, p_max, groups in (("p4096_16_gangs", 4096, 4096, 16),
                                       ("p2048_gang_2k_250", 2000, 2048, 8),
                                       ("p16384", 16284, 16384, 64)):
            args = cs.align_case(rng, p, p_max, groups, dev)
            run(lambda: gangcover.rank_align_kernel(*args), prof)
            line = sections_line("rank_align", case, prof,
                                 K.LAST_RANK_ALIGN_PLAN["cluster_size"], 1)
            line.update(p_max=p_max, plan=K.LAST_RANK_ALIGN_PLAN)
            print(json.dumps(line), flush=True)
    if "J" in which:
        from kubernetes_tpu_torch.ops.convert import solver_inputs_from_numpy
        from kubernetes_tpu_torch.ops.solver import feasibility_rows

        K._feas_launch.cache_clear()
        prof = bind("feasibility_rows", K._FeasRowsArgs, "_FeasRowsArgs")
        for rows in (1, 8, 512):
            f, _ = tt.scan_problem(rows, 5000, rows)
            f["class_ports"][:] = False  # as on the transport path
            inp = solver_inputs_from_numpy(f, dev)
            run(lambda: feasibility_rows(inp, inp.req, inp.req_nz, inp.class_of_pod,
                                         inp.balanced_active), prof)
            plan = K.LAST_FEASIBILITY_PLAN
            line = sections_line("feasibility_rows", f"{rows}_rows_x_5000_nodes", prof,
                                 plan["ctas"], 1)
            line.update(rows=rows, nodes=5000, plan=plan)
            print(json.dumps(line), flush=True)
        K._feas_launch.cache_clear()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="E,F",
                    help="any of E, F, C, G, I, J, D, H, comma-separated")
    which = set(ap.parse_args(argv).kernels.split(","))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_sections: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    sections_c_g(which, dev)
    if not which & {"E", "F"}:
        return 0
    sizes = {"nodes": 5000, "batch": 4096, "transport_pods": 50000,
             "mixed_transport_pods": 10000}
    wl = cs.transport_workloads(sizes)
    problems = {}
    for wname, label in (("Transport_50k", "transport_50k_batch"),
                         ("TransportMixed", "transport_mixed_batch")):
        nodes, pods = wl[wname]()
        problems[label] = cs.group_problem(nodes, pods[:sizes["batch"]], dev)[0]

    class AuArgs(K._AuctionArgs):
        _fields_ = [("prof", ctypes.c_void_p)]

    class SkArgs(K._SinkhornArgs):
        _fields_ = [("prof", ctypes.c_void_p)]

    def launch(lib, entry, args):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        launched = ctypes.c_int(0)
        for _ in range(3):  # the last of three back-to-back runs
            err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream,
                     ctypes.byref(launched))
            torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")

    lib = ctypes.CDLL(str(instrument("auction_phase")))
    lib.auction_phase_cluster_size.restype = ctypes.c_int
    for label, prob in problems.items() if "E" in which else ():
        args_t = cs.phase_args(prob)
        g, n = prob.utility.shape
        r = prob.req.shape[1]
        eps = (max(float(torch.where(prob.feasible, prob.utility, 0.0).max()) / 8.0, 0.9)
               if g == 1 else 0.9)
        plan, template, _ = K._auction_launch(g, n, r, lib.auction_phase_cluster_size())
        gscratch, xslots = K._cluster_scratch(plan, dev)
        outs = (torch.empty((g, n), dtype=torch.int32, device=dev), torch.empty(n, device=dev),
                torch.empty((g, n), device=dev), torch.empty(1, dtype=torch.int32, device=dev))
        prof = torch.zeros(16 * len(KERNELS["auction_phase"]["sections"]), dtype=torch.int64,
                           device=dev)
        a = AuArgs.from_buffer_copy(template + bytes(8))
        a.max_rounds, a.eps = 400, eps
        for f, t in zip(K._AU_PTRS, tuple(args_t) + outs + (gscratch, xslots)):
            setattr(a, f, t.data_ptr() if t is not None else None)
        a.prof = prof.data_ptr()
        launch(lib, "auction_phase_launch", a)
        rounds = int(outs[3])
        line = sections_line("auction_phase", label, prof, plan["cluster_size"], max(rounds, 1))
        line.update(G=g, N=n, rounds=rounds)
        print(json.dumps(line), flush=True)

    lib = ctypes.CDLL(str(instrument("sinkhorn")))
    lib.sinkhorn_cluster_size.restype = ctypes.c_int
    for label, prob in problems.items() if "F" in which else ():
        g, n = prob.utility.shape
        ins = (prob.utility, prob.feasible, prob.supply, ttr._effective_cap(prob).contiguous(),
               torch.zeros(g, device=dev), torch.zeros(n, device=dev))
        plan, template, _ = K._sinkhorn_launch(g, n, lib.sinkhorn_cluster_size())
        gscratch, xslots = K._cluster_scratch(plan, dev)
        outs = (torch.empty(g, device=dev), torch.empty(n, device=dev),
                torch.empty((g, n), device=dev))
        prof = torch.zeros(16 * len(KERNELS["sinkhorn"]["sections"]), dtype=torch.int64,
                           device=dev)
        a = SkArgs.from_buffer_copy(template + bytes(8))
        a.iters, a.eps = 60, 2.0
        for f, t in zip(K._SK_PTRS, ins + outs + (gscratch, xslots)):
            setattr(a, f, t.data_ptr() if t is not None else None)
        a.prof = prof.data_ptr()
        launch(lib, "sinkhorn_launch", a)
        line = sections_line("sinkhorn", label, prof, plan["cluster_size"], 60)
        line.update(G=g, N=n)
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
