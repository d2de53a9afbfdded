#!/usr/bin/env python3
"""Where a round of kernel E and an iteration of kernel F spend their cycles.

    python3 tools/kernel_sections.py

Writes copies of csrc/auction_phase.cu and csrc/sinkhorn.cu into
build/tools/ with a clock64 mark on thread 0 of every CTA at each section
boundary (the marks are inserted before fixed lines of the sources, so an
edit that moves one makes this script stop with the line it missed),
builds them with nvcc for sm_90a, runs them on the inputs chip_smoke.py
gives kernels E and F (the first Transport_50k batch and a TransportMixed
batch, at 5,000 nodes) and prints one JSON line per case: cycles a round
(E) or an iteration (F) per section, on CTA 0 and the most over the CTAs,
and the SM clock. A section's time on thread 0 includes its waits at CTA
barriers. Needs a CUDA card; the kernels themselves are untouched.
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
# goes before), where the timer starts, the args struct's last line)
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
}


def instrument(name: str) -> Path:
    spec = KERNELS[name]
    n = len(spec["sections"])
    s = (ROOT / "kubernetes_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    s = s.replace('#include "cluster_exchange.cuh"',
                  '#include "../../kubernetes_tpu_torch/csrc/cluster_exchange.cuh"\n' + MARK)
    for anchor in (spec["tail"], spec["start"], END):
        if s.count(anchor) != 1:
            sys.exit(f"kernel_sections: {name}.cu no longer has the line {anchor!r}")
    s = s.replace(spec["tail"], spec["tail"] + "  long long* prof;\n")
    s = s.replace(spec["start"], f"  long long prof_t = clock64(), prof_s[{n}] = {{0}};\n"
                  f"  int pk = {n - 1};\n" + spec["start"])
    for k, anchor in spec["marks"]:
        if s.count(anchor) != 1:
            sys.exit(f"kernel_sections: {name}.cu no longer has the line {anchor!r}")
        s = s.replace(anchor, f"PROF({k});\n" + anchor)
    s = s.replace(END, f"  PROF({n - 1});\n  if (tid == 0)\n    for (int k = 0; k < {n}; ++k) "
                  f"a.prof[rank * {n} + k] = prof_s[k];\n" + END)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}_sections.cu", OUT / f"lib{name}_sections.so"
    src.write_text(s)
    from kubernetes_tpu_torch.ops import kernels

    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kernels._nvcc(), *flags, "-o", str(lib), str(src)], check=True)
    return lib


def sections_line(name, label, prof, n_cta, per):
    import numpy as np

    names = KERNELS[name]["sections"]
    p = prof.view(16, len(names)).cpu().numpy()[:n_cta].astype(np.float64)
    return {"kernel": name, "case": label, "unit": "cycles a round" if name == "auction_phase"
            else "cycles an iteration",
            "cta0": {nm: round(p[0, k] / per, 1) for k, nm in enumerate(names)},
            "max_over_ctas": {nm: round(p[:, k].max() / per, 1) for k, nm in enumerate(names)}}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_sections: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.models import transport as ttr
    from kubernetes_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
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
    for label, prob in problems.items():
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
    for label, prob in problems.items():
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
