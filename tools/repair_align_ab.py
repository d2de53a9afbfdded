#!/usr/bin/env python3
"""Kernels D (repair check) and H (rank alignment) on the card, for one
checkout of the PyTorch port, so that two checkouts can be compared in one
run.

    python3 tools/repair_align_ab.py [--root DIR] [--label NAME]

Builds the cases with this checkout's chip_smoke.py helpers (seeded) and
drives the kubernetes_tpu_torch package found under --root (default: this
checkout):
  D  one repair_check call at chip_smoke's kernel_D_timing shapes
     (chip_smoke.d_timing_cases): TopologySpreading (5,000 nodes in 10
     zones, 4,096 placed pods, one spread row, has_ct), PodAntiAffinity
     (5,000 nodes, 50 groups of 40 pods, the hostname key, has_affinity) and
     PodAffinity (5,000 nodes in 50 zones, 4,096 pods affine to 50 bound
     seeds, has_affinity), each with its bound and the plan's mode;
  H  one rank_align_kernel call at p_max 4,096 (16 gangs of 256), 2,048
     (GangScheduling_2k_250's 8 gangs of 250) and 16,384;
  I  one defrag_assign call on the 1,024-victim cap (whether one profiler
     trace sees the kernel).
Per case: wall ms (CUDA events over back-to-back calls, the wrapper's host
work included), device ms (the summed kernel durations over the calls, as
the parent's kernels a call differ) and the device kernels a call, both
from one torch.profiler trace (chip_smoke.device_ms), the wrapper's
launches a call, and a checksum of the output (equal across checkouts).
Prints one JSON line per case with the card's name and power limit. Needs
a CUDA card.

To compare two checkouts in one call, run it in turns (parent, this, this,
parent), e.g. for the parent unpacked under build/archive/parent:
    for r in build/archive/parent . . build/archive/parent; do
        python3 tools/repair_align_ab.py --root $r --label $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is driven")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("repair_align_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import kubernetes_tpu_torch.testing as tt
    from kubernetes_tpu_torch.models import defrag as dfg
    from kubernetes_tpu_torch.models.gangcover import rank_align_kernel
    from kubernetes_tpu_torch.models.repair import repair_check
    from kubernetes_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build(["repair_check", "rank_align", "defrag_assign"])

    def emit(kernel, case, fn, name, prefixes, iters, **extra):
        out = fn()
        torch.cuda.synchronize()
        flat = torch.cat([o.reshape(-1).to(torch.int64) for o in
                          (out if isinstance(out, tuple) else (out,))]).cpu().numpy()
        before = kernels.LAUNCHES[name]
        fn()
        launches = kernels.LAUNCHES[name] - before
        dev_ms, per_call = cs.device_ms(fn, prefixes, device, iters=iters, with_count=True,
                                        per_call=None)
        print(json.dumps({"kernel": kernel, "label": args.label, "case": case,
                          "ms": cs.timed_ms(fn, iters, device), "device_ms": dev_ms,
                          "device_kernels_per_call": per_call,
                          "launches_per_call": launches,
                          "checksum": int((flat * (np.arange(flat.size) % 997 + 1)).sum()),
                          "card": card, **extra}), flush=True)

    rng = np.random.default_rng(0)
    for case, call_args, dm, ha, hc, _ in cs.d_timing_cases(5000, 4096, 4096, 50, 5000, device,
                                                             rng):
        def call(a=call_args, dm=dm, ha=ha, hc=hc):
            return repair_check(*a, d_max=dm, has_affinity=ha, has_ct=hc)

        call()
        nbytes, ops = cs.kernel_d_work(call_args, ha, hc)
        b_ms, b_by = cs.bound_ms(nbytes, ops)
        emit("D", case, call, "repair_check", ("rc_", "repair_check"), 50,
             pb=int(call_args[0].numel()), d_max=dm,
             mode=getattr(kernels, "LAST_REPAIR_PLAN", {}).get("mode"), bound_ms=b_ms,
             bound_by=b_by)

    rng = np.random.default_rng(1)
    for case, p, p_max, groups in (("p4096_16_gangs", 4096, 4096, 16),
                                   ("p2048_gang_2k_250", 2000, 2048, 8),
                                   ("p16384", 16284, 16384, 64)):
        h_args = cs.align_case(rng, p, p_max, groups, device)
        emit("H", case, lambda a=h_args: rank_align_kernel(*a), "rank_align",
             ("ra_", "rank_align"), 200, p_max=p_max)

    i_args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in tt.defrag_problem(0, 5000, 1024))
    emit("I", "b_cap_1024_victims", lambda: dfg.defrag_assign(*i_args), "defrag_assign",
         ("defrag_assign",), 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
