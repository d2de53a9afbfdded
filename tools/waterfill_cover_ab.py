#!/usr/bin/env python3
"""Kernels C (waterfill) and G (cover curve) on the card, for one checkout of
the PyTorch port, so that two checkouts can be compared in one run.

    python3 tools/waterfill_cover_ab.py [--root DIR] [--label NAME]

Builds the cases with this checkout's chip_smoke.py helpers and drives the
kubernetes_tpu_torch package found under --root (default: this checkout):
  C  one waterfill_group call at chip_smoke's kernel_C cases a
     (SchedulingBasic, 5,000 nodes, a 4,096-pod group) and b (a 10,000-pod
     group): wall ms (CUDA events over back-to-back calls, the wrapper's host
     work included), and from a torch.profiler trace the device ms and the
     device operations (kernels and memsets) a call;
  G  one cover_curve call at kernel_G case a (n_slots 256, k_max 1,024, R 3),
     and one cover attempt of GangPreemption_5000's shape (20 slices of 250
     nodes, up to 1,000 victims each) through the checkout's own route:
     cover_curves_batched where it has one, else one cover_curves call a
     slice.
Prints one JSON line per kernel with the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def profile(fn, prefixes, iters=20):
    """(device ms a call, device operations a call) of the kernels and
    memsets whose names hold one of `prefixes`, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, ops = 0.0, 0
    for ev in prof.key_averages():
        if any(p in ev.key for p in prefixes):
            us += getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
            ops += ev.count
    return us / iters / 1e3, ops / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is driven")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("waterfill_cover_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from kubernetes_tpu_torch.models import gangcover
    from kubernetes_tpu_torch.models.waterfill import bucket_j_max, make_groups, waterfill_group
    from kubernetes_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build(["waterfill", "cover_curve"])
    n = 5000
    c_prefixes = ("waterfill", "wf_", "Memset", "memset")
    for case, group in (("a_scheduling_basic", 4096), ("b_global_sort", 10000)):
        inp, _, _, batch = cs.tensorize(cs.make_nodes(n), cs.basic_pods(group, "ab"), device)
        members, cls = make_groups(batch)[0]
        j_max = bucket_j_max(inp.max_pods, inp.pod_count, n, 2_600_000)
        call_args, kw = cs.group_call(inp, members, cls, j_max)

        def call():
            return waterfill_group(*call_args, **kw)

        dev_ms, ops = profile(call, c_prefixes)
        print(json.dumps({"kernel": "C", "label": args.label, "case": case, "nodes": n,
                          "group": group, "j_max": j_max, "k_slots": kw["k_slots"],
                          "ms": cs.timed_ms(call, 20, device), "device_ms": dev_ms,
                          "device_ops_per_call": ops, "card": card}), flush=True)

    rng = np.random.default_rng(0)
    curve = cs.cover_case(rng, 250, 1000, 3, device)
    dev_ms, ops = profile(lambda: gangcover.cover_curve(*curve), ("cover_curve",))
    print(json.dumps({"kernel": "G", "label": args.label, "case": "a_full_width_slice",
                      "ms": cs.timed_ms(lambda: gangcover.cover_curve(*curve), 200, device),
                      "device_ms": dev_ms, "device_ops_per_call": ops, "card": card}),
          flush=True)
    req = np.array([3000, 0, 0])
    slices = [(rng.integers(-500, 4000, size=(250, 3)), rng.integers(0, 110, size=250),
               rng.random(250) > 0.05, rng.integers(0, 250, size=k),
               rng.integers(0, 2000, size=(k, 3)))
              for k in [1000 if i % 4 else int(rng.integers(0, 1000)) for i in range(20)]]
    batched = hasattr(gangcover, "cover_curves_batched")

    def attempt():
        if batched:
            return gangcover.cover_curves_batched(slices, req, device=device)
        return [gangcover.cover_curves(*x, req, device=device) for x in slices]

    dev_ms, ops = profile(attempt, ("cover_curve",), iters=10)
    print(json.dumps({"kernel": "G", "label": args.label, "case": "attempt_20_slices",
                      "route": "cover_curves_batched" if batched else "cover_curves a slice",
                      "ms": cs.timed_ms(attempt, 10, device), "device_ms": dev_ms,
                      "device_ops_per_attempt": ops, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
