#!/usr/bin/env python3
"""Kernels J (feasibility rows) and I (defrag assignment) on the card, for
one checkout of the PyTorch port, so that two checkouts can be compared in
one run.

    python3 tools/feasibility_defrag_ab.py [--root DIR] [--label NAME]
                                           [--defrag-npz PATH]

Builds the cases with this checkout's chip_smoke.py helpers and drives the
kubernetes_tpu_torch package found under --root (default: this checkout):
  J  one feasibility_rows call at chip_smoke's kernel_J cases a
     (TransportMixed's 8 group rows x 5,000 nodes) and d (Transport_50k's
     one row): wall ms (CUDA events over back-to-back calls, the wrapper's
     host work included), the device ms from a torch.profiler trace
     (chip_smoke.device_ms) and the wrapper's launches a call;
  I  one defrag_assign call at kernel_I cases a (the Defrag_5000 cycle's
     own tensors) and b (the 1,024-victim cap, tt.defrag_problem(0, 5,000,
     1,024)): the same numbers.
Case a of I is recorded once, by the first run that finds no --defrag-npz
file: the Defrag_5000 cluster under BatchScheduler(device="cuda",
solver="fast"), one rebalancer cycle, the first padded kernel I call saved.
Every later run, of either checkout, loads that file. Prints one JSON line
per case with the card's name and power limit. Needs a CUDA card.

To compare two checkouts in one call, run it in turns (parent, this, this,
parent), e.g. for the parent unpacked under build/archive/parent:
    for r in build/archive/parent . . build/archive/parent; do
        python3 tools/feasibility_defrag_ab.py --root $r --label $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def launches(fn, kernels, name):
    """The wrapper's launches in one call of fn."""
    before = kernels.LAUNCHES[name]
    fn()
    return kernels.LAUNCHES[name] - before


def record_defrag_cycle(cs, device, path: Path) -> None:
    """The first kernel I call of one Defrag_5000 rebalancer cycle, saved
    as numpy arrays (free, headroom, target_ok, v_req, v_valid)."""
    import numpy as np

    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    nodes, fillers, _ = cs.defrag_cluster({"nodes": 5000})
    store = APIStore()
    store.create_many("nodes", nodes)
    store.create_many("pods", fillers)
    sched = BatchScheduler(store, device=device.type, solver="fast")
    sched.sync()
    rb = sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=cs.DEFRAG_BUDGET_WAVE,
                                 budget_per_cycle=cs.DEFRAG_BUDGET_CYCLE, priority_ceiling=50)
    rec = cs.DefragInputs()
    with rec:
        rb.cycle()
    rb.release()
    sched.stop()
    if not rec.calls:
        raise RuntimeError("the Defrag_5000 cycle planned nothing")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, *[a.cpu().numpy() for a in rec.calls[0]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is driven")
    ap.add_argument("--label", default="")
    ap.add_argument("--defrag-npz", default=str(HERE / "build" / "archive" / "defrag_cycle.npz"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("feasibility_defrag_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import kubernetes_tpu_torch.testing as tt
    from kubernetes_tpu_torch.models import defrag as dfg
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.solver import feasibility_rows

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build(["feasibility_rows", "defrag_assign"])

    sizes = {"nodes": 5000, "transport_pods": 50000, "mixed_transport_pods": 10000}
    wl = cs.transport_workloads(sizes)
    for case, workload in (("a_transport_mixed_groups", "TransportMixed"),
                           ("d_transport_50k_row", "Transport_50k")):
        nodes, pods = wl[workload]()
        inp, _, _, groups, _ = cs.tensorize_groups(nodes, pods[:4096], device)
        reps = torch.tensor([int(m[0]) for m, _ in groups], device=device)
        call_args = (inp, inp.req[reps].contiguous(), inp.req_nz[reps].contiguous(),
                     inp.class_of_pod[reps].contiguous(), inp.balanced_active[reps].contiguous())

        def call():
            return feasibility_rows(*call_args)

        dev_ms = cs.device_ms(call, ("feasibility_rows",), device, iters=50, contains=True)
        print(json.dumps({"kernel": "J", "label": args.label, "case": case,
                          "rows": len(groups), "nodes": len(nodes),
                          "ms": cs.timed_ms(call, 200, device), "device_ms": dev_ms,
                          "launches_per_call": launches(call, kernels, "feasibility_rows"),
                          "card": card}), flush=True)

    npz = Path(args.defrag_npz)
    if not npz.exists():
        record_defrag_cycle(cs, device, npz)
    with np.load(npz) as z:
        cycle = [z[f"arr_{i}"] for i in range(5)]
    for case, arrays, iters in (("a_defrag_5000_cycle", cycle, 20),
                                ("b_cap_1024_victims", tt.defrag_problem(0, 5000, 1024), 10)):
        t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

        def assign():
            return dfg.defrag_assign(*t)

        dev_ms = cs.device_ms(assign, ("defrag_assign",), device, iters=iters, contains=True)
        out = assign().cpu().numpy()
        print(json.dumps({"kernel": "I", "label": args.label, "case": case,
                          "n_slots": int(t[0].shape[0]), "v_max": int(t[3].shape[0]),
                          "placed": int((out >= 0).sum()),
                          "targets_crc": int(np.frombuffer(out.tobytes(), np.uint8).sum()),
                          "ms": cs.timed_ms(assign, iters, device), "device_ms": dev_ms,
                          "launches_per_call": launches(assign, kernels, "defrag_assign"),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
