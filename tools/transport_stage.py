#!/usr/bin/env python3
"""The transport solve stage per batch on the card, split into the kernels'
device time and the rest, for one checkout of the PyTorch port.

    python3 tools/transport_stage.py [--root DIR] [--label NAME] [--repeat N]

Drives chip_smoke.py's four transport main paths (Transport_50k and
TransportMixed, solver="auction" and "sinkhorn", at scheduler_perf's 5,000
nodes and batch 4,096) with the kubernetes_tpu_torch package found under
--root (default: this checkout), so that two checkouts can be compared in
one run on one card. Prints one JSON line per run: pods/s, the solve stage
per batch (host clock) and, from CUDA events around each call of the E/F
and J launch wrappers, their time per batch and the rest of the stage. The
events bracket a wrapper's whole call on the stream, including any host
reads it makes between its own launches. Needs a CUDA card.
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
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("transport_stage: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import kubernetes_tpu_torch
    from kubernetes_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build(["feasibility_rows", "auction_phase", "sinkhorn"])
    sizes = {"nodes": 5000, "batch": 4096, "transport_pods": 50000,
             "mixed_transport_pods": 10000}
    for rep in range(args.repeat):
        for name, build in cs.transport_workloads(sizes).items():
            nodes, pods = build()
            for solver in ("auction", "sinkhorn"):
                with cs.KernelClock(device) as clock:
                    _, sched, got, launches, _, sched_s = cs.drive_main_path(
                        name, nodes, pods, device, sizes["batch"], solver=solver)
                bound = sum(1 for p in got if p.spec.node_name)
                print(json.dumps({
                    "label": args.label, "package": str(Path(kubernetes_tpu_torch.__file__).parent),
                    "repeat": rep, "workload": name, "solver": solver, "pods": len(pods),
                    "bound": bound, "pods_per_s": len(pods) / sched_s,
                    "solve_split": cs.solve_split(sched, clock.ms()),
                    "launches": launches,
                    "cuda_launches": dict(getattr(kernels, "CUDA_LAUNCHES", {})),
                    "host_syncs": dict(getattr(kernels, "HOST_SYNCS", {})),
                    "path": sched._solve_path, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
