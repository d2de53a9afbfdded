#!/usr/bin/env python3
"""What a CPU rerun running beside a card run costs that card run's clocks.

    python3 tools/rerun_contention.py [--legs beside,alone] [--phases controllers,transport]

chip_smoke.py runs the CPU reruns of main_path_controllers,
main_path_transport and main_path_preempt in spawned workers
(chip_smoke.rerun_pool: kept off two cores, their torch threads capped)
while the card runs are timed. This script times the card runs of the
first two both ways at the smoke's full sizes on one card: "beside" starts
the reruns with the card run, as the smoke does; "alone" starts them in the
same pool and waits for them to finish before the card run starts. Prints
one JSON line a leg: the controllers' step seconds and host split, or each
transport run's schedule seconds, pods/s and solve stage, beside the card's
name and power limit. Needs a CUDA card; run it from the repository root.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SIZES = {"nodes": 5000, "batch": 4096, "ctl_deployments": 10, "ctl_replicas": 100,
         "ctl_drain": 50, "transport_pods": 50000, "mixed_transport_pods": 10000,
         "transport_path_pods": {"Transport_50k": 12288, "TransportMixed": 5000}}


def controllers_leg(cs, device, leg):
    gc.collect()
    gc.freeze()
    try:
        with cs.rerun_pool(1) as pool:
            rerun = pool.apply_async(cs.ctl_run_cpu, (SIZES,))
            if leg == "alone":
                rerun.wait()
            t0 = time.perf_counter()
            run = cs.ctl_run(device, SIZES)
            card_s = time.perf_counter() - t0
            cpu = rerun.get(timeout=900)
    finally:
        gc.unfreeze()
        gc.collect()
    cs.check(cpu["map"] == cs.ctl_normalized_map(run["map"]) and cpu["rounds"] == run["rounds"],
             "controllers: the CPU rerun differs")
    return {"card_run_s": card_s,
            "steps_s": {k: v["seconds"] for k, v in run["steps"].items()},
            "host_s": run["host_s"], "rerun_steps_s": {k: v["seconds"]
                                                       for k, v in cpu["steps"].items()}}


def transport_leg(cs, device, leg, card):
    with cs.rerun_pool(2) as pool:
        reruns = {(name, solver): pool.apply_async(cs.transport_cpu_rerun,
                                                   (name, SIZES, solver))
                  for name in cs.transport_workloads(SIZES) for solver in ("auction", "sinkhorn")}
        if leg == "alone":
            for r in reruns.values():
                r.wait()
        t0 = time.perf_counter()
        out = cs.transport_runs(device, SIZES, card, reruns)
        card_s = time.perf_counter() - t0
    return {"card_runs_s": card_s,
            "runs": {k: {"schedule_s": v["schedule_s"], "pods_per_s": v["pods_per_s"],
                         "solve_s_per_batch": v["solve_s_per_batch"],
                         "partners_pods_per_s": {s: p["pods_per_s"]
                                                 for s, p in v["partners"].items()}}
                     for k, v in out.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default="beside,alone")
    ap.add_argument("--phases", default="controllers,transport")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("rerun_contention: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build()
    for phase in args.phases.split(","):
        for leg in args.legs.split(","):
            t0 = time.perf_counter()
            if phase == "controllers":
                res = controllers_leg(cs, device, leg)
            else:
                res = transport_leg(cs, device, leg, [card])
            print(json.dumps({"phase": phase, "leg": leg, **res,
                              "leg_s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
