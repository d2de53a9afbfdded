#!/usr/bin/env python3
"""What a CPU rerun running beside a card run costs that card run's clocks.

    python3 tools/rerun_contention.py [--legs beside,alone]
        [--phases controllers,transport,fast,gang_preempt,fallback,server]

chip_smoke.py runs the CPU reruns of main_path_fast, main_path_gang_preempt,
main_path_preempt, main_path_fallback, main_path_transport,
main_path_controllers, main_path_services and main_path_server in spawned
workers (chip_smoke.rerun_pool: kept off two cores, their torch threads
capped) while the card runs are timed. This script times the card runs of
the named phases both ways at the smoke's full sizes on one card: "beside"
starts the reruns with the card run, as the smoke does; "alone" starts them
in the same pool and waits for them to finish before the card run starts.
Prints one JSON line a leg: the phase's card-run seconds and its own clocks
(the controllers' and the server's step seconds, each transport or fast
run's schedule seconds and pods/s, the gang preemptions' and the fallback
cell's seconds to bound, the server's failover seconds), beside the card's
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

SIZES = {}  # chip_smoke.smoke_sizes(), filled in main()


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


def paired_leg(cs, leg, reruns, workers, card_runs):
    """Start `reruns` ([(fn, args)]) in a pool of `workers`; with leg
    "alone" wait for them before the card run; return the card run's
    seconds, its result and the reruns' results."""
    with cs.rerun_pool(workers) as pool:
        pending = [pool.apply_async(fn, args) for fn, args in reruns]
        if leg == "alone":
            for r in pending:
                r.wait()
        t0 = time.perf_counter()
        out = card_runs()
        card_s = time.perf_counter() - t0
        got = [r.get(timeout=900) for r in pending]
    return card_s, out, got


def fast_leg(cs, device, leg, card):
    names = list(cs.fast_workloads(SIZES))
    card_s, out, cpu = paired_leg(cs, leg, [(cs.fast_cpu_rerun, (n, SIZES)) for n in names], 2,
                                  lambda: cs.fast_card_runs(device, SIZES, card))
    for name, c in zip(names, cpu):
        cs.check(c["map"] == out[name]["_map"], f"fast {name}: the CPU rerun differs")
    return {"card_runs_s": card_s,
            "runs": {k: {"schedule_s": v["schedule_s"], "pods_per_s": v["pods_per_s"]}
                     for k, v in out.items()},
            "rerun_s": {n: c["seconds"] for n, c in zip(names, cpu)}}


def gang_preempt_leg(cs, device, leg, card):
    names = ("GangPreemption", "GangPreemption_5000")
    card_s, out, cpu = paired_leg(
        cs, leg, [(cs.gang_preempt_cpu_rerun, (n, SIZES)) for n in names], 2,
        lambda: cs.gang_preempt_card_runs(device, SIZES, card, names))
    for name, c in zip(names, cpu):
        cs.check(c["deleted"] == out[name]["_deleted"], f"{name}: the CPU rerun differs")
    return {"card_runs_s": card_s,
            "seconds_to_bound": {k: v["seconds_to_bound"] for k, v in out.items()},
            "rerun_s": {n: c["seconds"] for n, c in zip(names, cpu)}}


def fallback_leg(cs, device, leg):
    card_s, r, (c,) = paired_leg(
        cs, leg, [(cs.fallback_cpu_rerun, (SIZES,))], 1,
        lambda: cs.drive_fallback(cs.fallback_case(SIZES, 0), device, SIZES["batch"],
                                  trace_all=True))
    cs.check(c["placement"] == r["placement"], "fallback: the CPU rerun differs")
    return {"card_run_s": card_s, "seconds_to_bound": r["seconds"],
            "fallback_s": r["sched"].stage_seconds["fallback"], "rerun_s": c["seconds"]}


def server_leg(cs, device, leg):
    gc.collect()
    gc.freeze()
    try:
        card_s, run, (c,) = paired_leg(cs, leg, [(cs.server_cpu_rerun, (SIZES,))], 1,
                                       lambda: cs.server_run(device, SIZES))
    finally:
        gc.unfreeze()
        gc.collect()
    cs.check(c["bound"] == run["bound"], "server: the CPU rerun differs")
    return {"card_run_s": card_s, "steps_s": {k: v["seconds"] for k, v in run["steps"].items()},
            "failover": run["failover"], "node_not_ready_writes": run["node_not_ready_writes"],
            "heartbeat_late_s": run["heartbeat_late_s"],
            "rerun_steps_s": {k: v["seconds"] for k, v in c["steps"].items()}}


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

    SIZES.update(cs.smoke_sizes(False))

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
            elif phase == "transport":
                res = transport_leg(cs, device, leg, [card])
            elif phase == "fast":
                res = fast_leg(cs, device, leg, [card])
            elif phase == "gang_preempt":
                res = gang_preempt_leg(cs, device, leg, [card])
            elif phase == "fallback":
                res = fallback_leg(cs, device, leg)
            else:
                res = server_leg(cs, device, leg)
            print(json.dumps({"phase": phase, "leg": leg, **res,
                              "leg_s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
