#!/usr/bin/env python3
"""Host milliseconds a pod of the PyTorch port's per-pod scheduling cycle
(the serial Scheduler with the default plugins, the route fallback-class
pods take on the batch path), for one checkout.

    python3 tools/serial_cycle_cost.py [--root DIR] [--nodes N] [--pods P]
                                       [--without-volume] [--profile K]

Builds N nodes of 8 cpu / 32Gi / 110 pods in 10 zones and P pending pods of
500m / 1Gi (scheduler_perf's SchedulingBasic shapes) for the
kubernetes_tpu_torch package found under --root (default: this checkout),
then schedules them one cycle at a time (Scheduler.schedule_one, every node
scored: percentage_of_nodes_to_score 100). --without-volume drops the
four volume plugins from the default list, so a checkout without them and
one with them run the same plugins. Prints one JSON line: the
seconds, ms a pod, and with --profile the K functions of the largest
cumulative time under cProfile (a second run). Runs on the host: the cycle
uses no kernel. Compare two checkouts in one invocation each, on the same
machine, one after the other.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


VOLUME_PLUGINS = ("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")


def run(n_nodes: int, n_pods: int, without_volume: bool):
    from kubernetes_tpu_torch.scheduler.plugins import default_plugins
    from kubernetes_tpu_torch.scheduler.runtime import Framework
    from kubernetes_tpu_torch.scheduler.serial import Scheduler
    from kubernetes_tpu_torch.store import APIStore
    from kubernetes_tpu_torch.testing import MakeNode, MakePod
    from kubernetes_tpu_torch.utils import FakeClock

    store = APIStore()
    store.create_many("nodes", [
        MakeNode(f"node-{i}").labels({"topology.kubernetes.io/zone": f"z{i % 10}"})
        .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj()
        for i in range(n_nodes)])
    plugins = [p for p in default_plugins()
               if not (without_volume and p.name in VOLUME_PLUGINS)]
    sched = Scheduler(store, Framework(plugins), clock=FakeClock(1000.0))
    sched.sync()
    store.create_many("pods", [MakePod(f"pod-{i}").req({"cpu": "500m", "memory": "1Gi"}).obj()
                               for i in range(n_pods)])
    sched.pump_events()
    t0 = time.perf_counter()
    while sched.schedule_one(timeout=0.0):
        pass
    seconds = time.perf_counter() - t0
    bound = sum(1 for p in store.list("pods")[0] if p.spec.node_name)
    return seconds, bound


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is driven")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=50)
    ap.add_argument("--without-volume", action="store_true",
                    help="leave the volume plugins out of the default list")
    ap.add_argument("--profile", type=int, default=0, help="top functions to report")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    seconds, bound = run(args.nodes, args.pods, args.without_volume)
    line = {"root": args.root, "nodes": args.nodes, "pods": args.pods, "bound": bound,
            "without_volume": args.without_volume,
            "seconds": seconds, "ms_per_pod": 1000 * seconds / args.pods}
    if args.profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        run(args.nodes, args.pods, args.without_volume)
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(args.profile)
        line["profile"] = [ln.strip() for ln in buf.getvalue().splitlines()
                           if ln.strip() and ln.strip()[0].isdigit()]
    print(json.dumps(line))
    return 0 if bound == args.pods else 1


if __name__ == "__main__":
    sys.exit(main())
