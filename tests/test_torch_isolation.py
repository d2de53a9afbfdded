"""The port stands alone: it imports neither jax nor the JAX package.

A subprocess runs one batch through the port on the CPU (exact, fast and
auction), one auction batch with its warm duals, and one gang through the
victim cover and rank alignment, and reports what
it imported; another preempts through the serial scheduler and the batch
scheduler, both built from a configuration; another consolidates a fragmented cluster with the rebalancer
(kernel I's plain version) under an armed fault injector and trace buffer;
another runs a batch of device pods and every fallback class (volumes, DRA,
spread inclusion policies) through the per-pod route; another drives the
full store (columnar rows, the mutation detector, bounded history, watch
telemetry, an armed watch.deliver site); another runs the host commit
(columnar cache rows, the g++ engines, pipelined binds under armed bind
faults) and solver="native"; another drives the partitioned scheduler and
the multi-process one (spawned workers over shared columns), and a fresh
interpreter imports what a worker imports without torch; another drives a
Deployment and a DaemonSet through the workload controllers; another
imports every controller and the service, CRD, certificate, flow-control
and serializer modules and drives a namespace's service account, quota and
endpoint slice; another imports every module of the server slice and
drives the API server, a leading control plane and an informer; a static pass
over every module of kubernetes_tpu_torch and chip_smoke.py finds no such
import; and the entry points default to the
card, raising where none is present (decided inside each test).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kubernetes_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")

_ONE_BATCH = r"""
import json, sys
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod

bound = {}
for solver in ("exact", "fast", "auction"):
    store = APIStore()
    for i in range(4):
        store.create("nodes", MakeNode(f"n{i}").labels({"topology.kubernetes.io/zone": f"z{i % 2}"})
                     .capacity({"cpu": "4", "memory": "8Gi"}).obj())
    for i in range(6):
        store.create("pods", MakePod(f"p{i}").labels({"app": "a"}).req({"cpu": "500m"})
                     .topology_spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                                      {"app": "a"})
                     .pod_anti_affinity("kubernetes.io/hostname", {"app": "b"}).obj())
    for i in range(3):
        store.create("pods", MakePod(f"free{i}").req({"cpu": "250m"}).obj())
    sched = BatchScheduler(store, device="cpu", solver=solver, batch_size=6)
    sched.sync()
    sched.run_until_idle()
    pods, _ = store.list("pods")
    bound[solver] = sum(1 for p in pods if p.spec.node_name)
    if solver == "fast":
        bound["repair_batches"] = sched.repair_totals["batches"]
        bound["last_path"] = sched._solve_path

# one constraint-free batch through the auction (kernels J and E's plain
# versions) with its warm duals
store = APIStore()
for i in range(4):
    store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"}).obj())
for i in range(10):
    store.create("pods", MakePod(f"t{i}").req({"cpu": "500m", "memory": "1Gi"}).obj())
sched = BatchScheduler(store, device="cpu", solver="auction")
sched.sync()
sched.run_until_idle()
pods, _ = store.list("pods")
bound["auction_batch"] = sum(1 for p in pods if p.spec.node_name)
bound["auction_path"] = sched._solve_path
bound["auction_duals"] = len(sched.transport_state.price)

# a gang that fits one slice only after evicting lower-priority fillers:
# the cover (kernel G's plain version), eviction, parking, release and the
# rank alignment (kernel H's plain version)
from kubernetes_tpu_torch.api.policy import PodDisruptionBudget
from kubernetes_tpu_torch.testing import make_pod_group
store = APIStore()
for s in range(2):
    for i in range(4):
        store.create("nodes", MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                     .capacity({"cpu": "8", "memory": "32Gi"}).obj())
        store.create("pods", MakePod(f"low-{s}-{i}").priority(1).req({"cpu": "6"})
                     .node(f"node-{s}-{i}").obj())
sched = BatchScheduler(store, device="cpu", solver="fast")
sched.preemption.async_preparation = False
sched.sync()
store.create("podgroups", make_pod_group("train", 8))
store.create_many("pods", [MakePod(f"g-{i}").gang("train", rank=i).priority(100)
                           .req({"cpu": "3"}).obj() for i in range(8)])
for _ in range(5):
    sched.run_until_idle()
pods, _ = store.list("pods")
bound["gang"] = sum(1 for p in pods if p.metadata.name.startswith("g-") and p.spec.node_name)
bound["victims"] = sched.gangpreempt.stats()["victims"]
print(json.dumps({"bound": bound,
                  "loaded": sorted(m for m in sys.modules
                                   if m.startswith(("kubernetes_tpu_torch.models",
                                                    "kubernetes_tpu_torch.api",
                                                    "kubernetes_tpu_torch.scheduler"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_one_batch_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _ONE_BATCH], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # fast mode: the constrained batch rode repair, the constraint-free one waterfill
    assert got["bound"] == {"exact": 9, "fast": 9, "repair_batches": 1, "last_path": "fast",
                            "auction": 9, "auction_batch": 10, "auction_path": "auction",
                            "auction_duals": 4, "gang": 8, "victims": 4}
    assert {"kubernetes_tpu_torch.models.repair", "kubernetes_tpu_torch.models.waterfill",
            "kubernetes_tpu_torch.models.transport",
            "kubernetes_tpu_torch.models.gangcover", "kubernetes_tpu_torch.scheduler.gang",
            "kubernetes_tpu_torch.scheduler.gangpreempt",
            "kubernetes_tpu_torch.scheduler.plugins.default_preemption",
            "kubernetes_tpu_torch.api.podgroup", "kubernetes_tpu_torch.api.events",
            "kubernetes_tpu_torch.api.policy"} <= set(got["loaded"])
    assert got["modules"] == []


_REBALANCE = r"""
import json, sys
import kubernetes_tpu_torch.chaos.faultinject as fi
import kubernetes_tpu_torch.obs.tracebuf as tb
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod

store = APIStore()
for s in range(2):
    for i in range(4):
        store.create("nodes", MakeNode(f"node-{s}-{i}").tpu_slice(s, index=i)
                     .capacity({"cpu": "8", "memory": "32Gi", "pods": "110"}).obj())
        store.create("pods", MakePod(f"low-{s}-{i}").priority(1).req({"cpu": "3"})
                     .node(f"node-{s}-{i}").obj())
sched = BatchScheduler(store, device="cpu", solver="fast")
sched.sync()
rb = sched.enable_rebalancer(frag_threshold=0.25, budget_per_wave=2, budget_per_cycle=8,
                             priority_ceiling=50)
buf = tb.arm()
fi.arm([fi.FaultPlan("rebalance.cycle", "fail", count=1, match="wave-1")])
first = rb.cycle()
fi.disarm()
sched.run_until_idle()
print(json.dumps({"first": first["migrations"], "stats": sched.rebalance_stats()["migrations"],
                  "events": buf.status()["trace_events_total"],
                  "loaded": sorted(m for m in sys.modules if m.startswith((
                      "kubernetes_tpu_torch.chaos", "kubernetes_tpu_torch.obs",
                      "kubernetes_tpu_torch.models", "kubernetes_tpu_torch.scheduler"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_rebalancer_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _REBALANCE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the wave-1 fault stops the first cycle after one wave; the idle path
    # then moves the other two fillers
    assert (got["first"], got["stats"]) == (2, 4) and got["events"] >= 4
    assert {"kubernetes_tpu_torch.chaos.faultinject", "kubernetes_tpu_torch.obs.tracebuf",
            "kubernetes_tpu_torch.models.defrag",
            "kubernetes_tpu_torch.scheduler.rebalance"} <= set(got["loaded"])
    assert got["modules"] == []


_SERIAL_SLICE = r"""
import json, sys
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.scheduler.serial import Scheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod
from kubernetes_tpu_torch.utils import FakeClock

out = {}
for kind in ("serial", "auto"):
    store, clock = APIStore(), FakeClock()
    for i in range(3):
        store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "2", "pods": "10"}).obj())
        store.create("pods", MakePod(f"low{i}").priority(1).req({"cpu": "2"}).node(f"n{i}").obj())
    cfg = {"profiles": [{"schedulerName": "default-scheduler"}]}
    if kind == "serial":
        sched = Scheduler.from_config(store, cfg, clock=clock)
    else:
        sched = BatchScheduler.from_config(store, cfg, clock=clock, device="cpu", solver=kind)
    sched.framework.post_filter_plugins[0].async_preparation = False
    sched.sync()
    for i in range(2):
        store.create("pods", MakePod(f"high{i}").priority(100).req({"cpu": "2"}).obj())
    for _ in range(3):
        sched.run_until_idle()
        clock.step(11.0)
        sched.queue.flush_backoff_completed()
    pods, _ = store.list("pods")
    out[kind] = [sum(1 for p in pods if p.metadata.name.startswith("high") and p.spec.node_name),
                 sched.preemption_count]
print(json.dumps({"out": out,
                  "loaded": sorted(m for m in sys.modules
                                   if m.startswith(("kubernetes_tpu_torch.scheduler",
                                                    "kubernetes_tpu_torch.utils"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_serial_framework_and_preemption_import_no_jax_and_no_jax_package():
    """The serial scheduler, from_config profiles, the default plugins,
    QueueingHints and per-pod preemption (serial PostFilter and the batch
    path's tiered preemption) load neither jax nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _SERIAL_SLICE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["out"] == {"serial": [2, 2], "auto": [2, 2]}
    mods = {"kubernetes_tpu_torch.scheduler." + m for m in (
        "config", "runtime", "serial", "framework", "queue", "plugins.fit",
        "plugins.node_plugins", "plugins.topology_spread", "plugins.interpod_affinity",
        "plugins.default_preemption", "plugins.helpers")}
    assert mods | {"kubernetes_tpu_torch.utils.featuregate"} <= set(got["loaded"])
    assert got["modules"] == []


_FALLBACK_BATCH = r"""
import json, sys
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import fallback_workload
from kubernetes_tpu_torch.utils.featuregate import feature_gates

feature_gates.set("DynamicResourceAllocation", True)
w = fallback_workload(0, 20, 20, zones=4, tainted=2, slice_every=4, devices_per_slice=2,
                      prebound=2, provision=2, static=1, dra_one=2, dra_two=1, spread=2,
                      ephemeral=1, shared_disk=1)
store = APIStore()
for kind in ("nodes", "csinodes", "storageclasses", "persistentvolumes",
             "persistentvolumeclaims", "deviceclasses", "resourceslices", "resourceclaims"):
    store.create_many(kind, w[kind])
sched = BatchScheduler(store, device="cpu", solver="auto")
sched.sync()
store.create_many("pods", w["pods"])
sched.run_until_idle()
pods, _ = store.list("pods")
claims, _ = store.list("resourceclaims")
print(json.dumps({"bound": sum(1 for p in pods if p.spec.node_name), "pods": len(pods),
                  "fallback": [sched.fallback_pods, sched.serial_scheduled],
                  "allocated": sum(1 for c in claims if c.allocation is not None),
                  "loaded": sorted(m for m in sys.modules
                                   if m.startswith(("kubernetes_tpu_torch.scheduler",
                                                    "kubernetes_tpu_torch.api"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_fallback_batch_imports_no_jax_and_no_jax_package():
    """A batch of device pods and every fallback class through the per-pod
    route (the volume plugins, DynamicResources, the storage and DRA store
    kinds) loads neither jax nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _FALLBACK_BATCH], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bound"] == got["pods"] == 33
    assert got["fallback"] == [13, 13] and got["allocated"] == 3
    assert {"kubernetes_tpu_torch.scheduler.plugins.volume",
            "kubernetes_tpu_torch.scheduler.plugins.dynamic_resources",
            "kubernetes_tpu_torch.api.storage",
            "kubernetes_tpu_torch.api.dra"} <= set(got["loaded"])
    assert got["modules"] == []


_FULL_STORE = r"""
import json, sys
import kubernetes_tpu_torch.chaos.faultinject as fi
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod, assert_pod_conservation

out = {}
for columnar in (True, False):
    store = APIStore(columnar=columnar, mutation_detector=True, history_limit=64)
    per = store.watch("pods", maxsize=0)
    coal = store.watch("pods", maxsize=0, coalesce=True)
    for i in range(4):
        store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj())
    sched = BatchScheduler(store, device="cpu", solver="exact")
    sched.sync()
    pods = [MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(40)]
    fi.arm([fi.FaultPlan("watch.deliver", "fail", count=1, match="pods")])
    store.create_many("pods", pods)
    fi.disarm()
    sched.resync_from_store()
    sched.run_until_idle()
    assert_pod_conservation(store, sched, [p.key for p in pods])
    store.check_mutations()
    per.drain(), coal.drain()
    tel = store.watch_telemetry()
    out[str(columnar)] = {"bound": sum(1 for p in store.list("pods")[0] if p.spec.node_name),
                          "columnar": store.columnar,
                          "rows": (store.columnar_stats() or {}).get("rows"),
                          "dropped": tel["dropped"], "floor": store._history_floor_rv > 0}
print(json.dumps({"out": out,
                  "loaded": sorted(m for m in sys.modules
                                   if m.startswith(("kubernetes_tpu_torch.store",
                                                    "kubernetes_tpu_torch.server"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_full_store_imports_no_jax_and_no_jax_package():
    """The full store (columnar rows, the mutation detector, a bounded
    history, watch telemetry into the store's metric series, an armed
    watch.deliver site) under the batch scheduler, columnar and dict, loads
    neither jax nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _FULL_STORE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["out"]["True"] == {"bound": 40, "columnar": True, "rows": 40,
                                  "dropped": {"chaos": 1}, "floor": True}
    assert got["out"]["False"] == {"bound": 40, "columnar": False, "rows": None,
                                   "dropped": {"chaos": 1}, "floor": True}
    assert {"kubernetes_tpu_torch.store.store", "kubernetes_tpu_torch.store.columnar",
            "kubernetes_tpu_torch.server.metrics"} <= set(got["loaded"])
    assert got["modules"] == []


_COMMIT = r"""
import json, sys
import kubernetes_tpu_torch.chaos.faultinject as fi
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod, assert_pod_conservation

out = {}
for solver in ("exact", "native"):
    store = APIStore()
    for i in range(4):
        store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj())
    sched = BatchScheduler(store, device="cpu", solver=solver, bind_retry_base_s=0.001)
    sched.sync()
    pods = [MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(40)]
    fi.arm([fi.FaultPlan("store.bind_many", "fail", count=2),
            fi.FaultPlan("native.commit", "fail", count=1)])
    store.create_many("pods", pods)
    sched.run_until_idle()
    fi.disarm()
    rows = sched.cache.columnar_rows()
    assert_pod_conservation(store, sched, [p.key for p in pods])
    out[solver] = {"bound": sum(1 for p in store.list("pods")[0] if p.spec.node_name),
                   "rows": rows, "path": sched._solve_path,
                   "retries": sched.retry_counts["bind"],
                   "assumed": sched.cache.assumed_count()}
    sched.stop()
print(json.dumps({"out": out,
                  "loaded": sorted(m for m in sys.modules
                                   if m.startswith(("kubernetes_tpu_torch.native",
                                                    "kubernetes_tpu_torch.scheduler.cachecols"))),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_commit_pipeline_imports_no_jax_and_no_jax_package():
    """The host commit (columnar cache rows, the g++ engines, pipelined binds
    with an armed store.bind_many and native.commit site) and
    solver="native" load the native modules and scheduler/cachecols, and
    neither jax nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", _COMMIT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for solver in ("exact", "native"):
        assert got["out"][solver] == {"bound": 40, "rows": 40, "path": solver,
                                      "retries": 3, "assumed": 0}
    assert {"kubernetes_tpu_torch.native", "kubernetes_tpu_torch.native.hostcommit",
            "kubernetes_tpu_torch.native.hostsched",
            "kubernetes_tpu_torch.scheduler.cachecols"} <= set(got["loaded"])
    assert got["modules"] == []


_OBS = r"""
import json, sys
import kubernetes_tpu_torch.obs as obs
import kubernetes_tpu_torch.obs.critpath as critpath
import kubernetes_tpu_torch.obs.reconcile as reconcile
import kubernetes_tpu_torch.obs.resource as resource
import kubernetes_tpu_torch.obs.timeseries as timeseries
import kubernetes_tpu_torch.obs.tracebuf as tracebuf
import kubernetes_tpu_torch.scheduler.debugger as debugger
import kubernetes_tpu_torch.scheduler.flightrec as flightrec
import kubernetes_tpu_torch.scheduler.podtrace as podtrace
import kubernetes_tpu_torch.scheduler.slo as slo
import kubernetes_tpu_torch.utils.tracing as tracing
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod

buf = tracebuf.arm()
store = APIStore()
for i in range(4):
    store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj())
sched = BatchScheduler(store, device="cpu", solver="fast")
sched.attach_resource_sampler(obs.ResourceSampler(interval_s=0.05))
sched.sync()
store.create_many("pods", [MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(40)])
sched.run_until_idle()
stats = sched.sched_stats()
tracebuf.disarm()
spans = sched.podtrace.snapshot()["spans"]
doc = buf.export(spans=spans)
crit = critpath.analyze(spans, stage_table=sched.flightrec.stage_table())
sched.stop()
print(json.dumps({
    "recorder": stats["recorder"]["enabled"], "records": stats["recorder"]["records"],
    "scheduled": stats["scheduled"], "latency": stats["latency"]["count"],
    "valid": tracebuf.validate_export(doc)["valid"], "spans": crit["spans_analyzed"],
    "slo": slo.evaluate_slo(stats, slo.NORTH_STAR_SLO)["pass"],
    "dump": sorted(debugger.dump(sched)["nodes"]),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_observability_imports_no_jax_and_no_jax_package():
    """Every observability module, a BatchScheduler on the CPU with the
    recorder on (the default), an armed trace ring and sched_stats(): the
    recorder records, the export validates, and neither jax nor the JAX
    package is loaded."""
    out = subprocess.run([sys.executable, "-c", _OBS], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["recorder"] is True and got["records"] >= 1
    assert got["scheduled"] == got["latency"] == got["spans"] == 40
    assert got["valid"] is True and got["slo"] is True
    assert got["dump"] == ["n0", "n1", "n2", "n3"]
    assert got["modules"] == []


_PARTITION = r"""
import json, os, sys
from kubernetes_tpu_torch.scheduler.mpsched import MPScheduler
from kubernetes_tpu_torch.scheduler.partition import PartitionedScheduler
from kubernetes_tpu_torch.store import APIStore, shm
from kubernetes_tpu_torch.store.lockgraph import WITNESS
from kubernetes_tpu_torch.testing import MakeNode, MakePod, pod_conservation_report

out = {}
for name in ("partition", "mp"):
    store = APIStore(lock_order_check=True)
    for i in range(8):
        store.create("nodes", MakeNode(f"n{i}").labels(
            {"kubernetes.io/hostname": f"n{i}", "topology.kubernetes.io/zone": f"z{i % 2}"})
            .capacity({"cpu": "8", "memory": "16Gi"}).obj())
    if name == "partition":
        sched = PartitionedScheduler(store, lambda: None, partitions=2, device="cpu",
                                     solver="fast")
    else:
        sched = MPScheduler(store, processes=2, device="cpu", solver="fast")
    sched.sync()
    pods = [MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(40)]
    pods.append(MakePod("s0").labels({"app": "s"}).req({"cpu": "100m"}).topology_spread(
        1, "topology.kubernetes.io/zone", "DoNotSchedule", {"app": "s"}).obj())
    keys = [p.key for p in pods]
    store.create_many("pods", pods)
    sched.run_until_idle()
    sched.flush_binds()
    rep = pod_conservation_report(store, sched, keys)["counts"]
    st = sched.sched_stats()
    out[name] = {"bound": rep["bound"], "lost": rep["lost"], "double": rep["double_bound"],
                 "mode": getattr(sched, "mode", None),
                 "residual": (st["residual"]["scheduled"] if name == "partition"
                              else st["processes"]["residual"]["scheduled"])}
    sched.stop()
mine = f"{shm.NAME_PREFIX}-{os.getpid()}-"  # this process's arenas only
print(json.dumps({"out": out, "leaked": [s for s in shm.leaked_segments() if s.startswith(mine)],
                  "witness_clean": WITNESS.diff()["clean"],
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_partitioned_and_multiprocess_import_no_jax_and_no_jax_package():
    """A PartitionedScheduler (two shards and the residual pass) and an
    MPScheduler (two spawned worker processes over shared columns and its
    residual pipeline) on the CPU: every pod bound once, no segment left,
    the port's lock witness clean, and neither jax nor the JAX package
    loaded."""
    out = subprocess.run([sys.executable, "-c", _PARTITION], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["out"]["partition"] == {"bound": 41, "lost": 0, "double": 0, "mode": None,
                                       "residual": 1}
    assert got["out"]["mp"] == {"bound": 41, "lost": 0, "double": 0, "mode": "mp",
                                "residual": 1}
    assert got["leaked"] == [] and got["witness_clean"] is True
    assert got["modules"] == []


_CONTROLLERS = r"""
import json, sys
import kubernetes_tpu_torch.api.serialize as serialize
import kubernetes_tpu_torch.api.workloads as workloads
import kubernetes_tpu_torch.controllers as controllers
from kubernetes_tpu_torch.controllers.revision import template_fingerprint
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, run_bound_pods
from kubernetes_tpu_torch.utils.cron import CronSchedule

store = APIStore()
for i in range(4):
    store.create("nodes", MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi",
                                                       "pods": "110"}).obj())
sched = BatchScheduler(store, device="cpu", solver="auto")
sched.sync()
ctls = [controllers.DeploymentController(store), controllers.ReplicaSetController(store),
        controllers.DaemonSetController(store), controllers.GarbageCollector(store)]
for c in ctls:
    c.sync_all()
tpl = {"metadata": {"labels": {"app": "web"}},
       "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}
store.create("deployments", serialize.from_dict("deployments", {
    "metadata": {"name": "web"},
    "spec": {"replicas": 6, "selector": {"matchLabels": {"app": "web"}}, "template": tpl}}))
store.create("daemonsets", workloads.DaemonSet.from_dict({
    "metadata": {"name": "agent"},
    "spec": {"selector": {"matchLabels": {"app": "agent"}},
             "template": {"metadata": {"labels": {"app": "agent"}},
                          "spec": {"containers": [{"name": "a"}]}}}}))
for _ in range(6):
    for c in ctls:
        c.reconcile_once()
    sched.run_until_idle()
    run_bound_pods(store)
pods, _ = store.list("pods")
dep = store.get("deployments", "default/web")
print(json.dumps({
    "pods": len(pods), "running": sum(p.status.phase == "Running" for p in pods),
    "ready": dep.status.ready_replicas,
    "kind": serialize.to_dict(dep)["kind"],
    "hash": len(template_fingerprint(dep.spec.template)),
    "cron": CronSchedule("*/5 * * * *").next_after(0.0) > 0,
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_controllers_import_no_jax_and_no_jax_package():
    """The workload control loop (the controllers, the workload kinds, the
    serializer and the cron parser) drives a Deployment and a DaemonSet
    through a BatchScheduler on the CPU to Running pods, and neither jax nor
    the JAX package is loaded."""
    out = subprocess.run([sys.executable, "-c", _CONTROLLERS], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["pods"] == got["running"] == 10 and got["ready"] == 6
    assert got["kind"] == "Deployment" and got["hash"] == 10 and got["cron"] is True
    assert got["modules"] == []


_SERVICES = r"""
import json, sys
from kubernetes_tpu_torch import controllers
from kubernetes_tpu_torch.api import certificates, crd, flowcontrolapi, networking, serialize
from kubernetes_tpu_torch.api.policy import ResourceQuota
from kubernetes_tpu_torch.api.types import Namespace, ObjectMeta
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakePod
from kubernetes_tpu_torch.utils import FakeClock

store = APIStore()
clock = FakeClock(0.0)
ctls = [controllers.ServiceAccountController(store, clock=clock),
        controllers.ResourceQuotaController(store, clock=clock),
        controllers.EndpointSliceController(store, clock=clock)]
for c in ctls:
    c.sync_all()
store.create("namespaces", Namespace(metadata=ObjectMeta(name="team-a")))
store.create("resourcequotas", ResourceQuota.from_dict({
    "metadata": {"name": "q", "namespace": "team-a"}, "spec": {"hard": {"pods": "5"}}}))
store.create("services", networking.Service.from_dict({
    "metadata": {"name": "web", "namespace": "team-a"},
    "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}}))
for i in range(3):
    store.create("pods", MakePod(f"w{i}", namespace="team-a").labels({"app": "web"})
                 .node("n1").obj())
for c in ctls:
    c.run_until_stable()
print(json.dumps({
    "exports": sorted(n for n in dir(controllers) if n.endswith(("Controller", "Binder",
                                                                 "Collector"))),
    "sa": store.get("serviceaccounts", "team-a/default").metadata.name,
    "used": store.get("resourcequotas", "team-a/q").used,
    "endpoints": len(store.get("endpointslices", "team-a/web-0").endpoints),
    "kinds": len(serialize.RESOURCE_TO_TYPE),
    "csr": certificates.CertificateSigningRequest.kind, "crd": crd.DynamicRegistry.RESOURCE,
    "flow": flowcontrolapi.FlowSchemaConfiguration.kind,
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_services_and_every_controller_import_no_jax_and_no_jax_package():
    """Every controller of the package and the service, CRD, certificate,
    flow-control and serializer modules, driving a namespace's default
    service account, quota usage and endpoint slice: neither jax nor the
    JAX package is loaded."""
    out = subprocess.run([sys.executable, "-c", _SERVICES], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["exports"]) == 26 and "APIServiceAvailabilityController" in got["exports"]
    assert got["sa"] == "default" and got["used"] == {"pods": "3"} and got["endpoints"] == 3
    assert got["kinds"] == 46 and got["csr"] == "CertificateSigningRequest"
    assert got["crd"] == "customresourcedefinitions" and got["flow"] == "FlowSchema"
    assert got["modules"] == []

_SERVER = r"""
import importlib, json, sys, time
NEW = ["server.admission", "server.admissionpolicy", "server.audit", "server.auth",
       "server.celexpr", "server.client", "server.controlplane", "server.fieldmanager",
       "server.flowcontrol", "server.ipalloc", "server.podsecurity", "server.rest",
       "server.watchmux", "utils.leaderelection", "utils.leakcheck"]
mods = [importlib.import_module("kubernetes_tpu_torch." + m) for m in NEW]
from kubernetes_tpu_torch.api.workloads import Lease
from kubernetes_tpu_torch.server import APIServer, Informer, RESTClient
from kubernetes_tpu_torch.server.controlplane import ControlPlane
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, renew_node_leases
from kubernetes_tpu_torch.utils.leakcheck import assert_no_thread_leaks

with assert_no_thread_leaks(grace=5.0):
    store = APIStore()
    for i in range(2):
        store.create("nodes", MakeNode(f"n{i}").capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "20"}).obj())
    renew_node_leases(store, Lease, ["n0", "n1"], time.monotonic())
    srv = APIServer(store, flowcontrol="default", audit="default").start()
    cp = ControlPlane(store, "cp-0", device="cpu", lease_duration=1.0, renew_deadline=0.8,
                      retry_period=0.05).start()
    c = RESTClient(srv.url, timeout=10)
    inf = Informer(c, "pods").start()
    c.create("pods", {"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}})
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not (
            "default/p" in inf.cache and inf.cache["default/p"].spec.node_name):
        time.sleep(0.05)
    node = inf.cache["default/p"].spec.node_name
    stats = json.loads(c.request_text("/debug/schedstats"))
    inf.stop(); cp.stop(); srv.stop()
print(json.dumps({"imported": len(mods), "node": node, "pipelines": len(stats),
                  "modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu"))}))
"""


def test_server_and_control_plane_import_no_jax_and_no_jax_package():
    """Every module of the server slice, driving an APIServer, a leading
    ControlPlane on the CPU and an Informer over one pod: neither jax nor
    the JAX package is loaded, and every thread stops."""
    out = subprocess.run([sys.executable, "-c", _SERVER], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["imported"] == 15 and got["node"] in ("n0", "n1") and got["pipelines"] == 1
    assert got["modules"] == []


def test_worker_modules_import_no_torch():
    """What a spawned worker process imports (scheduler/mpworker.py and
    store/shm.py, through the package inits and the store) loads neither
    torch nor jax nor the JAX package: a worker holds no CUDA context."""
    code = ("import json, sys\n"
            "import kubernetes_tpu_torch.scheduler.mpworker\n"
            "import kubernetes_tpu_torch.store.shm\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'kubernetes_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_static_import_of_jax_or_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.name} imports {bad}"


def test_batch_scheduler_defaults_to_the_card():
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore

    if torch.cuda.is_available():
        assert BatchScheduler(APIStore()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            BatchScheduler(APIStore(), None)


def test_solver_wrappers_raise_for_other_devices():
    from kubernetes_tpu_torch.ops.solver import resolve_device
    from kubernetes_tpu_torch.snapshot.tensorizer import scatter_rows

    with pytest.raises(ValueError, match="device"):
        resolve_device("meta")
    meta = torch.empty((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        scatter_rows(meta, torch.empty(1, dtype=torch.int32, device="meta"),
                     torch.empty((1, 2), dtype=torch.int32, device="meta"))


def test_gang_kernel_wrappers_raise_for_other_devices():
    from kubernetes_tpu_torch.models.gangcover import cover_curve, rank_align_kernel

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="device"):
        cover_curve(meta(4, 3), meta(4), meta(4, dtype=torch.bool), meta(2), meta(2, 3),
                    meta(3))
    with pytest.raises(ValueError, match="device"):
        rank_align_kernel(meta(8), meta(8), meta(8), meta(8))


def test_defrag_wrapper_raises_for_other_devices():
    from kubernetes_tpu_torch.models.defrag import defrag_assign

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="device"):
        defrag_assign(meta(8, 3), meta(8), meta(8, dtype=torch.bool), meta(4, 3),
                      meta(4, dtype=torch.bool))


def test_transport_kernel_wrappers_raise_for_other_devices():
    from kubernetes_tpu_torch.models.transport import _auction_phase, _sinkhorn_iters
    from kubernetes_tpu_torch.ops.solver import SolverInputs, feasibility_rows

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32, b = torch.float32, torch.bool
    with pytest.raises(ValueError, match="device"):
        _auction_phase(meta(2, 4, dtype=f32), meta(2, 4), meta(2), meta(4), meta(2, 3),
                       meta(4, 3), meta(2, 4), meta(4, dtype=f32), meta(2, 4, dtype=f32), 1.0, 5)
    with pytest.raises(ValueError, match="device"):
        _sinkhorn_iters(meta(2, 4, dtype=f32), meta(2, 4, dtype=b), meta(2), meta(4, dtype=f32),
                        meta(2, dtype=f32), meta(4, dtype=f32), 2.0, 3)
    inp = SolverInputs(**{f: meta(1) for f in SolverInputs._fields if f != "gang_bonus"})
    with pytest.raises(ValueError, match="device"):
        feasibility_rows(inp, meta(1, 3), meta(1, 3), meta(1), meta(1, dtype=b))
