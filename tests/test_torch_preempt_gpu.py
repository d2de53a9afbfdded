"""Per-pod preemption on the card: PreemptionBasic at 64 nodes through
BatchScheduler(device="cuda") against the same run on the CPU.

64 nodes of 4 cpu / 32Gi / 110 pods, 64 bound priority-1 pods of 3 cpu (one
a node), then 64 pending priority-100 pods of 2 cpu, in solver="exact"
(kernels B and A) and "auto" (B and C), victims prepared synchronously and
on the async worker. The card run must bind every high pod and equal the
CPU run: the {pod: node} map, the victims and the Preempted events. The
scheduler's clock is a FakeClock the drive loop steps past every backoff,
so both runs admit the preemptors in the same batches.

The tests marked `gpu` skip without a card and run with `python -m pytest
--noconftest -m gpu tests/test_torch_preempt_gpu.py`; this file imports
neither jax nor the JAX package. The unmarked test runs the same drive on
the CPU.
"""

import pytest
import torch

from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
from kubernetes_tpu_torch.scheduler.plugins import default_plugins
from kubernetes_tpu_torch.scheduler.runtime import Framework
from kubernetes_tpu_torch.store import APIStore
from kubernetes_tpu_torch.testing import MakeNode, MakePod
from kubernetes_tpu_torch.utils import FakeClock

N = 64


def preemption_basic(device, solver, async_prep, n=N):
    store, clock = APIStore(), FakeClock(1000.0)
    store.create_many("nodes", [MakeNode(f"node-{i}").capacity(
        {"cpu": "4", "memory": "32Gi", "pods": "110"}).obj() for i in range(n)])
    store.create_many("pods", [MakePod(f"low-{i}").priority(1).req({"cpu": "3"})
                               .node(f"node-{i}").obj() for i in range(n)])
    sched = BatchScheduler(store, Framework(default_plugins()), device=device, solver=solver,
                           clock=clock)
    sched.preemption.async_preparation = async_prep
    sched.sync()
    kernels.reset_launch_counts()
    store.create_many("pods", [MakePod(f"high-{i}").priority(100).req({"cpu": "2"}).obj()
                               for i in range(n)])
    for _ in range(4):
        sched.run_until_idle()
        sched.preemption.wait_for_preparation(timeout=30.0)
        sched.pump_events()
        clock.step(11.0)
        sched.queue.flush_backoff_completed()
    pods = store.list("pods")[0]
    events = sorted((e.reason, e.involved_name, e.message) for e in store.list("events")[0])
    return {"placement": {p.metadata.name: p.spec.node_name for p in pods},
            "victims": sorted({f"low-{i}" for i in range(n)} - {p.metadata.name for p in pods}),
            "preempted": [e for e in events if e[0] == "Preempted"],
            "counts": (sched.preemption_count, sched.preempt_victims_total),
            "launches": dict(kernels.LAUNCHES)}


def test_preemption_basic_on_the_cpu_binds_every_preemptor():
    got = preemption_basic("cpu", "auto", False)
    high = {k: v for k, v in got["placement"].items() if k.startswith("high-")}
    assert len(high) == N and all(high.values()) and len(set(high.values())) == N
    assert len(got["victims"]) == N and got["counts"] == (N, N)
    assert len(got["preempted"]) == N


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("async_prep", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("solver", ["exact", "auto"])
def test_preemption_basic_on_card_equals_cpu(cuda_device, solver, async_prep):
    got = preemption_basic(cuda_device.type, solver, async_prep)
    want = preemption_basic("cpu", solver, async_prep)
    assert got["placement"] == want["placement"]
    assert got["victims"] == want["victims"] and len(got["victims"]) == N
    assert got["preempted"] == want["preempted"] and got["counts"] == want["counts"]
    assert all(v for k, v in got["placement"].items() if k.startswith("high-"))
    assert got["launches"]["row_scatter"] > 0
    assert got["launches"]["waterfill" if solver == "auto" else "greedy_scan"] > 0
