"""The kernel library's two thread-safety repairs (ops/kernels.py), checked
without nvcc: the partitioned scheduler's pipelines reach an unbuilt kernel
together and bump the launch counters from several threads at once.

  * `_lib` builds and binds a library once under concurrent first use (a
    slow fake build, a fake loader), and nvcc's temporary output is unique
    per thread as well as per process;
  * `bump` loses no count under threads, and `launch_scope` attributes each
    thread's launches to its own label.
"""

import ctypes
import os
import sys
import threading
import time

import pytest

from kubernetes_tpu_torch.ops import kernels


@pytest.fixture(autouse=True)
def _fresh_counts():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


class _FakeFn:
    """A C entry of the fake library: every size query answers the layout
    the wrapper expects for cover_curve."""

    argtypes = None
    restype = None

    def __call__(self, *args):
        return ctypes.sizeof(kernels._CoverCurveArgs)


def test_lib_builds_and_binds_once_under_concurrent_first_use(monkeypatch):
    builds, loads = [], []

    def slow_build(names=None):
        builds.append(list(names))
        time.sleep(0.05)
        return {n: "" for n in names}

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = _FakeFn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    got = []
    start = threading.Barrier(8)

    def first_use():
        start.wait()
        got.append(kernels._lib("cover_curve"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["cover_curve"]]
    assert loads == [str(kernels._lib_path("cover_curve"))]
    assert len(got) == 8 and len({id(lib) for lib in got}) == 1
    assert kernels._lib("cover_curve") is got[0]  # later calls: no lock, no build


def test_build_temporary_is_unique_per_thread(monkeypatch, tmp_path):
    """Two threads building the same kernel at once (build() itself takes no
    lock) each write their own temporary, and the library lands whole."""
    script = tmp_path / "nvcc"
    log = tmp_path / "outs"
    script.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; fi; shift\n"
        "done\n"
        f"echo \"$out\" >> {log}\n"
        "sleep 0.2\n"
        "echo built > \"$out\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "lib")
    start = threading.Barrier(2)
    errors = []

    def build_once():
        start.wait()
        try:
            kernels.build(["cover_curve"])
        except Exception as e:  # a shared temporary would make one rename fail
            errors.append(e)

    threads = [threading.Thread(target=build_once) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    outs = log.read_text().split()
    assert errors == [] and len(outs) == 2 and len(set(outs)) == 2
    assert all(o.endswith(".tmp") for o in outs)
    assert (tmp_path / "lib" / kernels._lib_path("cover_curve").name).read_text() == "built\n"
    assert not list((tmp_path / "lib").glob("*.tmp"))


def test_counters_are_exact_under_threads():
    """More threads than cores and a short switch interval: an unlocked
    read-modify-write would lose counts."""
    n_threads, per = 2 * (os.cpu_count() or 4), 3000

    def launcher(i):
        with kernels.launch_scope(f"p{i}"):
            for _ in range(per):
                kernels.bump(kernels.LAUNCHES, "waterfill")
                kernels.bump(kernels.CUDA_LAUNCHES, "waterfill", 2)
                kernels.bump(kernels.HOST_SYNCS, "waterfill")

    threads = [threading.Thread(target=launcher, args=(i,)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernels.LAUNCHES["waterfill"] == n_threads * per
    assert kernels.CUDA_LAUNCHES["waterfill"] == 2 * n_threads * per
    assert kernels.HOST_SYNCS["waterfill"] == n_threads * per
    # LAUNCHES only, split by each thread's scope
    assert sorted(kernels.SCOPED_LAUNCHES) == sorted(f"p{i}" for i in range(n_threads))
    assert all(c["waterfill"] == per and sum(c.values()) == per
               for c in kernels.SCOPED_LAUNCHES.values())


def test_launch_scope_nests_and_resets():
    with kernels.launch_scope("outer"):
        kernels.bump(kernels.LAUNCHES, "row_scatter")
        with kernels.launch_scope("inner"):
            kernels.bump(kernels.LAUNCHES, "row_scatter")
        kernels.bump(kernels.LAUNCHES, "greedy_scan")
    kernels.bump(kernels.LAUNCHES, "greedy_scan")  # no scope: the total only
    assert kernels.LAUNCHES["row_scatter"] == 2 and kernels.LAUNCHES["greedy_scan"] == 2
    assert kernels.SCOPED_LAUNCHES["outer"]["row_scatter"] == 1
    assert kernels.SCOPED_LAUNCHES["outer"]["greedy_scan"] == 1
    assert kernels.SCOPED_LAUNCHES["inner"]["row_scatter"] == 1
    kernels.reset_launch_counts()
    assert kernels.SCOPED_LAUNCHES == {} and not any(kernels.LAUNCHES.values())


def test_partitioned_pipelines_count_under_their_scope(monkeypatch):
    """A partitioned run on the CPU launches nothing (the plain versions
    run), so the drive's scopes are checked by a counting stand-in for a
    launch: each pipeline's drive thread counts under "p<i>" and the
    residual pass under "residual"."""
    from kubernetes_tpu_torch.scheduler import partition
    from kubernetes_tpu_torch.scheduler.batch import BatchScheduler
    from kubernetes_tpu_torch.store import APIStore
    from kubernetes_tpu_torch.testing import MakeNode, MakePod

    real = BatchScheduler.schedule_batch

    def counted(self):
        n = real(self)
        if n:
            kernels.bump(kernels.LAUNCHES, "waterfill")
        return n

    monkeypatch.setattr(BatchScheduler, "schedule_batch", counted)
    store = APIStore()
    for i in range(6):
        store.create("nodes", MakeNode(f"n{i}").labels({"kubernetes.io/hostname": f"n{i}",
                                                        "topology.kubernetes.io/zone": f"z{i % 2}"})
                     .capacity({"cpu": "16", "memory": "64Gi"}).obj())
    ps = partition.PartitionedScheduler(store, lambda: None, partitions=2, device="cpu",
                                        solver="fast", concurrent=True)
    ps.sync()
    pods = [MakePod(f"p{i}").req({"cpu": "500m"}).obj() for i in range(30)]
    pods += [MakePod(f"s{i}").labels({"app": "s"}).req({"cpu": "100m"})
             .topology_spread(1, "topology.kubernetes.io/zone", "DoNotSchedule", {"app": "s"})
             .obj() for i in range(4)]
    store.create_many("pods", pods)
    ps.run_until_idle()
    ps.stop()
    scoped = {k: v["waterfill"] for k, v in kernels.SCOPED_LAUNCHES.items()}
    assert scoped == {"p0": 1, "p1": 1, "residual": 1}
    assert kernels.LAUNCHES["waterfill"] == 3
