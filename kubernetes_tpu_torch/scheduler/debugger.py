"""Scheduler cache debugger: dump + cache-vs-store comparer.

The counterpart of `kubernetes_tpu/scheduler/debugger.py`. Reference:
pkg/scheduler/backend/cache/debugger (debugger.go:32 — SIGUSR2 dumps the
cache and queue; comparer.go diffs cached state against the apiserver's).
`install_signal_handler` wires the same SIGUSR2 behavior.
"""

from __future__ import annotations

import signal
from typing import Dict, List, Optional


def dump(scheduler) -> Dict:
    """Snapshot of cache + queue contents (dumper.go dumpNodes/dumpSchedulingQueue)."""
    snapshot = scheduler.cache.update_snapshot()
    nodes = {}
    for ni in snapshot.node_info_list:
        nodes[ni.node.metadata.name] = {
            "pods": sorted(pi.pod.key for pi in ni.pods),
            "requested": {"milliCPU": ni.requested.milli_cpu,
                          "memory": ni.requested.memory},
            "allocatable": {"milliCPU": ni.allocatable.milli_cpu,
                            "memory": ni.allocatable.memory},
        }
    active, backoff, unschedulable = scheduler.queue.lengths()
    return {
        "nodes": nodes,
        "queue": {"active": active, "backoff": backoff,
                  "unschedulable": unschedulable},
        "assumed": sorted(getattr(scheduler.cache, "_assumed", {})),
    }


def compare(scheduler) -> List[str]:
    """Cache-vs-store diff (comparer.go CompareNodes/ComparePods): returns
    human-readable discrepancy lines, empty when consistent."""
    problems: List[str] = []
    store_nodes, _ = scheduler.store.list("nodes")
    store_node_names = {n.metadata.name for n in store_nodes}
    snapshot = scheduler.cache.update_snapshot()
    cached_names = {ni.node.metadata.name for ni in snapshot.node_info_list}
    for name in sorted(store_node_names - cached_names):
        problems.append(f"node {name} in store but not in scheduler cache")
    for name in sorted(cached_names - store_node_names):
        problems.append(f"node {name} in scheduler cache but not in store")
    store_pods, _ = scheduler.store.list(
        "pods", lambda p: bool(p.spec.node_name) and not p.is_terminal())
    store_keys = {p.key for p in store_pods}
    cached_keys = set()
    for ni in snapshot.node_info_list:
        cached_keys.update(pi.pod.key for pi in ni.pods)
    # assumed pods are in the cache ahead of their Binding write landing in
    # the store — that window is healthy, not an inconsistency (comparer.go
    # filters assumed pods the same way)
    assumed = set(getattr(scheduler.cache, "_assumed", {}))
    for key in sorted(store_keys - cached_keys):
        problems.append(f"pod {key} bound in store but missing from cache")
    for key in sorted(cached_keys - store_keys - assumed):
        problems.append(f"pod {key} in cache but not bound in store")
    return problems


def install_signal_handler(scheduler, logger=None) -> None:
    """SIGUSR2 -> dump + compare to the structured log (debugger.go:71)."""
    from ..utils.tracing import default_logger

    log = logger or default_logger

    def handle(signum, frame):
        log.info("scheduler cache dump", dump=dump(scheduler))
        problems = compare(scheduler)
        if problems:
            log.warning("cache/store inconsistency", problems=problems)
        else:
            log.info("cache consistent with store")

    signal.signal(signal.SIGUSR2, handle)
