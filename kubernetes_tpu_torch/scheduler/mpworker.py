"""Multi-process scheduler WORKER entry point.

The counterpart of `kubernetes_tpu/scheduler/mpworker.py`: what a
`scheduler/mpsched.py` worker process runs — deliberately tiny and
numpy-only: no torch, no CUDA, no Framework, no store. A worker maps three
shared-memory column groups read-only (store/shm.py: the store's live pod
columns plus the owner-built batch and node shards), packs its shard's
pending pods onto its shard's nodes, and reports bind INTENTS —
`(batch_row, node_row, rv_snapshot)` integer triples — back over a bounded
queue. Only ints cross the boundary (no Pod is pickled); the owner process
re-validates every rv snapshot against the live columns and commits
through `store.bind_many`, whose `is_bind_conflict` surfacing absorbs
every cross-process race — exactly-once binding needs no new shared lock.

A spawned worker imports this module and store/shm.py through the package
inits, the store, the API types, the fault injector, the trace ring and
the metrics: none of them imports torch, so a worker holds no CUDA context
(one would cost hundreds of MB of device memory and seconds of start-up).

Solver: first-fit-decreasing by cpu over (cpu, mem) requests. Constrained
pods (affinity/topology/gang/anything beyond plain requests) never reach
a worker — the owner routes them to its thread-path residual pipeline
(scheduler/partition.py precedent), so FFD here is sound for what it
sees.

Clock contract: round spans are stamped with `time.perf_counter()`
(CLOCK_MONOTONIC on Linux — system-wide, so owner-side tracebuf tracks
`w{i}-sched` are comparable across processes) and `time.process_time()`
deltas carry each worker's own CPU time for the `overlap_cpu_s` reading.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

# intents per queue put: bounds a single message while letting a round
# stream results before it finishes
INTENT_CHUNK = 1024


def _solve_round(idx: int, pods_r, batch_r, nodes_r):
    """One round: pack my batch rows onto my node rows. Returns
    (intent_chunks, placed, unplaced_batch_rows)."""
    import numpy as np

    for r in (pods_r, batch_r, nodes_r):
        r.refresh()

    nb = batch_r.nrows
    ba = batch_r.arrays
    mine = np.nonzero(ba["worker"][:nb] == idx)[0]

    nn = nodes_r.nrows
    na = nodes_r.arrays
    my_nodes = np.nonzero(na["worker"][:nn] == idx)[0]
    free_cpu = (na["alloc_cpu"][my_nodes] - na["used_cpu"][my_nodes]).copy()
    free_mem = (na["alloc_mem"][my_nodes] - na["used_mem"][my_nodes]).copy()
    free_pods = (na["alloc_pods"][my_nodes]
                 - na["used_pods"][my_nodes]).copy()

    pods = pods_r.arrays
    pod_cap = pods_r.capacity
    store_row = ba["store_row"]
    req_cpu = ba["cpu"]
    req_mem = ba["mem"]

    # decreasing by cpu then mem — classic FFD ordering
    order = mine[np.lexsort((-req_mem[mine], -req_cpu[mine]))]

    intents: List[Tuple[int, int, int]] = []
    chunks: List[List[Tuple[int, int, int]]] = []
    unplaced: List[int] = []
    placed = 0
    for bi in order.tolist():
        sr = int(store_row[bi])
        if sr < 0 or sr >= pod_cap:
            continue
        rv = int(pods["row_rv"][sr])
        if rv < 0 or int(pods["node_id"][sr]) >= 0:
            continue  # removed / already bound — advisory skip, owner is truth
        c, m = int(req_cpu[bi]), int(req_mem[bi])
        cand = np.nonzero((free_cpu >= c) & (free_mem >= m)
                          & (free_pods >= 1))[0]
        if len(cand) == 0:
            unplaced.append(bi)
            continue
        slot = int(cand[0])
        free_cpu[slot] -= c
        free_mem[slot] -= m
        free_pods[slot] -= 1
        intents.append((bi, int(my_nodes[slot]), rv))
        placed += 1
        if len(intents) >= INTENT_CHUNK:
            chunks.append(intents)
            intents = []
    if intents:
        chunks.append(intents)
    return chunks, placed, unplaced


def worker_main(idx: int, store_base: str, batch_base: str, node_base: str,
                cmd_q, out_q) -> None:
    """Process entry: attach the three arenas read-only, serve rounds until
    told to stop. Protocol (ints and small tuples only):

      cmd_q <- ("round", rid)           solve the published batch/node state
      cmd_q <- ("stop",)                close mappings and exit
      out_q -> ("bind", idx, rid, [(batch_row, node_row, rv_snap), ...])
      out_q -> ("done", idx, rid, placed, unplaced_rows, t0, t1, cpu_s)
    """
    from ..store import shm as _shm

    pods_r = _shm.ShmArenaReader(store_base, _shm.POD_COLS_SCHEMA)
    batch_r = _shm.ShmArenaReader(batch_base, _shm.BATCH_COLS_SCHEMA)
    nodes_r = _shm.ShmArenaReader(node_base, _shm.NODE_COLS_SCHEMA)
    out_q.put(("ready", idx, os.getpid()))
    try:
        while True:
            cmd = cmd_q.get()
            if not cmd or cmd[0] == "stop":
                return
            if cmd[0] != "round":  # pragma: no cover - future-proofing
                continue
            rid = cmd[1]
            t0 = time.perf_counter()
            c0 = time.process_time()
            try:
                chunks, placed, unplaced = _solve_round(
                    idx, pods_r, batch_r, nodes_r)
            except Exception as exc:  # report, don't die silently
                out_q.put(("error", idx, rid, f"{type(exc).__name__}: {exc}"))
                continue
            for chunk in chunks:
                out_q.put(("bind", idx, rid, chunk))
            t1 = time.perf_counter()
            out_q.put(("done", idx, rid, placed, unplaced, t0, t1,
                       time.process_time() - c0))
    finally:
        pods_r.close()
        batch_r.close()
        nodes_r.close()
