"""Columnar cache rows: struct-of-arrays for steady-state assumed and bound
pods in the scheduler cache.

The counterpart of `kubernetes_tpu/scheduler/cachecols.py`. The columnar
store (store/columnar.py) removed the per-pod object work from the STORE
half of the bind pipeline; this module is the cache half of the same idiom:
a solved, constraint-free batch's placements land as ROWS (the original Pod
ref, the row key, an interned node-name id in an int32 column) with no
per-pod object allocated. Per-node resource totals ride the phase-2
scatter-add (Cache.apply_node_resource_deltas), and the per-node row
population is one int on NodeInfo (`col_count`), so the tensorizer's
pod_count stays exact without materializing anything.

Columns per row:

  keys[]     "namespace/name" (object list; the row identity)
  pod[]      the ORIGINAL store/queue Pod object (object list), never
             cloned, never mutated; held for removal accounting (its
             `_req_cache` memo pair is the exact inverse of the phase-2
             scatter) and for lazy materialization
  node_id[]  interned node-name id (int32)

Rows are created only by `Cache.assume_pods_columnar` under the dispatch
gate (no gangs, no topology-spread or inter-pod-affinity terms, no host
ports), so a row never owes affinity sublists or port claims. A row
MATERIALIZES into a real PodInfo at most once, when a consumer needs object
rows (a constrained batch's selector counts, the per-pod cycle's plugin
walks, device-reject preemption, the conservation checker), counted in the
lifetime `materialized_total`.

Locking: every mutation happens under the owning Cache's `_lock`;
CacheColumns itself is lock-free and trusts its caller, like the store's
PodColumns. The node-name intern table is append-only.

`STORE_COLUMNAR=0` (read when a BatchScheduler is built) or
BatchScheduler(columnar=False) disables the rows: the object path (PodInfo
appends) is the oracle.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


def env_enabled() -> bool:
    """Shares the store's STORE_COLUMNAR gate (default on): one switch
    sweeps the whole columnar pipeline to its object-path oracle."""
    return os.environ.get("STORE_COLUMNAR", "").lower() not in ("0", "false")


class CacheColumnsView:
    """Read-only view over the live cache rows (`Cache.pod_columns()`).

    Same contract as the store's PodColumnsView: the numpy member is a
    non-writeable VIEW of the live array, the lists/tables are the live
    objects, and everything is READ-ONLY (the array refuses writes at
    runtime). Take it under no lock only as advisory telemetry."""

    __slots__ = ("n", "keys", "pod", "node_id", "node_names", "key2row")

    def __init__(self, cols: "CacheColumns"):
        n = cols.n
        v = cols.node_id[:n].view()
        v.flags.writeable = False
        self.n = n
        self.keys = cols.keys
        self.pod = cols.pod
        self.node_id = v
        self.node_names = cols.node_names
        self.key2row = cols.key2row


class CacheColumns:
    """The struct-of-arrays cache-row table. All mutation under the owning
    Cache's lock (see module docstring)."""

    _INITIAL_CAP = 1024

    def __init__(self):
        cap = self._INITIAL_CAP
        self.n = 0  # high-water row count (free rows included)
        self.key2row: Dict[str, int] = {}
        self.keys: List[Optional[str]] = [None] * cap
        self.pod: List[Any] = [None] * cap
        self.node_id = np.full(cap, -1, dtype=np.int32)
        self._free: List[int] = []
        # interned node-name table (append-only: lock-free reads are safe)
        self.node_names: List[str] = []
        self._node_ids: Dict[str, int] = {}
        self.inserted_total = 0  # lifetime row inserts (assume placements)
        self.materialized_total = 0  # lifetime row -> PodInfo collapses

    def intern_node(self, name: str) -> int:
        i = self._node_ids.get(name)
        if i is None:
            i = len(self.node_names)
            self._node_ids[name] = i
            self.node_names.append(name)
        return i

    def _grow(self) -> None:
        cap = len(self.keys)
        new = cap * 2
        pad = new - cap
        self.keys.extend([None] * pad)
        self.pod.extend([None] * pad)
        arr = np.full(new, -1, dtype=np.int32)
        arr[:cap] = self.node_id
        self.node_id = arr

    def insert(self, key: str, pod, node_name: str) -> int:
        """New row for an assumed placement. Caller guarantees the key is
        fresh (the assume validation already rejected duplicates)."""
        if self._free:
            row = self._free.pop()
        else:
            row = self.n
            if row >= len(self.keys):
                self._grow()
            self.n += 1
        self.keys[row] = key
        self.pod[row] = pod
        self.node_id[row] = self.intern_node(node_name)
        self.key2row[key] = row
        self.inserted_total += 1
        return row

    def remove(self, key: str) -> Optional[Tuple[Any, str]]:
        """Drop a row; returns (pod, node_name) so the caller can settle the
        node-side accounting, or None when the key has no row."""
        row = self.key2row.pop(key, None)
        if row is None:
            return None
        pod = self.pod[row]
        node_name = self.node_names[self.node_id[row]]
        self.keys[row] = None
        self.pod[row] = None
        self.node_id[row] = -1
        self._free.append(row)
        return pod, node_name

    def rows(self) -> int:
        return len(self.key2row)

    def iter_rows(self) -> Iterator[Tuple[str, Any, str]]:
        """(key, pod, node_name) for every live row (caller holds the cache
        lock; snapshot the output before mutating)."""
        names = self.node_names
        node_id = self.node_id
        pods = self.pod
        for key, row in self.key2row.items():
            yield key, pods[row], names[node_id[row]]

    def stats(self) -> Dict[str, Any]:
        return {
            "rows": len(self.key2row),
            "capacity": len(self.keys),
            "free": len(self._free),
            "inserted_total": self.inserted_total,
            "materialized_total": self.materialized_total,
            "node_table": len(self.node_names),
        }
