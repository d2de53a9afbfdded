"""Columnar pod-row store: struct-of-arrays for the pod rows.

The counterpart of `kubernetes_tpu/store/columnar.py`. The hot fields the
scheduler pipeline touches per pod live in parallel columns (numpy int
arrays, interned string tables and parallel object-ref lists), and
`bind_many` commits by COLUMN WRITES — `node_id[rows] = ids`,
`row_rv[rows] = arange(rv0+1, ...)`, one diverged-bitmap set — instead of a
clone-and-swap a pod. The full Pod object of a bound row is materialized
LAZILY, at most once, when an API read, a non-coalescing watcher or a
cold field access needs the whole object (the lazy-event idiom of
store/store.py, extended from events to rows).

Columns per row (the scheduler pipeline's hot fields):

  keys[]        "namespace/name" (object list; the row identity)
  ns_id[]       interned namespace id (int32)
  name[]        pod name (object list)
  uid[]         metadata.uid (object list)
  node_id[]     interned node name id; -1 = unbound (int32) — AUTHORITATIVE
                for bound-ness (the dict row of a diverged row is stale)
  row_rv[]      the row's current resourceVersion (int64; -1 = free row) —
                authoritative for diverged rows, mirror otherwise
  phase_id[]    interned status.phase id (int32)
  priority[]    spec.priority (int64)
  rank[]        pod-group.scheduling/rank label, -1 when absent (int32)
  gang[]        pod-group key ("" when not a gang member; object list)
  sig[]         (class-signature, request-signature) memo REFS captured from
                the pod's __dict__ at sync (the tensorizer's memos —
                snapshot/tensorizer.py SIG_MEMO_KEYS; clones share __dict__
                copies so materialized rows keep them for free)
  base[]        the stored Pod object (object list). For a DIVERGED row this
                is the PRE-BIND object: node_id/row_rv above carry the
                committed bind until materialization swaps in the bound clone.
  diverged[]    bool bitmap: True = columns carry state the base object (and
                the store's dict row) does not yet reflect

Locking: every column mutation happens under the store's pods shard
(`_pods_lock`) — PodColumns itself is lock-free and trusts its caller
(store/store.py documents the order). The intern tables are append-only, so
LazyBindBatch consumers resolve node ids -> names lock-free on their own
threads.

Fallback: no numpy, `STORE_COLUMNAR=0`, `APIStore(columnar=False)`, or a
store configured without the lazy/deep-copy event contract all disable the
columns — the dict store is the oracle and stays bit-for-bit.

`bind_prepare(native=)` runs the validate/intern loop in the g++ commit
engine (native/hostcommit.cpp hc_columnar_prepare), byte-identical to the
Python loop here.

Not in this slice: the shared-memory backing of the numeric columns
(`attach_arena`; ROADMAP.md queue 1 item 7e).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

try:  # numpy is the whole point of the SoA layout; without it, dict path
    import numpy as np
except Exception:  # pragma: no cover - exercised via monkeypatch in tests
    np = None  # type: ignore

from ..api.podgroup import pod_gang_rank, pod_group_key


def numpy_available() -> bool:
    return np is not None


def env_enabled() -> bool:
    """STORE_COLUMNAR env gate (default on)."""
    return os.environ.get("STORE_COLUMNAR", "").lower() not in ("0", "false")


# the pod-carried memo keys whose refs the sig column captures; single
# source of truth lives with the memos' owner (snapshot/tensorizer.py) —
# imported lazily so a store-only consumer never pays the tensorizer import
_SIG_KEYS_FALLBACK = ("_class_sig", "_req_sig")


def _sig_memo_keys() -> Tuple[str, ...]:
    try:
        from ..snapshot.tensorizer import SIG_MEMO_KEYS

        return SIG_MEMO_KEYS[:2]
    except Exception:  # pragma: no cover - tensorizer always importable here
        return _SIG_KEYS_FALLBACK


class PodColumnsView:
    """Read-only view over the live columns (`APIStore.pod_columns()`).

    The numpy members are non-writeable VIEWS of the live arrays and the
    list/table members are the live objects — everything here carries the
    store-returned READ-ONLY contract (the arrays enforce it at runtime
    via writeable=False). Snapshot consistency: take it under
    `store.transaction("pods")` or treat the values as advisory telemetry.
    """

    __slots__ = ("n", "keys", "base", "uid", "name", "ns_id", "node_id",
                 "row_rv", "phase_id", "priority", "rank", "gang", "sig",
                 "diverged", "node_names", "namespaces", "phases", "key2row")

    def __init__(self, cols: "PodColumns"):
        n = cols.n

        def ro(arr):
            v = arr[:n].view()
            v.flags.writeable = False
            return v

        self.n = n
        self.keys = cols.keys
        self.base = cols.base
        self.uid = cols.uid
        self.name = cols.name
        self.ns_id = ro(cols.ns_id)
        self.node_id = ro(cols.node_id)
        self.row_rv = ro(cols.row_rv)
        self.phase_id = ro(cols.phase_id)
        self.priority = ro(cols.priority)
        self.rank = ro(cols.rank)
        self.gang = cols.gang
        self.sig = cols.sig
        self.diverged = ro(cols.diverged)
        self.node_names = cols.node_names
        self.namespaces = cols.namespaces
        self.phases = cols.phases
        # live row index (key -> row into the columns above) — lets column
        # consumers (tensorizer sig re-seed) address rows by pod key without
        # an O(rows) scan; read-only by the view's contract
        self.key2row = cols.key2row


class PodColumns:
    """The struct-of-arrays pod-row table. All mutation under the caller's
    pods-shard lock (see module docstring)."""

    _INITIAL_CAP = 1024

    def __init__(self, bind_cloner: Callable[[Any], Any]):
        self._bind_cloner = bind_cloner
        cap = self._INITIAL_CAP
        self.n = 0  # high-water row count (free rows included)
        self.key2row: Dict[str, int] = {}
        self.keys: List[Optional[str]] = [None] * cap
        self.base: List[Any] = [None] * cap
        self.uid: List[Optional[str]] = [None] * cap
        self.name: List[Optional[str]] = [None] * cap
        self.gang: List[str] = [""] * cap
        self.sig: List[Any] = [None] * cap
        self.ns_id = np.full(cap, -1, dtype=np.int32)
        self.node_id = np.full(cap, -1, dtype=np.int32)
        self.row_rv = np.full(cap, -1, dtype=np.int64)
        self.phase_id = np.full(cap, -1, dtype=np.int32)
        self.priority = np.zeros(cap, dtype=np.int64)
        self.rank = np.full(cap, -1, dtype=np.int32)
        self.diverged = np.zeros(cap, dtype=bool)
        self._free: List[int] = []
        self._diverged_n = 0
        # interned string tables (append-only: lock-free reads are safe)
        self.node_names: List[str] = []
        self._node_ids: Dict[str, int] = {}
        self.namespaces: List[str] = []
        self._ns_ids: Dict[str, int] = {}
        self.phases: List[str] = []
        self._phase_ids: Dict[str, int] = {}
        self.materialized_total = 0  # lifetime lazy row materializations
        self.sig_captured = 0  # lifetime capture_sig_memos column writes
        self._sig_keys = _sig_memo_keys()

    # -- intern tables ---------------------------------------------------------

    def intern_node(self, name: str) -> int:
        return self._intern(self.node_names, self._node_ids, name)

    def _intern(self, table: List[str], ids: Dict[str, int], val: str) -> int:
        i = ids.get(val)
        if i is None:
            i = len(table)
            ids[val] = i
            table.append(val)
        return i

    # -- row lifecycle ---------------------------------------------------------

    def _grow(self) -> None:
        cap = len(self.keys)
        new = cap * 2
        pad = new - cap
        self.keys.extend([None] * pad)
        self.base.extend([None] * pad)
        self.uid.extend([None] * pad)
        self.name.extend([None] * pad)
        self.gang.extend([""] * pad)
        self.sig.extend([None] * pad)
        for attr, fill in (("ns_id", -1), ("node_id", -1), ("phase_id", -1),
                           ("rank", -1)):
            old = getattr(self, attr)
            arr = np.full(new, fill, dtype=old.dtype)
            arr[:cap] = old
            setattr(self, attr, arr)
        rv = np.full(new, -1, dtype=np.int64)
        rv[:cap] = self.row_rv
        self.row_rv = rv
        pr = np.zeros(new, dtype=np.int64)
        pr[:cap] = self.priority
        self.priority = pr
        dv = np.zeros(new, dtype=bool)
        dv[:cap] = self.diverged
        self.diverged = dv

    def insert(self, key: str, pod) -> int:
        """New row for a just-stored pod (create path). Caller guarantees the
        key is fresh."""
        if self._free:
            row = self._free.pop()
        else:
            row = self.n
            if row >= len(self.keys):
                self._grow()
            self.n += 1
        self.keys[row] = key
        meta = pod.metadata
        self.uid[row] = meta.uid
        self.name[row] = meta.name
        self.ns_id[row] = self._intern(self.namespaces, self._ns_ids,
                                       meta.namespace or "")
        self.key2row[key] = row
        self.sync(row, pod)
        return row

    def sync(self, row: int, pod) -> None:
        """Refresh a row from a (new) stored object — every dict-path write
        (create/update/bind/status) keeps the columns coherent through here.
        Clears divergence: the dict row IS the object passed in."""
        self.base[row] = pod
        self.node_id[row] = (self.intern_node(pod.spec.node_name)
                             if pod.spec.node_name else -1)
        self.row_rv[row] = pod.metadata.resource_version
        self.phase_id[row] = self._intern(self.phases, self._phase_ids,
                                          pod.status.phase or "")
        self.priority[row] = pod.spec.priority or 0
        labels = pod.metadata.labels
        if labels:
            self.gang[row] = pod_group_key(pod)
            self.rank[row] = pod_gang_rank(pod)
        else:
            self.gang[row] = ""
            self.rank[row] = -1
        d = pod.__dict__
        k1, k2 = self._sig_keys
        cs, rs = d.get(k1), d.get(k2)
        cur = self.sig[row]
        if cur is not None:
            # a re-sync must not CLOBBER a previously captured memo ref the
            # incoming parse lacks (status/relist writes hand fresh objects
            # with empty memo slots, and the rebalancer's evict→re-place
            # waves re-sync constantly).
            # Keeping a stale ref is safe by construction — the tensorizer's
            # seed_memos validates the identity anchors (spec, labels)
            # before applying, so a ref whose spec was since replaced simply
            # never seeds.
            if cs is None:
                cs = cur[0]
            if rs is None:
                rs = cur[1]
        self.sig[row] = (cs, rs)
        if self.diverged[row]:
            self.diverged[row] = False
            self._diverged_n -= 1

    def capture(self, key: str, pod) -> bool:
        """Back-fill the sig column from a pod object whose memos were
        primed OUTSIDE the store (the tensorizer's build_pod_batch, at the
        batch's bind/assume edge): the scheduler's pod shares spec identity
        with the stored object (structural clones share deep members), so
        its memo refs seed future parses of this row. Only fills components
        the column does not already have — sync() owns refreshes."""
        row = self.key2row.get(key)
        if row is None:
            return False
        d = pod.__dict__
        k1, k2 = self._sig_keys
        cs, rs = d.get(k1), d.get(k2)
        if cs is None and rs is None:
            return False
        cur = self.sig[row]
        if cur is not None:
            if cur[0] is not None:
                cs = cur[0]
            if cur[1] is not None:
                rs = cur[1]
            if (cs is cur[0] and rs is cur[1]):
                return False
        self.sig[row] = (cs, rs)
        self.sig_captured += 1
        return True

    def remove(self, key: str) -> None:
        row = self.key2row.pop(key, None)
        if row is None:
            return
        if self.diverged[row]:
            self.diverged[row] = False
            self._diverged_n -= 1
        self.keys[row] = None
        self.base[row] = None
        self.uid[row] = None
        self.name[row] = None
        self.gang[row] = ""
        self.sig[row] = None
        self.node_id[row] = -1
        self.row_rv[row] = -1  # invalidates any in-flight bind's rv snapshot
        self._free.append(row)

    # -- the bind hot path -----------------------------------------------------

    def bind_prepare(self, bindings, errors: List[Tuple[str, str]],
                     native=None):
        """Phase 1 (caller holds the pods shard): validate each
        (namespace, name, node) against the COLUMNS — no clone, no object
        walk — and intern the node names. Returns (rows int32[], ids
        int32[], keys list, rv_snap int64[]): the accepted entries' row
        indices, interned node ids, key strings, and the rows' rv values
        (the commit phase re-validates raced rows against these: every row
        write bumps row_rv, and remove() poisons it with -1, so a changed
        value is exactly "this row raced"). Error messages match the dict
        path byte-for-byte. `native` (the loaded hostcommit module) runs the
        same loop in the g++ engine; bindings must then be a sequence."""
        if native is not None:
            rows, ids, keys = native.columnar_prepare(
                self.key2row, bindings, self._node_ids, self.node_names,
                self.node_id, errors)
        else:
            key2row = self.key2row
            node_id = self.node_id
            names = self.node_names
            node_ids = self._node_ids
            row_list: List[int] = []
            id_list: List[int] = []
            keys = []
            for namespace, name, node_name in bindings:
                key = f"{namespace}/{name}"
                row = key2row.get(key)
                if row is None:
                    errors.append((key, f"pods {key} not found"))
                    continue
                cur = node_id[row]
                if cur >= 0:
                    errors.append(
                        (key,
                         f"pod {key} is already bound to {names[cur]}"))
                    continue
                nid = node_ids.get(node_name)
                if nid is None:
                    # append-then-map, matching the C loop: a failure
                    # between the two leaves only an orphan table entry
                    nid = len(names)
                    names.append(node_name)
                    node_ids[node_name] = nid
                row_list.append(row)
                id_list.append(nid)
                keys.append(key)
            rows = np.asarray(row_list, dtype=np.int32)
            ids = np.asarray(id_list, dtype=np.int32)
        rv_snap = self.row_rv[rows].copy() if len(rows) else \
            np.zeros(0, dtype=np.int64)
        return rows, ids, keys, rv_snap

    def commit_bind(self, rows, ids, keys, rv_snap, rv0: int,
                    errors: List[Tuple[str, str]]):
        """Phase 2 (caller holds global + shard): re-validate rows that
        changed between the phases (a concurrent single bind / delete /
        create reusing a freed row — and duplicate keys within one batch,
        where the second occurrence must see the first, like the dict
        path's re-validate branch), then commit the survivors by COLUMN
        WRITES: node ids, a contiguous rv range, the diverged bitmap. Zero
        per-pod object allocation on the clean path. Returns (n, keys,
        bases, ids): the committed count plus the per-entry key strings,
        pre-bind base refs, and node ids the LazyBindBatch event marker
        captures."""
        n = len(rows)
        if n == 0:
            return 0, [], [], ids
        ok_all = bool(((self.node_id[rows] < 0)
                       & (self.row_rv[rows] == rv_snap)).all())
        if not ok_all or len(np.unique(rows)) != n:
            # raced/duplicate entries: per-entry slow path against CURRENT
            # state (we hold both locks now — no further races). Bound keys
            # within this very batch are tracked so a duplicate errors like
            # the dict path's second commit ("already bound to" the first
            # occurrence's node).
            key2row = self.key2row
            node_id = self.node_id
            names = self.node_names
            keep_rows: List[int] = []
            keep_ids: List[int] = []
            keep_keys: List[str] = []
            batch_bound: Dict[str, str] = {}
            ids_list = ids.tolist()
            for i in range(n):
                key = keys[i]
                first = batch_bound.get(key)
                if first is not None:
                    errors.append(
                        (key, f"pod {key} is already bound to {first}"))
                    continue
                row = key2row.get(key)
                if row is None:
                    errors.append((key, f"pods {key} not found"))
                    continue
                cur = node_id[row]
                if cur >= 0:
                    errors.append(
                        (key,
                         f"pod {key} is already bound to {names[cur]}"))
                    continue
                keep_rows.append(row)
                keep_ids.append(ids_list[i])
                keep_keys.append(key)
                batch_bound[key] = names[ids_list[i]]
            rows = np.asarray(keep_rows, dtype=np.int32)
            ids = np.asarray(keep_ids, dtype=np.int32)
            keys = keep_keys
            n = len(rows)
            if n == 0:
                return 0, [], [], ids
        bases = [self.base[r] for r in rows.tolist()]
        self.node_id[rows] = ids
        self.row_rv[rows] = np.arange(rv0 + 1, rv0 + 1 + n, dtype=np.int64)
        self.diverged[rows] = True
        self._diverged_n += n
        return n, keys, bases, ids

    # -- lazy row materialization ----------------------------------------------

    def materialize(self, row: int, objs: Dict[str, Any]):
        """Build the bound Pod object a diverged row stands for — ONE bind
        clone of the pre-bind base with the column node/rv applied — swap it
        into the store's dict row and the base column, and clear divergence.
        Runs at most once per row per bind (caller holds the pods shard)."""
        base = self.base[row]
        pod = self._bind_cloner(base)
        pod.spec.node_name = self.node_names[self.node_id[row]]
        pod.metadata.resource_version = int(self.row_rv[row])
        key = self.keys[row]
        objs[key] = pod
        self.base[row] = pod
        self.diverged[row] = False
        self._diverged_n -= 1
        self.materialized_total += 1
        return pod

    def materialize_key(self, key: str, objs: Dict[str, Any]):
        """Materialize one row iff diverged; None when clean/missing."""
        row = self.key2row.get(key)
        if row is not None and self.diverged[row]:
            return self.materialize(row, objs)
        return None

    def materialize_all(self, objs: Dict[str, Any]) -> int:
        """Materialize every diverged row (LIST and full-snapshot reads)."""
        if not self._diverged_n:
            return 0
        rows = np.nonzero(self.diverged[: self.n])[0].tolist()
        for row in rows:
            self.materialize(row, objs)
        return len(rows)

    # -- telemetry -------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "rows": len(self.key2row),
            "capacity": len(self.keys),
            "free": len(self._free),
            "diverged": int(self._diverged_n),
            "materialized_total": self.materialized_total,
            "bound": int((self.node_id[: self.n] >= 0).sum()),
            "node_table": len(self.node_names),
            "phase_table": len(self.phases),
            "sig_captured": self.sig_captured,
        }
