"""ctypes loader and wrappers for the host commit engine (hostcommit.cpp).

The counterpart of `kubernetes_tpu/native/hostcommit.py`. Compiled at first
use by g++ against the CPython headers into `build/torch_kernels/` (see
hostsched.build_so) and loaded with ctypes.PyDLL: every entry point works
on Python objects and runs WITH the GIL held, so the entries are legal
under the store and cache locks (the gain is fewer interpreter cycles a pod
inside those critical sections, not GIL release; the GIL-releasing array
kernels live in hostsched.py).

Selection: the engine is on unless HOSTSCHED_NATIVE_COMMIT is 0/false, the
switch that selects the Python loops (the oracles the engine is held
against) on every native-commit path; the store's own switch is
APIStore(native_commit=) / STORE_NATIVE_COMMIT. Where the engine is
selected, a failed build or load raises with the compiler's message: no
path falls back to the Python loops quietly.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .hostsched import build_so

_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def env_disabled() -> bool:
    """HOSTSCHED_NATIVE_COMMIT=0/false selects the Python loops (read live,
    so a test can flip it per case)."""
    return os.environ.get("HOSTSCHED_NATIVE_COMMIT", "").lower() in ("0", "false")


def load() -> ctypes.PyDLL:
    """The loaded engine (built on first use). Raises on a failed build or
    load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.PyDLL(str(build_so("hostcommit", python_headers=True)))
        obj = ctypes.py_object
        lib.hc_init.restype = obj
        lib.hc_init.argtypes = [obj, obj, obj]
        lib.hc_bind_prepare.restype = obj
        lib.hc_bind_prepare.argtypes = [obj, obj, obj, obj]
        lib.hc_bind_commit.restype = obj
        lib.hc_bind_commit.argtypes = [obj, obj, obj, obj, ctypes.c_long, ctypes.c_int,
                                       obj, obj, obj]
        lib.hc_delete_commit.restype = obj
        lib.hc_delete_commit.argtypes = [obj, obj, obj, obj, ctypes.c_long, ctypes.c_int,
                                         obj, obj, obj]
        lib.hc_assume_structural.restype = obj
        lib.hc_assume_structural.argtypes = [obj, obj, obj, obj, obj]
        lib.hc_columnar_prepare.restype = obj
        lib.hc_columnar_prepare.argtypes = [obj, obj, obj, obj, obj, obj,
                                            _i32p, _i32p, _i32p]
        lib.hc_batch_rows.restype = obj
        lib.hc_batch_rows.argtypes = [obj, obj, obj, obj, obj, obj, _i32p, _i32p]
        # the port's types (the engine holds strong references)
        from ..scheduler.framework import NodeInfo, PodInfo
        from ..store.store import Event

        lib.hc_init(Event, PodInfo, NodeInfo)
        _lib = lib
        return lib


def selected() -> bool:
    """True unless HOSTSCHED_NATIVE_COMMIT turns the engine off; where it is
    on, loads it (the first call may pay the one-time g++ build) and raises
    if that fails. Call it BEFORE taking a lock."""
    if env_disabled():
        return False
    load()
    return True


# -- store.bind_many (dict rows) -------------------------------------------------

def bind_prepare(pods: dict, bindings, prepared: list, errors: list) -> None:
    """Phase 1 (validate + ONE bind clone a pod; caller holds the pods
    shard). Appends (key, old, new, node_name) to prepared."""
    _lib.hc_bind_prepare(pods, bindings, prepared, errors)


def bind_commit(pods: dict, prepared: list, events: list, errors: list, rv: int,
                mode: int, commit_ts, cloner, etype: str) -> Tuple[int, int]:
    """Phase 2 (RV stamp + row swap + event append; caller holds global +
    shard). mode: 0 share / 1 lazy / 2 eager. Returns (final_rv, bound)."""
    return _lib.hc_bind_commit(pods, prepared, events, errors, rv, mode, commit_ts,
                               cloner, etype)


def delete_commit(pods: dict, keys, events: list, errors: list, rv: int, mode: int,
                  commit_ts, cloner, etype: str) -> Tuple[int, int]:
    """Batched pod-delete commit (caller holds global + shard): one
    structural clone a pod, DELETED events, then the rows popped. Returns
    (final_rv, deleted)."""
    return _lib.hc_delete_commit(pods, keys, events, errors, rv, mode, commit_ts,
                                 cloner, etype)


def columnar_prepare(key2row: dict, bindings, node_ids: dict, node_names: list,
                     node_id_col: np.ndarray, errors: list):
    """Columnar bind_many phase 1 (caller holds the pods shard): the
    validate/intern loop of store/columnar.py PodColumns.bind_prepare on the
    column arrays, no clones. Returns (rows int32[count], ids int32[count],
    keys list); mutates node_ids/node_names and errors exactly like the
    Python loop. bindings must be a sequence."""
    n = len(bindings)
    rows = np.empty(n, dtype=np.int32)
    ids = np.empty(n, dtype=np.int32)
    keys: list = []
    if n == 0:
        return rows, ids, keys
    count = _lib.hc_columnar_prepare(key2row, bindings, node_ids, node_names, errors,
                                     keys, node_id_col, rows, ids)
    return rows[:count], ids[:count], keys


# -- cache assume --------------------------------------------------------------

def assume_structural(pairs, pod_nodes: dict, assumed: dict, nodes: dict,
                      failed: list) -> None:
    """Cache.assume_pods_structural's loop (caller holds the cache lock;
    the check_ports=False form only: host-port batches take the Python
    loop)."""
    _lib.hc_assume_structural(pairs, pod_nodes, assumed, nodes, failed)


# -- build_pod_batch -----------------------------------------------------------

def batch_rows(pods, sig_to_class: dict, rep_pods: list, req_cache: dict, sig_cb,
               entry_cb) -> Tuple[np.ndarray, np.ndarray]:
    """The fused per-pod loop of build_pod_batch: returns (class_of_pod
    int32[P], entry_rows int32[P]); mutates sig_to_class/rep_pods/req_cache
    exactly like the Python loop (misses call back into sig_cb/entry_cb)."""
    n = len(pods)
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy()
    class_rows = np.empty(n, dtype=np.int32)
    entry_rows = np.empty(n, dtype=np.int32)
    _lib.hc_batch_rows(pods, sig_to_class, rep_pods, req_cache, sig_cb, entry_cb,
                       class_rows, entry_rows)
    return class_rows, entry_rows
