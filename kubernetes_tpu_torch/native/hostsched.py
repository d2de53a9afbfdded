"""ctypes loader and wrappers for the host array engine (hostsched.cpp).

The counterpart of `kubernetes_tpu/native/hostsched.py`. The shared object
is compiled at first use by g++ (`-O3 -std=c++17 -shared -fPIC`) into
`build/torch_kernels/`, named by a hash of the source and the flags, and
loaded with ctypes.CDLL, which RELEASES the GIL for every call. It exposes:

  native_commit_deltas  the fused scatter-add of the columnar assume
                        (BatchScheduler._columnar_account)
  native_greedy_solve   solver="native": the sequential greedy placement of
                        a constraint-free batch on the host, placement for
                        placement the scan's (`native_solvable` says which
                        batches it takes)

A failed build or load raises with the compiler's message: there is no
quiet fallback to the numpy loops. These are host engines, not device
fallbacks; a failed CUDA kernel never reroutes here. Never call them under
a store or cache lock (store/store.py, the NATIVE LOCK RULE).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def python_include() -> str:
    """The CPython headers' directory; raises where Python.h is missing."""
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found under {inc!r}: the native commit engine "
                           "(native/hostcommit.cpp) needs the CPython headers")
    return inc


def build_so(name: str, python_headers: bool = False) -> Path:
    """Compile native/<name>.cpp into build/torch_kernels/lib<name>-<hash>.so
    unless that library exists, and return its path. The hash covers the
    source, the flags and (for a C-API source) the CPython headers' path and
    version. Each process builds to its own temp name and renames it into
    place, so concurrent builds never interleave writes. Raises with the
    compiler's message on a failed build."""
    src = HERE / f"{name}.cpp"
    flags = list(GXX_FLAGS)
    if python_headers:
        flags.insert(0, f"-I{python_include()}")
    h = hashlib.sha256()
    h.update(src.read_bytes() + b"\0" + " ".join(flags).encode())
    if python_headers:
        h.update((sysconfig.get_config_var("SOABI") or "").encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build of {src.name} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {src.name} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_so("hostsched")))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.greedy_assign.restype = ctypes.c_int64
        lib.greedy_assign.argtypes = [
            i32p, i32p, i32p, i32p, i32p,  # alloc, used, used_nz, pod_count, max_pods
            u8p, i32p, u8p, i32p, i32p,  # static_ok, napref, has_napref, taint, img
            u8p, u8p,  # class_ports, node_ports
            i32p, i32p, i32p, u8p,  # class_of_pod, req, req_nz, bal_active
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u8p, i32p,  # feas_buf, assignment
        ]
        lib.commit_deltas.restype = ctypes.c_int64
        lib.commit_deltas.argtypes = [
            i64p, i64p, ctypes.c_int64,  # rows, nodes, p
            i64p, i64p, ctypes.c_int64,  # raw_req, raw_req_nz, r
            ctypes.c_int64, ctypes.c_int64,  # p_all, n (bounds)
            i64p, i64p, i64p, u8p,  # d_used, d_used_nz, d_count, touched
        ]
        _lib = lib
        return lib


def commit_deltas_plain(rows, nodes, raw_req, raw_req_nz, n: int):
    """The numpy version of native_commit_deltas (two np.add.at, a bincount,
    a unique): the oracle the engine is held against, and the route the
    HOSTSCHED_NATIVE_COMMIT=0 switch selects."""
    rows = np.asarray(rows, dtype=np.int64)
    nodes = np.asarray(nodes, dtype=np.int64)
    r = raw_req.shape[1] if raw_req.ndim == 2 else 0
    d_used = np.zeros((n, r), dtype=np.int64)
    d_used_nz = np.zeros((n, r), dtype=np.int64)
    np.add.at(d_used, nodes, raw_req[rows])
    np.add.at(d_used_nz, nodes, raw_req_nz[rows])
    d_count = np.bincount(nodes, minlength=n)
    touched = np.unique(nodes)
    return d_used, d_used_nz, d_count, touched


def native_commit_deltas(rows, nodes, raw_req, raw_req_nz, n: int):
    """Fused columnar-assume scatter-add: one C pass over the solved batch
    computing (d_used [N,R] i64, d_used_nz [N,R] i64, d_count [N] i64,
    touched node indices, sorted). The call RELEASES the GIL: never call it
    while holding a store or scheduler lock. An out-of-range node or row
    raises IndexError before anything is written."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    raw_req = np.ascontiguousarray(raw_req, dtype=np.int64)
    raw_req_nz = np.ascontiguousarray(raw_req_nz, dtype=np.int64)
    if raw_req.ndim != 2 or raw_req_nz.shape != raw_req.shape or rows.shape != nodes.shape:
        raise ValueError(f"commit_deltas: raw_req {raw_req.shape}, raw_req_nz "
                         f"{raw_req_nz.shape}, rows {rows.shape}, nodes {nodes.shape}")
    r = raw_req.shape[1]
    d_used = np.zeros((n, r), dtype=np.int64)
    d_used_nz = np.zeros((n, r), dtype=np.int64)
    d_count = np.zeros(n, dtype=np.int64)
    touched = np.zeros(n, dtype=np.uint8)
    rc = lib.commit_deltas(rows, nodes, len(rows), raw_req, raw_req_nz, r,
                           len(raw_req), n, d_used, d_used_nz, d_count, touched)
    if rc:
        i = int(-rc - 1)
        raise IndexError(
            f"commit_deltas: entry {i} out of bounds "
            f"(node {int(nodes[i])} of {n}, row {int(rows[i])} of {len(raw_req)})")
    return d_used, d_used_nz, d_count, np.nonzero(touched)[0]


def native_solvable(batch) -> bool:
    """The engine covers batches with no topology-spread constraints and no
    fallback-class pods (those carry semantics it does not model)."""
    return (batch.ct_class.size == 0 and batch.st_class.size == 0
            and not batch.fallback_class[batch.class_of_pod].any())


def native_greedy_solve(cluster, batch) -> Tuple[np.ndarray, int]:
    """Run the engine on numpy ClusterTensors + PodBatchTensors. Returns
    (assignment [P] int32, -1 for unschedulable, placed count). Raises
    RuntimeError for a batch the engine does not model (check
    native_solvable first)."""
    lib = _load()
    if not native_solvable(batch):
        raise RuntimeError("batch needs topology-spread/fallback semantics")
    t = batch.tables
    n = cluster.n
    p = batch.p
    r = len(cluster.resource_dims)
    used = np.ascontiguousarray(cluster.used, np.int32).copy()
    used_nz = np.ascontiguousarray(cluster.used_nz, np.int32).copy()
    pod_count = np.ascontiguousarray(cluster.pod_count, np.int32).copy()
    node_ports = np.ascontiguousarray(t.node_ports, np.uint8).copy()
    class_ports = np.ascontiguousarray(t.class_ports, np.uint8)
    pt = class_ports.shape[1] if class_ports.size else 0
    if pt == 0:
        class_ports = np.zeros((max(t.filter_ok.shape[0], 1), 1), np.uint8)
        node_ports = np.zeros((n, 1), np.uint8)
    assignment = np.full(p, -1, np.int32)
    feas_buf = np.zeros(n, np.uint8)
    placed = lib.greedy_assign(
        np.ascontiguousarray(cluster.alloc, np.int32), used, used_nz,
        pod_count, np.ascontiguousarray(cluster.max_pods, np.int32),
        np.ascontiguousarray(t.filter_ok, np.uint8),
        np.ascontiguousarray(t.napref_raw, np.int32),
        np.ascontiguousarray(t.has_napref, np.uint8),
        np.ascontiguousarray(t.taint_cnt, np.int32),
        np.ascontiguousarray(t.img_score, np.int32),
        class_ports, node_ports,
        np.ascontiguousarray(batch.class_of_pod, np.int32),
        np.ascontiguousarray(batch.req, np.int32),
        np.ascontiguousarray(batch.req_nz, np.int32),
        np.ascontiguousarray(batch.balanced_active, np.uint8),
        p, n, r, pt, feas_buf, assignment)
    return assignment, int(placed)
