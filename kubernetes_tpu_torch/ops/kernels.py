"""Build, bind and launch the hand-written CUDA kernels of the port.

Each `csrc/*.cu` source has a plain C interface and is compiled on first use
by nvcc for sm_90a into its own shared library under `build/torch_kernels/`
(named by a hash of source and flags, so an edited source rebuilds), then
loaded with ctypes. The build uses only the sources in this checkout; a
missing nvcc or a failed build raises.

The launch wrappers check device, dtype, shape and contiguity, launch on
torch's current stream without synchronizing, raise if the C entry returns a
CUDA error, and count their launches in LAUNCHES (a launch is counted where
it happens and nowhere else).

  greedy_scan  kernel A, csrc/greedy_scan.cu  <- ops/solver.py greedy_scan_solve
  row_scatter  kernel B, csrc/row_scatter.cu  <- snapshot/tensorizer.py scatter_rows/_cols
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from .solver import FIELD_DTYPES, SolverInputs

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"greedy_scan": "greedy_scan.cu", "row_scatter": "row_scatter.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc per source, all started together. Returns {name: nvcc/ptxas log}
    (empty for a library that was already built). Raises on any failure."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        if name == "greedy_scan":
            lib.greedy_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.greedy_scan_launch.restype = ctypes.c_int
            lib.greedy_scan_args_size.argtypes = []
            lib.greedy_scan_args_size.restype = ctypes.c_int
            if lib.greedy_scan_args_size() != ctypes.sizeof(_GreedyScanArgs):
                raise RuntimeError("GreedyScanArgs layout differs between "
                                   "csrc/greedy_scan.cu and ops/kernels.py")
        else:
            lib.row_scatter_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            lib.row_scatter_launch.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
                shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

_INT_DIMS = ("P", "N", "R", "C", "Pt", "SC", "G", "Ct", "St", "RAm", "RNm", "PPm", "Em",
             "Sm", "d_max", "has_ipa", "has_ct", "has_st", "has_gang")
_PTR_FIELDS = (
    "used", "used_nz", "pod_count", "dyn_selcls", "dyn_grp", "port_used",
    "alloc", "max_pods", "filter_ok", "aff_ok", "napref_raw", "has_napref", "taint_cnt",
    "img_score", "class_ports", "topo_id", "class_matches_selcls",
    "ct_class", "ct_key", "ct_sel", "ct_max_skew", "ct_min_domains", "ct_self_match",
    "st_class", "st_key", "st_sel", "st_max_skew",
    "ra_key", "ra_sel", "rn_key", "rn_sel", "pp_key", "pp_sel", "pp_weight",
    "grp_key", "class_holds_grp", "ea_grp", "sym_grp", "sym_weight",
    "class_self_ok", "class_has_ra", "req", "req_nz", "class_of_pod", "balanced_active",
    "gang_bonus", "assignment", "feas", "ignored", "st_sum", "ipa_raw", "ra_pos", "ra_keys",
    "dom_global")


class _GreedyScanArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in _INT_DIMS]
                + [(f, ctypes.c_void_p) for f in _PTR_FIELDS])


# largest dynamic shared memory the domain scratch may take before it moves
# to global memory (the card allows 227 KB per block)
_MAX_DOM_SMEM = 160 * 1024


def launch_greedy_scan(inp: SolverInputs, d_max: int, has_ipa: bool, has_ct: bool,
                       has_st: bool, has_gang: bool):
    """Kernel A on CUDA tensors: returns (assignment [P] int32, used [N, R],
    pod_count [N]) like greedy_scan_solve_plain. The carried state is scratch
    copied from the inputs; the inputs are not modified."""
    device = inp.alloc.device
    n, r = inp.alloc.shape
    c = inp.filter_ok.shape[0]
    p = inp.req.shape[0]
    pt = inp.class_ports.shape[1]
    kk = inp.topo_id.shape[0]
    sc = inp.selcls_count.shape[0]
    g = inp.grp_count.shape[0]
    if n < 1:
        raise ValueError("greedy_scan: needs at least one node")
    if r < 2:
        raise ValueError("greedy_scan: needs the cpu and memory resource columns")
    shapes = {
        "alloc": (n, r), "used": (n, r), "used_nz": (n, r), "pod_count": (n,),
        "max_pods": (n,), "filter_ok": (c, n), "aff_ok": (c, n), "napref_raw": (c, n),
        "has_napref": (c,), "taint_cnt": (c, n), "img_score": (c, n), "class_ports": (c, pt),
        "node_ports": (n, pt), "topo_id": (kk, n), "selcls_count": (sc, n),
        "class_matches_selcls": (c, sc), "grp_count": (g, n), "class_holds_grp": (c, g),
        "grp_key": (g,), "class_self_ok": (c,), "class_has_ra": (c,), "req": (p, r),
        "req_nz": (p, r), "class_of_pod": (p,), "balanced_active": (p,),
        "gang_bonus": (c, n),
    }
    # per-class term tables: [C, m] with one m per table family
    for family in (("ra_key", "ra_sel"), ("rn_key", "rn_sel"),
                   ("pp_key", "pp_sel", "pp_weight"), ("ea_grp",), ("sym_grp", "sym_weight")):
        lead = getattr(inp, family[0])
        width = lead.shape[1] if lead.dim() == 2 else -1
        for name in family:
            shapes[name] = (c, width)
    ct, st = inp.ct_class.shape[0], inp.st_class.shape[0]
    for name in FIELD_DTYPES:
        if name.startswith("ct_"):
            shapes[name] = (ct,)
        elif name.startswith("st_"):
            shapes[name] = (st,)
    for name, dtype in FIELD_DTYPES.items():
        if name == "gang_bonus" and not has_gang:
            continue
        t = getattr(inp, name)
        if t is None:
            raise ValueError(f"greedy_scan: {name} is missing")
        _check_cuda(t, name, dtype, device, shapes[name])

    def scratch(src):
        return torch.empty_like(src).copy_(src)

    used, used_nz, pod_count = scratch(inp.used), scratch(inp.used_nz), scratch(inp.pod_count)
    dyn_selcls, dyn_grp = scratch(inp.selcls_count), scratch(inp.grp_count)
    port_used = scratch(inp.node_ports)
    assignment = torch.empty(p, dtype=torch.int32, device=device)
    per_node = {k: torch.empty(n, dtype=torch.int32, device=device)
                for k in ("feas", "ignored", "ipa_raw", "ra_pos", "ra_keys")}
    st_sum = torch.empty(n, dtype=torch.float32, device=device)
    dom_bytes = 2 * (d_max + 1) * 4
    dom_global = None
    smem = dom_bytes
    if dom_bytes > _MAX_DOM_SMEM:
        dom_global = torch.empty(2 * (d_max + 1), dtype=torch.int32, device=device)
        smem = 0

    args = _GreedyScanArgs(
        P=p, N=n, R=r, C=c, Pt=pt, SC=sc, G=g, Ct=ct, St=st,
        RAm=inp.ra_key.shape[1], RNm=inp.rn_key.shape[1], PPm=inp.pp_key.shape[1],
        Em=inp.ea_grp.shape[1], Sm=inp.sym_grp.shape[1], d_max=d_max,
        has_ipa=int(has_ipa), has_ct=int(has_ct), has_st=int(has_st), has_gang=int(has_gang))
    carried = dict(used=used, used_nz=used_nz, pod_count=pod_count, dyn_selcls=dyn_selcls,
                   dyn_grp=dyn_grp, port_used=port_used, assignment=assignment,
                   st_sum=st_sum, dom_global=dom_global, **per_node)
    for f in _PTR_FIELDS:
        t = carried[f] if f in carried else getattr(inp, f)
        if f == "gang_bonus" and not has_gang:
            t = None
        setattr(args, f, t.data_ptr() if t is not None else None)
    if p == 0:
        return assignment, used, pod_count
    lib = _lib("greedy_scan")
    err = lib.greedy_scan_launch(ctypes.byref(args), smem,
                                 torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["greedy_scan"] += 1
    _raise_on(err, "greedy_scan launch")
    return assignment, used, pod_count


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


def launch_row_scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                       cols: bool) -> None:
    """Kernel B on CUDA tensors, in place: rows (dst[idx[i]] = src[i]) or
    columns (dst[:, idx[i]] = src[:, i]). Index values are produced by the
    host tensorizer and are not re-checked on the device."""
    device = dst.device
    k = idx.shape[0]
    _check_cuda(idx, "idx", torch.int32, device, (k,))
    _check_cuda(dst, "dst", torch.int32, device)
    if cols:
        if dst.dim() != 2:
            raise ValueError("row_scatter: column mode needs a 2-D dst")
        w, n_cols = dst.shape
        _check_cuda(src, "src", torch.int32, device, (w, k))
    else:
        if dst.dim() not in (1, 2):
            raise ValueError("row_scatter: row mode needs a 1-D or 2-D dst")
        w = dst.shape[1] if dst.dim() == 2 else 1
        n_cols = 0
        _check_cuda(src, "src", torch.int32, device, (k, w) if dst.dim() == 2 else (k,))
    if k == 0 or w == 0:
        return
    lib = _lib("row_scatter")
    err = lib.row_scatter_launch(dst.data_ptr(), idx.data_ptr(), src.data_ptr(), k, w, n_cols,
                                 int(cols), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["row_scatter"] += 1
    _raise_on(err, "row_scatter launch")
