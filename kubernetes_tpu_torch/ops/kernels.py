"""Build, bind and launch the hand-written CUDA kernels of the port.

Each `csrc/*.cu` source has a plain C interface and is compiled on first use
by nvcc for sm_90a into its own shared library under `build/torch_kernels/`
(named by a hash of the source, the `csrc/*.cuh` headers it includes and the
flags, so an edited source or header rebuilds), then loaded with ctypes. The
build uses only the sources in this checkout; a missing nvcc or a failed
build raises.

The launch wrappers check device, dtype, shape and contiguity, launch on
torch's current stream without synchronizing, raise if the C entry returns a
CUDA error, and count their launches in LAUNCHES (a launch is counted where
it happens and nowhere else). Kernels C, D, E, F, G, H, I and J also count
the CUDA kernels their C entry launched (CUDA_LAUNCHES), and the host reads
of their results are counted in HOST_SYNCS (by E's wrapper, and for C and G
by the models that read them). A, C, D, E, F and H are one thread-block
cluster each, J one cluster a row (csrc/cluster_exchange.cuh); D's, E's,
F's, H's and J's layout is planned here (repair_plan, auction_plan,
sinkhorn_plan, rank_align_plan, feasibility_plan) from the shape and the
cluster size; G runs every slice of a cover attempt as one CTA of one
launch; I walks the victims in one block over a tournament tree
(defrag_group).

  greedy_scan   kernel A, csrc/greedy_scan.cu   <- ops/solver.py greedy_scan_solve
  row_scatter   kernel B, csrc/row_scatter.cu   <- snapshot/tensorizer.py TensorCache.device_views
                                                  (scatter_mirrors, scatter_rows/_cols)
  waterfill     kernel C, csrc/waterfill.cu     <- models/waterfill.py waterfill_group
  repair_check  kernel D, csrc/repair_check.cu  <- models/repair.py repair_check
  cover_curve   kernel G, csrc/cover_curve.cu   <- models/gangcover.py cover_curve
  rank_align    kernel H, csrc/rank_align.cu    <- models/gangcover.py rank_align_kernel
  feasibility_rows  kernel J, csrc/feasibility_rows.cu  <- ops/solver.py feasibility_rows
  auction_phase     kernel E, csrc/auction_phase.cu     <- models/transport.py _auction_phase
  sinkhorn          kernel F, csrc/sinkhorn.cu          <- models/transport.py _sinkhorn_iters
  defrag_assign     kernel I, csrc/defrag_assign.cu     <- models/defrag.py defrag_assign
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from .solver import FIELD_DTYPES, SolverInputs, scan_class_rows, scan_key_domains

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"greedy_scan": "greedy_scan.cu", "row_scatter": "row_scatter.cu",
           "waterfill": "waterfill.cu", "repair_check": "repair_check.cu",
           "cover_curve": "cover_curve.cu", "rank_align": "rank_align.cu",
           "feasibility_rows": "feasibility_rows.cu", "auction_phase": "auction_phase.cu",
           "sinkhorn": "sinkhorn.cu", "defrag_assign": "defrag_assign.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
CUDA_LAUNCHES: Dict[str, int] = {"auction_phase": 0, "sinkhorn": 0, "waterfill": 0,
                                 "cover_curve": 0, "feasibility_rows": 0, "defrag_assign": 0,
                                 "repair_check": 0, "rank_align": 0}
HOST_SYNCS: Dict[str, int] = {"auction_phase": 0, "sinkhorn": 0, "waterfill": 0,
                              "cover_curve": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CUDA_LAUNCHES, HOST_SYNCS):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources_of(path: Path, seen=None) -> list:
    """`path` and every file of its directory that it includes with quotes,
    transitively, each once, in include order."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if not dep.is_file():
            raise FileNotFoundError(f"{path.name} includes {dep.name}, which is not in {path.parent}")
        _sources_of(dep, seen)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in _sources_of(CSRC / SOURCES[name]):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def _bind_args_entry(lib: ctypes.CDLL, name: str, struct) -> None:
    """`<name>_launch(const Args*, stream)` plus its layout check."""
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    size = getattr(lib, f"{name}_args_size")
    size.argtypes = []
    size.restype = ctypes.c_int
    if size() != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} layout differs between its csrc/ source "
                           "and ops/kernels.py")


def _bind_cluster_entry(lib: ctypes.CDLL, name: str, args_prefix: str, struct) -> None:
    """A cluster kernel's entries: `<name>_launch(const Args*, stream, int*
    launched)`, `<name>_cluster_size()` and the layout check."""
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    launch.restype = ctypes.c_int
    for fn in (f"{name}_cluster_size", f"{args_prefix}_args_size"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    if getattr(lib, f"{args_prefix}_args_size")() != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} layout differs between csrc/{SOURCES[name]} "
                           "and ops/kernels.py")


def _cluster_size(lib: ctypes.CDLL, name: str) -> int:
    """The kernel's cluster size (16 or 8, chosen once per process by the
    library); raises with the CUDA error if the card refuses both."""
    cs = getattr(lib, f"{name}_cluster_size")()
    if cs <= 0:
        raise RuntimeError(f"{name}: the card schedules no cluster of 16 or 8 CTAs "
                           f"(CUDA error {-cs})")
    return cs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        if name == "greedy_scan":
            _bind_args_entry(lib, name, _GreedyScanArgs)
            lib.greedy_scan_plan.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.greedy_scan_plan.restype = ctypes.c_int
            lib.greedy_scan_plan_size.argtypes = []
            lib.greedy_scan_plan_size.restype = ctypes.c_int
            if lib.greedy_scan_plan_size() != ctypes.sizeof(_GreedyScanPlan):
                raise RuntimeError("GreedyScanPlan layout differs between "
                                   "csrc/greedy_scan.cu and ops/kernels.py")
        elif name == "row_scatter":
            lib.mirror_scatter_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                                  ctypes.c_void_p]
            lib.mirror_scatter_launch.restype = ctypes.c_int
            lib.mirror_set_size.argtypes = []
            lib.mirror_set_size.restype = ctypes.c_int
            if lib.mirror_set_size() != ctypes.sizeof(_MirrorSet):
                raise RuntimeError("MirrorSet layout differs between csrc/row_scatter.cu and "
                                   "ops/kernels.py")
        elif name == "waterfill":
            _bind_cluster_entry(lib, name, name, _WaterfillArgs)
        elif name == "repair_check":
            _bind_cluster_entry(lib, name, name, _RepairCheckArgs)
            lib.repair_check_smem_budget.restype = ctypes.c_int
            lib.repair_check_smem_bytes.argtypes = [ctypes.c_int] * 6
            lib.repair_check_smem_bytes.restype = ctypes.c_longlong
            if (lib.repair_check_smem_budget() != REPAIR_SMEM_BUDGET
                    or any(lib.repair_check_smem_bytes(*shape) != repair_smem_bytes(*shape)
                           for shape in ((0, 16, 1, 2, 10, 10), (1, 8, 3, 40, 5000, 625),
                                         (2, 16, 5, 410, 70000, 4375)))):
                raise RuntimeError("kernel D's layout differs between csrc/repair_check.cu and "
                                   "ops/kernels.py")
        elif name == "cover_curve":
            _bind_args_entry(lib, name, _CoverCurveArgs)
            for fn in (lib.cover_curve_max_r, lib.cover_curve_smem_budget):
                fn.argtypes = []
                fn.restype = ctypes.c_int
        elif name == "rank_align":
            _bind_cluster_entry(lib, name, name, _RankAlignArgs)
            lib.rank_align_smem_rows.restype = ctypes.c_int
            if lib.rank_align_smem_rows() != RANK_ALIGN_SMEM_MAX:
                raise RuntimeError("RA_SMEM_ROWS differs between csrc/rank_align.cu and "
                                   "ops/kernels.py")
        elif name == "feasibility_rows":
            _bind_cluster_entry(lib, name, name, _FeasRowsArgs)
            lib.feasibility_rows_max_clusters.argtypes = [ctypes.c_int]
            lib.feasibility_rows_max_clusters.restype = ctypes.c_int
        elif name == "auction_phase":
            _bind_cluster_entry(lib, name, "auction", _AuctionArgs)
            lib.auction_max_r.argtypes = []
            lib.auction_max_r.restype = ctypes.c_int
        elif name == "defrag_assign":
            _bind_args_entry(lib, name, _DefragArgs)
            lib.defrag_assign_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.POINTER(ctypes.c_int)]
            lib.defrag_assign_max_r.argtypes = []
            lib.defrag_assign_max_r.restype = ctypes.c_int
            lib.defrag_assign_group.argtypes = [ctypes.c_int]
            lib.defrag_assign_group.restype = ctypes.c_int
            lib.defrag_assign_uses_smem.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.defrag_assign_uses_smem.restype = ctypes.c_int
            lib.defrag_assign_stride.argtypes = [ctypes.c_int]
            lib.defrag_assign_stride.restype = ctypes.c_int
            lib.defrag_assign_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.defrag_assign_smem_bytes.restype = ctypes.c_longlong
            if any(lib.defrag_assign_group(n) != defrag_group(n)
                   for n in (1, 5000, 8192, 16385, 1 << 20)):
                raise RuntimeError("the tree's group differs between csrc/defrag_assign.cu and "
                                   "ops/kernels.py")
        else:
            _bind_cluster_entry(lib, name, name, _SinkhornArgs)
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

_INT_DIMS = ("P", "N", "R", "C", "Pt", "SC", "G", "Kk", "Ct", "St", "RAm", "RNm", "PPm", "Em",
             "Sm", "d_max", "has_ipa", "has_ct", "has_st")
_PTR_FIELDS = (
    "used", "used_nz", "pod_count", "port_used", "alloc", "max_pods", "class_rows",
    "class_flags", "key_domains", "aff_ok", "class_ports", "topo_id", "selcls_count", "grp_count",
    "class_matches_selcls", "ct_class", "ct_key", "ct_sel", "ct_max_skew", "ct_min_domains",
    "ct_self_match", "st_class", "st_key", "st_sel", "st_max_skew",
    "ra_key", "ra_sel", "rn_key", "rn_sel", "pp_key", "pp_sel", "pp_weight",
    "grp_key", "class_holds_grp", "ea_grp", "sym_grp", "sym_weight",
    "class_self_ok", "class_has_ra", "req", "req_nz", "class_of_pod", "balanced_active",
    "assignment", "gscratch")


class _GreedyScanArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in _INT_DIMS]
                + [(f, ctypes.c_void_p) for f in _PTR_FIELDS])


class _GreedyScanPlan(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in ("cs", "threads", "chunk", "smem_bytes", "in_smem",
                                             "n_tables")]
                + [("gbytes", ctypes.c_longlong)])


# csrc/greedy_scan.cu's shared-memory regions, in the order they claim it
SCAN_REGIONS = ("pod_rows", "node", "used", "used_nz", "pod_count", "alloc", "max_pods", "st_flags",
                "class_rows", "ports", "domain_tables")
# the last launch's plan: cluster size, threads and shared memory per CTA,
# the regions in shared memory (the rest in the global scratch)
LAST_SCAN_PLAN: Dict[str, object] = {}


def launch_greedy_scan(inp: SolverInputs, d_max: int, has_ipa: bool, has_ct: bool,
                       has_st: bool, has_gang: bool):
    """Kernel A on CUDA tensors: returns (assignment [P] int32, used [N, R],
    pod_count [N]) like greedy_scan_solve_plain. The carried state is scratch
    copied from the inputs; the inputs are not modified. One launch is one
    thread-block cluster."""
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
    port_used = scratch(inp.node_ports)
    assignment = torch.empty(p, dtype=torch.int32, device=device)
    if p == 0:
        return assignment, used, pod_count
    class_rows, class_flags = scan_class_rows(inp, has_gang)
    args = _GreedyScanArgs(
        P=p, N=n, R=r, C=c, Pt=pt, SC=sc, G=g, Kk=kk, Ct=ct, St=st,
        RAm=inp.ra_key.shape[1], RNm=inp.rn_key.shape[1], PPm=inp.pp_key.shape[1],
        Em=inp.ea_grp.shape[1], Sm=inp.sym_grp.shape[1], d_max=d_max,
        has_ipa=int(has_ipa), has_ct=int(has_ct), has_st=int(has_st))
    ptrs = dict(used=used, used_nz=used_nz, pod_count=pod_count, port_used=port_used,
                class_rows=class_rows, class_flags=class_flags,
                key_domains=scan_key_domains(inp.topo_id),
                balanced_active=inp.balanced_active.to(torch.int32), assignment=assignment)
    for f in _PTR_FIELDS[:-1]:
        t = ptrs[f] if f in ptrs else getattr(inp, f)
        setattr(args, f, t.data_ptr() if t.numel() else None)
    lib = _lib("greedy_scan")
    plan = _GreedyScanPlan()
    _raise_on(lib.greedy_scan_plan(ctypes.byref(args), ctypes.byref(plan)), "greedy_scan plan")
    gscratch = None
    if plan.gbytes:
        gscratch = torch.empty(plan.cs * plan.gbytes, dtype=torch.uint8, device=device)
        args.gscratch = gscratch.data_ptr()
    LAST_SCAN_PLAN.clear()
    LAST_SCAN_PLAN.update(
        cluster_size=plan.cs, ctas=plan.cs, threads=plan.threads, nodes_per_cta=plan.chunk,
        smem_bytes=plan.smem_bytes, domain_tables=plan.n_tables,
        global_bytes_per_cta=plan.gbytes,
        in_smem=[nm for i, nm in enumerate(SCAN_REGIONS) if plan.in_smem >> i & 1])
    err = lib.greedy_scan_launch(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["greedy_scan"] += 1
    _raise_on(err, "greedy_scan launch")
    return assignment, used, pod_count


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


class _MirrorDesc(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("width", ctypes.c_int), ("offset", ctypes.c_int),
                ("col_mode", ctypes.c_int), ("n_cols", ctypes.c_int)]


MAX_MIRRORS = 8


class _MirrorSet(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("W", ctypes.c_int), ("d", _MirrorDesc * MAX_MIRRORS)]


_I32 = torch.int32
# the current stream's handle as an int without building a Stream object
# (the call Triton's launcher makes); the public call where torch lacks it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_handle(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


class MirrorSet:
    """Kernel B's descriptors for one set of device mirrors: checked once,
    when the mirrors are allocated or change, then reused by every fused
    launch. `segments` is a list of (mirror, offset, width, col_mode): the
    mirror's slice of the packed rows [k, W], whose column 0 holds the row
    indices. Row mode: mirror [N, width] (or [N] for width 1); column mode:
    mirror [width, N]."""

    def __init__(self, segments, W: int):
        if not 1 <= len(segments) <= MAX_MIRRORS:
            raise ValueError(f"mirror_scatter: 1 to {MAX_MIRRORS} mirrors, got {len(segments)}")
        device = segments[0][0].device
        if device.type != "cuda":
            raise ValueError(f"mirror_scatter: mirrors on {device}, expected a CUDA device")
        self.device = device
        self.W = W
        self.key = self.key_of(segments, W)
        self.struct = _MirrorSet(n=len(segments), W=W)
        for m, (dst, offset, width, col_mode) in enumerate(segments):
            _check_cuda(dst, f"mirror {m}", _I32, device)
            if col_mode:
                if dst.dim() != 2 or dst.shape[0] != width:
                    raise ValueError(f"mirror {m}: column mode needs [{width}, N], got "
                                     f"{tuple(dst.shape)}")
            elif (dst.dim() == 2 and dst.shape[1] != width) or dst.dim() not in (1, 2) or (
                    dst.dim() == 1 and width != 1):
                raise ValueError(f"mirror {m}: row mode needs [N, {width}], got "
                                 f"{tuple(dst.shape)}")
            if not (1 <= offset and offset + width <= W):
                raise ValueError(f"mirror {m}: segment [{offset}, {offset + width}) outside "
                                 f"the packed row [1, {W})")
            self.struct.d[m] = _MirrorDesc(dst=dst.data_ptr(), width=width, offset=offset,
                                           col_mode=int(bool(col_mode)),
                                           n_cols=dst.shape[1] if col_mode else 0)

    @staticmethod
    def key_of(segments, W: int):
        """What the descriptors depend on: a set is reused while this holds."""
        return (W,) + tuple((t.data_ptr(), tuple(t.shape), o, w, c) for t, o, w, c in segments)


def launch_mirror_scatter(mset: MirrorSet, packed: torch.Tensor, k: int) -> None:
    """Kernel B, fused: one launch writes rows 0..k-1 of `packed` ([>= k, W]
    int32 on the mirrors' device) into every mirror of `mset`. Only the
    packed buffer and the count are checked here (the mirrors were checked
    when the set was built). Row indices are produced by the host tensorizer
    and are not re-checked on the device."""
    if not (packed.dtype is _I32 and packed.device == mset.device and packed.dim() == 2
            and packed.shape[1] == mset.W and packed.is_contiguous()
            and 0 <= k <= packed.shape[0]):
        _check_cuda(packed, "packed", _I32, mset.device)
        raise ValueError(f"mirror_scatter: packed {tuple(packed.shape)} does not hold {k} rows "
                         f"of width {mset.W}")
    if k == 0:
        return
    err = _lib("row_scatter").mirror_scatter_launch(ctypes.byref(mset.struct), packed.data_ptr(),
                                                    k, _stream_handle(packed.get_device()))
    LAUNCHES["row_scatter"] += 1
    _raise_on(err, "mirror_scatter launch")


def launch_row_scatter(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                       cols: bool) -> None:
    """Kernel B with one mirror, in place: rows (dst[idx[i]] = src[i]) or
    columns (dst[:, idx[i]] = src[:, i]). The same launch as the fused form,
    with one descriptor, on [idx | src] packed on the device. Index values
    are produced by the host tensorizer and are not re-checked on the
    device."""
    device = dst.device
    k = idx.shape[0]
    if cols:
        if dst.dim() != 2:
            raise ValueError("row_scatter: column mode needs a 2-D dst")
        w = dst.shape[0]
        want = (w, k)
    else:
        if dst.dim() not in (1, 2):
            raise ValueError("row_scatter: row mode needs a 1-D or 2-D dst")
        w = dst.shape[1] if dst.dim() == 2 else 1
        want = (k, w) if dst.dim() == 2 else (k,)
    _check_cuda(idx, "idx", _I32, device, (k,))
    _check_cuda(src, "src", _I32, device, want)
    if k == 0 or w == 0:
        return
    mset = MirrorSet([(dst, 1, w, cols)], 1 + w)
    packed = torch.cat([idx.view(k, 1), src.t() if cols else src.view(k, w)], dim=1)
    launch_mirror_scatter(mset, packed, k)


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------

_WF_INTS = ("N", "R", "j_max", "k_slots", "group_size", "has_port", "has_gang", "cs", "chunk",
            "list_cap")
_WF_PTRS = ("alloc", "used", "used_nz", "pod_count", "max_pods", "filter_ok", "port_conflict",
            "napref", "has_napref", "taint", "img", "gang", "req", "req_nz", "bal_active",
            "k_per_node", "chosen_nodes", "gscratch")
# The callers' slot budgets keep score * (N * j_max + 1) below 2^31
# (models/waterfill.py waterfill_solve: 2,600,000 slots at scores <= 800,
# 2,300,000 with the gang bonus; models/repair.py: 1,900,000 at <= 1,100).
# Kernel C's rows are sorted only while keys do not wrap, so the wrapper
# raises for an N * j_max above every budget.
WATERFILL_MAX_SLOTS = 2_600_000
# kernel C's dynamic shared memory a CTA (WF_SMEM_BUDGET in csrc/waterfill.cu)
WATERFILL_SMEM_BUDGET = 216 * 1024
WATERFILL_THREADS = 512
# the last launch's plan: cluster size, threads and nodes a CTA, the global
# fallback slice a CTA
LAST_WATERFILL_PLAN: Dict[str, object] = {}


class _WaterfillArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in _WF_INTS] + [("slice_bytes", ctypes.c_longlong)]
                + [(f, ctypes.c_void_p) for f in _WF_PTRS])


def _check_flag(x: torch.Tensor, name: str, device: torch.device) -> None:
    """A one-element bool tensor on `device` (an element of a class/pod table)."""
    _check_cuda(x, name, torch.bool, device)
    if x.numel() != 1:
        raise ValueError(f"{name}: expected one element, got shape {tuple(x.shape)}")


def launch_waterfill_group(alloc, used, used_nz, pod_count, max_pods,
                           filter_ok_row, port_conflict_row, has_port, napref_row, has_napref,
                           taint_row, img_row, req, req_nz, bal_active, group_size: int,
                           j_max: int, k_slots: int, gang_row=None, has_gang: bool = False):
    """Kernel C on CUDA tensors: returns (k_per_node [N] int32, chosen_nodes
    [k_slots] int32) like waterfill_group_plain. One launch of one
    thread-block cluster on the current stream; the inputs are not modified."""
    global LAST_WATERFILL_PLAN
    device = alloc.device
    n, r = alloc.shape
    if n < 1 or r < 2:
        raise ValueError("waterfill: needs at least one node and the cpu/memory columns")
    if j_max < 1 or not 1 <= k_slots <= n * j_max:
        raise ValueError(f"waterfill: k_slots {k_slots} outside [1, N*j_max = {n * j_max}]")
    if n * j_max > WATERFILL_MAX_SLOTS:
        raise ValueError(f"waterfill: N*j_max = {n * j_max} above {WATERFILL_MAX_SLOTS}: keys "
                         "may wrap int32, and kernel C needs rows that do not")
    if has_gang and gang_row is None:
        raise ValueError("waterfill: has_gang needs gang_row")
    nr, n1, r1, i32, b8 = (n, r), (n,), (r,), torch.int32, torch.bool
    _check_all(device, (
        ("alloc", alloc, i32, nr), ("used", used, i32, nr), ("used_nz", used_nz, i32, nr),
        ("pod_count", pod_count, i32, n1), ("max_pods", max_pods, i32, n1),
        ("filter_ok_row", filter_ok_row, b8, n1), ("port_conflict_row", port_conflict_row, b8, n1),
        ("napref_row", napref_row, i32, n1), ("taint_row", taint_row, i32, n1),
        ("img_row", img_row, i32, n1), ("req", req, i32, r1), ("req_nz", req_nz, i32, r1))
        + ((("gang_row", gang_row, i32, n1),) if has_gang else ()))
    for name, x in (("has_napref", has_napref), ("bal_active", bal_active)):
        if not (x.dtype is b8 and x.device == device and x.numel() == 1 and x.is_contiguous()):
            _check_flag(x, name, device)
    lib = _lib("waterfill")
    cs = _cluster_size(lib, "waterfill")
    chunk = -(-n // cs)
    list_cap = 1 << (min(k_slots, chunk * j_max) - 1).bit_length()
    # a CTA's global fallback slice: 12 node arrays, its key rows, its list
    slice_bytes = _align16(12 * (chunk + 1) * 4) + _align16(chunk * j_max * 4) + list_cap * 8
    k_per_node = torch.empty(n, dtype=torch.int32, device=device)
    chosen = torch.empty(k_slots, dtype=torch.int32, device=device)
    gscratch = torch.empty(cs * slice_bytes, dtype=torch.uint8, device=device)
    ptrs = dict(alloc=alloc, used=used, used_nz=used_nz, pod_count=pod_count, max_pods=max_pods,
                filter_ok=filter_ok_row, port_conflict=port_conflict_row, napref=napref_row,
                has_napref=has_napref, taint=taint_row, img=img_row,
                gang=gang_row if has_gang else None, req=req, req_nz=req_nz,
                bal_active=bal_active, k_per_node=k_per_node, chosen_nodes=chosen,
                gscratch=gscratch)
    args = _WaterfillArgs(N=n, R=r, j_max=j_max, k_slots=k_slots,
                          group_size=max(0, min(int(group_size), 2**31 - 1)),
                          has_port=int(bool(has_port)), has_gang=int(bool(has_gang)), cs=cs,
                          chunk=chunk, list_cap=list_cap, slice_bytes=slice_bytes)
    for f in _WF_PTRS:
        t = ptrs[f]
        setattr(args, f, t.data_ptr() if t is not None else None)
    LAST_WATERFILL_PLAN = dict(cluster_size=cs, threads=WATERFILL_THREADS, nodes_per_cta=chunk,
                               smem_bytes=WATERFILL_SMEM_BUDGET,
                               global_bytes_per_cta=slice_bytes)
    launched = ctypes.c_int(0)
    err = lib.waterfill_launch(ctypes.byref(args), _stream_handle(alloc.get_device()),
                               ctypes.byref(launched))
    LAUNCHES["waterfill"] += 1
    CUDA_LAUNCHES["waterfill"] += launched.value
    _raise_on(err, "waterfill launch")
    return k_per_node, chosen


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------

_RC_INTS = ("Pb", "N", "Kk", "SC", "G", "RNm", "EAm", "RAm", "Ct", "d_max", "has_affinity",
            "has_ct", "cs", "mode", "rows", "slice", "node_chunk", "pod_chunk", "smem_bytes")
_RC_PTRS = ("node_of", "cls_of", "dyn_selcls", "dyn_grp", "topo_id", "rn_key", "rn_sel",
            "ea_grp", "ra_key", "ra_sel", "class_matches", "class_holds", "grp_key", "aff_ok",
            "ct_class", "ct_key", "ct_sel", "ct_max_skew", "ct_min_domains", "out", "gtab")


class _RepairCheckArgs(ctypes.Structure):
    _fields_ = [(d, ctypes.c_int) for d in _RC_INTS] + [(f, ctypes.c_void_p) for f in _RC_PTRS]


REPAIR_SMEM_BUDGET = 220 * 1024  # RC_SMEM_BUDGET in csrc/repair_check.cu
REPAIR_MODES = ("replicate", "owner", "global")
# the last launch's plan
LAST_REPAIR_PLAN: Dict[str, object] = {}


def repair_smem_bytes(mode: int, cs: int, ct: int, rows: int, d_max: int, slice_: int) -> int:
    """Kernel D's dynamic shared memory a CTA (rc_layout in csrc/): each
    spread row's minimum, the (n_valid, min) slots of modes 1-2, the table
    (mode 0 every domain, mode 1 the owned slice) and mode 0's CS slots."""
    size = _align16(4 * ct) + (_align16(8 * cs * ct) if mode else 0)
    size += _align16(4 * rows * (d_max if mode == 0 else slice_ if mode == 1 else 0))
    return size + (_align16(4 * cs * rows * d_max) if mode == 0 else 0)


@functools.lru_cache(maxsize=64)
def repair_plan(pb: int, n: int, kk: int, m: int, ct: int, d_max: int, has_affinity: bool,
                has_ct: bool, cs: int) -> Dict[str, object]:
    """Kernel D's layout on one cluster of `cs` CTAs: CTA r takes the nodes
    [r * node_chunk, ...) and the pods [r * pod_chunk, ...); the table's
    rows are Kk x (SC + G) (key, count row) pairs (has_affinity) and two a
    spread row (has_ct: counts, eligible nodes). Mode 0 (replicate) where
    every CTA can hold the whole table and CS slots of it, mode 1 (owner)
    where a 1/cs slice of the domains fits a CTA, else mode 2 (global: the
    owners' slices in a global scratch). The plan is cached by shape;
    callers must not modify it."""
    rows = (kk * m if has_affinity else 0) + (2 * ct if has_ct else 0)
    slice_ = -(-d_max // cs)
    # node slices of whole quads (a thread reads four adjacent nodes)
    nodes = -(-n // cs)
    nodes += -nodes % 4
    for mode in (0, 1, 2):
        sl = d_max if mode == 0 else slice_
        smem = repair_smem_bytes(mode, cs, ct, rows, d_max, sl)
        if smem <= REPAIR_SMEM_BUDGET:
            break
    else:
        raise ValueError(f"repair_check: {ct} spread rows exceed the shared memory of a CTA")
    return dict(cluster_size=cs, mode=REPAIR_MODES[mode], mode_id=mode, rows=rows,
                domains_per_cta=sl, nodes_per_cta=nodes, pods_per_cta=-(-pb // cs),
                smem_bytes=smem, global_bytes=4 * cs * rows * sl if mode == 2 else 0)


_RC_NAMES = _RC_PTRS[:19]


@functools.lru_cache(maxsize=64)
def _repair_launch(pb, n, kk, sc, g, c, rnm, eam, ram, ct, d_max, has_affinity, has_ct, cs):
    """(plan, the args' fixed fields as bytes) of one shape."""
    plan = repair_plan(pb, n, kk, sc + g, ct, d_max, has_affinity, has_ct, cs)
    args = _RepairCheckArgs(Pb=pb, N=n, Kk=kk, SC=sc, G=g, RNm=rnm, EAm=eam, RAm=ram, Ct=ct,
                            d_max=d_max, has_affinity=int(has_affinity), has_ct=int(has_ct),
                            cs=cs, mode=plan["mode_id"], rows=plan["rows"],
                            slice=plan["domains_per_cta"], node_chunk=plan["nodes_per_cta"],
                            pod_chunk=plan["pods_per_cta"], smem_bytes=plan["smem_bytes"])
    return plan, bytes(args)


def launch_repair_check_packed(node_of, cls_of, dyn_selcls, dyn_grp, topo_id,
                               rn_key, rn_sel, ea_grp, ra_key, ra_sel,
                               class_matches, class_holds, grp_key, aff_ok,
                               ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains,
                               d_max: int, has_affinity: bool = True,
                               has_ct: bool = True) -> torch.Tensor:
    """Kernel D on CUDA tensors: returns one [4, Pb] bool tensor, its rows
    the masks of repair_check_plain. One launch of one thread-block cluster
    (repair_plan); the inputs are not modified."""
    global LAST_REPAIR_PLAN
    ins = (node_of, cls_of, dyn_selcls, dyn_grp, topo_id, rn_key, rn_sel, ea_grp, ra_key, ra_sel,
           class_matches, class_holds, grp_key, aff_ok, ct_class, ct_key, ct_sel, ct_max_skew,
           ct_min_domains)
    device = node_of.device
    pb = node_of.shape[0]
    kk, n = topo_id.shape
    sc, g = dyn_selcls.shape[0], dyn_grp.shape[0]
    c = aff_ok.shape[0]
    ct = ct_class.shape[0]
    rnm, eam, ram = rn_key.shape[-1], ea_grp.shape[-1], ra_key.shape[-1]
    if d_max < 1:
        raise ValueError("repair_check: d_max must be >= 1")
    shapes = ((pb,), (pb,), (sc, n), (g, n), (kk, n), (c, rnm), (c, rnm), (c, eam), (c, ram),
              (c, ram), (c, sc), (c, g), (g,), (c, n), (ct,), (ct,), (ct,), (ct,), (ct,))
    index = node_of.get_device()
    for i, (t, shape) in enumerate(zip(ins, shapes)):
        dtype = torch.bool if i == 13 else torch.int32
        if not (t.dtype is dtype and t.shape == shape and t.is_contiguous()
                and t.get_device() == index):
            _check_cuda(t, _RC_NAMES[i], dtype, device, shape)
    out = torch.empty((4, pb), dtype=torch.bool, device=device)
    if pb == 0:
        return out
    if n < 1:
        raise ValueError("repair_check: needs at least one node")
    has_ct = bool(has_ct) and ct > 0
    lib = _lib("repair_check")
    plan, template = _repair_launch(pb, n, kk, sc, g, c, rnm, eam, ram, ct, d_max,
                                    bool(has_affinity), has_ct, _cluster_size(lib, "repair_check"))
    gtab = (torch.empty(plan["global_bytes"] // 4, dtype=torch.int32, device=device)
            if plan["mode_id"] == 2 else None)
    args = _RepairCheckArgs.from_buffer_copy(template)
    # the pointers in one assignment (an empty tensor's is never read)
    (ctypes.c_void_p * len(_RC_PTRS)).from_buffer(args, _RepairCheckArgs.node_of.offset)[:] = [
        t.data_ptr() for t in ins] + [out.data_ptr(), gtab.data_ptr() if gtab is not None else None]
    LAST_REPAIR_PLAN = plan
    launched = ctypes.c_int(0)
    err = lib.repair_check_launch(ctypes.byref(args), _stream_handle(index),
                                  ctypes.byref(launched))
    LAUNCHES["repair_check"] += 1
    CUDA_LAUNCHES["repair_check"] += launched.value
    _raise_on(err, "repair_check launch")
    return out


def launch_repair_check(node_of, cls_of, dyn_selcls, dyn_grp, topo_id,
                        rn_key, rn_sel, ea_grp, ra_key, ra_sel,
                        class_matches, class_holds, grp_key, aff_ok,
                        ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains,
                        d_max: int, has_affinity: bool = True, has_ct: bool = True):
    """Kernel D on CUDA tensors: returns the four [Pb] bool masks like
    repair_check_plain, as views of one [4, Pb] tensor. The inputs are not
    modified."""
    return tuple(launch_repair_check_packed(
        node_of, cls_of, dyn_selcls, dyn_grp, topo_id, rn_key, rn_sel, ea_grp, ra_key, ra_sel,
        class_matches, class_holds, grp_key, aff_ok, ct_class, ct_key, ct_sel, ct_max_skew,
        ct_min_domains, d_max, has_affinity, has_ct).unbind(0))


# ---------------------------------------------------------------------------
# kernel G
# ---------------------------------------------------------------------------


class _CoverCurveArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in ("S", "n_slots", "k_max", "R", "in_smem",
                                             "slice_words")]
                + [(f, ctypes.c_void_p) for f in ("free", "headroom", "eligible", "v_node",
                                                  "v_req", "req", "caps", "gscratch")])


def launch_cover_curve(free, headroom, eligible, v_node, v_req, req) -> torch.Tensor:
    """Kernel G on CUDA tensors for one slice: returns caps [k_max + 1] int32
    like cover_curve_plain. The inputs are not modified."""
    device = free.device
    if free.dim() != 2:
        raise ValueError("cover_curve: free must be [n_slots, R]")
    n_slots, r = free.shape
    k_max = v_node.shape[0] if v_node.dim() == 1 else -1
    _check_all(device, (
        ("free", free, torch.int32, (n_slots, r)),
        ("headroom", headroom, torch.int32, (n_slots,)),
        ("eligible", eligible, torch.bool, (n_slots,)),
        ("v_node", v_node, torch.int32, (k_max,)),
        ("v_req", v_req, torch.int32, (k_max, r)), ("req", req, torch.int32, (r,))))
    return launch_cover_curves(free[None], headroom[None], eligible[None], v_node[None],
                               v_req[None], req)[0]


def launch_cover_curves(free, headroom, eligible, v_node, v_req, req) -> torch.Tensor:
    """Kernel G on CUDA tensors for S slices at once (one CTA a slice, one
    launch): free [S, n_slots, R], headroom and eligible [S, n_slots],
    v_node [S, k_max], v_req [S, k_max, R], req [R]; returns caps [S, k_max +
    1] int32 like cover_curve_batch_plain. The inputs are not modified."""
    device = free.device
    if free.dim() != 3:
        raise ValueError("cover_curves: free must be [S, n_slots, R]")
    s, n_slots, r = free.shape
    k_max = v_node.shape[1] if v_node.dim() == 2 else -1
    _check_all(device, (
        ("free", free, torch.int32, (s, n_slots, r)),
        ("headroom", headroom, torch.int32, (s, n_slots)),
        ("eligible", eligible, torch.bool, (s, n_slots)),
        ("v_node", v_node, torch.int32, (s, k_max)),
        ("v_req", v_req, torch.int32, (s, k_max, r)), ("req", req, torch.int32, (r,))))
    lib = _lib("cover_curve")
    if not 1 <= r <= lib.cover_curve_max_r():
        raise ValueError(f"cover_curve: R = {r} outside [1, {lib.cover_curve_max_r()}]")
    caps = torch.empty((s, k_max + 1), dtype=torch.int32, device=device)
    # a slice's regions: node counts, free, headroom and eligible, then
    # v_node, v_req, rank, sorted order, R prefix rows and the curve
    words = n_slots * (3 + r) + k_max * (3 + 2 * r) + k_max + 1
    if words > 2**31 - 1:
        raise ValueError(f"cover_curve: {words} scratch words a slice exceed int32")
    in_smem = words * 4 <= lib.cover_curve_smem_budget()
    gscratch = None if in_smem else torch.empty(s * words, dtype=torch.int32, device=device)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    args = _CoverCurveArgs(S=s, n_slots=n_slots, k_max=k_max, R=r, in_smem=int(in_smem),
                           slice_words=words, free=ptr(free), headroom=ptr(headroom),
                           eligible=ptr(eligible), v_node=ptr(v_node), v_req=ptr(v_req),
                           req=req.data_ptr(), caps=caps.data_ptr(), gscratch=ptr(gscratch))
    err = lib.cover_curve_launch(ctypes.byref(args), _stream_handle(free.get_device()))
    LAUNCHES["cover_curve"] += 1
    CUDA_LAUNCHES["cover_curve"] += int(s > 0)
    _raise_on(err, "cover_curve launch")
    return caps


# ---------------------------------------------------------------------------
# kernel H
# ---------------------------------------------------------------------------

# rows a CTA of kernel H sorts in shared memory at a time (RA_SMEM_ROWS in
# csrc/): the largest chunk the plan takes (a smaller chunk means more of
# the team's merge levels)
RANK_ALIGN_SMEM_MAX = 8192
# the last launch's plan
LAST_RANK_ALIGN_PLAN: Dict[str, object] = {}


class _RankAlignArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in ("p_max", "cs", "active", "slice", "chunk",
                                             "smem_bytes")]
                + [(f, ctypes.c_void_p) for f in ("assignment", "group_id", "rank", "pos_key",
                                                  "out", "gkey", "gidx")])


def rank_align_plan(p_max: int, cs: int, smem_rows: Optional[int] = None) -> Dict[str, object]:
    """Kernel H's layout for p_max rows on a cluster of `cs` CTAs, cs / 2 a
    sort: `active` CTAs of a team hold a slice of p_max / active rows (at
    least 32 rows, one warp's run, where p_max allows), sorted in chunks of
    at most `smem_rows` (default RANK_ALIGN_SMEM_MAX) in shared memory and
    written to a global scratch, through which the team then merges them
    level by level."""
    rows = RANK_ALIGN_SMEM_MAX if smem_rows is None else smem_rows
    active = min(cs // 2, max(1, p_max // 32))
    slice_ = p_max // active
    chunk = min(slice_, rows)
    return dict(cluster_size=cs, active=active, slice=slice_, chunk=chunk,
                smem_bytes=24 * chunk,
                team_merge_levels=(p_max.bit_length() - 1) - (chunk.bit_length() - 1),
                global_bytes=2 * 2 * p_max * 12)


@functools.lru_cache(maxsize=32)
def _rank_align_launch(p_max: int, cs: int, smem_rows: int):
    plan = rank_align_plan(p_max, cs, smem_rows)
    args = _RankAlignArgs(p_max=p_max, cs=cs, active=plan["active"], slice=plan["slice"],
                          chunk=plan["chunk"], smem_bytes=plan["smem_bytes"])
    return plan, bytes(args)


def launch_rank_align(assignment, group_id, rank, pos_key,
                      _smem_rows: Optional[int] = None) -> torch.Tensor:
    """Kernel H on CUDA tensors: returns the aligned assignment [p_max] int32
    like rank_align_plain. p_max must be a power of two (rank_align pads).
    One launch of one thread-block cluster (rank_align_plan). `_smem_rows`,
    for tests only, sorts smaller chunks than the sizes in use ever need."""
    global LAST_RANK_ALIGN_PLAN
    device = assignment.device
    p_max = assignment.shape[0] if assignment.dim() == 1 else -1
    if p_max < 1 or p_max & (p_max - 1):
        raise ValueError(f"rank_align: p_max {p_max} is not a power of two")
    index = assignment.get_device()
    for name, t in (("assignment", assignment), ("group_id", group_id), ("rank", rank),
                    ("pos_key", pos_key)):
        if not (t.dtype is torch.int32 and t.shape == (p_max,) and t.is_contiguous()
                and t.get_device() == index):
            _check_cuda(t, name, torch.int32, device, (p_max,))
    rows = RANK_ALIGN_SMEM_MAX if _smem_rows is None else _smem_rows
    if not 1 <= rows <= RANK_ALIGN_SMEM_MAX or rows & (rows - 1):
        raise ValueError(f"rank_align: a chunk of {rows} rows is not a power of two in "
                         f"[1, {RANK_ALIGN_SMEM_MAX}]")
    lib = _lib("rank_align")
    plan, template = _rank_align_launch(p_max, _cluster_size(lib, "rank_align"), rows)
    out = torch.empty(p_max, dtype=torch.int32, device=device)
    gkey = torch.empty(4 * p_max, dtype=torch.int64, device=device)
    gidx = torch.empty(4 * p_max, dtype=torch.int32, device=device)
    args = _RankAlignArgs.from_buffer_copy(template)
    args.assignment, args.group_id = assignment.data_ptr(), group_id.data_ptr()
    args.rank, args.pos_key, args.out = rank.data_ptr(), pos_key.data_ptr(), out.data_ptr()
    args.gkey, args.gidx = gkey.data_ptr(), gidx.data_ptr()
    LAST_RANK_ALIGN_PLAN = plan
    launched = ctypes.c_int(0)
    err = lib.rank_align_launch(ctypes.byref(args), _stream_handle(index), ctypes.byref(launched))
    LAUNCHES["rank_align"] += 1
    CUDA_LAUNCHES["rank_align"] += launched.value
    _raise_on(err, "rank_align launch")
    return out


# ---------------------------------------------------------------------------
# kernel J
# ---------------------------------------------------------------------------

FEAS_MAX_THREADS = 512  # FR_MAX_THREADS in csrc/feasibility_rows.cu
FEAS_REG_R = 4  # resource columns a node keeps in registers (FR_REG_R)
_FR_PLAN = ("cs", "clusters", "threads", "chunk", "npt")
_FR_PTRS = ("alloc", "used", "used_nz", "pod_count", "max_pods", "filter_ok", "napref_raw",
            "has_napref", "taint_cnt", "img_score", "class_ports", "node_ports",
            "reqs", "req_nzs", "clss", "bals", "feas", "total")
# the last launch's plan (shared with the plan cache: not to be modified)
LAST_FEASIBILITY_PLAN: Dict[str, object] = {}


class _FeasRowsArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in ("Rw", "N", "R", "C", "Pt") + _FR_PLAN]
                + [(f, ctypes.c_void_p) for f in _FR_PTRS])


def _feas_shape(n: int, cs: int):
    """(nodes a CTA, threads a CTA, nodes a thread) for N nodes on clusters
    of `cs` CTAs."""
    chunk = -(-n // cs)
    threads = min(FEAS_MAX_THREADS, max(32, -(-chunk // 32) * 32))
    return chunk, threads, -(-chunk // threads)


@functools.lru_cache(maxsize=64)
def feasibility_plan(rw: int, n: int, r: int, cs: int, max_clusters: int) -> Dict[str, object]:
    """Kernel J's layout for Rw rows over N nodes on clusters of `cs` CTAs,
    of which the card runs `max_clusters` at once: CTA c of a cluster owns
    the nodes [c * chunk, (c + 1) * chunk), thread t the nodes c * chunk + t
    + j * threads (j < nodes_per_thread; the first in registers, the others
    read from global memory per row); cluster q takes the rows q, q +
    clusters, ... The plan is cached by shape; callers must not modify it."""
    chunk, threads, npt = _feas_shape(n, cs)
    clusters = max(1, min(rw, max_clusters))
    return dict(cluster_size=cs, clusters=clusters, ctas=cs * clusters, threads=threads,
                nodes_per_cta=chunk, nodes_per_thread=npt, passes=-(-rw // clusters),
                columns_in_registers=min(r, FEAS_REG_R))


@functools.lru_cache(maxsize=16)
def _feas_max_clusters(threads: int) -> int:
    got = _lib("feasibility_rows").feasibility_rows_max_clusters(threads)
    if got <= 0:
        raise RuntimeError(f"feasibility_rows: the occupancy query failed (CUDA error {-got})")
    return got


@functools.lru_cache(maxsize=64)
def _feas_launch(rw: int, n: int, r: int, c: int, pt: int, cs: int):
    """(plan, the args' fixed fields as bytes) of one shape."""
    _, threads, _ = _feas_shape(n, cs)
    plan = feasibility_plan(rw, n, r, cs, _feas_max_clusters(threads))
    args = _FeasRowsArgs(Rw=rw, N=n, R=r, C=c, Pt=pt, cs=cs, clusters=plan["clusters"],
                         threads=plan["threads"], chunk=plan["nodes_per_cta"],
                         npt=plan["nodes_per_thread"])
    return plan, bytes(args)


def launch_feasibility_rows(inp: SolverInputs, reqs, req_nzs, clss, bals):
    """Kernel J on CUDA tensors: returns (feas [Rw, N] bool, total [Rw, N]
    int32) like feasibility_rows_plain. One launch of one or more
    thread-block clusters (feasibility_plan); the inputs are not modified."""
    global LAST_FEASIBILITY_PLAN
    device = inp.alloc.device
    n, r = inp.alloc.shape if inp.alloc.dim() == 2 else (-1, -1)
    c = inp.filter_ok.shape[0]
    pt = inp.class_ports.shape[1] if inp.class_ports.dim() == 2 else -1
    rw = reqs.shape[0] if reqs.dim() == 2 else -1
    if n < 1 or r < 2:
        raise ValueError("feasibility_rows: needs at least one node and the cpu/memory columns")
    i32, b8 = torch.int32, torch.bool
    nr, n1, cn = (n, r), (n,), (c, n)
    _check_all(device, (
        ("alloc", inp.alloc, i32, nr), ("used", inp.used, i32, nr),
        ("used_nz", inp.used_nz, i32, nr), ("pod_count", inp.pod_count, i32, n1),
        ("max_pods", inp.max_pods, i32, n1), ("filter_ok", inp.filter_ok, b8, cn),
        ("napref_raw", inp.napref_raw, i32, cn), ("has_napref", inp.has_napref, b8, (c,)),
        ("taint_cnt", inp.taint_cnt, i32, cn), ("img_score", inp.img_score, i32, cn),
        ("class_ports", inp.class_ports, b8, (c, pt)), ("node_ports", inp.node_ports, b8, (n, pt)),
        ("reqs", reqs, i32, (rw, r)), ("req_nzs", req_nzs, i32, (rw, r)),
        ("clss", clss, i32, (rw,)), ("bals", bals, b8, (rw,))))
    feas = torch.empty((rw, n), dtype=b8, device=device)
    total = torch.empty((rw, n), dtype=i32, device=device)
    if rw == 0:
        return feas, total
    lib = _lib("feasibility_rows")
    plan, template = _feas_launch(rw, n, r, c, pt, _cluster_size(lib, "feasibility_rows"))
    args = _FeasRowsArgs.from_buffer_copy(template)
    # the pointers in one assignment (an empty tensor's is never read)
    (ctypes.c_void_p * len(_FR_PTRS)).from_buffer(args, _FeasRowsArgs.alloc.offset)[:] = [
        t.data_ptr() for t in (inp.alloc, inp.used, inp.used_nz, inp.pod_count, inp.max_pods,
                               inp.filter_ok, inp.napref_raw, inp.has_napref, inp.taint_cnt,
                               inp.img_score, inp.class_ports, inp.node_ports, reqs, req_nzs,
                               clss, bals, feas, total)]
    LAST_FEASIBILITY_PLAN = plan
    launched = ctypes.c_int(0)
    err = lib.feasibility_rows_launch(ctypes.byref(args), _stream_handle(inp.alloc.get_device()),
                                      ctypes.byref(launched))
    LAUNCHES["feasibility_rows"] += 1
    CUDA_LAUNCHES["feasibility_rows"] += launched.value
    _raise_on(err, "feasibility_rows launch")
    return feas, total


# ---------------------------------------------------------------------------
# the layout of kernels E and F (one thread-block cluster each)
# ---------------------------------------------------------------------------

# shared memory a cluster kernel's CTA may take (AU_/SK_SMEM_BUDGET in csrc/)
CLUSTER_SMEM_BUDGET = 220 * 1024


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _place(sizes: Dict[str, int], cluster_wide=("exchange",)) -> Dict[str, object]:
    """Regions in their order of claim: each in shared memory while it fits
    the budget, else in the CTA's slice of a global scratch buffer (a region
    in `cluster_wide` instead goes to one global array of the cluster)."""
    off, goff, smem, gbytes = {}, {}, 0, 0
    for name, size in sizes.items():
        if smem + size <= CLUSTER_SMEM_BUDGET:
            off[name], goff[name] = smem, 0
            smem += size
        else:
            off[name], goff[name] = -1, (0 if name in cluster_wide else gbytes)
            if name not in cluster_wide:
                gbytes += size
    return dict(off=off, goff=goff, smem_bytes=smem, global_bytes_per_cta=gbytes,
                in_smem=[k for k in sizes if off[k] >= 0],
                in_global=[k for k in sizes if off[k] < 0],
                exchange="st.async" if off["exchange"] >= 0 else "global + barrier.cluster",
                exchange_bytes=sizes["exchange"])


def _plan_line(plan: Dict[str, object]) -> Dict[str, object]:
    return {k: v for k, v in plan.items() if k not in ("off", "goff")}


def _check_all(device: torch.device, checks) -> None:
    """_check_cuda over (name, tensor, dtype, shape), with one cheap test of
    each first (the wrappers of E and F run several times a batch)."""
    for name, t, dtype, shape in checks:
        if not (t.dtype is dtype and t.device == device and t.shape == shape
                and t.is_contiguous()):
            _check_cuda(t, name, dtype, device, shape)


def _args_template(struct, plan: Dict[str, object], regions, **ints) -> bytes:
    """A launch's fixed fields (sizes, the plan's offsets) as the bytes of
    `struct`, to copy per call."""
    args = struct(cs=plan["cluster_size"], threads=plan["threads"], chunk=plan["nodes_per_cta"],
                  smem_bytes=plan["smem_bytes"], gbytes=plan["global_bytes_per_cta"], **ints)
    for i, region in enumerate(regions):
        args.off[i], args.goff[i] = plan["off"][region], plan["goff"][region]
    return bytes(args)


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------

AUCTION_THREADS = 256
_AU_LIST = 17  # entries a CTA sends per group a round: its K + 1 best
# csrc/auction_phase.cu's regions, in the order they claim shared memory
AUCTION_REGIONS = ("groups", "nodes", "exchange", "lists", "cells", "candidates")
# the last launch's plan (shared with the plan cache: not to be modified)
LAST_AUCTION_PLAN: Dict[str, object] = {}


@functools.lru_cache(maxsize=64)
def auction_plan(g: int, n: int, r: int, cs: int) -> Dict[str, object]:
    """Kernel E's layout for a [G, N] problem with R resources on a cluster of
    `cs` CTAs: CTA c owns the nodes c, c + cs, ... (ceil(N / cs) at most).
    The plan is cached by shape; callers must not modify it. Regions (bytes a CTA):
    groups (supply, the row-sum replica and its change, req), nodes (price,
    slots, the walk flags and list, free), exchange (two parities of cs x G
    lists of 17 16-byte entries), lists (a lane's 17 sorted keys, for every
    lane), cells (x, level, utility, jcap and the round's bids for G x chunk
    cells), candidates (a warp's 2G ranked keys)."""
    chunk = -(-n // cs)
    warps = AUCTION_THREADS // 32
    sizes = {"groups": _align16((3 + r) * g * 4), "nodes": _align16((4 + r) * chunk * 4),
             "exchange": 2 * cs * g * _AU_LIST * 16, "lists": warps * 32 * _AU_LIST * 8,
             "cells": _align16(6 * g * chunk * 4),
             "candidates": warps * 2 * g * 16}
    return dict(cluster_size=cs, threads=AUCTION_THREADS, nodes_per_cta=chunk, **_place(sizes))


_AU_INTS = ("G", "N", "R", "K", "max_rounds", "cs", "threads", "chunk", "smem_bytes")
_AU_IN = ("utility", "jcap", "supply", "slots", "req", "free", "x0", "price0", "level0")
_AU_PTRS = ("utility", "jcap", "supply", "slots", "req", "free", "x0", "price0", "level0",
            "x", "price", "level", "rounds", "gscratch", "xslots")


class _AuctionArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in _AU_INTS]
                + [("off", ctypes.c_int * len(AUCTION_REGIONS)),
                   ("goff", ctypes.c_longlong * len(AUCTION_REGIONS)),
                   ("gbytes", ctypes.c_longlong), ("eps", ctypes.c_float)]
                + [(f, ctypes.c_void_p) for f in _AU_PTRS])


@functools.lru_cache(maxsize=64)
def _auction_launch(g: int, n: int, r: int, cs: int):
    plan = auction_plan(g, n, r, cs)
    return (plan, _args_template(_AuctionArgs, plan, AUCTION_REGIONS, G=g, N=n, R=r, K=min(16, n)),
            _plan_line(plan))


def _cluster_scratch(plan: Dict[str, object], device: torch.device):
    """(per-CTA global slices, the cluster's global exchange array) the plan
    needs, as uint8 tensors or None."""
    cs = plan["cluster_size"]
    gscratch = (torch.empty(cs * plan["global_bytes_per_cta"], dtype=torch.uint8, device=device)
                if plan["global_bytes_per_cta"] else None)
    xslots = (torch.empty(plan["exchange_bytes"], dtype=torch.uint8, device=device)
              if plan["off"]["exchange"] < 0 else None)
    return gscratch, xslots


def launch_auction_phase(utility, jcap, supply, slots, req, free, x0, price0, level0,
                         eps: float, max_rounds: int):
    """Kernel E on CUDA tensors: one eps-phase of the forward auction.
    Returns (x [G, N] int32, price [N] float32, level [G, N] float32, rounds
    int) like _auction_phase_plain. One launch of one cluster runs every
    round on the device; the host reads `rounds` once, at the end. The
    inputs are not modified."""
    global LAST_AUCTION_PLAN
    device = utility.device
    if utility.dim() != 2 or req.dim() != 2:
        raise ValueError("auction_phase: utility must be [G, N] and req [G, R]")
    g, n = utility.shape
    r = req.shape[1]
    if g < 1 or n < 1:
        raise ValueError("auction_phase: needs at least one group and one node")
    inputs = (utility, jcap, supply, slots, req, free, x0, price0, level0)
    _check_all(device, zip(_AU_IN, inputs, (
        torch.float32, torch.int32, torch.int32, torch.int32, torch.int32, torch.int32,
        torch.int32, torch.float32, torch.float32),
        ((g, n), (g, n), (g,), (n,), (g, r), (n, r), (g, n), (n,), (g, n))))
    lib = _lib("auction_phase")
    if not 1 <= r <= lib.auction_max_r():
        raise ValueError(f"auction_phase: R = {r} outside [1, {lib.auction_max_r()}]")
    plan, template, line = _auction_launch(g, n, r, _cluster_size(lib, "auction_phase"))
    gscratch, xslots = _cluster_scratch(plan, device)
    x = torch.empty((g, n), dtype=torch.int32, device=device)
    price = torch.empty(n, dtype=torch.float32, device=device)
    level = torch.empty((g, n), dtype=torch.float32, device=device)
    rounds_t = torch.empty(1, dtype=torch.int32, device=device)
    args = _AuctionArgs.from_buffer_copy(template)
    args.max_rounds, args.eps = int(max_rounds), float(eps)
    for f, t in zip(_AU_PTRS, inputs + (x, price, level, rounds_t, gscratch, xslots)):
        setattr(args, f, t.data_ptr() if t is not None else None)
    LAST_AUCTION_PLAN = line
    launched = ctypes.c_int(0)
    err = lib.auction_phase_launch(ctypes.byref(args), _stream_handle(utility.get_device()),
                                   ctypes.byref(launched))
    LAUNCHES["auction_phase"] += 1
    CUDA_LAUNCHES["auction_phase"] += launched.value
    _raise_on(err, "auction_phase launch")
    rounds = int(rounds_t)  # the phase's one host read
    HOST_SYNCS["auction_phase"] += 1
    return x, price, level, rounds


# ---------------------------------------------------------------------------
# kernel F
# ---------------------------------------------------------------------------

SINKHORN_MAX_THREADS = 512
SINKHORN_MAX_Y = 16  # column threads a column's sum is split over (SK_MAX_Y in csrc/)
# csrc/sinkhorn.cu's regions, in the order they claim shared memory
SINKHORN_REGIONS = ("groups", "nodes", "exchange", "z")
# the last launch's plan (shared with the plan cache: not to be modified)
LAST_SINKHORN_PLAN: Dict[str, object] = {}


def _last_pow2(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _reduce_block(dim0: int, dim1: int, max_threads: int):
    """ATen's ReduceConfig::set_block_dimension: (block width, height)."""
    d0 = _last_pow2(dim0) if dim0 < max_threads else max_threads
    d1 = _last_pow2(dim1) if dim1 < max_threads else max_threads
    bw = min(d0, 32)
    bh = min(d1, max_threads // bw)
    return min(d0, max_threads // bh), bh


def sinkhorn_order(g: int, n: int) -> Dict[str, object]:
    """The order in which torch's CUDA sum (ATen Reduce.cuh, setReduceConfig)
    adds a contiguous float32 [G, N] over dim 1 (a row) and dim 0 (a
    column), which kernel F's sums follow so that its duals match the plain
    version's on the card bit for bit where they can.

    Row: `bw` x `by` threads share a row (by > 1 when the row is split
    across warps); thread t = x + bw * y takes, when `vec` (N >= 128),
    the float4 vectors t, t + W, ... (W = bw * by) into four accumulators
    (element i of a vector into accumulator i) plus, for x < N % 4 and y 0,
    the tail element 4 * (N // 4) + x into accumulator 0; else the elements
    t, t + W, ... into accumulator s % 4 (s its place in the thread's
    sequence). A thread's partial is ((a0 + a1) + a2) + a3; the partials are
    summed over x by a stride-halving tree (offsets bw/2 .. 1, lower index
    on the left), then over y the same way. Column: `cy` threads share a
    column; thread y takes rows y, y + cy, ... into accumulator s % 4, then
    the same combine and a stride-halving tree over y. `exact` is False
    where torch would add a misaligned row's head (N % 4 != 0: rows
    g * N % 4 != 0 start mid-vector), split a sum across blocks (N >= 256
    W, G >= 256 cy) or a column over more than 16 threads: there F keeps
    this order (cy capped at 16) and agrees to rounding."""
    vec = n >= 128
    bw, bh = _reduce_block(n // 4 if vec else n, g, 512)
    by = bh if -(-n // bw) >= min(bh * 16, 256) else 1
    ovs = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    _, cbh = _reduce_block(n // ovs, g, 512 // ovs)
    cy = cbh if g >= min(cbh * 16, 256) else 1
    exact = ((not vec or n % 4 == 0) and -(-n // (bw * by)) < 256
             and -(-g // cy) < 256 and cy <= SINKHORN_MAX_Y)
    return dict(vec=vec, bw=bw, by=by, cy=min(cy, SINKHORN_MAX_Y), exact=exact)


def _sinkhorn_counts(order: Dict[str, object], n: int, cs: int) -> list:
    """Nodes per CTA: CTA c < min(cs, bw) owns the row threads x = c, c + cx,
    ... (cx = min(cs, bw)) for every y, and the nodes they add."""
    bw, by, vec = order["bw"], order["by"], order["vec"]
    w, cx = bw * by, min(cs, bw)
    v = n // 4
    out = []
    for c in range(cs):
        total = 0
        if c < cx:
            for y in range(by):
                for x in range(c, bw, cx):
                    t = x + bw * y
                    if vec:
                        total += 4 * max(0, -(-(v - t) // w)) + (1 if y == 0 and x < n - 4 * v else 0)
                    else:
                        total += max(0, -(-(n - t) // w))
        out.append(total)
    return out


@functools.lru_cache(maxsize=64)
def sinkhorn_plan(g: int, n: int, cs: int) -> Dict[str, object]:
    """Kernel F's layout for a [G, N] problem on a cluster of `cs` CTAs. A
    CTA owns the nodes of its row threads (sinkhorn_order), at most
    `nodes_per_cta`, one thread a node up to 512 threads. The plan is cached
    by shape; callers must not modify it. Regions (bytes a
    CTA): groups (f, f / eps, log supply, the row maxima, the row threads'
    four accumulators and offsets), nodes
    (g, g / eps, log cap, the node index), exchange (cs x G row maxima and
    cs x G x by row partials), z (G x nodes_per_cta)."""
    order = sinkhorn_order(g, n)
    bw, by = order["bw"], order["by"]
    cx = min(cs, bw)
    owned = (bw // cx) * by  # row threads a CTA owns
    chunk = max(1, max(_sinkhorn_counts(order, n, cs)))
    threads = min(SINKHORN_MAX_THREADS, max(64, -(-chunk // 32) * 32))
    sizes = {"groups": _align16((4 * g + 4 * g * owned + owned + 1) * 4),
             "nodes": _align16(4 * chunk * 4),
             "exchange": cs * g * 4 + cs * g * by * 4,
             "z": _align16(g * chunk * 4)}
    return dict(cluster_size=cs, threads=threads, nodes_per_cta=chunk, row_threads_per_cta=owned,
                order=order, **_place(sizes))


_SK_INTS = ("G", "N", "iters", "cs", "threads", "chunk", "smem_bytes", "vec", "bw", "by", "cy")
_SK_PTRS = ("utility", "feasible", "supply", "cap", "f0", "g0", "f", "g", "plan", "gscratch",
            "xslots")


@functools.lru_cache(maxsize=64)
def _sinkhorn_launch(g: int, n: int, cs: int):
    plan = sinkhorn_plan(g, n, cs)
    order = plan["order"]
    return (plan, _args_template(_SinkhornArgs, plan, SINKHORN_REGIONS, G=g, N=n,
                                 vec=int(order["vec"]), bw=order["bw"], by=order["by"],
                                 cy=order["cy"]), _plan_line(plan))


class _SinkhornArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in _SK_INTS]
                + [("off", ctypes.c_int * len(SINKHORN_REGIONS)),
                   ("goff", ctypes.c_longlong * len(SINKHORN_REGIONS)),
                   ("gbytes", ctypes.c_longlong), ("eps", ctypes.c_float)]
                + [(f, ctypes.c_void_p) for f in _SK_PTRS])


def launch_sinkhorn_iters(utility, feasible, supply, cap, f0, g0, eps: float, iters: int):
    """Kernel F on CUDA tensors: `iters` row/column passes and the plan in
    one launch of one cluster, with no host sync. Returns (f [G], g [N],
    plan [G, N]) float32 like _sinkhorn_iters_plain. The inputs are not
    modified."""
    device = utility.device
    if utility.dim() != 2:
        raise ValueError("sinkhorn: utility must be [G, N]")
    g, n = utility.shape
    if g < 1 or n < 1:
        raise ValueError("sinkhorn: needs at least one group and one node")
    if iters < 0:
        raise ValueError(f"sinkhorn: iters {iters} < 0")
    global LAST_SINKHORN_PLAN
    inputs = (utility, feasible, supply, cap, f0, g0)
    _check_all(device, zip(("utility", "feasible", "supply", "cap", "f0", "g0"), inputs,
                           (torch.float32, torch.bool, torch.int32, torch.float32, torch.float32,
                            torch.float32), ((g, n), (g, n), (g,), (n,), (g,), (n,))))
    lib = _lib("sinkhorn")
    plan, template, line = _sinkhorn_launch(g, n, _cluster_size(lib, "sinkhorn"))
    gscratch, xslots = _cluster_scratch(plan, device)
    f = torch.empty(g, dtype=torch.float32, device=device)
    gg = torch.empty(n, dtype=torch.float32, device=device)
    out_plan = torch.empty((g, n), dtype=torch.float32, device=device)
    args = _SinkhornArgs.from_buffer_copy(template)
    args.iters, args.eps = int(iters), float(eps)
    for name, t in zip(_SK_PTRS, inputs + (f, gg, out_plan, gscratch, xslots)):
        setattr(args, name, t.data_ptr() if t is not None else None)
    LAST_SINKHORN_PLAN = line
    launched = ctypes.c_int(0)
    err = lib.sinkhorn_launch(ctypes.byref(args), _stream_handle(utility.get_device()),
                              ctypes.byref(launched))
    LAUNCHES["sinkhorn"] += 1
    CUDA_LAUNCHES["sinkhorn"] += launched.value
    _raise_on(err, "sinkhorn launch")
    return f, gg, out_plan


# ---------------------------------------------------------------------------
# kernel I
# ---------------------------------------------------------------------------


DEFRAG_VCHUNK = 256  # victims staged in shared memory at a time (DA_VCHUNK)
# the last launch's layout (shared with the plan cache: not to be modified)
LAST_DEFRAG_PLAN: Dict[str, object] = {}
# the last launch's schedule as the kernel counted it: a [2] int32 tensor on
# the card (tree rebuilds, leaf updates), written when the launch ends
LAST_DEFRAG_COUNTS: Optional[torch.Tensor] = None


class _DefragArgs(ctypes.Structure):
    _fields_ = ([(d, ctypes.c_int) for d in ("n_slots", "v_max", "R", "use_smem", "smem_bytes")]
                + [(f, ctypes.c_void_p) for f in ("free", "headroom", "target_ok", "v_req",
                                                  "v_valid", "out", "scratch", "counts")])


def defrag_group(n_slots: int) -> int:
    """Slots under one leaf of kernel I's tournament tree: a quad of 4 slots
    a lane of a warp, as many quads as keep the leaves at most 128
    (da_group in csrc/defrag_assign.cu): 128 up to 16,384 slots."""
    return 128 * max(1, -(-n_slots // (128 * 128)))


@functools.lru_cache(maxsize=64)
def _defrag_layout(n_slots: int, r: int) -> Dict[str, object]:
    lib = _lib("defrag_assign")
    use_smem = lib.defrag_assign_uses_smem(n_slots, r)
    stride = lib.defrag_assign_stride(n_slots)
    group = defrag_group(n_slots)
    return dict(state="shared" if use_smem else "global", group=group,
                leaves=-(-n_slots // group), stage_victims=DEFRAG_VCHUNK,
                smem_bytes=lib.defrag_assign_smem_bytes(n_slots, r, use_smem),
                state_bytes=stride * (r + 1) * 4, stride=stride)


def launch_defrag_assign(free, headroom, target_ok, v_req, v_valid) -> torch.Tensor:
    """Kernel I on CUDA tensors: returns the target per victim [v_max] int32
    like defrag_assign_plain. One block walks the victims over a tournament
    tree of at most 128 leaves; the carried state sits in shared memory where
    it fits, else in a global scratch copy this wrapper allocates. The inputs
    are not modified."""
    global LAST_DEFRAG_PLAN, LAST_DEFRAG_COUNTS
    device = free.device
    if free.dim() != 2:
        raise ValueError("defrag_assign: free must be [n_slots, R]")
    n_slots, r = free.shape
    v_max = v_req.shape[0] if v_req.dim() == 2 else -1
    if n_slots < 1:
        raise ValueError("defrag_assign: needs at least one slot")
    _check_all(device, (
        ("free", free, torch.int32, (n_slots, r)),
        ("headroom", headroom, torch.int32, (n_slots,)),
        ("target_ok", target_ok, torch.bool, (n_slots,)),
        ("v_req", v_req, torch.int32, (v_max, r)),
        ("v_valid", v_valid, torch.bool, (v_max,))))
    lib = _lib("defrag_assign")
    if not 1 <= r <= lib.defrag_assign_max_r():
        raise ValueError(f"defrag_assign: R = {r} outside [1, {lib.defrag_assign_max_r()}]")
    out = torch.empty(v_max, dtype=torch.int32, device=device)
    if v_max == 0:
        return out
    plan = _defrag_layout(n_slots, r)
    use_smem = plan["state"] == "shared"
    scratch = (None if use_smem else
               torch.empty(plan["stride"] * (r + 1), dtype=torch.int32, device=device))
    counts = torch.empty(2, dtype=torch.int32, device=device)
    args = _DefragArgs(n_slots=n_slots, v_max=v_max, R=r, use_smem=int(use_smem),
                       smem_bytes=plan["smem_bytes"],
                       free=free.data_ptr(), headroom=headroom.data_ptr(),
                       target_ok=target_ok.data_ptr(), v_req=v_req.data_ptr(),
                       v_valid=v_valid.data_ptr(), out=out.data_ptr(),
                       scratch=None if scratch is None else scratch.data_ptr(),
                       counts=counts.data_ptr())
    LAST_DEFRAG_PLAN, LAST_DEFRAG_COUNTS = plan, counts
    launched = ctypes.c_int(0)
    err = lib.defrag_assign_launch(ctypes.byref(args), _stream_handle(free.get_device()),
                                   ctypes.byref(launched))
    LAUNCHES["defrag_assign"] += 1
    CUDA_LAUNCHES["defrag_assign"] += launched.value
    _raise_on(err, "defrag_assign launch")
    return out
