"""Cluster snapshot -> struct-of-arrays tensors for the device solver.

The counterpart of `kubernetes_tpu/snapshot/tensorizer.py`. The host part is
numpy and behaves identically: NodeInfo-equivalent struct-of-arrays
(allocatable/requested [N,R], dictionary-encoded labels, topology-value ids,
per-constraint count tensors), mirroring the generation-diff stream of
cache.go:186. `TensorCache.device_views` keeps torch mirrors of the node
tensors on the device and updates them by scattering only the dirty rows,
every mirror in one launch of kernel B (`csrc/row_scatter.cu`).

Quantization (int32 everywhere — exact, no float rounding at feasibility
boundaries):
  cpu               -> millicores
  memory, ephemeral -> MiB; allocatable floors, requests ceil, so the device
                       view is conservative: it never admits a pod the byte-
                       exact oracle would reject (it may rarely reject one the
                       oracle admits, by < 1MiB).
  scalar resources  -> raw integer counts
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import Pod, Resource, compute_pod_resource_request
from ..api.resources import CPU, EPHEMERAL_STORAGE, MEMORY
from ..ops.kernels import MirrorSet, launch_mirror_scatter, launch_row_scatter
from ..ops.solver import resolve_device, to_device
from ..scheduler.framework import Snapshot
from ..scheduler.plugins.helpers import pts_effective_selector
from .class_compiler import (
    ClassTables,
    NodeColumns,
    compile_class_tables,
    pod_class_signature,
)
from .ipa import IPATensors, compile_ipa

# The pod-carried memo slots this module owns: `_class_sig` is the
# class-signature memo (pod_class_signature), `_req_sig` the spec-identity
# request-signature memo (_req_entry below), `_req_cache` the seeded PodInfo
# request pair. They live in pod.__dict__, so every structural/bind clone
# (which copies the dict at the C level) carries them for free — including
# the columnar store's lazily materialized rows (store/columnar.py captures
# the first two as its signature-ref column and relies on exactly this).
SIG_MEMO_KEYS = ("_class_sig", "_req_sig", "_req_cache")

MI = 1024 * 1024


def _quantize(r: Resource, resource_dims: Sequence[str], is_request: bool) -> List[int]:
    out = []
    for name in resource_dims:
        if name == CPU:
            out.append(r.milli_cpu)
        elif name == MEMORY:
            v = r.memory
            out.append(-(-v // MI) if is_request else v // MI)
        elif name == EPHEMERAL_STORAGE:
            v = r.ephemeral_storage
            out.append(-(-v // MI) if is_request else v // MI)
        else:
            out.append(r.scalar.get(name, 0))
    return out


def _raw_vec(r: Resource, resource_dims: Sequence[str]) -> List[int]:
    """Unquantized resource vector (milli-CPU, bytes, bytes, scalar counts).
    The columnar accounting path accumulates THESE and quantizes the totals,
    so its rows stay bit-identical to quantizing NodeInfo.requested (the sum
    of per-pod MiB ceilings is not the ceiling of the byte sum)."""
    out = []
    for name in resource_dims:
        if name == CPU:
            out.append(r.milli_cpu)
        elif name == MEMORY:
            out.append(r.memory)
        elif name == EPHEMERAL_STORAGE:
            out.append(r.ephemeral_storage)
        else:
            out.append(r.scalar.get(name, 0))
    return out


def _quantize_raw_rows(raw: np.ndarray, resource_dims: Sequence[str]) -> np.ndarray:
    """Vectorized request-side quantization of raw [K, R] rows: the columnar
    equivalent of _quantize(..., is_request=True) per node."""
    out = raw.astype(np.int64, copy=True)
    for di, name in enumerate(resource_dims):
        if name in (MEMORY, EPHEMERAL_STORAGE):
            out[:, di] = -(-out[:, di] // MI)
    return out.astype(np.int32)


@dataclass
class ClusterTensors:
    """Node-axis tensors + class tables + topology-spread tensors (all numpy;
    ops/solver.py moves them to the device)."""

    node_names: List[str]
    resource_dims: List[str]  # [cpu, memory, ephemeral-storage, *extended]
    alloc: np.ndarray  # [N, R] int32
    used: np.ndarray  # [N, R] int32 (Requested)
    used_nz: np.ndarray  # [N, R] int32 (NonZeroRequested)
    pod_count: np.ndarray  # [N] int32
    max_pods: np.ndarray  # [N] int32
    cols: Optional[NodeColumns]

    # topology keys in use: key -> row in topo_id
    topo_keys: List[str]
    topo_id: np.ndarray  # [Kk, N] int32 domain id per node (-1 = label missing)
    num_domains: np.ndarray  # [Kk] int32

    # selector-classes for PTS/IPA counting
    selcls_count: np.ndarray  # [SC, N] int32 existing matching pods per node

    @property
    def n(self) -> int:
        return len(self.node_names)


@dataclass
class PodBatchTensors:
    """Pod-axis tensors for one batch + the class tables they index into."""

    pods: List[Pod]
    class_of_pod: np.ndarray  # [P] int32
    req: np.ndarray  # [P, R] int32
    req_nz: np.ndarray  # [P, R] int32
    # balanced-allocation activity: all-zero plain request => skip
    balanced_active: np.ndarray  # [P] bool
    tables: ClassTables

    # flattened DoNotSchedule topology-spread constraints across classes
    ct_class: np.ndarray  # [CT] int32 (owning class)
    ct_key: np.ndarray  # [CT] int32 (row into topo_id)
    ct_sel: np.ndarray  # [CT] int32 (row into selcls_count)
    ct_max_skew: np.ndarray  # [CT] int32
    ct_min_domains: np.ndarray  # [CT] int32 (0 = unset)
    ct_self_match: np.ndarray  # [CT] int32 (pod matches own constraint selector)
    # ScheduleAnyway constraints (scored), same layout
    st_class: np.ndarray
    st_key: np.ndarray
    st_sel: np.ndarray
    st_max_skew: np.ndarray
    st_self_match: np.ndarray
    # does a pod of class c match selector-class sc?
    class_matches_selcls: np.ndarray  # [C, SC] int32

    ipa: IPATensors

    # classes whose pods the batched path does not place (DRA claims,
    # scheduling-relevant volumes, non-default PTS inclusion policies)
    fallback_class: np.ndarray  # [C] bool

    # columnar accounting inputs (see _raw_vec): unquantized per-pod request
    # vectors and the per-class host-port flag that gates the tensor-cache
    # assume fast path (host-port pods need a port-row recompute)
    raw_req: Optional[np.ndarray] = None  # [P, R] int64
    raw_req_nz: Optional[np.ndarray] = None  # [P, R] int64
    class_has_host_ports: Optional[np.ndarray] = None  # [C] bool

    # gang rows (scheduler/gang.py): group id per pod (-1 = not a member),
    # the group keys those ids index, and the per-(class, node) slice-packing
    # score bonus. All None when the batch has no gang members: the solvers
    # run their gang-free variants.
    gang_of_pod: Optional[np.ndarray] = None  # [P] int32
    gang_keys: Optional[List[str]] = None  # [G]
    gang_bonus: Optional[np.ndarray] = None  # [C, N] int32
    # positional rank per gang member (-1 absent); None when no member
    # carries one, and the rank-alignment pass is then skipped
    gang_rank: Optional[np.ndarray] = None  # [P] int32

    @property
    def p(self) -> int:
        return len(self.pods)

    @property
    def c(self) -> int:
        return len(self.tables.rep_pods)

    @property
    def has_constraints(self) -> bool:
        """Any topology-spread or inter-pod-affinity term in the batch."""
        return bool(self.ct_class.size or self.st_class.size or self.ipa.has_any)


# ---------------------------------------------------------------------------
# kernel B: dirty-row scatter into the device mirrors
# ---------------------------------------------------------------------------


class MirrorSegment(NamedTuple):
    """One mirror's columns in the packed dirty rows [k, W] (column 0 holds
    the row indices)."""

    name: str
    offset: int
    width: int
    col_mode: bool  # the mirror is [width, N] and takes the rows as columns


def mirror_layout(r: int, sc: int = 0) -> Tuple[List[MirrorSegment], int]:
    """Segments of the packed rows for the DEVICE_FIELDS ([N, R] x 3, [N] x 2)
    and, when sc > 0, selcls_count ([SC, N], column mode); returns
    (segments, W) with W = 3 + 3R + SC."""
    segs, off = [], 1
    for name, width in (("alloc", r), ("used", r), ("used_nz", r), ("pod_count", 1),
                        ("max_pods", 1)):
        segs.append(MirrorSegment(name, off, width, False))
        off += width
    if sc:
        segs.append(MirrorSegment("selcls_count", off, sc, True))
        off += sc
    return segs, off


def pack_mirror_rows(cluster: ClusterTensors, rows: np.ndarray, with_selcls: bool,
                     out: Optional[np.ndarray] = None):
    """The dirty rows of every mirror in one int32 buffer [k, W], in one
    numpy pass over the cluster arrays: the row index, then each segment of
    mirror_layout. `out` (at least k * W int32) is filled in place when
    given. Returns (packed [k, W], segments)."""
    sc = cluster.selcls_count.shape[0] if with_selcls else 0
    segs, w = mirror_layout(cluster.alloc.shape[1], sc)
    k = len(rows)
    packed = (np.empty((k, w), np.int32) if out is None
              else out.reshape(-1)[:k * w].reshape(k, w))
    packed[:, 0] = rows
    for seg in segs:
        src = getattr(cluster, seg.name)
        part = packed[:, seg.offset:seg.offset + seg.width]
        if seg.col_mode:
            part[:] = src[:, rows].T
        elif src.ndim == 1:
            part[:, 0] = src[rows]
        else:
            part[:] = src[rows]
    return packed, segs


def scatter_mirrors_plain(dsts: Sequence[torch.Tensor], packed: torch.Tensor,
                          layout: Sequence[MirrorSegment]) -> None:
    """Plain version of kernel B, fused form: for each mirror, per-field
    index assignment of its segment of the packed rows (rows in column 0)."""
    rows = packed[:, 0].long()
    for dst, seg in zip(dsts, layout):
        part = packed[:, seg.offset:seg.offset + seg.width]
        if seg.col_mode:
            dst[:, rows] = part.t()
        elif dst.dim() == 1:
            dst[rows] = part[:, 0]
        else:
            dst[rows] = part


def scatter_rows_plain(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> None:
    """dst[rows[i], ...] = src[i, ...] in place (plain version of kernel B)."""
    dst[rows.long()] = src


def scatter_cols_plain(dst: torch.Tensor, cols: torch.Tensor, src: torch.Tensor) -> None:
    """dst[:, cols[i]] = src[:, i] in place (plain version of kernel B)."""
    dst[:, cols.long()] = src


def scatter_rows(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> None:
    """Row scatter into one mirror: the plain version for CPU tensors,
    kernel B (one descriptor) on CUDA."""
    if dst.is_cuda:
        launch_row_scatter(dst, rows, src, cols=False)
    elif dst.device.type == "cpu":
        scatter_rows_plain(dst, rows, src)
    else:
        raise ValueError(f"scatter_rows: no implementation for device {dst.device}")


def scatter_cols(dst: torch.Tensor, cols: torch.Tensor, src: torch.Tensor) -> None:
    """Column scatter into one mirror: the plain version for CPU tensors,
    kernel B (one descriptor) on CUDA."""
    if dst.is_cuda:
        launch_row_scatter(dst, cols, src, cols=True)
    elif dst.device.type == "cpu":
        scatter_cols_plain(dst, cols, src)
    else:
        raise ValueError(f"scatter_cols: no implementation for device {dst.device}")


class TensorCache:
    """Cross-batch incremental tensorization (reference: cache.go:186
    UpdateSnapshot's generation diff).

    `Cache.update_snapshot` reuses the SAME NodeInfo object for nodes whose
    generation didn't change, so identity comparison against the previous
    snapshot is exactly the generation diff:

      cluster rows   — alloc/used/used_nz/pod_count/max_pods/port rows are
                       recomputed only for changed nodes (same node set);
      count columns  — the PTS/IPA per-(selector-class, node) count tensor is
                       recomputed only for changed nodes when the batch
                       registers the same selector classes AND the namespace
                       label table is unchanged.

    Anything structural (node set/order, label/taint/image/vocab changes,
    different class registry, namespace relabels) falls back to a full
    rebuild."""

    # cluster-level tensors mirrored on the device across batches; changed
    # rows are scattered there instead of re-uploading the full array
    DEVICE_FIELDS = ("alloc", "used", "used_nz", "pod_count", "max_pods")

    def __init__(self):
        self.snap: Optional[Snapshot] = None
        self.node_infos: Optional[list] = None  # aligned NodeInfo identities
        self.cluster: Optional[ClusterTensors] = None
        # batch-level artifacts for count-column reuse
        self.selcls_keys: Optional[tuple] = None
        self.selcls_count: Optional[np.ndarray] = None
        self.ns_fingerprint: Optional[tuple] = None
        # device mirrors; dirty rows accumulate across passes until the next
        # device_views call uploads them
        self._device: Dict[str, torch.Tensor] = {}
        self._device_selcls: Optional[torch.Tensor] = None
        self._device_selcls_host = None  # the host array the mirror tracks
        self._dirty_rows: set = set()
        self._dirty_all = True
        # kernel B's pinned staging buffer, its device copy, the event after
        # the last copy, and the mirrors' checked descriptors
        self._stage_host: Optional[torch.Tensor] = None
        self._stage_dev: Optional[torch.Tensor] = None
        self._stage_event = None
        self._mirror_set = None
        # previous PodBatchTensors (pod-axis reuse for same-backlog re-solves)
        self._last_batch = None
        # columnar assume state: raw (unquantized) per-node request totals,
        # the cache generation the current tensors are consistent with, and
        # the rows + generation a pending apply_assume_deltas covers
        self._raw_used: Optional[np.ndarray] = None  # [N, R] int64
        self._raw_used_nz: Optional[np.ndarray] = None
        self._tensorized_gen: Optional[int] = None
        self._assume_gen: Optional[int] = None
        self._assume_rows: Optional[set] = None

    # -- cluster tensors -------------------------------------------------------

    def cluster_tensors(self, snapshot: Snapshot) -> Tuple[ClusterTensors, Optional[List[int]]]:
        """Returns (cluster, changed_node_indices). changed is None on a full
        rebuild (meaning: treat every node as changed)."""
        nis = snapshot.node_info_list
        prev_nis = self.node_infos
        if self.cluster is None or prev_nis is None or len(prev_nis) != len(nis):
            return self._full(snapshot)
        if self._assume_gen is not None and snapshot.generation == self._assume_gen:
            # columnar fast path: every cache mutation since the last
            # tensorize was our own assume batch, whose deltas are already
            # in used/used_nz/pod_count (apply_assume_deltas): no per-node
            # requantize, no label/taint/port re-checks. The rows still go
            # back as `changed` so selector-class counts recount them when a
            # constrained batch follows.
            changed = sorted(self._assume_rows)
            self._assume_gen = None
            self._assume_rows = None
            cluster = self.cluster
            for i in changed:
                cluster.cols.node_infos[i] = nis[i]
            self.snap = snapshot
            self.node_infos = list(nis)
            self._tensorized_gen = snapshot.generation
            return cluster, changed
        self._assume_gen = None
        self._assume_rows = None
        if (snapshot.changed_names is not None and self.snap is not None
                and snapshot.changed_from_gen == self.snap.generation):
            # the snapshot carries the diff relative to exactly the snapshot
            # we last tensorized: the same rows the identity walk would find
            name_index = snapshot._name_index
            changed = sorted(name_index[nm] for nm in snapshot.changed_names)
        else:
            changed = [i for i in range(len(nis)) if nis[i] is not prev_nis[i]]
        cluster = self.cluster
        for i in changed:
            ni, old = nis[i], prev_nis[i]
            if (ni.node is None or old.node is None
                    or ni.node.metadata.name != cluster.node_names[i]
                    or ni.node.metadata.labels != old.node.metadata.labels
                    or ni.node.spec.taints != old.node.spec.taints
                    or ni.node.spec.unschedulable != old.node.spec.unschedulable
                    or ni.image_states.keys() != old.image_states.keys()):
                return self._full(snapshot)  # structural: vocab / topo ids move
        if not changed:
            self.snap = snapshot
            self.node_infos = list(nis)
            self._tensorized_gen = snapshot.generation
            return cluster, []
        self._dirty_rows.update(changed)
        dims = cluster.resource_dims
        for i in changed:
            ni = nis[i]
            if set(ni.allocatable.scalar.keys()) - set(dims):
                return self._full(snapshot)  # new extended resource dim
            cluster.alloc[i] = np.array(
                _quantize(ni.allocatable, dims, is_request=False), dtype=np.int32)
            cluster.used[i] = np.array(
                _quantize(ni.requested, dims, is_request=True), dtype=np.int32)
            cluster.used_nz[i] = np.array(
                _quantize(ni.non_zero_requested, dims, is_request=True), dtype=np.int32)
            cluster.pod_count[i] = len(ni.pods) + ni.col_count
            cluster.max_pods[i] = ni.allocatable.allowed_pod_number
            if self._raw_used is not None:
                self._raw_used[i] = _raw_vec(ni.requested, dims)
                self._raw_used_nz[i] = _raw_vec(ni.non_zero_requested, dims)
        # port usage rows (NodeColumns caches them for class table compile)
        cols = cluster.cols
        for i in changed:
            cols.node_infos[i] = nis[i]
            row = np.zeros(cols.port_matrix.shape[1], dtype=bool)
            for (_ip, proto, port) in nis[i].used_ports:
                pi = cols.port_vocab.get((proto, port))
                if pi is None:
                    return self._full(snapshot)  # new port vocab entry: structural
                row[pi] = True
            cols.port_matrix[i] = row
        self.snap = snapshot
        self.node_infos = list(nis)
        self._tensorized_gen = snapshot.generation
        return cluster, changed

    def _full(self, snapshot: Snapshot) -> Tuple[ClusterTensors, None]:
        self.cluster = build_cluster_tensors(snapshot)
        self.snap = snapshot
        self.node_infos = list(snapshot.node_info_list)
        self.selcls_keys = self.selcls_count = None
        self.ns_fingerprint = None
        self._device = {}
        self._device_selcls = None
        self._device_selcls_host = None
        self._dirty_rows.clear()
        self._dirty_all = True
        dims = self.cluster.resource_dims
        self._raw_used = np.array(
            [_raw_vec(ni.requested, dims) for ni in self.node_infos],
            dtype=np.int64).reshape(len(self.node_infos), len(dims))
        self._raw_used_nz = np.array(
            [_raw_vec(ni.non_zero_requested, dims) for ni in self.node_infos],
            dtype=np.int64).reshape(len(self.node_infos), len(dims))
        self._tensorized_gen = snapshot.generation
        self._assume_gen = None
        self._assume_rows = None
        return self.cluster, None

    def apply_assume_deltas(self, rows: np.ndarray, d_raw_used: np.ndarray,
                            d_raw_used_nz: np.ndarray, d_count: np.ndarray,
                            tensorized_gen: int, assume_gen: int) -> bool:
        """Columnar assume accounting: fold a solved batch's per-node raw
        request deltas (the scatter-add keyed by the tensorizer's node index,
        computed by the batch scheduler) straight into the cluster tensors,
        then requantize only the touched rows, vectorized. The rows join the
        dirty set, so kernel B scatters exactly them into the device mirrors
        on the next device_views. Records assume_gen (the cache generation
        after the matching Cache.apply_node_resource_deltas) so the next
        cluster_tensors can prove the snapshot diff is fully explained by
        this batch and skip the per-node walk. Returns False (no-op) when the
        tensors are not at tensorized_gen: a foreign mutation slipped in and
        the normal incremental path must requantize instead."""
        if (self.cluster is None or self._raw_used is None
                or self._tensorized_gen != tensorized_gen):
            return False
        rows = np.asarray(rows)
        dims = self.cluster.resource_dims
        self._raw_used[rows] += d_raw_used
        self._raw_used_nz[rows] += d_raw_used_nz
        self.cluster.used[rows] = _quantize_raw_rows(self._raw_used[rows], dims)
        self.cluster.used_nz[rows] = _quantize_raw_rows(self._raw_used_nz[rows], dims)
        self.cluster.pod_count[rows] = (
            self.cluster.pod_count[rows] + d_count.astype(self.cluster.pod_count.dtype))
        self._dirty_rows.update(int(i) for i in rows)
        if self._assume_rows is None:
            self._assume_rows = set()
        self._assume_rows.update(int(i) for i in rows)
        self._assume_gen = assume_gen
        return True

    # -- device mirrors (the diff -> device stream of cache.go:186) -----------

    def device_views(self, cluster: ClusterTensors, device) -> Dict[str, torch.Tensor]:
        """Device-resident cluster tensors, updated incrementally: a full
        rebuild uploads once; afterwards only dirty node rows (accumulated
        across passes) reach the device: packed into one buffer (every
        mirror's row segments, and the selector-class columns where that
        mirror is reused), one host-to-device copy, one kernel-B launch. The
        mirrors are updated in place (the JAX version rebinds new arrays).
        Returns {field: tensor} for make_inputs(views=...)."""
        device = resolve_device(device)
        dirty = bool(self._dirty_rows)
        full_upload = (self._dirty_all or not self._device
                       or self._device["alloc"].device != device)
        if full_upload:
            self._device = {f: to_device(getattr(cluster, f), device, torch.int32)
                            for f in self.DEVICE_FIELDS}
        # selector-class counts: same treatment, keyed by host-array identity
        # (build_pod_batch reuses the array in place on the incremental path)
        sc = cluster.selcls_count
        sc_fresh = bool(sc.size) and (
            full_upload or self._device_selcls is None
            or self._device_selcls_host is not sc
            or tuple(self._device_selcls.shape) != sc.shape)
        if sc_fresh:
            self._device_selcls = to_device(sc, device, torch.int32)
            self._device_selcls_host = sc
        if dirty and not full_upload:
            self._scatter_dirty(cluster, device, bool(sc.size) and not sc_fresh)
        out = dict(self._device)
        if sc.size:
            out["selcls_count"] = self._device_selcls
        self._dirty_rows.clear()
        self._dirty_all = False
        return out

    def _scatter_dirty(self, cluster: ClusterTensors, device, with_selcls: bool) -> None:
        """One fused scatter of the dirty rows (ascending) into every mirror."""
        rows = np.fromiter(self._dirty_rows, dtype=np.int64, count=len(self._dirty_rows))
        rows.sort()
        if device.type == "cpu":
            packed, segs = pack_mirror_rows(cluster, rows, with_selcls)
            scatter_mirrors_plain(self._mirrors(segs), torch.from_numpy(packed), segs)
            return
        w = mirror_layout(cluster.alloc.shape[1],
                          cluster.selcls_count.shape[0] if with_selcls else 0)[1]
        k = len(rows)
        # the pinned staging buffer must not be repacked while the previous
        # batch's copy may still read it: wait on the event recorded after
        # that copy (the copy is non_blocking)
        if self._stage_event is not None:
            self._stage_event.synchronize()
        if self._stage_host is None or self._stage_host.numel() < k * w:
            cap = max(k * w, 2 * (0 if self._stage_host is None else self._stage_host.numel()))
            self._stage_host = torch.empty(cap, dtype=torch.int32, pin_memory=True)
            self._stage_dev = torch.empty(cap, dtype=torch.int32, device=device)
            self._stage_event = torch.cuda.Event()
        elif self._stage_dev.device != device:
            self._stage_dev = torch.empty(self._stage_host.numel(), dtype=torch.int32,
                                          device=device)
        _packed, segs = pack_mirror_rows(cluster, rows, with_selcls,
                                         out=self._stage_host.numpy())
        dev = self._stage_dev[:k * w].view(k, w)
        dev.copy_(self._stage_host[:k * w].view(k, w), non_blocking=True)
        self._stage_event.record()
        self._scatter_packed(dev, segs)

    def _scatter_packed(self, packed: torch.Tensor, segs: Sequence[MirrorSegment]) -> None:
        """Kernel B: the packed rows on the card into every mirror, one
        launch (the mirrors' descriptors are rebuilt only when a mirror
        changes)."""
        segments = [(t, s.offset, s.width, s.col_mode)
                    for t, s in zip(self._mirrors(segs), segs)]
        key = MirrorSet.key_of(segments, packed.shape[1])
        if self._mirror_set is None or self._mirror_set.key != key:
            self._mirror_set = MirrorSet(segments, packed.shape[1])
        launch_mirror_scatter(self._mirror_set, packed, packed.shape[0])

    def _mirrors(self, segs: Sequence[MirrorSegment]) -> List[torch.Tensor]:
        return [self._device_selcls if s.col_mode else self._device[s.name] for s in segs]


def build_cluster_tensors(snapshot: Snapshot, extra_resource_dims: Sequence[str] = ()) -> ClusterTensors:
    node_infos = snapshot.node_info_list
    n = len(node_infos)
    # resource dims: core three + every extended resource present in allocatable
    extended = set(extra_resource_dims)
    for ni in node_infos:
        extended.update(ni.allocatable.scalar.keys())
    resource_dims = [CPU, MEMORY, EPHEMERAL_STORAGE] + sorted(extended)
    r = len(resource_dims)

    alloc = np.zeros((n, r), dtype=np.int64)
    used = np.zeros((n, r), dtype=np.int64)
    used_nz = np.zeros((n, r), dtype=np.int64)
    pod_count = np.zeros(n, dtype=np.int32)
    max_pods = np.zeros(n, dtype=np.int32)
    for i, ni in enumerate(node_infos):
        alloc[i] = _quantize(ni.allocatable, resource_dims, is_request=False)
        used[i] = _quantize(ni.requested, resource_dims, is_request=True)
        used_nz[i] = _quantize(ni.non_zero_requested, resource_dims, is_request=True)
        # columnar cache rows count toward the node's pod population
        # without being materialized as PodInfo objects
        pod_count[i] = len(ni.pods) + ni.col_count
        max_pods[i] = ni.allocatable.allowed_pod_number

    cols = NodeColumns(node_infos)
    return ClusterTensors(
        node_names=[ni.node.metadata.name for ni in node_infos],
        resource_dims=resource_dims,
        alloc=alloc.astype(np.int32),
        used=used.astype(np.int32),
        used_nz=used_nz.astype(np.int32),
        pod_count=pod_count,
        max_pods=max_pods,
        cols=cols,
        topo_keys=[],
        topo_id=np.zeros((0, n), dtype=np.int32),
        num_domains=np.zeros(0, dtype=np.int32),
        selcls_count=np.zeros((0, n), dtype=np.int32),
    )


def _res_sig(res: dict) -> tuple:
    # {"requests": {...}, "limits": {...}} -> hashable value key; non-dict
    # values degrade to repr
    if not res:
        return ()
    return tuple(
        (k, tuple(sorted(v.items())) if isinstance(v, dict) else repr(v))
        for k, v in sorted(res.items()))


def build_pod_batch(pods: Sequence[Pod], snapshot: Snapshot,
                    cluster: ClusterTensors, ns_labels=None,
                    hard_pod_affinity_weight: int = 1,
                    reuse: Optional[TensorCache] = None,
                    changed_nodes: Optional[List[int]] = None,
                    gangs=None, store_cols=None) -> PodBatchTensors:
    """Group pods into classes, compile class tables, build PTS + IPA tensors.

    reuse + changed_nodes (from TensorCache.cluster_tensors) enable the
    incremental count path: when this batch registers the same selector
    classes as the previous one, per-node match counts are recomputed only
    for changed nodes instead of scanning every bound pod.

    gangs (a scheduler.gang.GangDirectory) threads group-id rows through the
    batch: each pod's PodGroup index, its rank, and the per-class
    slice-packing bonus. Skipped entirely while the directory is inactive
    (no PodGroups).

    store_cols (a store PodColumnsView) re-seeds the per-pod signature memos
    from the store's sig COLUMN: pods freshly parsed by the watch ingest
    carry no `_class_sig`/`_req_sig` memos, but the columnar store captured
    an earlier parse's memo refs — when a column entry's identity anchors
    (spec, labels) still match this pod object, the memos are re-seeded and
    the signature loop hits instead of re-deriving. Never required for
    correctness."""
    ns_labels = ns_labels or {}
    gang_of_pod = gang_keys = gang_bonus = gang_rank = None
    if gangs is not None and gangs.active:
        gang_of_pod, gang_keys, gang_rank = gangs.batch_rows(pods)
    # pod-axis reuse: re-solving the SAME pending backlog skips the per-pod
    # signature/quantization loops (identity comparison of the pod lists)
    prev = getattr(reuse, "_last_batch", None) if reuse is not None else None
    pod_axis = None
    if (prev is not None and len(prev.pods) == len(pods)
            and all(a is b for a, b in zip(prev.pods, pods))):
        pod_axis = prev
    r = len(cluster.resource_dims)
    # memoize by container-resources signature: template-stamped pods compute
    # their request vectors exactly once
    req_cache: Dict[tuple, tuple] = {}
    req_entries: List[tuple] = []  # (quant, quant_nz, active, raw, raw_nz)

    def _req_entry(pod) -> tuple:
        # request-signature memo keyed by spec identity (any change parses a
        # NEW Pod/spec), so the tuple build runs once per pod lifetime
        rs = pod.__dict__.get("_req_sig")
        if rs is not None and rs[0] is pod.spec:
            sig = rs[1]
        else:
            sig = (
                tuple(_res_sig(c.resources) for c in pod.spec.containers),
                tuple(_res_sig(c.resources) for c in pod.spec.init_containers),
                repr(pod.spec.overhead) if pod.spec.overhead else "",
            )
            pod.__dict__["_req_sig"] = (pod.spec, sig)
        got = req_cache.get(sig)
        if got is None:
            pr = compute_pod_resource_request(pod)
            prnz = compute_pod_resource_request(pod, non_zero=True)
            req_entries.append((
                _quantize(pr, cluster.resource_dims, is_request=True),
                _quantize(prnz, cluster.resource_dims, is_request=True),
                # BalancedAllocation PreScore skip rule (balanced_allocation.go)
                pr.milli_cpu != 0 or pr.memory != 0,
                _raw_vec(pr, cluster.resource_dims),
                _raw_vec(prnz, cluster.resource_dims),
            ))
            got = (len(req_entries) - 1, (pr, prnz))
            req_cache[sig] = got
        # seed PodInfo's memoized request pair for the later assume
        if "_req_cache" not in pod.__dict__:
            pod.__dict__["_req_cache"] = got[1]
        return got

    seed_memos = None
    if store_cols is not None:
        _key2row = store_cols.key2row
        _sig_col = store_cols.sig

        def seed_memos(pod):
            # Re-seed the pod's signature memos from the store's sig COLUMN
            # when the identity anchors still hold; a miss (fresh spec, no
            # row) is harmless: the normal derivation runs. Returns True
            # when anything was seeded (the sweep's dry-out signal).
            d = pod.__dict__
            row = _key2row.get(pod.key)
            if row is None:
                return False
            ent = _sig_col[row]
            if ent is None:
                return False
            cs, rs = ent
            seeded = False
            if (cs is not None and "_class_sig" not in d and len(cs) == 3
                    and cs[0] is pod.spec and cs[1] is pod.metadata.labels):
                d["_class_sig"] = cs
                seeded = True
            if (rs is not None and "_req_sig" not in d and len(rs) == 2
                    and rs[0] is pod.spec):
                d["_req_sig"] = rs
                seeded = True
            return seeded

    entry_rows: List[int] = []
    if pod_axis is not None:
        rep_pods = list(pod_axis.tables.rep_pods)
        class_of_pod = pod_axis.class_of_pod
        if getattr(pod_axis, "_resource_dims", None) == tuple(cluster.resource_dims):
            req = pod_axis.req
            req_nz = pod_axis.req_nz
            balanced_active = pod_axis.balanced_active
            raw_req = pod_axis.raw_req
            raw_req_nz = pod_axis.raw_req_nz
        else:
            for pod in pods:
                entry_rows.append(_req_entry(pod)[0])
    else:
        # one fused pass per pod: class signature + request-memo row; the
        # native commit engine runs the same loop over the same dicts (misses
        # call back into the Python helpers), HOSTSCHED_NATIVE_COMMIT=0 the
        # Python loop below
        from ..native import hostcommit

        sig_to_class: Dict[tuple, int] = {}
        rep_pods = []
        if seed_memos is not None:
            # a pre-pass over memo-less pods; adaptive dry-out: a batch whose
            # first 64 memo-less pods find nothing in the column (rows synced
            # before any memo existed) stops consulting it, so the seed path
            # never costs more than the derivation it saves
            probed = hits = 0
            for pod in pods:
                d = pod.__dict__
                if "_class_sig" in d and "_req_sig" in d:
                    continue
                if seed_memos(pod):
                    hits += 1
                probed += 1
                if probed >= 64 and not hits:
                    break
        if pods and hostcommit.selected():
            def _entry_cb(pod):
                return _req_entry(pod)[0]
            class_of_pod, entry_rows = hostcommit.batch_rows(
                pods, sig_to_class, rep_pods, req_cache, pod_class_signature, _entry_cb)
        else:
            class_rows: List[int] = []
            for pod in pods:
                sig = pod_class_signature(pod)
                ci = sig_to_class.get(sig)
                if ci is None:
                    ci = len(rep_pods)
                    sig_to_class[sig] = ci
                    rep_pods.append(pod)
                class_rows.append(ci)
                entry_rows.append(_req_entry(pod)[0])
            class_of_pod = np.asarray(class_rows, dtype=np.int32)

    if len(entry_rows):
        eidx = np.asarray(entry_rows)
        ne = len(req_entries)
        req = np.array([e[0] for e in req_entries], dtype=np.int64).reshape(ne, r)[eidx]
        req_nz = np.array([e[1] for e in req_entries], dtype=np.int64).reshape(ne, r)[eidx]
        balanced_active = np.array([e[2] for e in req_entries], dtype=bool)[eidx]
        raw_req = np.array([e[3] for e in req_entries], dtype=np.int64).reshape(ne, r)[eidx]
        raw_req_nz = np.array([e[4] for e in req_entries], dtype=np.int64).reshape(ne, r)[eidx]
    elif pod_axis is None:
        req = np.zeros((0, r), dtype=np.int64)
        req_nz = np.zeros((0, r), dtype=np.int64)
        balanced_active = np.zeros(0, dtype=bool)
        raw_req = np.zeros((0, r), dtype=np.int64)
        raw_req_nz = np.zeros((0, r), dtype=np.int64)

    tables = compile_class_tables(rep_pods, cluster.cols)

    if gang_of_pod is not None:
        # per-(class, node) packing bonus: classes are gang-exclusive (the
        # gang label is part of pod_class_signature), so the bias rides the
        # class axis like every other static score table
        from ..scheduler.gang import gang_slice_bonus

        gang_bonus = gang_slice_bonus(cluster, class_of_pod, np.asarray(req, dtype=np.int64),
                                      tables.filter_ok, gang_of_pod, len(rep_pods))

    # -- topology keys + selector classes (shared by PTS + IPA) ----------------
    topo_key_idx: Dict[str, int] = {k: i for i, k in enumerate(cluster.topo_keys)}
    selcls_idx: Dict[tuple, int] = {}
    selcls_matchers: List = []  # pod -> bool predicates, one per row

    def topo_row(key: str) -> int:
        if key not in topo_key_idx:
            topo_key_idx[key] = len(topo_key_idx)
            cluster.topo_keys.append(key)
            vocab, ids = cluster.cols.val_ids(key)
            row = ids[None, :].astype(np.int32)
            cluster.topo_id = np.concatenate([cluster.topo_id, row], axis=0) \
                if cluster.topo_id.size else row
            nd = np.array([max(len(vocab), 1)], dtype=np.int32)
            cluster.num_domains = np.concatenate([cluster.num_domains, nd])
        return topo_key_idx[key]

    def selcls_row(key: tuple, matcher) -> int:
        if key not in selcls_idx:
            selcls_idx[key] = len(selcls_matchers)
            selcls_matchers.append(matcher)
        return selcls_idx[key]

    def pts_selcls_row(namespace: str, sel) -> int:
        def matcher(p, _ns=namespace, _sel=sel):
            # PTS counting excludes terminating pods (countPodsMatchSelector)
            return (p.metadata.namespace == _ns
                    and p.metadata.deletion_timestamp is None
                    and _sel.matches(p.metadata.labels))

        return selcls_row(("pts", namespace, repr(sel)), matcher)

    ct_rows, st_rows = [], []
    fallback_class = np.zeros(len(rep_pods), dtype=bool)
    for ci, pod in enumerate(rep_pods):
        if pod.spec.resource_claims or pod.spec.resource_claim_templates:
            # DRA claims need the allocator's Reserve/Unreserve/PreBind
            fallback_class[ci] = True
        if any(v.scheduling_relevant for v in pod.spec.volumes):
            # PVC/ephemeral/shared-disk constraints are not dense-encoded
            fallback_class[ci] = True
        for c in pod.spec.topology_spread_constraints:
            sel = pts_effective_selector(c, pod)
            if sel is None:
                continue
            if c.node_affinity_policy != "Honor" or c.node_taints_policy != "Ignore":
                fallback_class[ci] = True  # non-default inclusion policies
                continue
            row = (
                ci,
                topo_row(c.topology_key),
                pts_selcls_row(pod.metadata.namespace, sel),
                c.max_skew,
                c.min_domains or 0,
                1 if sel.matches(pod.metadata.labels) else 0,
            )
            if c.when_unsatisfiable == "DoNotSchedule":
                ct_rows.append(row)
            else:
                st_rows.append(row)

    # inter-pod affinity rows + holder groups (registers more selector classes)
    ipa = compile_ipa(
        rep_pods, snapshot, topo_row, selcls_row, ns_labels,
        hard_pod_affinity_weight,
        node_name_to_idx=cluster.cols.name_to_idx, n_nodes=cluster.n,
    )

    # existing matching-pod counts per (selector-class, node)
    sc = len(selcls_matchers)
    selcls_key_tuple = tuple(selcls_idx.keys())

    def _count_node_column(ni) -> np.ndarray:
        col = np.zeros(sc, dtype=np.int32)
        for pinfo in ni.pods:
            p = pinfo.pod
            for si, matcher in enumerate(selcls_matchers):
                if matcher(p):
                    col[si] += 1
        return col

    # IPA namespaceSelector matchers resolve against the live ns_labels
    # table, which the selector-class keys do NOT capture
    ns_fp = tuple(sorted(
        (ns, tuple(sorted(lbls.items()))) for ns, lbls in ns_labels.items()))
    if sc == 0:
        selcls_count = np.zeros((0, cluster.n), dtype=np.int32)
    elif (reuse is not None and changed_nodes is not None
            and reuse.selcls_keys == selcls_key_tuple
            and reuse.ns_fingerprint == ns_fp
            and reuse.selcls_count is not None
            and reuse.selcls_count.shape == (sc, cluster.n)):
        # incremental: only changed nodes rescan their pods
        selcls_count = reuse.selcls_count
        for nidx in changed_nodes:
            selcls_count[:, nidx] = _count_node_column(snapshot.node_info_list[nidx])
    else:
        selcls_count = np.zeros((sc, cluster.n), dtype=np.int32)
        for nidx, ni in enumerate(snapshot.node_info_list):
            selcls_count[:, nidx] = _count_node_column(ni)
    if reuse is not None:
        reuse.selcls_keys = selcls_key_tuple
        reuse.selcls_count = selcls_count
        reuse.ns_fingerprint = ns_fp
    cluster.selcls_count = selcls_count

    # cross-match: placing a pod of class c bumps counts of selector-class sc?
    class_matches = np.zeros((len(rep_pods), max(sc, 1)), dtype=np.int32)
    for ci, pod in enumerate(rep_pods):
        for si, matcher in enumerate(selcls_matchers):
            if matcher(pod):
                class_matches[ci, si] = 1

    def rows_to_arrays(rows, with_min_domains):
        if not rows:
            z = np.zeros(0, dtype=np.int32)
            return (z, z, z, z, z, z) if with_min_domains else (z, z, z, z, z)
        a = np.array(rows, dtype=np.int32)
        if with_min_domains:
            return a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], a[:, 5]
        return a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 5]

    ct_class, ct_key, ct_sel, ct_max_skew, ct_min_domains, ct_self = rows_to_arrays(ct_rows, True)
    st_class, st_key, st_sel, st_max_skew, st_self = rows_to_arrays(st_rows, False)

    from ..scheduler.framework import _host_ports

    class_has_host_ports = np.array(
        [any(True for _ in _host_ports(p)) for p in rep_pods], dtype=bool)

    out = PodBatchTensors(
        pods=list(pods),
        class_of_pod=class_of_pod,
        req=np.asarray(req, dtype=np.int32),
        req_nz=np.asarray(req_nz, dtype=np.int32),
        balanced_active=balanced_active,
        tables=tables,
        ct_class=ct_class, ct_key=ct_key, ct_sel=ct_sel,
        ct_max_skew=ct_max_skew, ct_min_domains=ct_min_domains, ct_self_match=ct_self,
        st_class=st_class, st_key=st_key, st_sel=st_sel,
        st_max_skew=st_max_skew, st_self_match=st_self,
        class_matches_selcls=class_matches,
        ipa=ipa,
        fallback_class=fallback_class,
        raw_req=np.asarray(raw_req, dtype=np.int64),
        raw_req_nz=np.asarray(raw_req_nz, dtype=np.int64),
        class_has_host_ports=class_has_host_ports,
        gang_of_pod=gang_of_pod,
        gang_keys=gang_keys or None,
        gang_bonus=gang_bonus,
        gang_rank=gang_rank,
    )
    if reuse is not None:
        # the cached req vectors are only valid against the same resource-dim
        # layout (a dim swap with equal length would misquantize silently)
        out._resource_dims = tuple(cluster.resource_dims)
        reuse._last_batch = out
    return out
