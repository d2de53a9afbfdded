"""Shared-memory column segments: the columnar store's numeric columns as
`multiprocessing.shared_memory` blocks that cross process boundaries.

The counterpart of `kubernetes_tpu/store/shm.py`. The columnar pod rows
(store/columnar.py) keep the scheduler pipeline's hot fields as flat numpy
arrays; this module lets those arrays live in named POSIX shared memory so a
WORKER PROCESS (scheduler/mpsched.py) can map them read-only and solve
against live cluster state without pickling a single Pod: only columns and
keys cross the boundary. Nothing here imports torch.

Layout per column group ("arena"):

  {base}.ctl        16-byte control segment: [magic, latest_generation].
                    Its NAME never changes — readers resolve the live data
                    segment through it, so grow-by-remap never strands a
                    late attacher.
  {base}.g{N}       generation-N data segment: a 64-byte header
                    [magic, generation, nrows, capacity, version,
                    moved_to_gen, ncols, reserved] followed by the columns
                    back-to-back at fixed capacity. Offsets are derived
                    from (schema, capacity) — both sides share the schema
                    in code, the header carries the capacity.

Grow-by-remap: the owner allocates {base}.g{N+1} at double capacity,
copies every column, publishes the new generation in the control segment,
stamps the OLD header's moved_to_gen, and unlinks the old name. Readers
holding the old mapping still read it safely (unlink removes the name,
not the mapping), notice moved_to_gen (or the control generation) on
their next refresh(), and remap.

Ownership: the creating process is the only writer — readers get numpy
views with `writeable=False` (the store's read-only contract, extended
across the process boundary). The `version` field is a seqlock over the
HEADER (nrows), not the column bytes: concurrent column reads may tear,
which is fine for every consumer here — worker reads are advisory
(row_rv snapshots are re-validated by the owner at bind arbitration).

Lifecycle: every create is paired with close+unlink on a finally/stop path
— ShmArena.close() unlinks the data AND control segments and is
idempotent; readers close their mappings only. A `/dev/shm/kttorch-*`
entry left after stop() is a leak (leaked_segments() finds it). The port's
prefix differs from the JAX package's ("ktpu"), so the two packages' leak
checks never see each other's segments.

Resource tracker: before Python 3.13, SharedMemory registers with the
resource tracker even on ATTACH, and multiprocessing children SHARE the
parent's tracker process — so a reader's registration is a duplicate entry
in the owner's cache, and unregistering it would delete the owner's
crash-cleanup protection. Attaches here suppress the registration instead
(`_attach`); only the owner's create-side registration exists, which is
exactly the crash-cleanup the tracker is for.
"""

from __future__ import annotations

import os
import secrets
from typing import Dict, List, Optional, Sequence, Tuple

try:
    import numpy as np
except Exception:  # pragma: no cover - numpy-less rigs run the dict path
    np = None  # type: ignore

try:
    from multiprocessing import resource_tracker, shared_memory
except Exception:  # pragma: no cover - exotic platforms
    shared_memory = None  # type: ignore
    resource_tracker = None  # type: ignore

MAGIC = 0x4B545055  # "KTPU", the JAX package's layout
HEADER_WORDS = 8  # int64 each
HEADER_BYTES = HEADER_WORDS * 8
_H_MAGIC, _H_GEN, _H_NROWS, _H_CAP, _H_VER, _H_MOVED, _H_NCOLS, _H_RSV = \
    range(HEADER_WORDS)
CTL_WORDS = 2
CTL_BYTES = CTL_WORDS * 8

# the one prefix every arena name of the port carries: leak checks scan
# /dev/shm for it, so a forgotten close() cannot hide. It must not start
# with the JAX package's "ktpu": each package's tests assert that no
# segment of its own prefix is left, and they run side by side.
NAME_PREFIX = "kttorch"


def available() -> bool:
    return np is not None and shared_memory is not None


def _attach(name: str):
    """Attach to an existing segment WITHOUT a resource_tracker
    registration. Python 3.10 registers on attach too (module docstring),
    and multiprocessing children share the parent's tracker process — so an
    attach-then-unregister would delete the OWNER's crash-cleanup entry
    from the shared cache (and make the owner's later unlink a noisy
    double-unregister). Suppressing the register call leaves the owner's
    registration — the only one that should exist — untouched."""
    if resource_tracker is None:  # pragma: no cover - exotic platforms
        return shared_memory.SharedMemory(name=name)
    reg = resource_tracker.register
    try:
        resource_tracker.register = lambda *a, **kw: None
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = reg


def fresh_base_name(tag: str = "cols") -> str:
    """A collision-resistant arena base name: pid + random suffix, carrying
    the leak-scan prefix."""
    return f"{NAME_PREFIX}-{os.getpid()}-{tag}-{secrets.token_hex(4)}"


def leaked_segments() -> List[str]:
    """Every live /dev/shm entry carrying the arena prefix — the unlink-
    clean assertion's probe (empty on non-Linux fallback)."""
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith(NAME_PREFIX))
    except Exception:  # pragma: no cover - non-Linux
        return []


def _col_bytes(schema: Sequence[Tuple[str, str]], capacity: int) -> int:
    return sum(np.dtype(dt).itemsize for _n, dt in schema) * capacity


def _map_columns(buf, schema: Sequence[Tuple[str, str]], capacity: int,
                 writeable: bool) -> Dict[str, "np.ndarray"]:
    """Column views over a segment buffer at the layout the schema +
    capacity imply. Offsets are deterministic: header, then each column at
    its dtype's itemsize * capacity."""
    cols: Dict[str, np.ndarray] = {}
    off = HEADER_BYTES
    for name, dt in schema:
        d = np.dtype(dt)
        arr = np.ndarray((capacity,), dtype=d, buffer=buf, offset=off)
        if not writeable:
            arr.flags.writeable = False
        cols[name] = arr
        off += d.itemsize * capacity
    return cols


class ShmArena:
    """Owner side of one shared column group. All mutation happens in the
    creating process; `publish()` makes a row count visible to readers."""

    def __init__(self, schema: Sequence[Tuple[str, str]],
                 capacity: int = 1024, base_name: Optional[str] = None):
        if not available():
            raise RuntimeError("shared-memory columns need numpy + "
                               "multiprocessing.shared_memory")
        self.schema = [(n, str(np.dtype(d))) for n, d in schema]
        self.base_name = base_name or fresh_base_name()
        self.capacity = int(capacity)
        self.generation = 0
        self._closed = False
        self._ctl = shared_memory.SharedMemory(
            name=f"{self.base_name}.ctl", create=True, size=CTL_BYTES)
        ctl = np.ndarray((CTL_WORDS,), dtype=np.int64, buffer=self._ctl.buf)
        ctl[0] = MAGIC
        ctl[1] = 0
        self._seg = None
        self._alloc_segment(self.capacity, generation=0)

    # -- segment lifecycle -----------------------------------------------------

    def _seg_name(self, gen: int) -> str:
        return f"{self.base_name}.g{gen}"

    def _alloc_segment(self, capacity: int, generation: int) -> None:
        size = HEADER_BYTES + _col_bytes(self.schema, capacity)
        seg = shared_memory.SharedMemory(
            name=self._seg_name(generation), create=True, size=size)
        hdr = np.ndarray((HEADER_WORDS,), dtype=np.int64, buffer=seg.buf)
        hdr[_H_MAGIC] = MAGIC
        hdr[_H_GEN] = generation
        # fresh segment: no reader can map this generation until the
        # control word flips, so the header/column writes here need no
        # version bracket (the first publish() does)
        hdr[_H_NROWS] = 0
        hdr[_H_CAP] = capacity
        hdr[_H_VER] = 0
        hdr[_H_MOVED] = 0
        hdr[_H_NCOLS] = len(self.schema)
        self._seg = seg
        self._hdr = hdr
        self.capacity = capacity
        self.generation = generation
        self.arrays = _map_columns(seg.buf, self.schema, capacity,
                                   writeable=True)

    def grow(self, min_capacity: int) -> None:
        """Grow-by-remap: new generation at >= min_capacity (pow2 doubling),
        columns copied, control bumped, old header stamped with the forward
        pointer, old NAME unlinked (live mappings stay valid)."""
        new_cap = max(self.capacity, 1)
        while new_cap < min_capacity:
            new_cap *= 2
        old_seg, old_hdr, old_arrays = self._seg, self._hdr, self.arrays
        old_nrows = int(old_hdr[_H_NROWS])
        gen = self.generation + 1
        self._alloc_segment(new_cap, generation=gen)
        for name, _dt in self.schema:
            src = old_arrays[name]
            self.arrays[name][: len(src)] = src
        # grow-by-remap writes into the NEW generation's segment, invisible
        # to readers until ctl[1] flips below — the version bracket is only
        # needed once it is live
        self._hdr[_H_NROWS] = old_nrows
        ctl = np.ndarray((CTL_WORDS,), dtype=np.int64, buffer=self._ctl.buf)
        ctl[1] = gen
        old_hdr[_H_MOVED] = gen
        old_seg.close()
        try:
            old_seg.unlink()
        except Exception:  # pragma: no cover - raced external unlink
            pass

    def publish(self, nrows: int) -> None:
        """Seqlock publish of the visible row count (odd version = publish
        in progress)."""
        hdr = self._hdr
        hdr[_H_VER] += 1
        hdr[_H_NROWS] = nrows
        hdr[_H_VER] += 1

    @property
    def nrows(self) -> int:
        return int(self._hdr[_H_NROWS])

    def close(self) -> None:
        """Unlink everything this arena created. Idempotent; safe to call
        from finally/stop paths."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._seg is not None:
                self._seg.close()
                self._seg.unlink()
        except Exception:
            pass
        finally:
            try:
                self._ctl.close()
                self._ctl.unlink()
            except Exception:
                pass

    def __enter__(self) -> "ShmArena":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict:
        return {"base": self.base_name, "generation": self.generation,
                "capacity": self.capacity, "nrows": self.nrows,
                "columns": [n for n, _d in self.schema],
                "bytes": HEADER_BYTES + _col_bytes(self.schema,
                                                   self.capacity)}


class ShmArenaReader:
    """Reader side: maps the live generation READ-ONLY; refresh() follows
    grow-by-remap. Safe in any process (including the owner's, for tests).
    Column reads are advisory — see the module docstring's seqlock note."""

    def __init__(self, base_name: str, schema: Sequence[Tuple[str, str]]):
        if not available():
            raise RuntimeError("shared-memory columns need numpy + "
                               "multiprocessing.shared_memory")
        self.base_name = base_name
        self.schema = [(n, str(np.dtype(d))) for n, d in schema]
        self._ctl = _attach(f"{base_name}.ctl")
        ctl = np.ndarray((CTL_WORDS,), dtype=np.int64, buffer=self._ctl.buf)
        if int(ctl[0]) != MAGIC:
            raise ValueError(f"{base_name}: bad arena magic")
        self._ctl_arr = ctl
        self._seg = None
        self.generation = -1
        self._attach(int(ctl[1]))

    def _attach(self, gen: int) -> None:
        seg = _attach(f"{self.base_name}.g{gen}")
        hdr = np.ndarray((HEADER_WORDS,), dtype=np.int64, buffer=seg.buf)
        hdr.flags.writeable = False
        magic, ncols = int(hdr[_H_MAGIC]), int(hdr[_H_NCOLS])
        if magic != MAGIC or ncols != len(self.schema):
            # read the header BEFORE the close: a view of an unmapped
            # segment must never be touched again (the JAX reader reads it
            # after the close and crashes the process)
            del hdr
            seg.close()
            if magic != MAGIC:
                raise ValueError(f"{self.base_name}.g{gen}: bad segment magic")
            raise ValueError(f"{self.base_name}.g{gen}: schema mismatch "
                             f"({ncols} cols, expected {len(self.schema)})")
        old = self._seg
        self._seg = seg
        self._hdr = hdr
        self.generation = gen
        self.capacity = int(hdr[_H_CAP])
        self.arrays = _map_columns(seg.buf, self.schema, self.capacity,
                                   writeable=False)
        if old is not None:
            old.close()

    def refresh(self) -> bool:
        """Follow a grow-by-remap if one happened; True when remapped."""
        gen = int(self._ctl_arr[1])
        if gen != self.generation or int(self._hdr[_H_MOVED]):
            self._attach(gen)
            return True
        return False

    @property
    def nrows(self) -> int:
        """Seqlock-consistent row count (retries a mid-publish read)."""
        hdr = self._hdr
        for _ in range(64):
            v0 = int(hdr[_H_VER])
            n = int(hdr[_H_NROWS])
            if v0 % 2 == 0 and int(hdr[_H_VER]) == v0:
                return n
        return int(hdr[_H_NROWS])  # pragma: no cover - writer wedged mid-pub

    def close(self) -> None:
        """Close the mappings (readers never unlink — the owner owns the
        names)."""
        try:
            if self._seg is not None:
                self._seg.close()
                self._seg = None
        finally:
            try:
                self._ctl.close()
            except Exception:
                pass


# -- the columnar store's numeric segments --------------------------------------

# the PodColumns numeric columns that cross the process boundary — the
# scheduler pipeline's hot fields (store/columnar.py module docstring).
# bool diverged rides as int8 (numpy bool itemsize 1, stable across procs).
POD_COLS_SCHEMA = (
    ("ns_id", "int32"),
    ("node_id", "int32"),
    ("row_rv", "int64"),
    ("phase_id", "int32"),
    ("priority", "int64"),
    ("rank", "int32"),
    ("diverged", "bool"),
)

# the mpsched owner's per-round worker feeds (scheduler/mpsched.py):
# node shard columns ...
NODE_COLS_SCHEMA = (
    ("alloc_cpu", "int64"),   # allocatable cpu, millicores
    ("alloc_mem", "int64"),   # allocatable memory, bytes
    ("alloc_pods", "int64"),  # allocatable pod slots
    ("used_cpu", "int64"),    # committed cpu of bound/assumed pods
    ("used_mem", "int64"),
    ("used_pods", "int64"),
    ("worker", "int32"),      # owning worker slot; -1 = excluded (tainted)
)

# ... and the pending-pod batch columns (requests + routing). Workers read
# row_rv/node_id for these store_rows straight from the POD_COLS segment.
BATCH_COLS_SCHEMA = (
    ("store_row", "int64"),   # row into the store's pod columns
    ("cpu", "int64"),         # request, millicores
    ("mem", "int64"),         # request, bytes
    ("worker", "int32"),      # assigned worker slot this round
)
