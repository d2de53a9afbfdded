"""Native host engines: C++ behind ctypes, built by g++ at first use.

The counterpart of `kubernetes_tpu/native/`, with the port's own copies of
both sources:

  hostsched.cpp   array kernels loaded with ctypes.CDLL, which RELEASES the
                  GIL for every call: the columnar assume's scatter-add
                  (commit_deltas) and solver="native"'s host greedy solve
                  (greedy_assign). Never call them under a store or
                  scheduler lock.
  hostcommit.cpp  the C-API commit engine loaded with ctypes.PyDLL (GIL
                  HELD): the store's bind/delete commit loops, the columnar
                  bind prepare, the cache's assume loop and build_pod_batch's
                  fused row loop, each byte-identical to the port's Python
                  loop (tests/test_torch_native.py).

Both build into `build/torch_kernels/` from the sources in the checkout.
Unlike the JAX loaders, which fall back to the Python loops when g++ or
Python.h is missing, a selected engine whose build fails raises; the
switches (HOSTSCHED_NATIVE_COMMIT, STORE_NATIVE_COMMIT,
APIStore(native_commit=False)) select the Python loops explicitly. These are
host engines: no CUDA kernel ever falls back to them.
"""

from . import hostcommit, hostsched  # noqa: F401
from .hostsched import native_commit_deltas, native_greedy_solve, native_solvable  # noqa: F401
