"""Carry solver state across from numpy, with dtypes checked.

The tests hand the JAX package's tensors to the port through here, so both
solvers see the same inputs: `solver_inputs_from_numpy` takes the fields of
a JAX `SolverInputs` as numpy (`{k: np.asarray(v) for k, v in
inp._asdict().items()}`) and returns the port's, on `device`;
`cluster_from_numpy` does the same for the array fields of `ClusterTensors`.
A field whose dtype is not the one the port expects (int32 or bool) raises
instead of being cast.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..snapshot.tensorizer import ClusterTensors
from .solver import FIELD_DTYPES, SolverInputs, to_device

_NP_DTYPE = {torch.int32: np.dtype(np.int32), torch.bool: np.dtype(np.bool_)}

CLUSTER_ARRAYS = {"alloc": np.int32, "used": np.int32, "used_nz": np.int32,
                  "pod_count": np.int32, "max_pods": np.int32, "topo_id": np.int32,
                  "num_domains": np.int32, "selcls_count": np.int32}


def _checked(name: str, a, want: np.dtype) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != want:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {want}")
    return a


def solver_inputs_from_numpy(fields: Mapping[str, np.ndarray], device) -> SolverInputs:
    """Numpy SolverInputs fields -> the port's SolverInputs on `device`."""
    out = {}
    for name, dtype in FIELD_DTYPES.items():
        a = fields.get(name)
        if a is None:
            if name != "gang_bonus":
                raise KeyError(f"solver input {name} is missing")
            out[name] = None
            continue
        out[name] = to_device(_checked(name, a, _NP_DTYPE[dtype]), device, dtype)
    return SolverInputs(**out)


def cluster_from_numpy(fields: Mapping) -> ClusterTensors:
    """ClusterTensors array fields (+ node_names, resource_dims, topo_keys)
    -> the port's ClusterTensors (host numpy; cols is not carried)."""
    arrays = {name: np.array(_checked(name, fields[name], np.dtype(dt)), copy=True)
              for name, dt in CLUSTER_ARRAYS.items()}
    return ClusterTensors(node_names=list(fields["node_names"]),
                          resource_dims=list(fields["resource_dims"]),
                          topo_keys=list(fields.get("topo_keys", ())), cols=None, **arrays)
