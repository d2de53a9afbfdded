#!/usr/bin/env python3
"""Checks that ops/kernels.py sinkhorn_order describes the order in which
this card's torch adds a float32 [G, N] tensor over dim 1 and dim 0.

    python3 tools/torch_sum_order.py

Kernel F adds its row and column sums in that order so that its duals
match the plain version's on the card bit for bit. For each shape below
the script sums seeded exp-like rows on the card with torch (as
_sinkhorn_iters_plain's logsumexp does), redoes each sum in numpy float32
in the order sinkhorn_order gives, and prints one JSON line per shape: the
order, and how many row and column sums matched bit for bit (rows whose
start is misaligned, g * N % 4 != 0 at N >= 128, are left out: torch adds
their head separately). Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 5000), (8, 5000), (5, 300), (3, 24), (2, 7), (3, 1), (128, 10000), (2100, 40),
          (4, 600), (12, 500), (1, 10000), (2, 5000), (16, 5000), (1, 130), (3, 4999),
          (64, 1000), (3500, 40), (2, 20000)]


def halving(v):
    v, o = [np.float32(x) for x in v], len(v) // 2
    while o:
        for k in range(o):
            v[k] = np.float32(v[k] + v[k + o])
        o //= 2
    return v[0]


def partial(vals, elems):
    acc = [np.float32(0)] * 4
    for s, j in enumerate(elems):
        acc[s % 4] = np.float32(acc[s % 4] + vals[j])
    return np.float32(np.float32(np.float32(acc[0] + acc[1]) + acc[2]) + acc[3])


def row_sum(row, order):
    n, bw, by = len(row), order["bw"], order["by"]
    w = bw * by

    def elems(x, y):
        t = x + bw * y
        if not order["vec"]:
            return list(range(t, n, w))
        v = n // 4
        out = [4 * u + i for u in range(t, v, w) for i in range(4)]
        return out + ([4 * v + x] if y == 0 and x < n - 4 * v else [])

    return halving([halving([partial(row, elems(x, y)) for x in range(bw)]) for y in range(by)])


def col_sum(col, order):
    cy = order["cy"]
    return halving([partial(col, list(range(y, len(col), cy))) for y in range(cy)])


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_sum_order: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops.kernels import sinkhorn_order

    rng = np.random.default_rng(0)
    for g, n in SHAPES:
        x = np.exp(-rng.random((g, n)) * rng.choice([2.0, 20.0], size=(g, 1))).astype(np.float32)
        t = torch.from_numpy(x).cuda()
        a = torch.exp(t - t.max(dim=1, keepdim=True).values)
        rows, cols, av = a.sum(dim=1).cpu().numpy(), a.sum(dim=0).cpu().numpy(), a.cpu().numpy()
        order = sinkhorn_order(g, n)
        checked = [i for i in range(min(g, 4)) if n < 128 or i * n % 4 == 0]
        row_ok = sum(row_sum(av[i], order) == rows[i] for i in checked)
        col_idx = range(min(n, 24))
        col_ok = sum(col_sum(av[:, j], order) == cols[j] for j in col_idx)
        print(json.dumps({"G": g, "N": n, "order": order, "rows_checked": len(checked),
                          "rows_equal": int(row_ok), "cols_checked": len(col_idx),
                          "cols_equal": int(col_ok), "torch": torch.__version__}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
