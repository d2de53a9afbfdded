"""L5 — device solvers (ops/solver.py) and the hand-written kernels that run
them on the card (ops/kernels.py, csrc/)."""
