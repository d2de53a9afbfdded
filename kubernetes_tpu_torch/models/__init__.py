"""L5 — the fast-mode solvers: waterfill (kernel C) and propose-and-repair
(kernel D). Import them from their modules."""
