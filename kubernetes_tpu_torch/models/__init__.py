"""L5 — the fast-mode solvers, waterfill (kernel C) and propose-and-repair
(kernel D), and the gang kernels, victim cover (G) and rank alignment (H).
Import them from their modules."""
