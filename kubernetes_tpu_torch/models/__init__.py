"""L5 — the fast-mode solvers, waterfill (kernel C) and propose-and-repair
(kernel D), the gang kernels, victim cover (G) and rank alignment (H), and
the transport solvers, auction (kernel E) and Sinkhorn (kernel F), on the
rows of kernel J, and the rebalancer's slice defragmentation (kernel I).
Import them from their modules, as the JAX package's models/ does."""
