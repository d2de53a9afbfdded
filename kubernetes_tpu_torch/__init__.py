"""PyTorch/CUDA port of kubernetes_tpu for one NVIDIA Hopper card.

A second package beside the JAX reference, laid out the same way (`api/`,
`store/`, `scheduler/`, `snapshot/`, `models/`, `ops/`). It imports torch
and numpy, never jax and nothing of `kubernetes_tpu`. Device work runs in
kernels written by hand for sm_90a under `csrc/`, built with nvcc at first
use (`ops/kernels.py`): the batch scheduler's scan (A) and device mirrors
(B), waterfill (C) and the repair check (D) of the fast/auto modes, the
gang cover (G) and rank alignment (H), the transport modes' feasibility
rows (J), auction phase (E) and Sinkhorn iterations (F), and the background
rebalancer's defrag assignment (I). Entry points take
an explicit `device`, default to "cuda", and raise where no card is
present; the CPU is used only when the caller passes device="cpu", and then
each kernel's plain PyTorch version runs.
"""
