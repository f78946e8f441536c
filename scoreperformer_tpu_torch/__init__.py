"""PyTorch/CUDA port of scoreperformer_tpu.

The JAX package stays the reference; this package imports nothing of it.
Its kernels are hand-written CUDA for Hopper (sm_90a) under `csrc/`, each
with a plain PyTorch version beside it (`ops/`).
"""
