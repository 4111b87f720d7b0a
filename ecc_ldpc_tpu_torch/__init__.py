"""ecc_ldpc_tpu_torch — the PyTorch/CUDA port of ecc_ldpc_tpu.

Module names mirror the JAX package (codes/, graph/, encode/, chan/,
learn/, decode/, bench/) so each counterpart is easy to find. Importing
this package imports nothing else: every module is imported where it is
used, and CUDA kernels are built on first launch (see _build.py).

Entry points that create tensors take a `device` argument, default
"cuda", and raise when CUDA is absent unless the caller passes
device="cpu" (the plain PyTorch path the CPU tests run).
"""
