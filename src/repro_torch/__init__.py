"""PyTorch/CUDA port of the ANTAREX DSL runtime (`repro` is the JAX reference).

Mirrors `repro` path for path; imports torch, numpy and the standard
library only.  Hand-written CUDA kernels live under `csrc/` and are built at
first use (see `kernels/build.py`).
"""
