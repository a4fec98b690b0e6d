"""PyTorch + CUDA port of the heterogeneity-aware gradient coding runtime.

Mirrors the module layout of the JAX package ``repro`` and imports nothing
from it.  See README.md for what is ported so far.
"""
