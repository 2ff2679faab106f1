"""Tensor ops: RNG, planar vector math, table lookups, BVH build, and the
trace op with its hand-written CUDA kernels."""
