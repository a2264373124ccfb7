"""Device compute kernels (JAX/XLA), batched over macroblocks.

This layer is the batched equivalent of the reference's VFT kernel
table (`src/h264-lab.h:3274-3366`): every pixel/DSP kernel the C encoder
dispatches per-macroblock is re-designed here as a batched tensor op over
`(n_mb, …)` arrays, jit-compiled and fused by XLA.
"""
