"""PyTorch + CUDA port of glsdet_tpu for NVIDIA Hopper.

Mirrors the layout of ``glsdet_tpu`` (models/, ops/, ufp/, eval/,
assign/, losses/, train/, native/, utils/) and adds ``csrc/``, the
hand-written CUDA kernels that replace the JAX package's Pallas kernels.  Imports torch and numpy only;
the JAX package is the reference the port's tests hold it against.
"""
