"""PyTorch + CUDA port of ``climatemodel_tpu`` for NVIDIA Hopper GPUs.

Mirrors the JAX package's module paths and public names.  Plain tensor code
is PyTorch; the grey two-stream kernels are hand-written CUDA
(``ops/csrc/two_stream.cu``), built with ``nvcc`` at first use.  The port
imports neither ``jax`` nor ``climatemodel_tpu``.
"""
__version__ = "0.1.0"
