"""PyTorch + CUDA port of ``climatemodel_tpu`` for NVIDIA Hopper GPUs.

Mirrors the JAX package's module paths and public names.  Plain tensor code
is PyTorch; every Pallas kernel of the JAX package is hand-written CUDA
(``ops/csrc/*.cu``: the grey two-stream walks, the isotonic fit and the
division probe, the fused shallow-water Richtmyer step), built with
``nvcc`` at first use.  The port imports neither ``jax`` nor
``climatemodel_tpu``.
"""
__version__ = "0.1.0"
