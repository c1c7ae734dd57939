"""PyTorch + CUDA port of ``flair_for_aigle_tpu`` for NVIDIA Hopper.

The JAX package stays the numerical reference; this package mirrors its
layout (``models/``, ``ops/``, ``zonal/``, ``train/``, ``writer/``,
``parallel/``) so each counterpart is easy to find. Framework-free host
modules (``geo``, ``data``, ``zonal.slicing``, ``zonal.dataset``,
``zonal.config``, ``writer.metrics_*``, ``utils``) are imported from the
JAX package, which does not pull ``jax`` into ``sys.modules``.

The Pallas kernels on the zonal and training paths are hand-written CUDA
C++ kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). Each kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors; every op
is differentiable.
"""
