"""PyTorch + CUDA port of ``flair_for_aigle_tpu`` for NVIDIA Hopper.

The JAX package stays the numerical reference; this package mirrors its
layout (``models/``, ``ops/``, ``zonal/``, ``train/``, ``writer/``,
``parallel/``) so each counterpart is easy to find. It imports nothing of
the JAX package: the framework-free host modules it needs (``geo``,
``data``, ``zonal.{slicing,dataset,config}``, ``writer.metrics_*``,
``utils``) are copies, which differ from the originals only in their
imports.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, the CLIs' ``--device cpu``); they raise when ``cuda`` is
asked for and there is no card.

The Pallas kernels on the zonal and training paths are hand-written CUDA
C++ kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). Each kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors; every op
is differentiable.
"""
