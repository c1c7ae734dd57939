"""Tensor ops: resize semantics and the hand-written CUDA kernels.

``prep``, ``window_attn``, ``ffn`` and ``epilogue`` each hold one kernel
wrapper and its plain PyTorch version (``<fn>_reference``).
"""
