"""Tensor ops: resize semantics and the hand-written CUDA kernels.

``prep``, ``window_attn``, ``ffn``, ``merge`` and ``epilogue`` each hold a
kernel wrapper and its plain PyTorch version (``<fn>_reference``);
``window_attn`` also holds the attention backward kernel's.
"""
