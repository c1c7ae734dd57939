"""Backward by recomputation through a plain version, as the JAX package's
``custom_vjp``s recompute through their ``_xla_forward`` twins."""

from __future__ import annotations

import torch


def plain_vjp(fn, inputs, grad_out, needs_grad=None) -> tuple:
    """Gradients of ``fn(*inputs)`` against ``grad_out`` for each input
    (None where ``needs_grad`` says no), by running ``fn`` again under
    autograd on detached copies of the saved inputs."""
    if needs_grad is None:
        needs_grad = [True] * len(inputs)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs_grad)]
        out = fn(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)
