"""Process groups and collectives on ``torch.distributed`` (port of
``flair_for_aigle_tpu/parallel/dist.py``, whose helpers import jax inside
the call). A process that never joined a process group is rank 0 of 1, and
every collective here is then the identity.

Data-parallel training keeps the JAX package's global-batch semantics
(what GSPMD gives it): each rank's loss is its share of the global loss
(``train/losses.py`` divides by the global weight sum), so the gradients
are *summed* over the ranks (``all_reduce_grads``), and BatchNorm takes its
statistics over the global batch through ``AllReduceSum``. Only
``all_reduce`` and ``broadcast`` are used: gloo supports no other
collective on CUDA tensors.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _group_active() else 0


def world_size() -> int:
    return dist.get_world_size() if _group_active() else 1


def is_rank_zero() -> bool:
    return process_index() == 0


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda",
               backend: str | None = None) -> torch.device:
    """Join the process group and return the device this process runs on.

    Without arguments it reads torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); an
    explicit ``init_method`` (``tcp://host:port``) takes ``world_size`` and
    ``rank`` from the arguments. The backend is ``nccl`` for a CUDA device
    and ``gloo`` for ``device="cpu"`` unless ``backend`` names one. A CUDA
    device without an index becomes ``cuda:LOCAL_RANK`` and is made current.
    A single process with no ``init_method`` joins nothing (as the JAX
    package's ``initialize``), and a process already in a group stays in
    it. Raises when a CUDA device is asked for and no card is present."""
    from flair_for_aigle_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if world_size == 1 and init_method is None and not _group_active():
        return dev
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if _group_active():
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size, rank=rank)
    return dev


def _reduce_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_over_group(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group, outside autograd (``t`` itself in a
    group of one or with no group)."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group; the gradient of x is the sum of
    the ranks' gradients of y, since every rank's y is the same sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        g = grad.clone()
        dist.all_reduce(g)
        return g


class ReplayedSum(torch.autograd.Function):
    """``y``, the group sum that an earlier ``AllReduceSum`` of the same
    values returned, as a function of this rank's ``x``: the forward sends
    nothing, the backward is ``AllReduceSum``'s. A checkpointed block's
    recompute (``models/layers.py remat``) replays its BatchNorms' sums so,
    sparing the forward collective a second time."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return y.clone()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.clone()
        dist.all_reduce(g)
        return g, None


def all_reduce_grads(grads) -> tuple:
    """The gradients summed over the group (one all_reduce of their flat
    concatenation), None where a gradient is None; ``grads`` itself in a
    group of one."""
    grads = tuple(grads)
    if world_size() == 1:
        return grads
    live = [g for g in grads if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.reshape(-1) for g in live])
    dist.all_reduce(flat)
    summed = iter(flat.split([g.numel() for g in live]))
    return tuple(None if g is None else next(summed).view_as(g) for g in grads)


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)


def barrier() -> None:
    """Wait until every rank got here (an all_reduce read back on the
    host)."""
    if world_size() > 1:
        t = torch.zeros(1, device=_reduce_device())
        dist.all_reduce(t)
        t.item()


def all_sum_host(array) -> np.ndarray:
    """Sum a host numpy array over every process of the group (identity in
    a single process); every process returns the same sum."""
    arr = np.asarray(array)
    if world_size() == 1:
        return arr
    t = torch.as_tensor(arr.astype(np.int64) if arr.dtype.kind in "iub" else arr)
    t = t.to(_reduce_device())
    dist.all_reduce(t)
    return t.cpu().numpy().astype(arr.dtype)


def rank_zero_only(fn):
    """Decorator: run only on process 0."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_rank_zero():
            return fn(*args, **kwargs)
        return None

    return wrapper
