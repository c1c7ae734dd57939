"""Process-rank helpers on ``torch.distributed`` (port of
``flair_for_aigle_tpu/parallel/dist.py``, whose helpers import jax inside
the call). A process that never joined a process group is rank 0 of 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _group_active() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if _group_active() else 0


def is_rank_zero() -> bool:
    return process_index() == 0


def all_sum_host(array) -> np.ndarray:
    """Sum a host numpy array over every process of the group (identity in
    a single process); every process returns the same sum."""
    arr = np.asarray(array)
    if not _group_active() or torch.distributed.get_world_size() == 1:
        return arr
    t = torch.as_tensor(arr.astype(np.int64) if arr.dtype.kind in "iub" else arr)
    if torch.distributed.get_backend() == "nccl":
        t = t.cuda()
    torch.distributed.all_reduce(t)
    return t.cpu().numpy().astype(arr.dtype)


def rank_zero_only(fn):
    """Decorator: run only on process 0."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_rank_zero():
            return fn(*args, **kwargs)
        return None

    return wrapper
