"""The data-parallel axis of the port (counterpart of
``flair_for_aigle_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` with a ``dp`` axis over its
devices and shards each batch over it (``P("dp")``): device i holds the
i-th contiguous slice of the leading axis. Here ``DataParallelMesh`` is
the ordered device list of that axis: the zonal engine keeps a model
replica on each of its devices in one process, and a training run over
``torch.distributed`` is the same axis spread over processes, rank i
taking slice i (``shard_batch``). The JAX ``fsdp`` axis has no caller and
has no counterpart.

Two deliberate divergences from the JAX package: ``make_mesh`` raises
where fewer cards exist than were asked for (``jax.devices()[:n]`` gives a
smaller mesh), and ``shard_batch`` raises unless the batch divides evenly.

``ShardedGenerator`` carries a shard's place on the axis to the random
draws of the model (dropout, modality dropout): every shard draws the
global batch's numbers and keeps its own slice, so a step over W shards
draws what one device draws on the same global batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``torch.device(device)``, a CUDA device without an index given the
    current device's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DataParallelMesh:
    """The ``dp`` axis: an ordered list of devices, one batch shard each.
    A device may appear more than once (two replicas on one card, or on
    the CPU)."""

    def __init__(self, devices: Iterable):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a data-parallel mesh needs at least one device")

    @property
    def dp(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device_type: str = "cuda") -> DataParallelMesh:
    """The first ``n_devices`` CUDA cards (all of them when None), or
    ``n_devices`` CPU replicas with ``device_type="cpu"``; an explicit
    ``devices`` list is taken as it is. Raises when fewer cards exist than
    were asked for."""
    if devices is not None:
        return DataParallelMesh(devices)
    if device_type == "cpu":
        return DataParallelMesh([torch.device("cpu")] * (1 if n_devices is None else n_devices))
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = available if n_devices is None else n_devices
    if n < 1 or n > available:
        raise RuntimeError(
            f"{n} CUDA device(s) asked for and {available} present: the data-parallel "
            "mesh is never cut down to the cards present")
    return DataParallelMesh([torch.device("cuda", i) for i in range(n)])


def shard_batch(batch: dict, index: int, dp: int) -> dict:
    """Shard ``index`` of ``dp`` of every array entry (numpy or torch, at
    least one axis): the contiguous slice ``[index * B / dp, (index + 1) *
    B / dp)`` of its leading axis, the ``P("dp")`` layout; other entries
    pass through. Raises unless every such B divides by ``dp``."""
    if not 0 <= index < dp:
        raise ValueError(f"shard index {index} outside a mesh of {dp}")
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1:
            b = v.shape[0]
            if b % dp:
                raise ValueError(f"batch entry {k!r} of {b} rows does not split "
                                 f"into {dp} equal shards")
            n = b // dp
            v = v[index * n:(index + 1) * n]
        out[k] = v
    return out


def pad_batch_to(batch: dict, size: int) -> dict:
    """Pad the leading axis of every numpy array to ``size`` by repeating
    the last row (JAX ``parallel/mesh.py pad_batch_to``), so a ragged final
    batch gets the reference's treatment."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] < size:
            v = np.concatenate([v] + [v[-1:]] * (size - v.shape[0]), axis=0)
        out[k] = v
    return out


class ShardedGenerator(torch.Generator):
    """A ``torch.Generator`` for shard ``index`` of ``count`` of a global
    batch. ``batch_rand`` draws the global batch's numbers from it and
    returns this shard's slice; with ``count`` 1 it is a plain generator."""

    def __new__(cls, device="cpu", index: int = 0, count: int = 1):
        return super().__new__(cls, device)

    def __init__(self, device="cpu", index: int = 0, count: int = 1):
        if not 0 <= index < count:
            raise ValueError(f"shard index {index} outside a mesh of {count}")
        self.index, self.count = index, count


def batch_rand(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """``torch.rand(shape)`` (float32) whose leading axis runs over this
    shard's samples, batch-major. Under a ``ShardedGenerator`` of ``count``
    > 1 it draws ``global_shape(shape)`` and returns rows ``[index *
    shape[0], (index + 1) * shape[0])``: the numbers one device draws for
    this shard's samples."""
    count = getattr(generator, "count", 1)
    if count == 1:
        return torch.rand(tuple(shape), generator=generator, device=device,
                          dtype=torch.float32)
    n = shape[0]
    full = torch.rand(global_shape(shape, generator), generator=generator, device=device,
                      dtype=torch.float32)
    return full[generator.index * n:(generator.index + 1) * n]


def global_shape(shape, generator: torch.Generator | None) -> tuple:
    """``shape`` with its leading axis over the global batch of the
    generator's mesh."""
    return (shape[0] * getattr(generator, "count", 1), *shape[1:])
