"""The device an entry point runs on: the CUDA card unless the caller asks
for the CPU (``device="cpu"``, the CLIs' ``--device cpu``), where every
kernel wrapper runs its plain PyTorch version; and the constants that the
forward builds from shapes alone, kept on that device."""

from __future__ import annotations

import numpy as np
import torch

from flair_for_aigle_tpu_torch.utils import profiling


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for and
    no card is present, rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


_CONSTANTS: dict = {}
#: the tensors uploaded by ``device_constant``, a key of every zonal call's record
profiling.declare(const_uploads=0)


def device_constant(make, *sizes: int, device):
    """``make(*sizes)``, a NumPy array or a tuple of them built from the
    sizes alone, as tensors on ``device``: uploaded once a (``make``,
    ``sizes``, ``str(device)``), the same tensors on every later call.

    A copy from pageable memory waits for the card's queue to drain, so an
    upload inside a forward would hold the host to the card's pace; here
    the first forward at a geometry uploads, and each later one reads the
    cache. Each upload adds to ``const_uploads`` of the current call's
    record and its host seconds to ``blocked_s``. On the CPU the tensors
    share the host arrays' memory."""
    key = (make, sizes, str(device))
    hit = _CONSTANTS.get(key)
    if hit is None:
        host = make(*sizes)
        arrays = host if isinstance(host, tuple) else (host,)
        # a tensor made under inference_mode could not be saved for a backward
        with torch.inference_mode(False), profiling.blocked():
            tensors = tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                            for a in arrays)
        profiling.count("const_uploads", len(tensors))
        hit = _CONSTANTS[key] = tensors if isinstance(host, tuple) else tensors[0]
    return hit
