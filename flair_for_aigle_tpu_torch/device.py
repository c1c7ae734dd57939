"""The device an entry point runs on: the CUDA card unless the caller asks
for the CPU (``device="cpu"``, the CLIs' ``--device cpu``), where every
kernel wrapper runs its plain PyTorch version."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for and
    no card is present, rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
