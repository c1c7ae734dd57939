"""Random weights from the seed, made on the device in the reference
layout (smp / timm state-dict names), and their names in the port's
``FlairHubModel``.

One ``torch.randn`` call on the device draws every value; each tensor is a
slice of it, scaled by its role so that activations keep a unit scale:
products and convolutions ``1 / sqrt(fan_in)``, norm scales ``1 + 0.1 z``,
biases ``0.1 z``, Swin's relative-position tables ``0.5 z`` (so that the
bias reaches the scores), ConvNeXt's layer scales ``0.5 + 0.1 z``;
BatchNorm statistics are mean 0 and variance 1.
"""

from __future__ import annotations

import math

import torch

from benchmark.frozen.raster import generator


def layout(model: torch.nn.Module) -> dict[str, tuple[torch.Size, torch.dtype]]:
    return {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}


def reference_layout(fam, cfg: dict, in_channels: int, device: torch.device) -> dict:
    """Names, shapes and dtypes of the reference model's state (built on
    ``device`` and dropped)."""
    with torch.device(device):
        return layout(fam.build(cfg, in_channels))


def _scale(name: str, shape) -> tuple[float, float]:
    """(offset, scale) of a drawn tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "relative_position_bias_table":
        return 0.0, 0.5
    if leaf == "gamma":
        return 0.5, 0.1
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return 0.0, 1.0 / math.sqrt(fan_in)
    if leaf == "weight":
        return 1.0, 0.1
    return 0.0, 0.1


def make(spec: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The state dict of ``spec`` (name -> (shape, dtype)) from the seed."""
    drawn = [(k, shape) for k, (shape, dtype) in spec.items()
             if dtype.is_floating_point and not k.endswith(("running_mean", "running_var"))]
    total = sum(math.prod(shape) for _, shape in drawn)
    flat = torch.randn(total, generator=generator(seed, device, stream=2), device=device)
    out, at = {}, 0
    for k, shape in drawn:
        n = math.prod(shape)
        offset, scale = _scale(k, shape)
        out[k] = (flat[at:at + n].view(shape) * scale + offset)
        at += n
    for k, (shape, dtype) in spec.items():
        if k.endswith("running_mean"):
            out[k] = torch.zeros(shape, device=device)
        elif k.endswith("running_var"):
            out[k] = torch.ones(shape, device=device)
        elif k not in out:
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def port_name(ref_name: str, modality: str, task: str) -> str | None:
    """The port's ``FlairHubModel`` name of a reference tensor (None: the
    port keeps no such tensor)."""
    if ref_name.endswith("num_batches_tracked"):
        return None
    if ref_name.startswith("encoder."):
        return f"encoders.{modality}.seg_model." + ref_name[len("encoder."):]
    return f"main_decoders.{task}.seg_model." + ref_name


def port_state(ref_state: dict, modality: str, task: str) -> dict:
    out = {}
    for k, v in ref_state.items():
        name = port_name(k, modality, task)
        if name is not None:
            out[name] = v
    return out
