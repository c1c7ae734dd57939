"""ConvNeXt v1 encoder (timm 1.x layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/convnext.py``. Module names are timm's
state-dict keys (``stem.{0,1}``, ``stages.{i}.downsample.{0,1}``,
``stages.{i}.blocks.{j}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``). A block
is a 7x7 depthwise conv, LayerNorm (eps 1e-6; on NHWC the channels-first
LayerNorm of timm is the last-axis one), the 4x MLP with exact GELU, the
layer scale ``gamma`` (init 1e-6) and the residual. The forward returns
smp's TimmUniversalEncoder pyramid ``[x, zero-channel dummy at stride 2,
s4, s8, s16, s32]``, as the Swin encoder does. ``remat=True`` recomputes
each block in the backward (``models/layers.py remat``, JAX
``convnext.py:79``), in training mode only.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    MLP,
    TorchConv,
    TorchLayerNorm,
    remat,
    remat_active,
)
from flair_for_aigle_tpu_torch.utils import profiling


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = TorchConv(dim, dim, 7, 1, 3, groups=dim)
        self.norm = TorchLayerNorm(dim, eps=1e-6)
        self.mlp = MLP(dim, 4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x)))
        return x + self.gamma.to(y.dtype) * y


class ConvNeXtEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (3, 3, 9, 3), remat: bool = False):
        super().__init__()
        self.remat = remat
        self.out_channels = (in_channels, 0, *dims)
        self.stem = nn.Sequential(TorchConv(in_channels, dims[0], 4, 4, 0),
                                  TorchLayerNorm(dims[0], eps=1e-6))
        self.stages = nn.ModuleList()
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            stage = nn.Module()
            if i > 0:
                stage.downsample = nn.Sequential(TorchLayerNorm(dims[i - 1], eps=1e-6),
                                                 TorchConv(dims[i - 1], dim, 2, 2, 0))
            stage.blocks = nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth)))
            self.stages.append(stage)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        b, h, w, _ = x.shape
        feats = [x, x.new_zeros(b, h // 2, w // 2, 0)]
        y = self.stem(x)
        rm = remat_active(self, self.remat)
        for i, stage in enumerate(self.stages):
            with profiling.span(f"model.encoder.stage{i + 1}"):
                if hasattr(stage, "downsample"):
                    y = stage.downsample(y)
                for block in stage.blocks:
                    with profiling.span("model.encoder.block"):
                        y = remat(block, y) if rm else block(y)
            feats.append(y)
        return feats
