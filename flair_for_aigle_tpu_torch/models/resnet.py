"""ResNet encoders (smp / torchvision layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/resnet.py``. Module names are the
torchvision state-dict keys (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.{0,1}``). The forward returns smp's feature pyramid
``[x, conv1+bn1+relu, maxpool+layer1, layer2, layer3, layer4]``, cut to
``depth + 1`` entries.

* ``output_stride`` 16 or 8 is smp's ``make_dilated``: the dilated stages
  (layer4 at 16; layer3 and layer4 at 8, rates 2 and 4) run every
  convolution at stride 1 and every 3x3 at dilation = padding = rate. The
  parameters are those of the stride-32 encoder.
* ``depth`` < 5 builds only the stem and the first ``depth - 1`` stages,
  and the state dict lacks the deeper ones (PSPNet's encoder_depth 3).
"""

from __future__ import annotations

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import TorchBatchNorm, TorchConv, max_pool2d


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(TorchConv(in_ch, out_ch, 1, stride, 0, bias=False),
                         TorchBatchNorm(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = TorchConv(in_ch, features, 3, stride, d, bias=False, dilation=d)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = TorchConv(features, features, 3, 1, d, bias=False, dilation=d)
        self.bn2 = TorchBatchNorm(features)
        self.downsample = _downsample(in_ch, features, stride) if use_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 use_downsample: bool = False, dilation: int = 1):
        super().__init__()
        d, out_ch = dilation, features * self.expansion
        self.conv1 = TorchConv(in_ch, features, 1, 1, 0, bias=False)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = TorchConv(features, features, 3, stride, d, bias=False, dilation=d)
        self.bn2 = TorchBatchNorm(features)
        self.conv3 = TorchConv(features, out_ch, 1, 1, 0, bias=False)
        self.bn3 = TorchBatchNorm(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride) if use_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


# arch -> (block, blocks per stage)
_RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


def resnet_out_channels(arch: str, in_channels: int, depth: int = 5) -> tuple[int, ...]:
    exp = _RESNET_SPECS[arch][0].expansion
    full = (in_channels, 64, 64 * exp, 128 * exp, 256 * exp, 512 * exp)
    return full[:depth + 1]


class ResNetEncoder(nn.Module):
    """smp-style ResNet encoder returning the feature pyramid (NHWC)."""

    def __init__(self, arch: str = "resnet34", in_channels: int = 3,
                 output_stride: int = 32, depth: int = 5):
        super().__init__()
        if output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride {output_stride} not in (8, 16, 32)")
        block_cls, depths = _RESNET_SPECS[arch]
        self.out_channels = resnet_out_channels(arch, in_channels, depth)
        # per stage: (stride of its first block, dilation of every block)
        layer_sd = {li: (1 if li == 0 else 2, 1) for li in range(4)}
        if output_stride <= 16:
            layer_sd[3] = (1, 2)
        if output_stride == 8:
            layer_sd[2] = (1, 2)
            layer_sd[3] = (1, 4)
        self.conv1 = TorchConv(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = TorchBatchNorm(64)
        self.n_stages = depth - 1
        in_ch = 64
        for li, (w, n) in enumerate(zip((64, 128, 256, 512)[:self.n_stages], depths)):
            stride, dil = layer_sd[li]
            blocks = []
            for bi in range(n):
                out_ch = w * block_cls.expansion
                use_ds = bi == 0 and (stride != 1 or in_ch != out_ch)
                blocks.append(block_cls(in_ch, w, stride if bi == 0 else 1,
                                        use_downsample=use_ds, dilation=dil))
                in_ch = out_ch
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        features = [x]
        out = torch.relu(self.bn1(self.conv1(x)))
        features.append(out)
        out = max_pool2d(out, 3, 2, 1)
        for li in range(self.n_stages):
            out = getattr(self, f"layer{li + 1}")(out)
            features.append(out)
        return features
