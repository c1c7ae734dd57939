"""PyTorch layers with the JAX reference's numerics, NHWC activations.

Port of ``flair_for_aigle_tpu/models/layers.py``. Parameters keep the torch
state-dict layout (Conv ``(O, I, kH, kW)``, Linear ``(out, in)``) so the
published FLAIR-HUB checkpoints and the JAX package's
``export_torch_state_dict`` load with no renames. Activations are NHWC like
the reference. Parameters stay float32; each layer casts them to the
activation dtype (the compute dtype) at use, and rounds in the reference's
order: float32-accumulated product -> compute dtype -> + bias.

Random init follows the reference's initializers (torch kaiming-uniform
a=sqrt(5) for weights, fan-in uniform for biases, ones/zeros for norms)
drawn from an explicit ``torch.Generator``; see ``init_weights``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen, dtype=torch.float32)
                .mul_(2 * bound).sub_(bound))


def kaiming_uniform_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """torch's default Conv/Linear weight init (kaiming_uniform, a=sqrt(5))."""
    if fan_in == 0 or w.numel() == 0:
        with torch.no_grad():
            w.zero_()
        return
    gain = math.sqrt(2.0 / (1.0 + 5.0))
    _uniform_(w, gain * math.sqrt(3.0 / fan_in), gen)


def bias_uniform_(b: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    _uniform_(b, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, gen)


class TorchConv(nn.Module):
    """2-D convolution with torch Conv2d semantics on NHWC tensors.

    A list input means "conv over the channel concatenation of these maps",
    computed as the sum of per-piece convs with the weight sliced along
    C_in (the UPerNet bottleneck; identical params, no concat)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1,
                 padding=0, bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        kaiming_uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            bias_uniform_(self.bias, fan_in, gen)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (list, tuple)):
            y, off = None, 0
            for piece in x:
                cs = piece.shape[-1]
                p = self._conv(piece, self.weight[:, off:off + cs])
                y = p if y is None else y + p
                off += cs
        else:
            y = self._conv(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TorchLinear(nn.Module):
    """Linear layer, weight (out, in); compute-dtype epilogue."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.empty(out_f)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            bias_uniform_(self.bias, self.weight.shape[1], gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TorchLayerNorm(nn.Module):
    """LayerNorm over the last axis; float32 statistics, eps 1e-5."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return out.to(x.dtype)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, torch semantics
    (``flair_for_aigle_tpu/models/layers.py:229``). In training mode it
    normalises with the batch's float32 mean and biased variance over every
    axis but the last, and updates the running statistics with momentum
    0.1 and the unbiased variance; in eval mode it uses the running
    statistics."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            var = ((xf - mean) ** 2).mean(axes)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


class MLP(nn.Module):
    """Transformer MLP (Linear - exact GELU - Linear), timm layout."""

    def __init__(self, in_f: int, hidden: int, out_f: int):
        super().__init__()
        self.fc1 = TorchLinear(in_f, hidden)
        self.fc2 = TorchLinear(hidden, out_f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every layer of ``model`` in module order from ``gen``."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return model
