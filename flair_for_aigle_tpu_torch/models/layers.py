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
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_ac_nhwc
from flair_for_aigle_tpu_torch.parallel import dist
from flair_for_aigle_tpu_torch.parallel.mesh import batch_rand, global_shape


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
    C_in (the UPerNet bottleneck; identical params, no concat).
    ``padding_mode="reflect"`` reflect-pads the input and convolves it
    unpadded (the UTAE convolutions). ``dilation`` and ``groups`` are
    torch's (``flair_for_aigle_tpu/models/layers.py:70``): the weight is
    (out, in // groups, kH, kW), so ``groups=in_ch`` is a depthwise
    convolution."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1,
                 padding=0, bias: bool = True, padding_mode: str = "zeros",
                 dilation=1, groups: int = 1):
        super().__init__()
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"padding_mode {padding_mode!r}")
        if in_ch % groups or out_ch % groups:
            raise ValueError(f"channels {in_ch} -> {out_ch} not divisible by groups {groups}")
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        kaiming_uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            bias_uniform_(self.bias, fan_in, gen)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        padding = self.padding
        if self.padding_mode == "reflect" and any(padding):
            ph, pw = padding
            x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
            padding = (0, 0)
        if w.shape[0] == 0:
            # a zero-channel output (U-Net++ blocks fed only a transformer
            # encoder's zero-channel dummy), which F.conv2d refuses
            hw = [(n + 2 * p - d * (k - 1) - 1) // s + 1 for n, p, d, k, s in zip(
                x.shape[-2:], padding, self.dilation, w.shape[-2:], self.stride)]
            return x.new_zeros(x.shape[0], *hw, 0)
        y = F.conv2d(x, w.to(x.dtype), None, self.stride, padding, self.dilation,
                     self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (list, tuple)):
            if self.groups != 1:
                raise ValueError("a split-input convolution needs groups=1")
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


class TorchConvTranspose(nn.Module):
    """2-D transposed convolution with torch ConvTranspose2d semantics on
    NHWC tensors (``flair_for_aigle_tpu/models/layers.py:187``); weight in
    the torch layout (C_in, C_out, kH, kW). Output size (in - 1) * stride -
    2 * padding + kernel + output_padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=4, stride=2,
                 padding=1, output_padding: int = 0, bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the reference's fan-in: kH * kW * C_in
        fan_in = self.weight.shape[0] * self.weight.shape[2] * self.weight.shape[3]
        kaiming_uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            bias_uniform_(self.bias, fan_in, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                               self.stride, self.padding, self.output_padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class TorchLinear(nn.Module):
    """Linear layer, weight (out, in); compute-dtype epilogue. A kernel-1
    Conv1d weight (out, in, 1) in a state dict loads as this Linear (the
    reference LTAE's ``inconv``)."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.empty(out_f)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            bias_uniform_(self.bias, self.weight.shape[1], gen)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and w.ndim == 3 and w.shape[-1] == 1:
            state_dict[prefix + "weight"] = w[:, :, 0]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

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


class _Remat:
    """One checkpointed call of a block: ``recompute`` is False while its
    forward runs and True while autograd recomputes it for the backward;
    ``sums`` holds the group sums its BatchNorms took in the forward, in
    call order, which the recompute replays (``next_sum``)."""

    def __init__(self):
        self.calls = 0
        self.recompute = False
        self.sums: list = []
        self.i = 0

    def next_sum(self) -> torch.Tensor:
        y = self.sums[self.i]
        self.i += 1
        return y


class _Current(threading.local):
    call: _Remat | None = None  # the checkpointed call this thread runs


_CURRENT = _Current()


def remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint`` (flax ``nn.checkpoint``,
    the JAX package's ``remat``): the block's activations are dropped after
    the forward and recomputed in the backward, custom autograd kernels
    included. The recompute leaves the BatchNorm running statistics as the
    forward left them and replays its group sums instead of all-reducing
    again (``TorchBatchNorm``), so a step matches the step without remat.
    The RNG state is not saved: no block that runs here draws random
    numbers (the port's dropouts draw from explicit generators, which
    ``checkpoint`` would not restore)."""
    call = _Remat()

    def run(x):
        call.recompute = call.calls > 0
        call.calls += 1
        call.i = 0
        outer, _CURRENT.call = _CURRENT.call, call
        try:
            return block(x)
        finally:
            _CURRENT.call = outer

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def remat_active(module: nn.Module, flag: bool) -> bool:
    """Whether ``module``'s blocks run under ``remat``: asked for, in
    training mode, with autograd recording."""
    return flag and module.training and torch.is_grad_enabled()


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis, torch semantics
    (``flair_for_aigle_tpu/models/layers.py:229``). In training mode it
    normalises with the batch's float32 mean and biased variance over every
    axis but the last, and updates the running statistics with momentum
    0.1 and the unbiased variance; in eval mode it uses the running
    statistics. Inside a process group of more than one rank (data
    parallelism, ``parallel/dist.py``) the training-mode statistics and the
    unbiased count are the global batch's, summed over the ranks with
    ``AllReduceSum`` so that the gradient reaches every rank's inputs.
    Inside a block that ``remat`` recomputes, the recompute updates no
    running statistic and replays the forward's group sums
    (``dist.ReplayedSum``), so the statistics and the collectives are a
    step without remat's."""

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
        if x.shape[-1] == 0:
            return x
        xf = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            n = x.numel() // x.shape[-1]
            call = _CURRENT.call
            if dist.world_size() > 1:
                # data parallel: the global batch's statistics, as GSPMD
                # takes them (two passes: the mean, then the squared
                # deviations from it); every rank holds an equal shard
                n *= dist.world_size()
                mean = _group_sum(xf.sum(axes), call) / n
                var = _group_sum(((xf - mean) ** 2).sum(axes), call) / n
            else:
                mean = xf.mean(axes)
                var = ((xf - mean) ** 2).mean(axes)
            if call is None or not call.recompute:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


def _group_sum(x: torch.Tensor, call: _Remat | None) -> torch.Tensor:
    """The sum of ``x`` over the group; inside ``remat``, the forward keeps
    it and the recompute replays it."""
    if call is not None and call.recompute:
        return dist.ReplayedSum.apply(x, call.next_sum())
    y = dist.AllReduceSum.apply(x)
    if call is not None:
        call.sums.append(y.detach())
    return y


class TorchGroupNorm(nn.Module):
    """GroupNorm with torch semantics, channels last
    (``flair_for_aigle_tpu/models/layers.py:274``): per sample, float32
    statistics over every axis but the batch and the group, so a (N, T, C)
    sequence is normalised over T and C / G together; the output is cast
    back to the input dtype."""

    def __init__(self, num_groups: int, ch: int, eps: float = 1e-5):
        super().__init__()
        if ch % num_groups:
            raise ValueError(f"channels {ch} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch, g = x.shape[-1], self.num_groups
        xg = x.float().reshape(x.shape[0], -1, g, ch // g)
        mean = xg.mean((1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean((1, 3), keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        return (xg.reshape(x.shape) * self.weight + self.bias).to(x.dtype)


class TorchInstanceNorm(nn.Module):
    """InstanceNorm2d (torch default: no affine) on NHWC, float32
    statistics over H and W (``flair_for_aigle_tpu/models/layers.py:367``)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean((-3, -2), keepdim=True)
        var = ((xf - mean) ** 2).mean((-3, -2), keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel_size=3, stride=2, padding=1) -> torch.Tensor:
    """torch MaxPool2d on NHWC: the padding is -inf, so it never wins
    (``flair_for_aigle_tpu/models/layers.py:380``)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), _pair(kernel_size), _pair(stride),
                     _pair(padding))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kernel_size, stride=None) -> torch.Tensor:
    """torch AvgPool2d (no padding) on (..., H, W, C), summed in float32
    (``flair_for_aigle_tpu/models/layers.py:401``)."""
    kh, kw = _pair(kernel_size)
    sh, sw = (kh, kw) if stride is None else _pair(stride)
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.avg_pool2d(y, (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], c).to(x.dtype)


def xavier_uniform_like(x: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
    """Xavier-uniform noise of ``x``'s shape and dtype, with the fans of
    flax's ``xavier_uniform`` (in axis -2, out axis -1, the leading axes a
    receptive field): bound sqrt(6 / (fan_in + fan_out)). ``x``'s leading
    axis is the batch: under a ``ShardedGenerator`` the fans and the draw
    are the global batch's, and this shard keeps its slice."""
    shape = global_shape(x.shape, gen)
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = batch_rand(x.shape, gen, x.device)
    return (u * (2 * bound) - bound).to(x.dtype)


def dropout(x: torch.Tensor, p: float, training: bool,
            gen: torch.Generator | None, channel_wise: bool = False) -> torch.Tensor:
    """Inverted dropout with draws from ``gen`` (flax ``nn.Dropout``: keep
    with probability 1 - p, scale the kept values by 1 / (1 - p)).
    ``channel_wise`` drops whole channels of each NHWC sample, one draw per
    (sample, channel) (torch ``Dropout2d``; flax ``broadcast_dims=(1, 2)``).
    ``x``'s leading axis runs over the samples, batch-major: under a
    ``ShardedGenerator`` the mask is this shard's slice of the global
    batch's."""
    if not training or p == 0.0:
        return x
    shape = (x.shape[0], 1, 1, x.shape[-1]) if channel_wise else x.shape
    keep = batch_rand(shape, gen, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class MLP(nn.Module):
    """Transformer MLP (Linear - exact GELU - Linear), timm layout."""

    def __init__(self, in_f: int, hidden: int, out_f: int):
        super().__init__()
        self.fc1 = TorchLinear(in_f, hidden)
        self.fc2 = TorchLinear(hidden, out_f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SequentialReLU(nn.Sequential):
    """``nn.Sequential`` then ReLU: smp's conv + BatchNorm + ReLU blocks,
    the conv at child ``0`` and its BatchNorm at child ``1``."""

    def forward(self, x) -> torch.Tensor:
        return torch.relu(super().forward(x))


class ConvBNReLU(SequentialReLU):
    """Bias-free conv (``kernel_size``, same padding) + BatchNorm + ReLU. A
    list input is the concat-free split conv of ``TorchConv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1):
        super().__init__(TorchConv(in_ch, out_ch, kernel_size, 1, kernel_size // 2, bias=False),
                         TorchBatchNorm(out_ch))


class SegmentationHead(nn.Module):
    """smp's SegmentationHead: ``segmentation_head.0``, a conv to the
    classes, then an align-corners bilinear x ``upsampling`` when it is
    above 1."""

    def __init__(self, in_ch: int, classes: int, kernel_size: int = 3, upsampling: int = 1):
        super().__init__()
        self.upsampling = upsampling
        self.add_module("0", TorchConv(in_ch, classes, kernel_size, 1, kernel_size // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, "0")(x)
        if self.upsampling > 1:
            x = resize_bilinear_ac_nhwc(x, x.shape[-3] * self.upsampling,
                                        x.shape[-2] * self.upsampling)
        return x


def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise every layer of ``model`` in module order from ``gen``."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return model
