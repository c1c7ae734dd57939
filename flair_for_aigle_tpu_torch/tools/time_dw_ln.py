"""K9's times: ``depthwise7_ln`` (a ConvNeXt block's 7x7 depthwise conv, its
bias and its LayerNorm) at ConvNeXt-B's four stages at 512 px, beside its
plain version, its bound and two yardsticks.

    python -m flair_for_aigle_tpu_torch.tools.time_dw_ln [--batch 16] [--dtype bfloat16|float32]

Prints the card's line (name and power limit from nvidia-smi), one JSON
line per stage ``{"hw", "c", "ms", "plain_ms", "device_ms", "plain_device_ms",
"library_device_ms", "layers_device_ms", "bound_ms", "bytes_ms",
"ops_ms"}`` and a last line with the sums over the stages and over
ConvNeXt-B's 36 blocks (each stage's times by its depth, 3-3-27-3). ``ms``
and ``plain_ms`` are CUDA events around each call (``tools/timing.py
cuda_ms``); the ``*device_ms`` keys are device time (``device_ms``), with
the host's work hidden. The bound is the larger of the bytes (x read and the output
written once, the parameters read once) at 3.35 TB/s and the 49 FMAs an
element at the float32 SIMT rate (67 TFLOP/s). The yardsticks, as device
time: ``library``, ``F.conv2d(groups=C)`` on the NCHW view and
``F.layer_norm`` in the same dtype; ``layers``, the ``TorchConv`` ->
``TorchLayerNorm`` pair a ConvNeXt block ran before K9 (permutes, ATen's
depthwise conv, the bias and the float32 norm passes). It reads nothing of
the op but the wrapper and its plain version, so an older checkout with
this file and ``tools/timing.py`` copied into its ``tools/`` times that
checkout's op the same way. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.models.layers import TorchConv, TorchLayerNorm
from flair_for_aigle_tpu_torch.ops import dw_ln
from flair_for_aigle_tpu_torch.tools.timing import cuda_ms, device_ms

#: ConvNeXt-B at 512 px: (H = W, C, blocks) of each stage
STAGES = [(128, 128, 3), (64, 256, 3), (32, 512, 27), (16, 1024, 3)]
EPS = 1e-6
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_ms(b: int, hw: int, c: int, dtype) -> dict:
    """The op's least time on the card: bytes once at 3.35 TB/s against 49
    FMAs (98 operations) an element at the float32 SIMT rate."""
    n = b * hw * hw * c
    nbytes = 2 * n * torch.finfo(dtype).bits // 8 + (49 + 3) * c * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, 98 * n / F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "ops_ms": t_ops}


def stage_inputs(b: int, hw: int, c: int, dtype, gen) -> tuple:
    """(x, w_dw, b_dw, ln_w, ln_b) of one stage on the card: parameters
    float32, as the model holds them."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    return (randn(b, hw, hw, c).to(dtype), randn(c, 1, 7, 7, std=1 / 7), randn(c, std=0.1),
            randn(c, std=0.1) + 1, randn(c, std=0.1))


def stage_times(x, w_dw, b_dw, ln_w, ln_b) -> dict:
    """K9 on one stage's inputs by both timings, its plain version and the
    two yardsticks as device time, and its bound."""
    b, hw, _, c = x.shape
    kernel = lambda: dw_ln.depthwise7_ln(x, w_dw, b_dw, ln_w, ln_b, eps=EPS)  # noqa: E731
    plain = lambda: dw_ln.depthwise7_ln_reference(x, w_dw, b_dw, ln_w, ln_b, eps=EPS)  # noqa: E731
    wl, bl, gl, tl = (p.to(x.dtype) for p in (w_dw, b_dw, ln_w, ln_b))

    def library():
        y = F.conv2d(x.permute(0, 3, 1, 2), wl, bl, 1, 3, 1, c).permute(0, 2, 3, 1)
        return F.layer_norm(y, (c,), gl, tl, EPS)

    conv, norm = TorchConv(c, c, 7, 1, 3, groups=c), TorchLayerNorm(c, eps=EPS)
    with torch.no_grad():
        for p, q in ((conv.weight, w_dw), (conv.bias, b_dw), (norm.weight, ln_w),
                     (norm.bias, ln_b)):
            p.copy_(q)
    conv.to(x.device)
    norm.to(x.device)
    with torch.no_grad():
        return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
                "library_device_ms": device_ms(library),
                "layers_device_ms": device_ms(lambda: norm(conv(x))),
                **bound_ms(b, hw, c, x.dtype)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_dw_ln measures the card's time: no CUDA card here")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    sums: dict = {}
    blocks: dict = {}
    for hw, c, depth in STAGES:
        line = stage_times(*stage_inputs(args.batch, hw, c, dtype, gen))
        print(json.dumps({"hw": hw, "c": c, **line}), flush=True)
        for k, v in line.items():
            sums[k] = sums.get(k, 0.0) + v
            blocks[k] = blocks.get(k, 0.0) + depth * v
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "stage_sum": sums,
                      "convnext_base_blocks": blocks}), flush=True)


if __name__ == "__main__":
    main()
