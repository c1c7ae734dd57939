"""K8's and K4's times: ``fused_reverse_ln_mlp_residual`` (the fused finish,
at swin-base@512's four stages, window 12, shift 6) and
``upsample_crop_convert`` (the zonal epilogue on (B, 19, 128, 128) stride-4
logits, margin 40, argmax and class_prob), each beside its plain version
and a yardstick.

    python -m flair_for_aigle_tpu_torch.tools.time_finish_epilogue [--batch 2] [--dtype bfloat16|float32]

Prints the card's line (name and power limit from nvidia-smi), one JSON
line per finish stage ``{"op": "finish", "hw", "c", "ms", "plain_ms",
"device_ms", "plain_device_ms", "ffn_device_ms", "cublas_device_ms"}``,
one per epilogue output type ``{"op": "epilogue", "output_type", "ms",
"plain_ms", "device_ms", "plain_device_ms", "interpolate_device_ms"}`` and
a last line with the finish's sums over the stages. ``ms`` and
``plain_ms`` are CUDA events around each call (``tools/timing.py
cuda_ms``); the ``*device_ms`` keys are device time (``device_ms``), with
the host's work hidden. The yardsticks, as device time: for K8, K3
(``fused_ln_mlp_residual``) on the same shortcut and the gathered
attention rows (the function K8 computes after its gather pass), and the
two products alone through cuBLAS (``F.linear`` twice in the same dtype,
TF32 off); for K4, ``F.interpolate(..., scale_factor=4, mode="bilinear",
align_corners=True)`` on the same logits, which upsamples the whole tile
and neither crops nor converts. It reads nothing of the two ops but the
wrappers and their plain versions, so an older checkout with this file and
``tools/timing.py`` copied into its ``tools/`` times that checkout's
kernels the same way. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.ops import epilogue, ffn, finish
from flair_for_aigle_tpu_torch.tools.timing import cuda_ms, device_ms

STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]  # (H = W, C)
WS, SS = 12, 6
N_CLASSES, H4, MARGIN = 19, 128, 40


def _gathered(win, x):
    """The attention rows (B, H, W, C) that K8's gather pass reads for x:
    window reverse, crop and the +ss roll."""
    b, h, w, c = x.shape
    hp, wp = h + (WS - h % WS) % WS, w + (WS - w % WS) % WS
    y = win.reshape(b, hp // WS, wp // WS, WS, WS, c).permute(0, 1, 3, 2, 4, 5)
    return torch.roll(y.reshape(b, hp, wp, c)[:, :h, :w], (SS, SS), dims=(1, 2)).contiguous()


def finish_times(win, x, p) -> dict:
    """K8 on windows win, shortcut x and parameters p (the op's order) by
    both timings; K3 on x and the gathered rows, and the two products
    alone through cuBLAS in x's dtype, TF32 off for them (restored after),
    as device time."""
    kw = dict(ws=WS, ss=SS)
    c = x.shape[-1]
    a = _gathered(win, x)
    w1, w2 = p[2].to(x.dtype), p[4].to(x.dtype)
    ln = x.reshape(-1, c)
    h = F.linear(ln, w1)
    kernel = lambda: finish.fused_reverse_ln_mlp_residual(win, x, *p, **kw)  # noqa: E731
    plain = lambda: finish.fused_reverse_ln_mlp_residual_reference(win, x, *p, **kw)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: (F.linear(ln, w1), F.linear(h, w2)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "ffn_device_ms": device_ms(lambda: ffn.fused_ln_mlp_residual(x, a, *p)),
            "cublas_device_ms": t_l}


def epilogue_times(lg, output_type: str) -> dict:
    """K4 on stride-4 logits lg, margin 40, by both timings, and
    ``F.interpolate`` of lg to full resolution as device time."""
    kw = dict(margin=MARGIN, scale=4, output_type=output_type)
    kernel = lambda: epilogue.upsample_crop_convert(lg, **kw)  # noqa: E731
    plain = lambda: epilogue.upsample_crop_convert_reference(lg, **kw)  # noqa: E731
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "interpolate_device_ms": device_ms(lambda: F.interpolate(
                lg, scale_factor=4, mode="bilinear", align_corners=True))}


def finish_inputs(batch: int, hw: int, c: int, dtype, randn) -> tuple:
    """(windows, shortcut, parameters) of one finish stage, from
    ``randn(*shape, std=..., dt=...)``: parameters float32, as the model
    holds them."""
    nwh = -(-hw // WS)
    return (randn(batch * nwh * nwh, WS * WS, c, dt=dtype), randn(batch, hw, hw, c, dt=dtype),
            (randn(c, std=0.1) + 1, randn(c, std=0.1), randn(4 * c, c, std=c ** -0.5),
             randn(4 * c, std=0.02), randn(c, 4 * c, std=(4 * c) ** -0.5), randn(c, std=0.02)))


def epilogue_inputs(batch: int, dtype, randn) -> torch.Tensor:
    """Stride-4 logits (B, 19, 128, 128) of a batch of 512 px tiles."""
    return randn(batch, N_CLASSES, H4, H4, std=3.0, dt=dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_finish_epilogue measures the card's time: no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dt)

    sums: dict = {}
    for hw, c in STAGES:
        line = finish_times(*finish_inputs(args.batch, hw, c, dtype, randn))
        print(json.dumps({"op": "finish", "hw": hw, "c": c, **line}), flush=True)
        for k, v in line.items():
            sums[k] = sums.get(k, 0.0) + v
    lg = epilogue_inputs(args.batch, dtype, randn)
    for output_type in ("argmax", "class_prob"):
        print(json.dumps({"op": "epilogue", "output_type": output_type,
                          **epilogue_times(lg, output_type)}), flush=True)
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "finish_sum": sums}), flush=True)


if __name__ == "__main__":
    main()
