"""A/B of the window-attention products (QK^T, then P V; no softmax) at one
stage geometry: one head at a time (A, ``attn_dots_per_head``) against the
heads of a 128-channel group together (B, ``attn_dots_grouped``). The port
of ``tools/exp_attn_dots.py``.

    python -m flair_for_aigle_tpu_torch.tools.exp_attn_dots [--device cuda|cpu]

The geometry comes from the JAX tool's environment knobs, with its
defaults: ``DB`` batch (16), ``DHW`` stage side (128), ``DC`` channels
(128), ``DNH`` heads (4), ``BW`` windows per block (4); windows of 12 x 12
tokens over the side padded to a multiple of 12. The inputs are the JAX
tool's: ``np.random.default_rng(0)`` standard normals for q, k, v in that
order, rounded to bf16. Prints the device's line (the card's name and power
limit from nvidia-smi), then three JSON lines: ``max_abs_diff`` (B against
A), ``per_head_ms`` and ``grouped_ms``, each the time per call of a chain of
dependent calls (every output is the next call's q), CUDA events on the
card. The kernels' launch counts go to standard error as one JSON line.
Runs on the card unless ``--device cpu`` asks for the CPU (where both
variants run the plain version), and stops with an error when there is no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.ops.attn_dots import attn_dots_grouped, attn_dots_per_head

WS = 12
T = WS * WS


def geometry(env=os.environ) -> dict:
    """The JAX tool's knobs (``tools/exp_attn_dots.py:21-35``) and its
    window count BNW."""
    b, hw = int(env.get("DB", "16")), int(env.get("DHW", "128"))
    hp = hw + (WS - hw % WS) % WS
    return {"b": b, "hw": hw, "c": int(env.get("DC", "128")), "nh": int(env.get("DNH", "4")),
            "bw": int(env.get("BW", "4")), "bnw": b * (hp // WS) ** 2}


def inputs(bnw: int, c: int, device) -> tuple:
    """The JAX tool's q, k, v: seeded standard normals rounded to bf16."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal((bnw, T, c), np.float32))
                 .to(torch.bfloat16).to(device) for _ in range(3))


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (plain versions)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _elapsed_ms(fn, device: torch.device) -> float:
    if device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def t_chain(call, xq, xk, xv, iters: int = 12) -> float:
    """ms per call of a chain of dependent calls (the JAX tool's ``t_chain``,
    :100-117): a warm-up chain of 2, then (t(iters) - t(2)) / (iters - 2)."""
    def run(n):
        q = xq
        for _ in range(n):
            q = call(q, xk, xv)

    run(2)
    t2 = _elapsed_ms(lambda: run(2), xq.device)
    tn = _elapsed_ms(lambda: run(iters), xq.device)
    return (tn - t2) / (iters - 2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="A/B the window-attention products.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Run on the CUDA card (default) or on the CPU")
    dev = resolve_device(parser.parse_args(argv).device)
    g = geometry()
    xq, xk, xv = inputs(g["bnw"], g["c"], dev)
    kw = {"num_heads": g["nh"], "bw": g["bw"]}

    def per_head(q, k, v):
        return attn_dots_per_head(q, k, v, **kw)

    def grouped(q, k, v):
        return attn_dots_grouped(q, k, v, **kw)

    print(device_line(dev), flush=True)
    oa, ob = per_head(xq, xk, xv), grouped(xq, xk, xv)
    d = (oa.float() - ob.float()).abs().max().item()
    print(json.dumps({"max_abs_diff": d}), flush=True)
    print(json.dumps({"per_head_ms": round(t_chain(per_head, xq, xk, xv), 4)}), flush=True)
    print(json.dumps({"grouped_ms": round(t_chain(grouped, xq, xk, xv), 4)}), flush=True)
    print(json.dumps({"launches": {"attn_dots_per_head": attn_dots_per_head.launches,
                                   "attn_dots_grouped": attn_dots_grouped.launches}}),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
