"""Where a training step's device time goes: the port's ``train_step`` with
the default training configuration (``configs/train/*.yaml``:
swin-base-UPerNet, AERIAL_RGBI channels [4, 1, 2], 19 classes, AdamW) on
one random batch, random weights from the configuration's seed.

    python -m flair_for_aigle_tpu_torch.tools.profile_train_step \\
        [--dtype float32|bfloat16] [--batch 5] [--px 512] [--steps 3] [--device cuda|cpu]

Prints the device's line (the card's name and power limit from
nvidia-smi), then two JSON lines: ``ms_per_step``, the host clock around
``--steps`` synchronised steps after two warm-up steps, with no profiler;
then, from ``torch.profiler`` over another ``--steps`` steps,
``device_busy_ms_per_step`` (the summed time of the card's kernels and
copies, one stream, so no overlap), ``wall_ms_per_step`` (the host clock
under the profiler), ``kernels``: the 15 largest by device time as
[name, ms per step, calls per step], ``cores``: the attention cores of
K2 and K6 (``attn_core_*``, ``attn_bwd_core_*``) as {name: [ms per step,
calls per step]}, however small; ``ffn_gemms``: the ffn's two products
(``gemm_mma_kernel`` with the GELU, residual or split-K epilogue, and
``resid_sum_kernel`` where fc2 splits K) the same way: K3's, or under
``FLAIR_SWIN_FINISH=1`` K8's, which runs the same kernels after its gather
pass (``finish_gather_kernel``, among ``kernels``); and
``attn_gemms``: ``gemm_mma_kernel`` with the bias epilogue, K2's qkv and
output projections and K6's qkv recompute; ``bwd_gemms``: ``gemm_mma_kernel``
with the rounding and weight-gradient epilogues, K6's do, dx, dWproj and
dWqkv (``gemm_tallies`` splits them by the kernel's epilogue template
argument); ``merge_gemms``: K5's ``gemm_mma_ln_kernel`` (the reduction
with the gathering LayerNorm producer of A, and ``sum_round_kernel`` where
it cuts K); and ``ffn_bwd_gemms``: ``gemm_mma_aux_kernel``, K7's fc1
recompute and dh (the epilogues with a second output, codes 6 and 7; under
``FLAIR_FFN_BWD=kernel``, none otherwise). K7's other three products share
their kernels with the tallies above: its dW2 and dW1 (the weight-gradient
epilogue, code 5) land in ``bwd_gemms``, its dln (the split-K partials'
epilogue, code 2) in ``ffn_gemms``. ``FLAIR_FFN_BWD`` and
``FLAIR_SWIN_FINISH`` are read as in training. Runs on the card unless
``--device cpu`` asks for the CPU (the plain versions; no device lines).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch
import yaml

from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.train.optim import make_optimizer
from flair_for_aigle_tpu_torch.train.stages import build_model
from flair_for_aigle_tpu_torch.train.task import make_steps

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "train")


def train_config(dtype: str) -> dict:
    """configs/train/*.yaml merged in file order (as ``read_config``), the
    compute dtype set."""
    cfg: dict = {}
    for name in sorted(os.listdir(CONFIGS)):
        if name.endswith(".yaml"):
            with open(os.path.join(CONFIGS, name)) as f:
                cfg.update(yaml.safe_load(f) or {})
    cfg["hyperparams"]["compute_dtype"] = dtype
    return cfg


def random_batch(cfg: dict, batch: int, px: int, seed: int = 0) -> dict:
    """Standard-normal images of the configured channels and one-hot labels
    of uniform random classes, as the data module's batches are laid out."""
    rng = np.random.default_rng(seed)
    task = cfg["labels"][0]
    k = len(cfg["labels_configs"][task]["value_name"])
    channels = len(cfg["modalities"]["inputs_channels"]["AERIAL_RGBI"])
    labels = rng.integers(0, k, (batch, px, px))
    return {"AERIAL_RGBI": rng.standard_normal((batch, channels, px, px), np.float32),
            task: np.moveaxis(np.eye(k, dtype=np.float32)[labels], -1, 1)}


#: gemm_mma.cuh's epilogue codes (its template argument EPI): K3's (and
#: K8's) MMA_GELU, MMA_RESID and MMA_PART (also K7's dln); MMA_BIAS, K2's and
#: K6's projections; MMA_ROUND and MMA_WGRAD, K6's do and dx and its weight
#: gradients (also K7's); MMA_GELU_AUX and MMA_DGELU, K7's fc1 recompute and
#: dh (gemm_mma_aux_kernel)
K3_EPILOGUES = {0, 1, 2}
BIAS_EPILOGUE = 3
K6_EPILOGUES = {4, 5}
K7_EPILOGUES = {6, 7}
_MMA_EPI = re.compile(r"gemm_mma(?:_aux)?_kernel<[^>]*?(\d+)\s*>")


def gemm_tallies(rows) -> dict:
    """``rows``: (kernel name, ms per step, calls per step) of the device
    kernels. Returns {"ffn_gemms": K3's (or K8's) products and K7's dln,
    "attn_gemms": K2's and K6's bias products, "bwd_gemms": K6's do, dx and
    weight gradients and K7's, "merge_gemms": K5's reduction,
    "ffn_bwd_gemms": K7's fc1 recompute and dh}, each {name[:90]: [ms,
    calls]}: ``gemm_mma_kernel`` and ``gemm_mma_aux_kernel`` by their
    epilogue template argument, ``resid_sum_kernel`` (fc2's split-K sum) to
    K3, ``gemm_mma_ln_kernel`` and ``sum_round_kernel`` to K5."""
    out: dict = {"ffn_gemms": {}, "attn_gemms": {}, "bwd_gemms": {}, "merge_gemms": {},
                 "ffn_bwd_gemms": {}}
    for name, ms, calls in rows:
        if "resid_sum_kernel" in name:
            key = "ffn_gemms"
        elif "gemm_mma_ln_kernel<" in name or "sum_round_kernel<" in name:
            key = "merge_gemms"
        else:
            m = _MMA_EPI.search(name)
            if m is None:
                continue
            epi = int(m.group(1))
            key = ("ffn_gemms" if epi in K3_EPILOGUES
                   else "attn_gemms" if epi == BIAS_EPILOGUE
                   else "bwd_gemms" if epi in K6_EPILOGUES
                   else "ffn_bwd_gemms" if epi in K7_EPILOGUES else None)
            if key is None:
                raise ValueError(f"gemm_mma_kernel with an unknown epilogue {epi}: {name}")
        out[key][name[:90]] = [ms, calls]
    return out


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (plain versions)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--px", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    cfg = train_config(args.dtype)
    model = build_model(cfg).to(device)
    steps = make_steps(model, cfg, make_optimizer(cfg["hyperparams"], model.parameters()), device)
    batch = random_batch(cfg, args.batch, args.px)

    def run(n: int) -> float:
        """Seconds of n synchronised steps on the host clock."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps.train_step(batch, 1e-5)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)
    print(json.dumps({"ms_per_step": run(args.steps) / args.steps * 1e3}), flush=True)
    if device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(args.steps)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / args.steps
    print(json.dumps({
        "device_busy_ms_per_step": busy, "wall_ms_per_step": wall / args.steps * 1e3,
        "kernels": [[e.key[:90], e.self_device_time_total / 1e3 / args.steps,
                     e.count / args.steps] for e in events[:15]],
        "cores": {e.key[:90]: [e.self_device_time_total / 1e3 / args.steps,
                               e.count / args.steps]
                  for e in events if "attn_core" in e.key or "attn_bwd_core" in e.key},
        **gemm_tallies((e.key, e.self_device_time_total / 1e3 / args.steps,
                        e.count / args.steps) for e in events)}),
          flush=True)


if __name__ == "__main__":
    main()
