#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flair_for_aigle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):

1. environment: the card (name and power limit from nvidia-smi), TF32 off;
   whether the host tail's libraries load (the GeoTIFF IO and GEOS,
   ``memory_io.native_io_error``; libproj);
2. build: compile the CUDA kernels under flair_for_aigle_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card at
   the swin-base@512 shapes (batch 2): K1-K3 at the zonal path's stages,
   K4 (zonal epilogue) on (B, 19, 128, 128) logits at batch 2 and at the
   zonal batch 16, both output types, K5 (patch merge) at the three merge
   transitions, K6 (attention backward, plain version: autograd through
   the plain forward), K7 (ffn backward) and K8 (fused finish, with the
   real shift) at the four stages, in bf16 and float32, both softmax
   modes; K4 and K8 twice bit-identical, with their CUDA-event and device
   times (``tools/time_finish_epilogue.py``) beside yardsticks as device
   time (K8: K3 on the same shortcut and gathered rows, and its two
   products through cuBLAS; K4: ``F.interpolate`` of the logits alone),
   and their kernels' resources (K4's at the zonal geometry, no spill in
   its argmax kernel; K8's gather pass at each stage's C, no spill, the
   blocks per SM it promises); max and median error against
   the stated bound, kernel and plain times (CUDA events, median of 20)
   and each kernel's bound (the larger of its bytes over 3.35 TB/s and its
   operations over the peak for its dtype); the A/B tool's two
   attention-product kernels (per head, grouped) at the tool's defaults and
   the four stage geometries at batch 16, beside the library call (two bf16
   ``torch.bmm``) that computes the same function; K2's attention core
   alone (``window_attention_core``) at the four stages in both softmax
   modes, bf16 and float32, beside one ``scaled_dot_product_attention`` call
   in the same dtype with the bias and the shift mask as its ``attn_mask``
   (each line names the backend that took it; two calls bit-identical;
   the float32 lines also give the bound at 3xTF32's effective rate), and
   both cores' registers, spill bytes, shared bytes and resident blocks
   per SM at T = 144 (no spill, at least 2 blocks, at most 48 KB bf16 and
   104 KB float32); K6's
   attention-backward core alone (``window_attention_core_backward``)
   likewise in both dtypes, beside the backward of one
   ``scaled_dot_product_attention`` call whose ``attn_mask`` requires its
   gradient: per output its error against the plain version (float32: 1e-4
   of each output's largest magnitude), the two passes' probabilities read
   out through o and dv (equal), and both cores' resources at T = 144 (no
   spill; at least 16 warps per SM for the bf16 core, 9 for the float32
   core); K3 at the four stages in bf16 and float32 at batch 2 and in bf16
   at batch 16 (the zonal batch): two calls bit-identical, kernel and
   plain ms by CUDA events and as device time, its two products alone
   through cuBLAS as device time (``torch.nn.functional.linear`` in the
   same dtype, TF32 off: the GEMM part's yardstick, K3's function being
   fused), float32 also bounded at
   3xTF32's rate; K2 the same way (two calls bit-identical, CUDA events
   and device time, its two projections alone through cuBLAS as device
   time); K7 the same way at the four stages at batch 2 in both dtypes and
   at the training batch 5 in float32 (two calls bit-identical, CUDA
   events and device time, ``tools/time_ffn.py backward_stage_times``,
   beside its five products alone through cuBLAS, ``torch.matmul`` in the
   same dtype, TF32 off, as device time; float32 also bounded at 3xTF32's
   rate); K6 in the training configuration's mode also as device time,
   beside its four products alone (do, dx, dWproj, dWqkv on
   ``gemm_mma.cuh``, ``window_attn.backward_gemm``), the weights'
   transposed copies it makes, and the same four products through cuBLAS
   (``torch.matmul``, same dtype, TF32 off: a yardstick); then the
   tensor-core GEMM kernels' resources at each stage, K3's and K2's
   projections', and K6's and K7's products' at every tile (no spill; at
   least 2 blocks per SM), and both A/B kernels' (no spill; per head at least 3
   blocks per SM, grouped 2); K1 and K5 at batch 2 in both dtypes and at
   the paths' batches (16 in bf16, the zonal one; 5 in float32, the
   training one): two calls bit-identical, kernel and plain by CUDA events
   and as device time (``tools/time_prep_merge.py``), beside a yardstick
   as device time (K1: ``F.layer_norm`` over the same input; K5: its
   reduction alone through cuBLAS on ready LN rows, TF32 off), and the
   host time of a call (CUDA events minus device time); K1's kernel per
   stage width and K5's GEMM per merge and batch (no spill; K1 at least
   the blocks per SM its launch bounds promise, K5 2); every
   ``gemm_mma.cuh`` instantiation of K2, K3 and K6 with the registers it
   had before K5's producer joined the GEMM's body, and no spill; K6's
   float32 weight gradients (dWqkv, dWproj) at the four stages at the
   training batch 5 in its own plan's partials, each stage's worst ratio
   to 2e-3 + 2e-3 |ref| against the float64 product; K2 and K6 at attn_f32
   True on scores 200 past exp's range (the min(s, 80) clamp: one spike a
   score row, then every score) at T = 144 in both dtypes (``clamp_lines``:
   finite, and on the spike case within their bounds);
4. slice: the port's zonal ``run_inference`` on a synthetic, spatially
   correlated 2048 x 2048 3-band uint8 raster at 0.2 m/px (25 tiles of
   512 px, margin 40, batch 16,
   bf16, attn_f32 False, device normalisation, random seeded weights):
   output geometry, labels < 19, every kernel's launch count during the run,
   argmax agreement of one batch with a forward built from the plain
   versions (float32 and bf16), and the warm wall time, tiles/s and km2/h;
   then a pass of the same raster with ``FLAIR_SWIN_FINISH=1`` (K8 in every
   block, K3 in none): its launches, its label agreement with the default
   pass and both passes' tiles/s;
   profile: ``utils/profiling.py profile_trace`` around one zonal batch of
   the slice (bf16, batch 16): its Chrome trace names K2's core and K3's
   and K4's kernels;
   bench: the port's bench (``flair_for_aigle_tpu_torch/bench.py``) at its
   defaults (5000 x 5000 at 0.2 m/px, 144 tiles, batch 16, bf16): its JSON
   line, km2/h > 0, the tile count, labels < 19, and the launches of K1,
   K2, K3, K5 and K4 during its timed runs;
   codec: the bench's raster at batch 16, bf16, one warm pass each with
   ``pack_d2h: false``, ``d2h_codec: pack5`` and ``auto``: the three label
   rasters byte-identical, per pass tiles/s, the codec's mode, D2H bytes,
   finalize wait and unpack seconds and the unpack route (native for the
   packed passes); ``StripeCodec`` on two piecewise-constant canvases on
   the card, its rle-small and rle-mid tiers landing byte for byte, every
   ``encode`` under ``torch.cuda.set_sync_debug_mode("error")``;
   multimodal: the FLAIR-HUB fusion model at full width, swin-base-UPerNet
   on the slice's raster fused with a UTAE (the zonal multitemp defaults)
   on a Sentinel-2 time series over the same extent (41 x 41 px, 12
   monthly dates x 10 bands, a dates file, a cloud mask that clouds one
   date over half the raster, 12 fixed time steps), through
   ``run_inference`` (the host loader route): output geometry, labels <
   19, the launches of K1, K2, K3, K5 and K4 during the run
   (``launches_multimodal`` in the kernels line), argmax agreement of one
   batch of the run's own inputs with a forward built from the plain
   versions (float32 >= 0.999, bf16 >= 0.99, and the kernels' bf16 drift
   from the float32 plain forward within 0.002 of the plain bf16
   forward's), the warm wall time, tiles/s,
   km2/h and the engine's phases; then one float32 training step of the
   same model at batch 5 with modality dropout and the aux losses on:
   finite loss, a finite non-zero gradient for every UTAE and fusion
   parameter, the launches of K1, K2, K6, K3 and K5
   (``launches_multimodal_train``);
   families: the other model families on the slice's raster and
   configuration (random seeded weights written as checkpoints):
   resnet34-unet, resnet50-deeplabv3plus, efficientnet_b4-unetplusplus,
   convnext_base-upernet and swin_base_patch4_window12_384-fpn through
   ``run_inference``: output geometry, labels < 19, every kernel's launches
   (the Swin kernels for the Swin arch only, K4 for the UPerNet one only;
   ``launches_families`` in the kernels line), argmax agreement of one
   batch in bf16 with the same model in float32 on the card (0.99
   reported as met or not, the run failing below 0.98: random weights leave
   near-ties that bf16 flips in the JAX package as well,
   ``tools/bf16_label_agreement.py``), for the Swin arch also against a
   forward made of the plain versions (as the slice), and warm tiles/s;
   resnet34 with linknet, manet, pan, pspnet and deeplabv3 through one
   ``forward_convert`` batch (shape, labels < 19); AERIAL_RGBI (512 px)
   and SPOT_RGBI at 1.6 m (64 px tiles) in one swin-base-UPerNet, one
   batch: K2's launches by tokens per window (T = 4 among them) and the
   agreement with the plain versions; one float32 resnet34-fpn training
   step at batch 5: finite loss, every gradient finite and non-zero, every
   BatchNorm running mean moved, FPN's dropout drawn from the generator
   seeded by (seed, step);
5. train: the host probe (pandas), then the port's ``training_stage`` and
   ``predict_stage`` with the reference's default training configuration
   (configs/train/*.yaml: swin-base-UPerNet, AERIAL_RGBI channels [4,1,2],
   19 classes and their loss weights, 512 px, batch 5, AdamW, one_cycle_lr,
   float32) for 2 epochs on a synthetic FLAIR-HUB-style split (20 train,
   5 val, 5 test patches, random seeded weights): every kernel's launch
   count during the run, finite losses, the checkpoint reloading strictly,
   the prediction rasters and metrics; the cosine between the gradients of
   one batch-5 float32 step through the kernels and through the plain
   versions, and again with ``FLAIR_FFN_BWD=kernel`` (K7 in every block's
   backward) and with ``FLAIR_SWIN_FINISH=1`` (K8 in every block); ms/step
   and peak device memory of the kernel, plain and K7 routes in float32
   and with ``compute_dtype: bfloat16``;
   remat: ``models.monotemp_model.remat`` on the same configuration: one
   float32 step with and without it on the default route and under each
   fused-block switch (gradient cosine >= 0.9999, largest absolute
   difference, the forward kernels launched twice with remat), ms/step
   and peak device memory of each, and one float32 efficientnet-b4-U-Net++
   step with and without remat whose BatchNorm running statistics must be
   equal;
6. multigpu: data parallelism on the one card (``parallel/``). Zonal: the
   slice's raster and configuration through the engine on one device and
   with ``devices=[cuda:0, cuda:0]`` (two replicas, 8 tiles each a batch),
   in bf16 and float32: first, layer by layer, one batch's first 8 tiles
   as a replica's batch against the same tiles' rows of the batch of 16
   (``replica_diagnosis``, once with ``ops/resize.py``'s products through
   cuBLAS's default kernels and once as shipped, through cuBLASLt:
   forward hooks on every module and the kernel wrappers; the first output
   that differs, the share of each output that differs, the calls at
   fault, every kernel call again on its inputs' first rows, the PSP
   pools' products through cuBLAS and cuBLASLt); then
   each replica's launches (the one-device pass's), the two-replica labels
   byte-identical to the one-device labels, the diagnosis batch's logits
   byte-identical and every kernel call bit-identical on the shard's rows,
   both passes' warm tiles/s; in bf16 40 alternating pairs of one
   batch's forward with the resize products through cuBLAS and through
   cuBLASLt (CUDA-event and host ms, reported). Training: one AdamW step
   of the default configuration
   (float32, 512 px, global batch 4) from the same weights and seed three
   ways: (c) no process group, (b) one NCCL rank of world size 1, which
   must equal (c) bit for bit (both deterministic, in this process), (a)
   two gloo ranks with CUDA tensors on card 0 (``python3 chip_smoke.py
   --train-rank <dir>``, each rank under a timeout), against (c): gradient
   cosine >= 0.9999, every parameter within 3 learning rates, every
   BatchNorm running statistic within 1e-3 of its tensor's largest
   magnitude, both ranks' parameters bit-identical, K6's 24 launches a
   rank. Dry run: ``python -m
   flair_for_aigle_tpu_torch.tools.dryrun_multichip --world 2 --device
   cuda --backend gloo`` prints ``dryrun_multichip(2) ok``. The kernels
   are built before any rank starts; any rank's failure fails the run;
   class_prob: ``run_inference`` with ``output_type: class_prob`` on the
   slice's raster, configuration and checkpoint (19 bands): K4's
   class_prob epilogue once a batch (``launches_class_prob``), >= 99 % of
   the bytes within 2 uint8 steps of the plain versions' pass, the argmax
   over the bands equal to the argmax pass's labels wherever the top-two
   gap exceeds 2 steps, warm tiles/s;
   zonal_main: the port's CLI, ``zonal_main.main(["--config", path])``,
   on ``configs/config_model_zonal_segmentation.yaml`` with the slice's
   raster and checkpoint (swin-base-UPerNet, 512 px, margin 40, bf16,
   ``attn_f32: True``, batch 8, ``pack_d2h`` with ``d2h_codec: auto``):
   every K2 launch in bf16 at attn_f32 True, the codec's mode rle or
   pack5, >= 99 % label agreement with the same file under the plain
   versions, the agreement with the slice's attn_f32 False pass and warm
   tiles/s at batch 8 (``launches_zonal_main``);
7. tool: the port's A/B tool, ``python -m
   flair_for_aigle_tpu_torch.tools.exp_attn_dots``, once as a subprocess at
   its defaults: its three JSON lines, the two kernels' agreement and times,
   and its kernel launches.

The line before the last is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``. Needs one card, the CUDA toolkit (nvcc)
and the repository checkout; exits non-zero without a card.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TMP = os.path.join(REPO, ".tmp", "chip_smoke")

# swin-base@512 stage geometries: (H = W, C, heads); window 12, shift 6
STAGES = [(128, 128, 4), (64, 256, 8), (32, 512, 16), (16, 1024, 32)]
WS, SS = 12, 6
N_CLASSES = 19
RES = 0.2
SIDE = 2048
BATCH = 16

KERNELS = {
    # name -> (source, TPU kernel it replaces)
    "prep": ("flair_for_aigle_tpu_torch/csrc/prep.cu",
             "flair_for_aigle_tpu/ops/pallas/prep.py:40"),
    "window_attn": ("flair_for_aigle_tpu_torch/csrc/window_attn.cu",
                    "flair_for_aigle_tpu/ops/pallas/window_attn.py:290"),
    "ffn": ("flair_for_aigle_tpu_torch/csrc/ffn.cu",
            "flair_for_aigle_tpu/ops/pallas/ffn.py:152"),
    "epilogue": ("flair_for_aigle_tpu_torch/csrc/epilogue.cu",
                 "flair_for_aigle_tpu/ops/pallas/epilogue.py:119"),
    "merge": ("flair_for_aigle_tpu_torch/csrc/merge.cu",
              "flair_for_aigle_tpu/ops/pallas/merge.py:32"),
    "window_attn_bwd": ("flair_for_aigle_tpu_torch/csrc/window_attn_bwd.cu",
                        "flair_for_aigle_tpu/ops/pallas/window_attn.py:534"),
    "ffn_bwd": ("flair_for_aigle_tpu_torch/csrc/ffn_bwd.cu",
                "flair_for_aigle_tpu/ops/pallas/ffn.py:297"),
    "finish": ("flair_for_aigle_tpu_torch/csrc/finish.cu",
               "flair_for_aigle_tpu/ops/pallas/finish.py:41"),
    "attn_dots_per_head": ("flair_for_aigle_tpu_torch/csrc/attn_dots.cu",
                           "tools/exp_attn_dots.py:44"),
    "attn_dots_grouped": ("flair_for_aigle_tpu_torch/csrc/attn_dots.cu",
                          "tools/exp_attn_dots.py:57"),
}
# kernels that run only under the reference's opt-in fused-block switches
SWITCHED = {"ffn_bwd": ("FLAIR_FFN_BWD", "kernel"), "finish": ("FLAIR_SWIN_FINISH", "1")}
# the H100 SXM's published peaks: memory bytes/s,
# and dense operations/s for the dtype a kernel's products run in (bf16 on
# the tensor cores; float32 on the SIMT units, the bound of every float32
# kernel); "tf32x3": a third of the tf32 tensor cores' 495 TFLOP/s, the
# effective rate of the float32 cores' 3xTF32 products, printed beside
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
T = WS * WS  # tokens per window
# (H = W, C) entering each merge of swin-base@512 (stages 1->2, 2->3, 3->4)
MERGES = [(128, 128), (64, 256), (32, 512)]
TRAIN_N = {"train": 20, "val": 5, "test": 5}
TRAIN_BATCH = 5  # the default training configuration's batch
TRAIN_PX = 512
DEVICE = "cuda"
STEPS_WARM, STEPS_TIMED = 2, 5  # train_step timing: warm-up, then timed


def kernel_fns() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from flair_for_aigle_tpu_torch.ops import epilogue, ffn, finish, merge, prep, window_attn

    return {"prep": prep.fused_ln_shift_partition,
            "window_attn": window_attn.fused_window_attention,
            "window_attn_bwd": window_attn.fused_window_attention_backward,
            "ffn": ffn.fused_ln_mlp_residual,
            "ffn_bwd": ffn.fused_ln_mlp_residual_backward,
            "merge": merge.fused_patch_merge,
            "finish": finish.fused_reverse_ln_mlp_residual,
            "epilogue": epilogue.upsample_crop_convert}


def zero_launches(names) -> dict:
    """Set the named kernels' launch counts to 0; returns their wrappers."""
    fns = {k: fn for k, fn in kernel_fns().items() if k in names}
    for fn in fns.values():
        fn.launches = 0
    return fns


@contextlib.contextmanager
def switch(name: str, value: str):
    """The environment variable ``name`` set to ``value`` inside the block."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def plain_versions():
    """The model's ops resolve to their plain versions inside the block."""
    from flair_for_aigle_tpu_torch.ops import epilogue, ffn, finish, merge, prep, window_attn

    mods = [(prep, "fused_ln_shift_partition"), (window_attn, "fused_window_attention"),
            (ffn, "fused_ln_mlp_residual"), (merge, "fused_patch_merge"),
            (finish, "fused_reverse_ln_mlp_residual"), (epilogue, "upsample_crop_convert")]
    saved = [getattr(m, n) for m, n in mods]
    try:
        for m, n in mods:
            setattr(m, n, getattr(m, n + "_reference"))
        yield
    finally:
        for (m, n), fn in zip(mods, saved):
            setattr(m, n, fn)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_env() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    from flair_for_aigle_tpu_torch.bench import card

    smi = card(torch.device(DEVICE))
    print(smi, flush=True)
    # the plain versions stand for the reference's float32-accumulated
    # products: no TF32, no reduced-precision bf16 split-K reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    say("env", f"host tail: {host_libraries()}")
    return {"card": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def host_libraries() -> str:
    """Whether the host tail's native libraries load here: the GeoTIFF IO
    and GEOS (``memory_io.native_io_error``) and libproj (the CRS
    transforms of ``geo/crs.py``)."""
    import ctypes

    from flair_for_aigle_tpu_torch.zonal.memory_io import native_io_error

    try:
        ctypes.CDLL("libproj.so.25")
        proj = "libproj.so.25 loads"
    except OSError as e:
        proj = f"libproj.so.25 does not load ({e})"
    err = native_io_error()
    return (f"native_io_error() = {err!r}" if err is not None
            else "native GeoTIFF IO and GEOS load") + f"; {proj}"


def phase_build() -> None:
    from flair_for_aigle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    say("build", f"{os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.LAST_BUILD_SECONDS:.1f} s)")


def _stat(stats, name) -> dict:
    return stats.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                   "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                   "library_ms": None})


def _bound(cost) -> tuple[float, float]:
    """(bytes, operations) of ``cost = (bytes, operations, dtype)`` as the
    least ms the card takes for each; the bound is the larger."""
    nbytes, ops, dt = cost
    return nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[dt] * 1e3


def _bound_text(cost) -> str:
    t_bytes, t_ops = _bound(cost)
    return f"bound {max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})"


def _add_time(stats, name, t_k, t_p, cost):
    """Add one timed call to the kernel's sums: its time, its plain
    version's, and its bound."""
    s = _stat(stats, name)
    t_bytes, t_ops = _bound(cost)
    s["ms"] += t_k
    s["plain_ms"] += t_p
    s["bytes_ms"] += t_bytes
    s["ops_ms"] += t_ops
    s["bound_ms"] += max(t_bytes, t_ops)


# (bytes, operations) of each kernel's function at one call's shapes: every
# input read once, every output written once (activations in the compute
# dtype of itemsize ``isz``, parameters float32 as the wrappers receive
# them); operations of the products (2 per multiply-add) and ~8 per element
# of the normalisations and the epilogue's interpolation
def _ffn_param_bytes(c):
    return (8 * c * c + 7 * c) * 4  # LN scale, bias; W1, b1, W2, b2 (hidden 4C)


def cost_prep(b, hw, c, isz):
    nw = b * (-(-hw // WS)) ** 2
    return (b * hw * hw * c + nw * T * c) * isz + 2 * c * 4, 8 * b * hw * hw * c


def cost_window_attn(bnw, c, nh, isz):
    m = bnw * T
    return (2 * m * c * isz + (4 * c * c + 4 * c + nh * T * T) * 4,
            8 * m * c * c + 4 * bnw * T * T * c)


def cost_window_attn_bwd(bnw, c, nh, isz):
    # recompute qkv, s and o; then do, dWproj, dp, dv, dq, dk, dWqkv, dx
    m = bnw * T
    return (3 * m * c * isz + 2 * (4 * c * c + 4 * c + nh * T * T) * 4,
            22 * m * c * c + 12 * bnw * T * T * c)


def cost_ffn(n, c, isz):
    return 3 * n * c * isz + _ffn_param_bytes(c), 16 * n * c * c


def cost_ffn_bwd(n, c, isz):
    # x, attn, g in; dx (= dattn) out; five products of 2 n C 4C each
    return 4 * n * c * isz + 2 * _ffn_param_bytes(c), 40 * n * c * c


def cost_finish(b, hw, c, isz):
    n, nw = b * hw * hw, b * (-(-hw // WS)) ** 2
    return (nw * T * c + 2 * n * c) * isz + _ffn_param_bytes(c), 16 * n * c * c


def cost_merge(b, hw, c, isz):
    n_out = b * (hw // 2) ** 2
    return ((b * hw * hw * c + n_out * 2 * c) * isz + (8 * c + 8 * c * c) * 4,
            16 * n_out * c * c)


def cost_epilogue(b, k, hw, margin, isz, out_ch):
    # out_ch: 1 (argmax labels) or k (class_prob bytes)
    kept = 4 * hw - 2 * margin
    return b * k * hw * hw * isz + b * out_ch * kept * kept, 8 * b * kept * kept * k


def cost_attn_dots(bnw, c):
    # tools/exp_attn_dots.py: q, k, v in, out; QK^T and P V per window, bf16
    return 4 * bnw * T * c * 2, 4 * bnw * T * T * c


def attn_dots_bound(ref) -> float:
    """The A/B kernels' bound: one bf16 unit in the last place at the
    reference's largest magnitude, and at least 4e-3 of it. The kernels sum
    exact bf16 products in another float32 order than the plain version, so
    single roundings of the scores and of the outputs flip; an output flip
    at the largest magnitude is one unit there, between 2^-8 and 2^-7 of
    that magnitude (4e-3 alone is below one unit in the lower part of each
    binade)."""
    m = max(ref.float().abs().max().item(), 2.0 ** -20)
    return max(4e-3 * m, 2.0 ** (math.floor(math.log2(m)) - 7))


def library_attn_dots(q, k, v, nh):
    """The attention products in library calls (the yardstick, used
    nowhere in the port): the head transposes, then two bf16 ``torch.bmm``
    with their float32 accumulation and the bf16 round between them."""
    import torch

    bnw, t, c = q.shape
    hd = c // nh

    def heads(x):
        return x.view(bnw, t, nh, hd).transpose(1, 2).reshape(bnw * nh, t, hd)

    p = torch.bmm(heads(q), heads(k).transpose(1, 2))
    o = torch.bmm(p, heads(v))
    return o.view(bnw, nh, t, hd).transpose(1, 2).reshape(bnw, t, c)


def cost_window_attn_core(bnw, c, nh, isz, bias_isz):
    # q, k, v in, o out (itemsize isz), the (nh, T, T) bias once; QK^T and P V
    return 4 * bnw * T * c * isz + nh * T * T * bias_isz, 4 * bnw * T * T * c


def _sdpa_backends():
    """The ``scaled_dot_product_attention`` backends tried for a yardstick,
    in order: memory-efficient (takes float32 and bf16), cuDNN (bf16 only),
    then the plain math backend where neither takes the inputs."""
    from torch.nn.attention import SDPBackend

    return (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH)


def _backend_name(backend) -> str:
    return backend.name + (" (neither memory-efficient nor cuDNN attention takes these "
                           "inputs)" if backend.name == "MATH" else "")


def _sdpa_mask(bias, nwh, nh, bnw, dtype, device):
    """The bias plus the shift mask, prebuilt as one (bnw, nh, T, T)
    ``attn_mask`` in the inputs' dtype."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    grid = torch.as_tensor(window_attn._grid_mask(WS, SS, nwh, nwh), device=device)
    return (bias.float()[None, None] + grid[None, :, None]).expand(
        bnw // grid.shape[0], -1, -1, -1, -1).reshape(bnw, nh, T, T).to(dtype)


def library_core(qkv, bias, nwh, nh):
    """K2's attention core as one ``scaled_dot_product_attention`` call
    (the yardstick, used nowhere in the port): contiguous (bnw, nh, T, 32)
    q, k, v in qkv's dtype and the bias plus the shift mask prebuilt as one
    (bnw, nh, T, T) ``attn_mask`` of that dtype, the backend pinned to the
    first of ``_sdpa_backends`` that takes them. Returns (run, backend
    name, output (bnw*T, C))."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    m, c3 = qkv.shape
    bnw, c = m // T, c3 // 3
    q, k, v = (t.contiguous() for t in qkv.view(bnw, T, 3, nh, c // nh).permute(2, 0, 3, 1, 4))
    mask = _sdpa_mask(bias, nwh, nh, bnw, qkv.dtype, qkv.device)
    for backend in _sdpa_backends():
        def run(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      scale=(c // nh) ** -0.5)
        try:
            out = run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return run, _backend_name(backend), out.transpose(1, 2).reshape(m, c)
    raise RuntimeError("no attention backend takes this attn_mask")


def core_lines(stats, geom, bnw, c, nh, nwh, randn, bound, dtype) -> None:
    """K2's attention core alone at one stage geometry in ``dtype``, both
    softmax modes, against its plain version and beside the library call,
    two calls bit-identical, timed as device time (``device_ms``: at batch
    2 one call's Python outlasts the core's device work). bf16: at most 1 %
    of the outputs may differ from the plain version's, and 4 bf16 units at
    the largest magnitude; times of the slice's mode (attn_f32 False) go
    into ``stats["window_attn_core"]``. float32: 1e-4 of the largest
    magnitude, and beside the float32 bound the one at 3xTF32's effective
    rate; times of the training configuration's mode (attn_f32 True) go
    into ``stats["window_attn_core_f32"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn
    from flair_for_aigle_tpu_torch.tools.timing import device_ms

    bf = dtype == torch.bfloat16
    dts, name = ("bf16", "window_attn_core") if bf else ("f32", "window_attn_core_f32")
    qkv = randn(bnw * T, 3 * c, dtype=dtype)
    bias32 = randn(nh, T, T, dtype=torch.float32, std=0.5)
    run, backend, lib = library_core(qkv, bias32, nwh, nh)
    t_l = device_ms(run)
    for attn_f32 in (True, False):
        akw = dict(num_heads=nh, window_size=WS, shift_size=SS, grid_hw=(nwh, nwh),
                   attn_f32=attn_f32)
        # the bias in the dtype the mode reads (float32, or the compute dtype
        # as the wrappers cast it), so no call times a cast
        bias = bias32 if attn_f32 else bias32.to(dtype)
        got = window_attn.window_attention_core(qkv, bias, **akw)
        again = window_attn.window_attention_core(qkv, bias, **akw)
        want = window_attn.window_attention_core_reference(qkv, bias, **akw)
        same = torch.equal(got, again)
        say("kernel", f"{name} {geom} {dts} attn_f32={attn_f32}: repeat "
            f"{'bit-identical ok' if same else 'DIFFERS FAIL'}")
        if not same:
            raise AssertionError(f"{name} {geom}: two calls differ")
        if attn_f32:  # the library call computes the float32 softmax's function
            lib_err = (lib.float() - want.float()).abs().max().item()
            lib_bound = bound(want, torch.bfloat16, 4, None)
            say("kernel", f"{name} library {geom}: scaled_dot_product_attention "
                f"({backend}, {dts}) {t_l:.4f} ms, max_abs_err {lib_err:.3e} against the "
                f"attn_f32=True plain core, bound {lib_bound:.3e} "
                f"{'ok' if lib_err <= lib_bound else 'FAIL'}")
            if lib_err > lib_bound:
                raise AssertionError("the library call computes another function than the core")
        if bf:
            # the core rounds where its plain version does, in the same
            # order; only float32 sums run in another order: at most 1 % of
            # the outputs may differ at all
            frac = (got != want).float().mean().item()
            say("kernel", f"{name} {geom} bf16 attn_f32={attn_f32}: outputs differing "
                f"from the plain version's {frac:.2e} (bound 1.0e-02)")
            if frac > 0.01:
                raise AssertionError(f"{name} {geom}: {frac} of the outputs differ")
        t_k = device_ms(lambda: window_attn.window_attention_core(qkv, bias, **akw))
        t_p = device_ms(lambda: window_attn.window_attention_core_reference(qkv, bias, **akw))
        cost = (*cost_window_attn_core(bnw, c, nh, 2 if bf else 4, 4 if attn_f32 else
                                       (2 if bf else 4)), dts)
        x3 = (*cost[:2], "tf32x3")  # the same work at 3xTF32's effective rate
        note = "" if bf else f"; at 3xTF32's 165 TFLOP/s {_bound_text(x3)}"
        _compare(name, f"{geom} {dts} attn_f32={attn_f32}", got, want,
                 bound(want, dtype, 4, 1e-4), t_k, t_p, stats, cost, t_lib=t_l, note=note)
        if attn_f32 != bf:  # bf16: the slice's mode; float32: training's
            _add_time(stats, name, t_k, t_p, cost)
            s = stats[name]
            s["library_ms"] = (s["library_ms"] or 0.0) + t_l
            if not bf:
                s["bound_3xtf32_ms"] = s.get("bound_3xtf32_ms", 0.0) + max(_bound(x3))


def core_info(stats) -> None:
    """K2's core kernels' registers, spill bytes, shared bytes and resident
    blocks per SM at T = 144 in both modes; raises on a spill, on fewer
    than 2 blocks per SM, or on more shared memory a block than the
    design's: 48 KB for the bf16 core, 104 KB for the float32 core (float32
    q rows, k and v split into tf32 halves)."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    for dtype, name, smem, mode in ((torch.bfloat16, "window_attn_core", 48 * 1024, False),
                                    (torch.float32, "window_attn_core_f32", 104 * 1024, True)):
        for attn_f32 in (True, False):
            info = window_attn.window_attention_core_info(T, attn_f32, dtype)
            say("kernel", f"{name} T{T} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                f"attn_f32={attn_f32}: {info['regs']} registers, {info['spill_bytes']} spill "
                f"bytes, {info['shared_bytes']} shared bytes per block, {info['blocks_per_sm']} "
                f"blocks per SM (bound: 0 spill bytes, >= 2 blocks per SM, <= {smem} shared "
                f"bytes)")
            if (info["spill_bytes"] > 0 or info["blocks_per_sm"] < 2
                    or info["shared_bytes"] > smem):
                raise AssertionError(f"{name} spills or misses its occupancy at "
                                     f"attn_f32={attn_f32}: {info}")
            if attn_f32 == mode:  # the mode whose times the stats sum
                stats[name]["info"] = info


def cost_window_attn_bwd_core(bnw, c, nh, isz):
    # qkv and do in, o and dqkv out (itemsize isz: 8 C elements a token); the
    # float32 (nh, T, T) bias in and dbias out, dbqkv out; six T x T x 32
    # products per (window, head)
    return 8 * isz * bnw * T * c + 8 * nh * T * T + 12 * c, 12 * bnw * T * T * c


def library_core_backward(qkv, do, bias, nwh, nh):
    """K6's attention core as the backward of one ``scaled_dot_product_
    attention`` (the yardstick, used nowhere in the port): contiguous
    (bnw, nh, T, 32) q, k, v in qkv's dtype and the bias plus the shift mask
    prebuilt as one (bnw, nh, T, T) ``attn_mask`` of that dtype, all
    requiring their gradients, the backend pinned to the first of
    ``_sdpa_backends`` that takes them. The timed call is the backward alone
    (dq, dk, dv and the mask's gradient) of a forward run once. Returns
    (run, backend name, (dq, dk, dv) merged as (bnw*T, 3C))."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    m, c3 = qkv.shape
    bnw, c = m // T, c3 // 3
    q, k, v = (t.contiguous().requires_grad_()
               for t in qkv.view(bnw, T, 3, nh, c // nh).permute(2, 0, 3, 1, 4))
    g = do.view(bnw, T, nh, c // nh).transpose(1, 2).contiguous()
    mask = _sdpa_mask(bias, nwh, nh, bnw, qkv.dtype, qkv.device).requires_grad_()
    for backend in _sdpa_backends():
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     scale=(c // nh) ** -0.5)

            def run(out=out):
                return torch.autograd.grad(out, (q, k, v, mask), g, retain_graph=True)

            dq, dk, dv, _ = run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(m, c3)
        return run, _backend_name(backend), dqkv
    raise RuntimeError("no attention backend takes this attn_mask's gradient")


def ulps(ref, n) -> float:
    """n bf16 units in the last place at the largest magnitude of ref, taken
    as n * 2^-7 of that magnitude (a unit is 2^-8 to 2^-7 of it)."""
    return n * 2.0 ** -7 * ref.float().abs().max().item()


def bwd_core_errors(got, want, attn_f32) -> tuple[dict, bool]:
    """K6's core (o, dqkv, dbias, dbqkv) against its plain version: per
    output its max error, its bound, and the share of outputs that differ at
    all. float32 (o and dqkv float32): every output within 1e-4 of its
    largest magnitude, the card suite's float32 bound. bf16: o at most 1 %
    differing and 4 bf16 units at its largest magnitude (K2's core: both
    round in the same places, only float32 sums run in another order); dq,
    dk, dv 4 units at each one's largest magnitude; dbias and dbqkv
    (float32) 1e-4 of their largest magnitude, except dbias with attn_f32
    False: 4 bf16 units at its largest magnitude. There the scores are
    rounded to bf16, and the tensor cores' float32 sum of a score's 32
    products (not an IEEE sum) differs from the plain version's in the last
    bit often enough that a few scores per (window, head) round to the
    neighbouring bf16 value; each such p and ds moves by up to a few bf16
    units, and dbias sums them."""
    import torch

    o, dqkv, dbias, dbqkv = got
    c = o.shape[1]
    f32 = o.dtype == torch.float32

    def rel(ref):
        return 1e-4 * ref.float().abs().max().item()

    act = rel if f32 else (lambda ref: ulps(ref, 4))
    parts = {"o": (o, want[0], act(want[0])),
             "dq": (dqkv[:, :c], want[1][:, :c], act(want[1][:, :c])),
             "dk": (dqkv[:, c:2 * c], want[1][:, c:2 * c], act(want[1][:, c:2 * c])),
             "dv": (dqkv[:, 2 * c:], want[1][:, 2 * c:], act(want[1][:, 2 * c:])),
             "dbias": (dbias, want[2], rel(want[2]) if attn_f32 or f32 else ulps(want[2], 4)),
             "dbqkv": (dbqkv, want[3], rel(want[3]))}
    out, ok = {}, True
    for name, (a, b, bound) in parts.items():
        err = (a.float() - b.float()).abs().max().item()
        frac = (a != b).float().mean().item()
        out[name] = (err, bound, frac)
        ok &= err <= bound and bool(a.float().isfinite().all())
    if not f32:
        ok &= out["o"][2] <= 0.01
    return out, ok


def core_p_readouts(qkv, bias, nh, **kw):
    """The probabilities as each pass of K6's core takes them into its
    products (pc in bf16; p as the tensor cores see it in float32), (bnw,
    nh, T, T) twice in qkv's dtype: pass Q's through o = pc V with V one-hot
    (o[q, d] = pc[q, k0 + d]), pass K's through dv = pc^T do with do one-hot
    (dv[k, d] = pc[k0 + d, k]); each a single product by 1 with p as the
    same operand. V and do do not enter p, so every call sees the same p."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    t = kw["window_size"] ** 2
    m, c = qkv.shape[0], qkv.shape[1] // 3
    bnw, hd = m // t, c // nh
    pq = torch.zeros((bnw, nh, t, t), dtype=qkv.dtype, device=qkv.device)
    pk = torch.zeros_like(pq)
    for k0 in range(0, t, hd):
        n = min(hd, t - k0)
        hot = torch.zeros((bnw, t, nh, hd), dtype=qkv.dtype, device=qkv.device)
        hot[:, k0 + torch.arange(n), :, torch.arange(n)] = 1
        qkv_v = qkv.clone()
        qkv_v[:, 2 * c:] = hot.reshape(m, c)
        o, dqkv, _, _ = window_attn.window_attention_core_backward(qkv_v, hot.reshape(m, c), bias,
                                                                   num_heads=nh, **kw)
        pq[..., k0:k0 + n] = o.view(bnw, t, nh, hd)[..., :n].permute(0, 2, 1, 3)
        pk[..., k0:k0 + n, :] = dqkv[:, 2 * c:].reshape(bnw, t, nh, hd)[..., :n].permute(0, 2, 3, 1)
    return pq, pk


def f32_units(a, b) -> float:
    """The largest distance between float32 tensors a and b in units in the
    last place of b's elements (2^(exponent - 23))."""
    import torch

    a, b = a.float(), b.float()
    _, e = torch.frexp(b.abs().clamp(min=torch.finfo(torch.float32).tiny))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(b), e - 24)).max().item()


def bwd_core_lines(stats, geom, bnw, c, nh, nwh, randn, dtype) -> None:
    """K6's attention core alone at one stage geometry in ``dtype``, both
    softmax modes, against its plain version (``bwd_core_errors``), two
    calls bit-identical, both passes' probabilities read out, beside the
    library call's backward; device times (``device_ms``); times of the
    training configuration's mode (attn_f32 True) go into ``stats`` as
    ``window_attn_bwd_core`` (bf16) or ``window_attn_bwd_core_f32``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn
    from flair_for_aigle_tpu_torch.tools.timing import device_ms

    bf = dtype == torch.bfloat16
    dts, name = ("bf16", "window_attn_bwd_core") if bf else ("f32", "window_attn_bwd_core_f32")
    qkv, do = randn(bnw * T, 3 * c, dtype=dtype), randn(bnw * T, c, dtype=dtype)
    bias = randn(nh, T, T, dtype=torch.float32, std=0.5)
    run, backend, lib = library_core_backward(qkv, do, bias, nwh, nh)
    t_l = device_ms(run)
    cost = (*cost_window_attn_bwd_core(bnw, c, nh, 2 if bf else 4), dts)
    failed = []
    for attn_f32 in (True, False):
        akw = dict(num_heads=nh, window_size=WS, shift_size=SS, grid_hw=(nwh, nwh),
                   attn_f32=attn_f32)
        got = window_attn.window_attention_core_backward(qkv, do, bias, **akw)
        again = window_attn.window_attention_core_backward(qkv, do, bias, **akw)
        want = window_attn.window_attention_core_backward_reference(qkv, do, bias, **akw)
        if attn_f32:  # the library call computes the float32 softmax's gradients
            rel = ((lib.float() - want[1].float()).abs()
                   / want[1].float().abs().clamp(min=1e-2)).median().item()
            say("kernel", f"{name} library {geom}: scaled_dot_product_attention "
                f"backward ({backend}, {dts}) {t_l:.4f} ms, dqkv median relative error "
                f"{rel:.2e} against the attn_f32=True plain core (bound 0.04) "
                f"{'ok' if rel < 0.04 else 'FAIL'}")
            if not rel < 0.04:
                raise AssertionError("the library call computes another function than the core")
        errs, ok = bwd_core_errors(got, want, attn_f32)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # p out of each pass (bf16: they must agree bit for bit; float32: the
        # largest distance in float32 units, at most 4), and how it differs
        # from the plain version's
        pq, pk = core_p_readouts(qkv, bias, nh, **{k: v for k, v in akw.items()
                                                    if k != "num_heads"})
        q, k, _ = window_attn._split_heads(qkv, nh, T)
        s = window_attn._scores(q, k, bias, window_size=WS, shift_size=SS, grid_hw=(nwh, nwh),
                                attn_f32=attn_f32)
        e = (torch.exp(torch.clamp(s, max=window_attn.CLAMP) - window_attn.SHIFT) if attn_f32
             else torch.exp(s - s.amax(-1, keepdim=True)))
        pc = (e / (e.sum(-1, keepdim=True) + 1e-37)).to(dtype)
        p_units = 0.0 if torch.equal(pq, pk) else (f32_units(pk, pq) if not bf else math.inf)
        p_ok = p_units <= (0 if bf else 4)
        p_frac = (pq != pc).float().mean().item()
        p_err = (pq.float() - pc.float()).abs().max().item()
        del q, k, s, e, pc, pk, pq
        t_k = device_ms(lambda: window_attn.window_attention_core_backward(qkv, do, bias, **akw))
        t_p = device_ms(lambda: window_attn.window_attention_core_backward_reference(
            qkv, do, bias, **akw))
        p_text = ("=" if p_units == 0 else f"DIFFERS FROM ({p_units:.1f} float32 units, bound "
                  f"{0 if bf else 4})")
        say("kernel", f"{name} {geom} {dts} attn_f32={attn_f32}: " + "; ".join(
            f"{n} max {e:.2e} (bound {b:.2e}) differing {f:.2e}" for n, (e, b, f) in errs.items())
            + (" (o bound 1.0e-02 differing)" if bf else "")
            + f"; p of pass K {p_text} pass Q's, {p_frac:.2e} of it differing from the plain "
            f"version's (max {p_err:.2e}); repeat {'bit-identical' if same else 'DIFFERS'} "
            f"{'ok' if ok and same and p_ok else 'FAIL'}; kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_l:.4f} ms (x{t_l / t_k:.2f} the kernel's), "
            f"{_bound_text(cost)}")
        if not (ok and same and p_ok):
            failed.append(attn_f32)
        st = _stat(stats, name)
        st["max_abs_err"] = max(st["max_abs_err"], max(e for e, _, _ in errs.values()))
        if attn_f32:
            _add_time(stats, name, t_k, t_p, cost)
            st["library_ms"] = (st["library_ms"] or 0.0) + t_l
    if failed:
        raise AssertionError(f"{name} {geom} attn_f32={failed}: outside its bounds, not "
                             f"repeatable, or its passes' p differ")


def bwd_core_info(stats) -> None:
    """K6's core kernels' registers, spill bytes, shared bytes, resident
    blocks and warps per SM at T = 144 in both modes; raises on a spill, or
    on fewer resident warps per SM than the design's: 16 for the bf16 core
    (two blocks of 9), 9 for the float32 core (one block of 9: 144 KB of
    float32 rows and rings)."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    for dtype, name, warps in ((torch.bfloat16, "window_attn_bwd_core", 16),
                               (torch.float32, "window_attn_bwd_core_f32", 9)):
        for attn_f32 in (True, False):
            info = window_attn.window_attention_core_backward_info(T, attn_f32, dtype)
            say("kernel", f"{name} T{T} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                f"attn_f32={attn_f32}: {info['regs']} registers, {info['spill_bytes']} spill "
                f"bytes, {info['shared_bytes']} shared bytes per block, {info['blocks_per_sm']} "
                f"blocks and {info['warps_per_sm']} warps per SM (bound: 0 spill bytes, >= "
                f"{warps} warps per SM)")
            if info["spill_bytes"] > 0 or info["warps_per_sm"] < warps:
                raise AssertionError(f"{name} spills or misses its occupancy at "
                                     f"attn_f32={attn_f32}: {info}")
            if attn_f32:
                stats[name]["info"] = info


def ffn_lines(stats, batch, hw, c, dtype, randn, bound, ffn_params) -> None:
    """K3 at one stage for ``batch`` tiles of 512 px in ``dtype``: against
    its plain version (4 bf16 units, float32 1e-4 of the largest
    magnitude), two calls bit-identical, and ``tools/time_ffn.py``'s
    ``stage_times``: kernel and plain ms by CUDA events around each call,
    as every kernel line, then as device time (at batch 2 a call's Python
    outlasts K3's device work), and beside them the two products alone
    through cuBLAS (``torch.nn.functional.linear`` twice in the same dtype,
    float32 with TF32 off) as device time: a yardstick of the GEMM part,
    not a library call computing K3's fused function. float32 lines give
    the bound at 67 TFLOP/s and at 3xTF32's 165. Sums: bf16 at batch 2 in
    ``stats["ffn"]``, float32 in ``stats["ffn_f32"]``, bf16 at the zonal
    batch in ``stats["ffn_b16"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import ffn
    from flair_for_aigle_tpu_torch.tools.time_ffn import stage_times

    bf = dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    n = batch * hw * hw
    x = randn(batch, hw, hw, c, dtype=dtype)
    a = randn(batch, hw, hw, c, dtype=dtype, std=0.5)
    fp = ffn_params(c)
    got = ffn.fused_ln_mlp_residual(x, a, *fp)
    again = ffn.fused_ln_mlp_residual(x, a, *fp)
    want = ffn.fused_ln_mlp_residual_reference(x, a, *fp)
    tag = f"B{batch} {hw}x{hw}x{c} {dts}"
    same = torch.equal(got, again)
    say("kernel", f"ffn {tag}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"ffn {tag}: two calls differ")
    t = stage_times(x, a, fp)
    cost = (*cost_ffn(n, c, 2 if bf else 4), dts)
    x3 = (*cost[:2], "tf32x3")  # the same work at 3xTF32's effective rate
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"cuBLAS products (F.linear x2, {dts}) {t['cublas_device_ms']:.4f} ms"
            + ("" if bf else f"; at 3xTF32's 165 TFLOP/s {_bound_text(x3)}"))
    _compare("ffn", tag, got, want, bound(want, dtype, 4, 1e-4), t["ms"], t["plain_ms"], stats,
             cost, note=note)
    name = "ffn_b16" if batch != 2 else ("ffn" if bf else "ffn_f32")
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    s = stats[name]
    for key in ("device_ms", "plain_device_ms", "cublas_device_ms"):
        s[key] = s.get(key, 0.0) + t[key]
    if not bf:
        s["bound_3xtf32_ms"] = s.get("bound_3xtf32_ms", 0.0) + max(_bound(x3))


def ffn_bwd_lines(stats, batch, hw, c, dtype, randn, ffn_params) -> None:
    """K7 at one stage (N = batch H W rows) in ``dtype`` against its plain
    version (``_compare_grads``' bounds), two calls bit-identical, and
    ``tools/time_ffn.py``'s ``backward_stage_times``: kernel and plain ms
    by CUDA events, as every kernel line, then as device time, and beside
    them its five products alone through cuBLAS (``torch.matmul`` in the
    same dtype, float32 with TF32 off) as device time: a yardstick of the
    GEMM part, not a library call computing K7's fused function. float32
    lines give the bound at 67 TFLOP/s and at 3xTF32's 165. Sums: float32
    at batch 2 in ``stats["ffn_bwd"]`` (the training configuration's
    dtype), bf16 at batch 2 in ``stats["ffn_bwd_bf16"]``, float32 at the
    training batch in ``stats["ffn_bwd_b5"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import ffn
    from flair_for_aigle_tpu_torch.tools.time_ffn import backward_stage_times

    bf = dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    n = batch * hw * hw
    x, a, gy = (randn(n, c, dtype=dtype) for _ in range(3))
    fp = ffn_params(c)
    s, b, w1, b1, w2, _ = fp
    args = (gy, x, a, s, b, w1, b1, w2)
    got = ffn.fused_ln_mlp_residual_backward(*args)
    again = ffn.fused_ln_mlp_residual_backward(*args)
    want = ffn.fused_ln_mlp_residual_backward_reference(x, a, s, b, w1, b1, w2, gy)
    tag = f"B{batch} N{n} C{c} {dts}"
    same = all(torch.equal(u, v) for u, v in zip(got, again))
    say("kernel", f"ffn_bwd {tag}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"ffn_bwd {tag}: two calls differ")
    t = backward_stage_times(x, a, gy, fp)
    cost = (*cost_ffn_bwd(n, c, 2 if bf else 4), dts)
    x3 = (*cost[:2], "tf32x3")  # the same work at 3xTF32's effective rate
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"cuBLAS products (torch.matmul x5, {dts}) {t['cublas_device_ms']:.4f} ms"
            + ("" if bf else f"; at 3xTF32's 165 TFLOP/s {_bound_text(x3)}"))
    _compare_grads("ffn_bwd", ["dx", "dattn", "dln_scale", "dln_bias", "dw1", "db1", "dw2",
                               "db2"], tag, got, want, not bf, t["ms"], t["plain_ms"], stats,
                   cost, note=note)
    name = "ffn_bwd_bf16" if bf else ("ffn_bwd" if batch == 2 else f"ffn_bwd_b{batch}")
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    st = stats[name]
    for key in ("device_ms", "plain_device_ms", "cublas_device_ms"):
        st[key] = st.get(key, 0.0) + t[key]
    if not bf:
        st["bound_3xtf32_ms"] = st.get("bound_3xtf32_ms", 0.0) + max(_bound(x3))


def wgrad_lines(stats, randn) -> None:
    """K6's float32 weight gradients dWqkv = dqkv^T x and dWproj = g^T o
    at swin-base's four stages at the training batch, in the partials of
    K6's own plan (``window_attn._bwd_plan``; ``backward_gemm`` runs the
    same ``wgrad_plan``), against the float64 product of the same inputs:
    each stage's worst ratio to the elementwise bound 2e-3 + 2e-3 |ref|
    (raises above 1). The worst over the stages goes into K6's stats."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn
    from flair_for_aigle_tpu_torch.ops.mma_plan import n_sm

    f32 = torch.float32
    sms = n_sm(torch.device("cuda"))
    worst_all = 0.0
    for hw, c, nh in STAGES:
        nwh = -(-hw // WS)
        bnw = TRAIN_BATCH * nwh * nwh
        m = bnw * T
        plan = window_attn._bwd_plan(bnw, nh, T, c, sms,
                                     window_attn._core_slots(T, True, f32, sms), f32)
        x, o, gy = (randn(m, c, dtype=f32) for _ in range(3))
        dqkv = randn(m, 3 * c, dtype=f32)
        parts = []
        for name, a, b, k_chunk in (("dwqkv", dqkv, x, plan.k_chunk_qkv),
                                    ("dwproj", gy, o, plan.k_chunk_proj)):
            if window_attn.wgrad_plan(a.shape[1], c, m, sms, f32)[1] != k_chunk:
                raise AssertionError(f"backward_gemm's {name} plan is not K6's")
            got = window_attn.backward_gemm(a, b, wgrad=True)
            want = a.double().t() @ b.double()
            ratio = ((got.double() - want).abs() / (2e-3 + 2e-3 * want.abs())).max().item()
            worst_all = max(worst_all, ratio)
            parts.append(f"{name} partials of {k_chunk} rows x{ratio:.3f} of bound")
            del got, want
        ok = worst_all <= 1.0
        say("kernel", f"window_attn_bwd weight gradients B{TRAIN_BATCH} N{m} C{c} f32: "
            f"{'; '.join(parts)} (bound 2e-3 + 2e-3|ref| against the float64 product) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K6's weight gradients at N{m} C{c} outside the bound")
        del x, o, gy, dqkv
    stats["window_attn_bwd"]["wgrad_b5_worst_ratio"] = worst_all


def window_attn_lines(stats, tag, win, params, nh, nwh, attn_f32, bound) -> None:
    """K2 on the stage's windows in one softmax mode against its plain
    version (4 bf16 units, float32 1e-4 of the largest magnitude), two
    calls bit-identical, and ``tools/time_window_attn.py``'s
    ``stage_times``: kernel and plain ms by CUDA events, as every kernel
    line, then as device time, and beside them its two products alone
    through cuBLAS (``torch.nn.functional.linear`` twice in the same dtype,
    float32 with TF32 off) as device time: a yardstick of the projections,
    not a library call computing K2's fused function. float32 lines give
    the bound at 67 TFLOP/s and at 3xTF32's 165. Sums: bf16 at attn_f32
    False (the slice's) in ``stats["window_attn"]``, float32 at attn_f32
    True (the training configuration's) in ``stats["window_attn_f32"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn
    from flair_for_aigle_tpu_torch.tools.time_window_attn import stage_times

    bf = win.dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    c = win.shape[-1]
    akw = dict(num_heads=nh, window_size=WS, shift_size=SS, grid_hw=(nwh, nwh),
               attn_f32=attn_f32)
    got = window_attn.fused_window_attention(win, *params, **akw)
    again = window_attn.fused_window_attention(win, *params, **akw)
    want = window_attn.fused_window_attention_reference(win, *params, **akw)
    case = f"{tag} attn_f32={attn_f32}"
    same = torch.equal(got, again)
    say("kernel", f"window_attn {case}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"window_attn {case}: two calls differ")
    t = stage_times(win, params, akw)
    cost = (*cost_window_attn(win.shape[0], c, nh, 2 if bf else 4), dts)
    x3 = (*cost[:2], "tf32x3")  # the same work at 3xTF32's effective rate
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"cuBLAS products (F.linear x2, {dts}) {t['cublas_device_ms']:.4f} ms"
            + ("" if bf else f"; at 3xTF32's 165 TFLOP/s {_bound_text(x3)}"))
    _compare("window_attn", case, got, want, bound(want, win.dtype, 4, 1e-4), t["ms"],
             t["plain_ms"], stats, cost, note=note)
    if attn_f32 == bf:  # neither the slice's mode nor training's
        return
    name = "window_attn" if bf else "window_attn_f32"
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    s = stats[name]
    for key in ("device_ms", "plain_device_ms", "cublas_device_ms"):
        s[key] = s.get(key, 0.0) + t[key]
    if not bf:
        s["bound_3xtf32_ms"] = s.get("bound_3xtf32_ms", 0.0) + max(_bound(x3))


def prep_merge_line(stats, op, batch, hw, c, args, bound) -> None:
    """K1 (``op`` "prep": x, scale, bias; window 12, shift 6) or K5
    ("merge": x, scale, bias, reduction) at one stage for ``batch`` tiles
    against its plain version (K1 one bf16 unit, float32 1e-5 of the
    largest magnitude; K5 two bf16 units, as its LN rows round to bf16
    before the product, float32 1e-4), two calls bit-identical, and
    ``tools/time_prep_merge.py``'s times: kernel and plain by CUDA events
    and as device time, beside a yardstick as device time (K1:
    ``F.layer_norm`` over the same input, weights in its dtype; K5: the
    reduction alone through cuBLAS, ``F.linear`` on ready LN rows, TF32
    off). Sums: batch 2 in ``stats[op]`` (K1 bf16, K5 float32: the entry's
    own numbers), batch 2 in the other dtype in ``stats[op + "_f32"]`` or
    ``["merge_bf16"]``, and the paths' batches in ``stats[op + "_b16"]``
    (bf16) and ``[op + "_b5"]`` (float32)."""
    import torch

    from flair_for_aigle_tpu_torch.ops import merge, prep
    from flair_for_aigle_tpu_torch.tools.time_prep_merge import merge_times, prep_times

    x = args[0]
    bf = x.dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    fn, ref, times, kw, cost_fn, ulps, rel, to, yard = {
        "prep": (prep.fused_ln_shift_partition, prep.fused_ln_shift_partition_reference,
                 prep_times, dict(ws=WS, ss=SS), cost_prep, 1, 1e-5, "", "F.layer_norm"),
        "merge": (merge.fused_patch_merge, merge.fused_patch_merge_reference, merge_times, {},
                  cost_merge, 2, 1e-4, f"->{2 * c}",
                  "cuBLAS reduction (F.linear on ready LN rows)")}[op]
    tag = f"B{batch} {hw}x{hw}x{c}{to} {dts}"
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    want = ref(*args, **kw)
    same = torch.equal(got, again)
    say("kernel", f"{op} {tag}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"{op} {tag}: two calls differ")
    t = times(*args)
    cost = (*cost_fn(batch, hw, c, 2 if bf else 4), dts)
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} "
            f"ms, {yard} {t['library_device_ms']:.4f} ms; host time of a call (CUDA events "
            f"minus device time) {t['ms'] - t['device_ms']:.4f} ms")
    _compare(op, tag, got, want, bound(want, x.dtype, ulps, rel), t["ms"], t["plain_ms"], stats,
             cost, note=note)
    # batch 2 in the entry's own dtype (K1 bf16, K5 float32) or the other
    name = f"{op}_b{batch}" if batch != 2 else op if bf == (op == "prep") else f"{op}_{dts}"
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    st = stats[name]
    for key in ("device_ms", "plain_device_ms", "library_device_ms"):
        st[key] = st.get(key, 0.0) + t[key]


def finish_line(stats, hw, c, dtype, randn, bound, ffn_params) -> None:
    """K8 at one stage for 2 tiles, window 12, shift 6, in ``dtype``:
    against its plain version (K3's bounds: 4 bf16 units, float32 1e-4 of
    the largest magnitude), two calls bit-identical, and
    ``tools/time_finish_epilogue.py``'s ``finish_times``: kernel and plain
    by CUDA events and as device time, beside K3 on the same shortcut and
    gathered rows and the two products alone through cuBLAS (``F.linear``
    twice, same dtype, TF32 off), as device time. Sums: bf16 in
    ``stats["finish"]``, float32 in ``stats["finish_f32"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import finish
    from flair_for_aigle_tpu_torch.tools.time_finish_epilogue import finish_times

    bf = dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    nwh = -(-hw // WS)
    win = randn(2 * nwh * nwh, T, c, dtype=dtype)
    x = randn(2, hw, hw, c, dtype=dtype)
    fp = ffn_params(c)
    kw = dict(ws=WS, ss=SS)
    tag = f"B2 {hw}x{hw}x{c} ws{WS} ss{SS} {dts}"
    got = finish.fused_reverse_ln_mlp_residual(win, x, *fp, **kw)
    again = finish.fused_reverse_ln_mlp_residual(win, x, *fp, **kw)
    want = finish.fused_reverse_ln_mlp_residual_reference(win, x, *fp, **kw)
    same = torch.equal(got, again)
    say("kernel", f"finish {tag}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"finish {tag}: two calls differ")
    t = finish_times(win, x, fp)
    cost = (*cost_finish(2, hw, c, 2 if bf else 4), dts)
    x3 = (*cost[:2], "tf32x3")  # the same work at 3xTF32's effective rate
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"K3 on the gathered rows {t['ffn_device_ms']:.4f} ms, cuBLAS products (F.linear "
            f"x2, {dts}) {t['cublas_device_ms']:.4f} ms"
            + ("" if bf else f"; at 3xTF32's 165 TFLOP/s {_bound_text(x3)}"))
    _compare("finish", tag, got, want, bound(want, dtype, 4, 1e-4), t["ms"], t["plain_ms"], stats,
             cost, note=note)
    name = "finish" if bf else "finish_f32"
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    st = stats[name]
    for key in ("device_ms", "plain_device_ms", "ffn_device_ms", "cublas_device_ms"):
        st[key] = st.get(key, 0.0) + t[key]
    if not bf:
        st["bound_3xtf32_ms"] = st.get("bound_3xtf32_ms", 0.0) + max(_bound(x3))


def epilogue_line(stats, lg, output_type) -> None:
    """K4 on stride-4 logits lg (B, 19, 128, 128), margin 40, against its
    plain version (argmax: at most 1e-4 of the pixels differ, where the
    kernel's two-tap sums and the plain matmuls round apart at near-ties;
    class_prob: one uint8 step), two calls bit-identical, and
    ``tools/time_finish_epilogue.py``'s ``epilogue_times``: kernel and
    plain by CUDA events and as device time, beside ``F.interpolate`` of
    the logits to full resolution (a yardstick: no crop, no conversion) as
    device time. Sums in bf16: argmax at batch 2 in ``stats["epilogue"]``
    (the entry's own), at the zonal batch in ``["epilogue_b16"]``;
    class_prob in ``["epilogue_class_prob"]`` and ``["epilogue_class_prob_b16"]``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import epilogue
    from flair_for_aigle_tpu_torch.tools.time_finish_epilogue import MARGIN, epilogue_times

    batch, bf = lg.shape[0], lg.dtype == torch.bfloat16
    dts = "bf16" if bf else "f32"
    ekw = dict(margin=MARGIN, scale=4, output_type=output_type)
    got = epilogue.upsample_crop_convert(lg, **ekw)
    again = epilogue.upsample_crop_convert(lg, **ekw)
    want = epilogue.upsample_crop_convert_reference(lg, **ekw)
    tag = f"({batch},{N_CLASSES},128,128) m{MARGIN} {dts} {output_type}"
    same = torch.equal(got, again)
    say("kernel", f"epilogue {tag}: repeat {'bit-identical ok' if same else 'DIFFERS FAIL'}")
    if not same:
        raise AssertionError(f"epilogue {tag}: two calls differ")
    t = epilogue_times(lg, output_type)
    cost = (*cost_epilogue(batch, N_CLASSES, 128, MARGIN, 2 if bf else 4,
                           1 if output_type == "argmax" else N_CLASSES), dts)
    note = (f"; device time kernel {t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms, "
            f"F.interpolate alone {t['interpolate_device_ms']:.4f} ms")
    if output_type == "argmax":
        frac = (got != want).float().mean().item()
        say("kernel", f"epilogue {tag}: differing pixels {frac:.2e} bound 1.0e-04 "
            f"{'ok' if frac <= 1e-4 else 'FAIL'}; kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {_bound_text(cost)}{note}")
        if frac > 1e-4:
            raise AssertionError(f"epilogue {tag}: {frac} of pixels differ")
        _stat(stats, "epilogue")
    else:
        _compare("epilogue", tag, got.int(), want.int(), 1.0, t["ms"], t["plain_ms"], stats,
                 cost, note=note)
    if not bf:
        return
    name = "epilogue" + ("" if output_type == "argmax" else "_class_prob") + (
        "" if batch == 2 else f"_b{batch}")
    _add_time(stats, name, t["ms"], t["plain_ms"], cost)
    st = stats[name]
    for key in ("device_ms", "plain_device_ms", "interpolate_device_ms"):
        st[key] = st.get(key, 0.0) + t[key]


def finish_epilogue_info_lines(stats) -> None:
    """K4's kernels at the zonal geometry (19 classes, 128 px, margin 40)
    in both dtypes and output types, and K8's gather pass at each stage's C
    in both dtypes: registers, spill bytes, shared bytes, blocks per SM.
    Raises on a spill in K4's argmax kernel or in the gather pass, and on a
    gather pass below the blocks per SM its launch bounds promise."""
    import torch

    from flair_for_aigle_tpu_torch.ops import epilogue, finish

    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        for output_type in ("argmax", "class_prob"):
            i = epilogue.epilogue_info(N_CLASSES, dtype, output_type)
            say("kernel", f"epilogue {dts} {output_type} ({i['tr']} rows x {i['gt']} groups of "
                f"{i['p']} pixels a block): {i['regs']} registers, {i['spill_bytes']} spill "
                f"bytes, {i['shared_bytes']} shared bytes per block, {i['blocks_per_sm']} "
                f"blocks per SM (bound: 0 spill bytes in the argmax kernel)")
            if output_type == "argmax" and i["spill_bytes"] > 0:
                raise AssertionError(f"epilogue {dts} argmax spills: {i}")
            if output_type == "argmax" and dtype == torch.bfloat16:
                stats["epilogue"]["info"] = i
        worst = {"gather_spill_bytes": 0, "gather_max_regs": 0, "gather_min_blocks_per_sm": 99}
        for (_, c, _) in STAGES:
            i = finish.finish_info(c, dtype)
            say("kernel", f"finish gather C{c} {dts} ({i['g']} lanes a token, {i['v']} x 16 bytes "
                f"a lane): {i['regs']} registers, {i['spill_bytes']} spill bytes, "
                f"{i['shared_bytes']} shared bytes per block, {i['blocks_per_sm']} blocks per "
                f"SM (bound: 0 spill bytes, >= {i['min_blocks']} blocks per SM)")
            if i["spill_bytes"] > 0 or i["blocks_per_sm"] < i["min_blocks"]:
                raise AssertionError(f"finish gather C{c} {dts} spills or misses its residency: {i}")
            worst["gather_spill_bytes"] = max(worst["gather_spill_bytes"], i["spill_bytes"])
            worst["gather_max_regs"] = max(worst["gather_max_regs"], i["regs"])
            worst["gather_min_blocks_per_sm"] = min(worst["gather_min_blocks_per_sm"],
                                                    i["blocks_per_sm"])
        if dtype == torch.bfloat16:
            stats["finish"]["info"] = worst


def prep_merge_info_lines(stats) -> None:
    """K1's kernel at each stage's C (registers, spill bytes, shared bytes,
    blocks per SM; raises on a spill or below the blocks per SM its launch
    bounds promise) and K5's GEMM kernel at each merge and batch, as
    ``fused_patch_merge`` launches it (raises on a spill or below 2 blocks
    per SM); the worst into each kernel's stats."""
    import torch

    from flair_for_aigle_tpu_torch.ops import merge, prep

    worst = {"gemm_spill_bytes": 0, "gemm_max_regs": 0, "gemm_min_blocks_per_sm": 99}
    pworst = {"spill_bytes": 0, "max_regs": 0, "min_blocks_per_sm": 99}
    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        for (_, c, _) in STAGES:
            i = prep.prep_info(c, dtype)
            say("kernel", f"prep C{c} {dts} ({i['g']} lanes a token, {i['v']} x 16 bytes a lane): "
                f"{i['regs']} registers, {i['spill_bytes']} spill bytes, {i['shared_bytes']} "
                f"shared bytes per block, {i['blocks_per_sm']} blocks per SM (bound: 0 spill "
                f"bytes, >= {i['min_blocks']} blocks per SM)")
            if i["spill_bytes"] > 0 or i["blocks_per_sm"] < i["min_blocks"]:
                raise AssertionError(f"prep C{c} {dts} spills or misses its residency: {i}")
            pworst["spill_bytes"] = max(pworst["spill_bytes"], i["spill_bytes"])
            pworst["max_regs"] = max(pworst["max_regs"], i["regs"])
            pworst["min_blocks_per_sm"] = min(pworst["min_blocks_per_sm"], i["blocks_per_sm"])
        for batch in (2, TRAIN_BATCH, BATCH):
            for (hw, c) in MERGES:
                for kname, i in merge.merge_info(dtype, batch * (hw // 2) ** 2, c).items():
                    _resource_line(f"merge GEMM B{batch} C{c} {dts} {kname}", i, worst)
    stats["prep"]["info"] = pworst
    stats["merge"]["info"] = worst


# registers of every gemm_mma.cuh instantiation of K3, K2's projections and
# K6's products as they were built before K5's LayerNorm producer joined
# the GEMM's body (ffn_info, window_attention_gemm_info and
# window_attention_backward_gemm_info on an NVIDIA H100 80GB HBM3, nvcc of
# CUDA 12.8), none spilling
GEMM_MMA_REGS = {
    "ffn bf16 fc1 128x128": 128, "ffn bf16 fc1 64x128": 102, "ffn bf16 fc2 128x128": 128,
    "ffn bf16 fc2 64x128": 102, "ffn bf16 fc2 split 128x128": 128,
    "ffn bf16 fc2 split 64x128": 102, "attn bf16 bias 128x128": 126,
    "attn bf16 bias 64x128": 96, "bwd bf16 round 128x128": 128, "bwd bf16 round 64x128": 102,
    "bwd bf16 wgrad 64x128": 114, "ffn f32 fc1 64x128": 113, "ffn f32 fc2 64x128": 113,
    "ffn f32 fc2 split 64x128": 113, "attn f32 bias 64x128": 114, "bwd f32 round 64x128": 113,
    "bwd f32 wgrad 64x128": 112}


def gemm_mma_unchanged(stats) -> None:
    """Every instantiation of ``gemm_mma.cuh`` that K3, K2 and K6 launch
    keeps the registers it had before K5's producer joined the body
    (``GEMM_MMA_REGS``) and spills nothing; raises otherwise."""
    import torch

    from flair_for_aigle_tpu_torch.ops import ffn, window_attn

    now = {}
    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        for kname, i in ffn.ffn_info(128, 512, dtype).items():
            now[f"ffn {dts} {kname}"] = i
        for kname, i in window_attn.window_attention_gemm_info(dtype).items():
            now[f"attn {dts} {kname}"] = i
        for kname, i in window_attn.window_attention_backward_gemm_info(dtype).items():
            now[f"bwd {dts} {kname}"] = i
    changed = {k: (GEMM_MMA_REGS.get(k), i["regs"], i["spill_bytes"]) for k, i in now.items()
               if GEMM_MMA_REGS.get(k) != i["regs"] or i["spill_bytes"]}
    say("kernel", f"gemm_mma instantiations of K2, K3 and K6: {len(now) - len(changed)} of "
        f"{len(now)} keep their registers with 0 spill bytes "
        f"({'ok' if not changed else f'CHANGED FAIL {changed}'})")
    if changed:
        raise AssertionError(f"gemm_mma instantiations changed: {changed}")
    stats["ffn"]["gemm_mma_unchanged"] = len(now)


def _resource_line(what, i, worst) -> None:
    """One GEMM kernel's resources; raises on a spill or on fewer than the
    design's 2 blocks per SM, and folds them into ``worst``."""
    say("kernel", f"{what}: {i['regs']} registers, {i['spill_bytes']} spill bytes, "
        f"{i['shared_bytes']} shared bytes per block, {i['blocks_per_sm']} blocks per SM "
        f"(bound: 0 spill bytes, >= 2 blocks per SM)")
    if i["spill_bytes"] > 0 or i["blocks_per_sm"] < 2:
        raise AssertionError(f"{what} spills or misses its occupancy: {i}")
    worst["gemm_spill_bytes"] = max(worst["gemm_spill_bytes"], i["spill_bytes"])
    worst["gemm_max_regs"] = max(worst["gemm_max_regs"], i["regs"])
    worst["gemm_min_blocks_per_sm"] = min(worst["gemm_min_blocks_per_sm"], i["blocks_per_sm"])


def ffn_info_lines(stats) -> None:
    """The tensor-core GEMM kernels (gemm_mma.cuh) at each stage's C and
    the rows of batch 2 (bf16 and float32) and of the zonal batch (bf16):
    K3's two and K2's two projections (the bias epilogue, which K6's qkv
    recompute shares); registers, spill bytes, shared bytes and resident
    blocks per SM; raises on a spill or on fewer than the design's 2 blocks
    per SM. The worst of each kernel's go into its stats."""
    import torch

    from flair_for_aigle_tpu_torch.ops import ffn, window_attn

    def fresh():
        return {"gemm_spill_bytes": 0, "gemm_max_regs": 0, "gemm_min_blocks_per_sm": 99}

    worst = {"ffn": fresh(), "window_attn": fresh()}
    for (hw, c, _) in STAGES:
        m = (-(-hw // WS)) ** 2 * T  # window rows of one tile
        for dtype, batch in ((torch.bfloat16, 2), (torch.float32, 2), (torch.bfloat16, BATCH)):
            dts = "bf16" if dtype == torch.bfloat16 else "f32"
            for kname, i in ffn.ffn_info(c, 4 * c, dtype, n=batch * hw * hw).items():
                _resource_line(f"ffn GEMM B{batch} C{c} {dts} {kname}", i, worst["ffn"])
            for kname, i in window_attn.window_attention_gemm_info(dtype, batch * m, c).items():
                _resource_line(f"window_attn GEMM B{batch} C{c} {dts} {kname}", i,
                               worst["window_attn"])
    stats["ffn"]["info"] = worst["ffn"]
    stats["window_attn"]["info"] = worst["window_attn"]


def bwd_product_times(x, gy, ap) -> dict:
    """K6's four products alone as K6 launches them
    (``window_attn.backward_gemm``: do = g Wproj and dx = dqkv Wqkv on the
    weights' transposed copies, dWproj = g^T o and dWqkv = dqkv^T x), as
    device time, on the operands ``tools/time_window_attn.py
    backward_times`` gives its cuBLAS yardstick; and the two transposed
    copies K6 makes, as device time."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn
    from flair_for_aigle_tpu_torch.tools.timing import device_ms

    c = x.shape[-1]
    xm, g = x.reshape(-1, c), gy.reshape(-1, c)
    wq, wp = ap[0].to(x.dtype), ap[2].to(x.dtype)
    o, dqkv = xm, torch.cat([g, xm, g], 1)
    wq_t, wp_t = wq.t().contiguous(), wp.t().contiguous()
    bg = window_attn.backward_gemm
    return {"gemm_products_device_ms": device_ms(lambda: (
                bg(g, wp_t, wgrad=False), bg(g, o, wgrad=True), bg(dqkv, xm, wgrad=True),
                bg(dqkv, wq_t, wgrad=False))),
            "weight_transpose_device_ms": device_ms(
                lambda: (wq.t().contiguous(), wp.t().contiguous()))}


def bwd_gemm_info_lines(stats) -> None:
    """K6's product kernels (gemm_mma.cuh's rounding and weight-gradient
    epilogues) at every tile of each dtype's plan: registers, spill bytes,
    shared bytes and resident blocks per SM; raises on a spill or on fewer
    than the design's 2 blocks per SM. The worst go into K6's stats."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    worst = {"gemm_spill_bytes": 0, "gemm_max_regs": 0, "gemm_min_blocks_per_sm": 99}
    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        for kname, i in window_attn.window_attention_backward_gemm_info(dtype).items():
            _resource_line(f"window_attn_bwd GEMM {dts} {kname}", i, worst)
    stats["window_attn_bwd"]["gemm_info"] = worst


def ffn_bwd_info_lines(stats) -> None:
    """K7's product kernels (gemm_mma.cuh: fc1's MMA_GELU_AUX, dh's
    MMA_DGELU and dln's MMA_PART at every tile of each dtype's plan, the
    weight gradients' MMA_WGRAD at theirs): registers, spill bytes, shared
    bytes and resident blocks per SM; raises on a spill or on fewer than
    the design's 2 blocks per SM. The worst go into K7's stats."""
    import torch

    from flair_for_aigle_tpu_torch.ops import ffn

    worst = {"gemm_spill_bytes": 0, "gemm_max_regs": 0, "gemm_min_blocks_per_sm": 99}
    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        for kname, i in ffn.ffn_bwd_gemm_info(dtype).items():
            _resource_line(f"ffn_bwd GEMM {dts} {kname}", i, worst)
    stats["ffn_bwd"]["gemm_info"] = worst


def attn_dots_info_lines(stats) -> None:
    """Both A/B kernels' registers, spill bytes, shared bytes and resident
    blocks per SM at T = 144; raises on a spill or below the design's
    residency (per head three blocks per SM, grouped two)."""
    from flair_for_aigle_tpu_torch.ops import attn_dots

    for name, grouped, blocks in (("attn_dots_per_head", False, 3),
                                  ("attn_dots_grouped", True, 2)):
        i = attn_dots.attn_dots_info(grouped)
        say("kernel", f"{name}: {i['regs']} registers, {i['spill_bytes']} spill bytes, "
            f"{i['shared_bytes']} shared bytes per block, {i['blocks_per_sm']} blocks per SM "
            f"(bound: 0 spill bytes, >= {blocks} blocks per SM)")
        if i["spill_bytes"] > 0 or i["blocks_per_sm"] < blocks:
            raise AssertionError(f"{name} spills or misses its residency: {i}")
        stats[name]["info"] = i


def _compare(name, case, got, want, bound, t_k, t_p, stats, cost, t_lib=None, note=""):
    import torch

    err = (got.float() - want.float()).abs()
    mx, med = err.max().item(), err.median().item()
    ok = mx <= bound
    lib = "" if t_lib is None else f"library {t_lib:.4f} ms (x{t_lib / t_k:.2f} the kernel's), "
    say("kernel", f"{name} {case}: max_abs_err {mx:.3e} median {med:.3e} "
        f"bound {bound:.3e} {'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, {lib}{_bound_text(cost)}{note}")
    s = _stat(stats, name)
    s["max_abs_err"] = max(s["max_abs_err"], mx)
    if not ok:
        raise AssertionError(f"{name} {case}: max_abs_err {mx} > bound {bound}")
    torch.cuda.synchronize()


def _compare_grads(name, grad_names, case, got, want, f32: bool, t_k, t_p, stats, cost,
                   note=""):
    """A backward kernel against its plain version, per gradient: float32
    elementwise |a - b| <= 2e-3 + 2e-3 |b|; bf16 median relative error <
    0.04 (tests/test_window_attn_kernel.py's and tests/test_ffn_kernel.py's
    bounds for the TPU backwards)."""
    import torch

    s = _stat(stats, name)
    parts, ok = [], True
    for gname, a, b in zip(grad_names, got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        mx = err.max().item()
        s["max_abs_err"] = max(s["max_abs_err"], mx)
        if f32:
            worst = (err / (2e-3 + 2e-3 * b.abs())).max().item()
            ok &= worst <= 1.0 and bool(torch.isfinite(a).all())
            parts.append(f"{gname} max {mx:.2e} (x{worst:.3f} of bound)")
        else:
            med = (err / b.abs().clamp(min=1e-2)).median().item()
            ok &= med < 0.04 and bool(torch.isfinite(a).all())
            parts.append(f"{gname} max {mx:.2e} med_rel {med:.2e}")
    say("kernel", f"{name} {case}: {'; '.join(parts)} "
        f"bound {'2e-3 + 2e-3|ref|' if f32 else 'median rel < 0.04'} "
        f"{'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"{_bound_text(cost)}{note}")
    if not ok:
        raise AssertionError(f"{name} {case}: outside the bound")
    torch.cuda.synchronize()


def spike_bias(nh: int, t: int, g, value: float | None = 200.0):
    """(nh, T, T) float32 bias on the card: N(0, 0.5) with one +``value``
    spike in every score row, scattered across columns and heads (the
    reference's case, tests/test_window_attn_kernel.py:236-240); ``value``
    None: every score at +200."""
    import torch

    if value is None:
        return torch.full((nh, t, t), 200.0, device=DEVICE)
    bias = torch.randn((nh, t, t), generator=g, device=DEVICE) * 0.5
    rows = torch.arange(t, device=DEVICE)
    for h in range(nh):
        bias[h, rows, (rows * 7 + h) % t] = value
    return bias


def clamp_lines(stats, g) -> None:
    """K2 and K6 under attn_f32 (the min(s, 80) clamp of the float32
    softmax) on the spike case at T = 144 (window 12, shift 6, a 2 x 3
    window grid at batch 2, C = 128, 4 heads), bf16 and float32, against
    their plain versions: every output finite; K2 within 4 bf16 units
    (float32: 1e-4) at its largest magnitude, K6's gradients but dbias within
    the card suite's bounds (float32 2e-3 of each one's largest magnitude,
    bf16 a median relative error < 0.04); then every score at +200: all
    finite. dbias vanishes on the spike case (each score row's softmax is
    one-hot, so ds = p (dp - sum p dp) cancels to rounding): the plain
    version's must be below 1e-6 and the kernel's within the reference's
    absolute 1e-3 on this case (tests/test_window_attn_kernel.py:266-270).
    Goes into ``stats['window_attn']['clamp']``."""
    import torch

    from flair_for_aigle_tpu_torch.ops import window_attn

    c, nh, grid = 128, 4, (2, 3)
    bnw = 2 * grid[0] * grid[1]
    kw = dict(num_heads=nh, window_size=WS, shift_size=SS, grid_hw=grid, attn_f32=True)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dts = "bf16" if dtype == torch.bfloat16 else "f32"
        x, gy = (torch.randn((bnw, T, c), generator=g, device=DEVICE).to(dtype)
                 for _ in range(2))
        p = (torch.randn((3 * c, c), generator=g, device=DEVICE) * 0.05,
             torch.randn(3 * c, generator=g, device=DEVICE) * 0.05,
             torch.randn((c, c), generator=g, device=DEVICE) * 0.05,
             torch.randn(c, generator=g, device=DEVICE) * 0.05)
        res = {}
        for case, value in (("spike", 200.0), ("saturated", None)):
            ap = (*p, spike_bias(nh, T, g, value))
            got = window_attn.fused_window_attention(x, *ap, **kw)
            grads = window_attn.fused_window_attention_backward(gy, x, *ap, **kw)
            want = window_attn.fused_window_attention_reference(x, *ap, **kw)
            want_g = window_attn.fused_window_attention_backward_reference(gy, x, *ap, **kw)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(a.float()).all()) for a in (got, *grads))
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            bound = (4 * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
            gerr = []
            for a, b in zip(grads[:5], want_g[:5]):
                a, b = a.float(), b.float()
                gerr.append((a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)
                            if dtype == torch.float32 else
                            ((a - b).abs() / b.abs().clamp(min=1e-2)).median().item())
            gbound = 2e-3 if dtype == torch.float32 else 0.04
            # dbias vanishes on the spike case (one-hot softmax rows: ds
            # cancels to rounding): the plain version's is below 1e-6, the
            # kernel's residue within the reference's absolute 1e-3 there
            dbias_ref = want_g[5].float().abs().max().item()
            dbias_err = (grads[5].float() - want_g[5].float()).abs().max().item()
            ok = finite and (case == "saturated" or (
                err <= bound and max(gerr) < gbound and dbias_ref <= 1e-6 and dbias_err <= 1e-3))
            res[case] = {"finite": finite, "fwd_err": err, "fwd_bound": bound,
                         "bwd_worst": max(gerr), "bwd_bound": gbound, "dbias_err": dbias_err}
            say("kernel", f"clamp {case} ({'one +200 spike a score row' if value else 'every score +200'}) "
                f"T {T} {dts} attn_f32=True: K2 and K6 finite {finite}; K2 max_abs_err {err:.3e} "
                f"(bound {bound:.3e}), K6's dx, dwqkv, dbqkv, dwproj, dbproj worst "
                + ("relative error" if dtype == torch.float32 else "median relative error")
                + f" {max(gerr):.3e} (bound {gbound}), dbias max_abs_err {dbias_err:.3e} (plain "
                f"{dbias_ref:.1e}; bound: plain <= 1e-6, kernel within 1e-3)"
                + (" (saturated: finiteness only)" if value is None else "")
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 / K6 on the clamp's {case} case")
        out[dts] = res
    stats["window_attn"]["clamp"] = out


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns per-kernel stats
    (times and bounds summed over the stages, in the dtype of the path each
    kernel serves: bf16 for K1-K4 and K8, the zonal slice's; float32 for K5,
    K6 and K7, the training configuration's; K1 and K5 also in the other
    dtype and at the paths' batches; the A/B kernels' at the tool's default
    geometry, with the library call's time)."""
    import torch

    from flair_for_aigle_tpu_torch.tools.time_window_attn import backward_times
    from flair_for_aigle_tpu_torch.tools.timing import cuda_ms
    from flair_for_aigle_tpu_torch.ops import attn_dots, prep, window_attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    stats: dict = {}

    def randn(*shape, dtype=bf, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def bound(ref, dtype, bf16_ulps, f32_rel):
        # bf16: a few units in the last place at the reference's largest
        # magnitude (sums run in another order, so single roundings flip);
        # float32: a relative bound at that magnitude
        scale = max(1.0, ref.float().abs().max().item())
        return (bf16_ulps * 2.0 ** -7 if dtype == bf else f32_rel) * scale

    def ffn_params(c):
        return (randn(c, dtype=f32) * 0.1 + 1, randn(c, dtype=f32) * 0.1,
                randn(4 * c, c, dtype=f32, std=c ** -0.5), randn(4 * c, dtype=f32, std=0.02),
                randn(c, 4 * c, dtype=f32, std=(4 * c) ** -0.5), randn(c, dtype=f32, std=0.02))

    for (hw, c, nh) in STAGES:
        geom = f"B2 {hw}x{hw}x{c}"
        hp = hw + (WS - hw % WS) % WS
        nwh = hp // WS
        for dtype in (bf, f32):
            dts = "bf16" if dtype == bf else "f32"
            tag = f"{geom} {dts}"
            isz = 2 if dtype == bf else 4
            # K1: LN + shift + pad + partition
            x = randn(2, hw, hw, c, dtype=dtype)
            s, b = randn(c, dtype=f32) * 0.1 + 1, randn(c, dtype=f32) * 0.1
            kw = dict(ws=WS, ss=SS)
            prep_merge_line(stats, "prep", 2, hw, c, (x, s, b), bound)

            # K2: window attention, both softmax modes
            win = prep.fused_ln_shift_partition(x, s, b, **kw)
            bound_c = c ** -0.5
            params = (randn(3 * c, c, dtype=f32, std=bound_c), randn(3 * c, dtype=f32, std=0.02),
                      randn(c, c, dtype=f32, std=bound_c), randn(c, dtype=f32, std=0.02),
                      randn(nh, T, T, dtype=f32, std=0.02))
            for attn_f32 in (True, False):
                window_attn_lines(stats, tag, win, params, nh, nwh, attn_f32, bound)
            core_lines(stats, geom, win.shape[0], c, nh, nwh, randn, bound, dtype)

            # K3: residual + LN + MLP + residual
            ffn_lines(stats, 2, hw, c, dtype, randn, bound, ffn_params)
        # K3 at the zonal batch
        ffn_lines(stats, BATCH, hw, c, bf, randn, bound, ffn_params)

    # K8: the fused finish at the four stages with the real shift, both
    # dtypes; K3's bounds (after its gather pass it runs K3's products)
    for (hw, c, nh) in STAGES:
        for dtype in (bf, f32):
            finish_line(stats, hw, c, dtype, randn, bound, ffn_params)

    # K7: the ffn backward at the four stages, both dtypes at batch 2 and
    # float32 at the training batch, against its plain version
    for (hw, c, nh) in STAGES:
        for batch, dtype in ((2, f32), (2, bf), (TRAIN_BATCH, f32)):
            ffn_bwd_lines(stats, batch, hw, c, dtype, randn, ffn_params)

    # K5: patch merge at the three transitions, batch 2 in both dtypes
    # (times summed in float32, the training configuration's dtype)
    for (hw, c) in MERGES:
        for dtype in (bf, f32):
            x = randn(2, hw, hw, c, dtype=dtype)
            mp = (randn(4 * c, dtype=f32) * 0.1 + 1, randn(4 * c, dtype=f32) * 0.1,
                  randn(2 * c, 4 * c, dtype=f32, std=(4 * c) ** -0.5))
            prep_merge_line(stats, "merge", 2, hw, c, (x, *mp), bound)
    # K1 and K5 at the batches the paths run: the zonal batch in bf16, the
    # training batch in float32
    for batch, dtype in ((BATCH, bf), (TRAIN_BATCH, f32)):
        for op, stages in (("prep", [st[:2] for st in STAGES]), ("merge", MERGES)):
            for hw, c in stages:
                x = randn(batch, hw, hw, c, dtype=dtype)
                if op == "prep":
                    args = (x, randn(c, dtype=f32) * 0.1 + 1, randn(c, dtype=f32) * 0.1)
                else:
                    args = (x, randn(4 * c, dtype=f32) * 0.1 + 1, randn(4 * c, dtype=f32) * 0.1,
                            randn(2 * c, 4 * c, dtype=f32, std=(4 * c) ** -0.5))
                prep_merge_line(stats, op, batch, hw, c, args, bound)
                del x, args

    # K6: attention backward at the four stages, both softmax modes, against
    # autograd through the plain forward; times summed over the stages in
    # float32 with attn_f32 True (the training configuration)
    for (hw, c, nh) in STAGES:
        hp = hw + (WS - hw % WS) % WS
        nwh = hp // WS
        for dtype in (bf, f32):
            x = randn(2 * nwh * nwh, T, c, dtype=dtype)
            gy = randn(2 * nwh * nwh, T, c, dtype=dtype)
            bound_c = c ** -0.5
            ap = (randn(3 * c, c, dtype=f32, std=bound_c), randn(3 * c, dtype=f32, std=0.02),
                  randn(c, c, dtype=f32, std=bound_c), randn(c, dtype=f32, std=0.02),
                  randn(nh, T, T, dtype=f32, std=0.5))
            dts = "bf16" if dtype == bf else "f32"
            cost = (*cost_window_attn_bwd(x.shape[0], c, nh, 2 if dtype == bf else 4), dts)
            for attn_f32 in (True, False):
                tag = f"B2 {hw}x{hw}x{c} {dts} attn_f32={attn_f32}"
                akw = dict(num_heads=nh, window_size=WS, shift_size=SS,
                           grid_hw=(nwh, nwh), attn_f32=attn_f32)
                got = window_attn.fused_window_attention_backward(gy, x, *ap, **akw)
                want = window_attn.fused_window_attention_backward_reference(gy, x, *ap, **akw)
                note = ""
                if attn_f32:  # by both timings, with its products alone beside cuBLAS's
                    t = {**backward_times(gy, x, ap, akw), **bwd_product_times(x, gy, ap)}
                    t_k, t_p = t["bwd_ms"], t["bwd_plain_ms"]
                    note = (f"; device time kernel {t['bwd_device_ms']:.4f} ms, plain "
                            f"{t['bwd_plain_device_ms']:.4f} ms; its four products "
                            f"(gemm_mma.cuh) {t['gemm_products_device_ms']:.4f} ms and the "
                            f"weights' transposed copies {t['weight_transpose_device_ms']:.4f} "
                            f"ms, cuBLAS products (torch.matmul x4, {dts}) "
                            f"{t['bwd_cublas_device_ms']:.4f} ms")
                else:
                    t_k = cuda_ms(lambda: window_attn.fused_window_attention_backward(
                        gy, x, *ap, **akw))
                    t_p = cuda_ms(lambda: window_attn.fused_window_attention_backward_reference(
                        gy, x, *ap, **akw))
                _compare_grads("window_attn_bwd", ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                                                   "dbias"], tag, got, want, dtype == f32,
                               t_k, t_p, stats, cost, note=note)
                if dtype == f32 and attn_f32:
                    _add_time(stats, "window_attn_bwd", t_k, t_p, cost)
                    st = stats["window_attn_bwd"]
                    for key, tkey in (("device_ms", "bwd_device_ms"),
                                      ("plain_device_ms", "bwd_plain_device_ms"),
                                      ("gemm_products_device_ms", "gemm_products_device_ms"),
                                      ("weight_transpose_device_ms", "weight_transpose_device_ms"),
                                      ("cublas_device_ms", "bwd_cublas_device_ms")):
                        st[key] = st.get(key, 0.0) + t[tkey]
            bwd_core_lines(stats, f"B2 {hw}x{hw}x{c}", x.shape[0], c, nh, nwh, randn, dtype)
    # K6's float32 weight gradients at the training batch against float64
    wgrad_lines(stats, randn)
    # the min(s, 80) clamp: K2 and K6 on scores 200 past exp's range
    clamp_lines(stats, g)

    # K4: epilogue at (B, 19, 128, 128), margin 40, at batch 2 and at the
    # zonal batch, both dtypes, both output types
    for batch in (2, BATCH):
        for dtype in (bf, f32):
            lg = randn(batch, N_CLASSES, 128, 128, dtype=dtype, std=3.0)
            for output_type in ("argmax", "class_prob"):
                epilogue_line(stats, lg, output_type)
            del lg
    # the A/B tool's kernels at the stage geometries, batch 16, bw 1 and 4
    # (stage 1 at bw 4 is the tool's defaults, whose times go into stats)
    # against their plain version, beside the library call
    for (hw, c, nh) in STAGES:
        bnw = BATCH * (-(-hw // WS)) ** 2
        q, k, v = (randn(bnw, T, c) for _ in range(3))
        want = attn_dots.attn_dots_reference(q, k, v, num_heads=nh)
        lib = library_attn_dots(q, k, v, nh)
        t_p = cuda_ms(lambda: attn_dots.attn_dots_reference(q, k, v, num_heads=nh))
        t_l = cuda_ms(lambda: library_attn_dots(q, k, v, nh))
        cost = (*cost_attn_dots(bnw, c), "bf16")
        b = attn_dots_bound(want)
        say("kernel", f"attn_dots library B{BATCH} {hw}x{hw}x{c} {nh} heads: two bf16 torch.bmm "
            f"{t_l:.4f} ms, max_abs_err {(lib.float() - want.float()).abs().max().item():.3e} "
            f"against the plain version (for information)")
        for bw in (1, 4):
            defaults = hw == 128 and bw == 4
            for fn in (attn_dots.attn_dots_per_head, attn_dots.attn_dots_grouped):
                got = fn(q, k, v, num_heads=nh, bw=bw)
                t_k = cuda_ms(lambda: fn(q, k, v, num_heads=nh, bw=bw))
                tag = (f"B{BATCH} {hw}x{hw}x{c} {nh} heads bw {bw}"
                       + (" (the tool's default geometry)" if defaults else ""))
                _compare(fn.__name__, tag, got, want, b, t_k, t_p, stats, cost, t_lib=t_l)
                if defaults:
                    _add_time(stats, fn.__name__, t_k, t_p, cost)
                    stats[fn.__name__]["library_ms"] = t_l
        del q, k, v, want, lib
    core_info(stats)
    bwd_core_info(stats)
    ffn_info_lines(stats)
    bwd_gemm_info_lines(stats)
    ffn_bwd_info_lines(stats)
    prep_merge_info_lines(stats)
    finish_epilogue_info_lines(stats)
    gemm_mma_unchanged(stats)
    attn_dots_info_lines(stats)
    for name, st in stats.items():
        lib = "" if st["library_ms"] is None else f"library {st['library_ms']:.4f} ms, "
        if "device_ms" in st:
            lib += (f"device time kernel {st['device_ms']:.4f} ms, plain "
                    f"{st['plain_device_ms']:.4f} ms, ")
            if "cublas_device_ms" in st:
                lib += f"cuBLAS products {st['cublas_device_ms']:.4f} ms, "
            if "library_device_ms" in st:
                lib += f"yardstick {st['library_device_ms']:.4f} ms, "
        x3 = (f", at 3xTF32's rate {st['bound_3xtf32_ms']:.4f} ms" if "bound_3xtf32_ms" in st
              else "")
        say("kernel", f"{name}: summed kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
            f"{lib}bound {st['bound_ms']:.4f} ms (bytes {st['bytes_ms']:.4f}, operations "
            f"{st['ops_ms']:.4f}{x3}); share of bound {st['bound_ms'] / st['ms']:.3f}")
    return stats


def slice_config(img: str, weights: str) -> dict:
    """The port's bench configuration (``bench.py make_cfg``: bench.py's
    zonal configuration, bench.py:55-90) with a checkpoint to load."""
    from flair_for_aigle_tpu_torch import bench

    return {**bench.make_cfg(img, os.path.join(TMP, "out")), "output_name": "chip_smoke",
            "model_weights": weights}


def _zonal_pass(cfg: dict, model, devices=None) -> tuple[float, dict, str]:
    """Wall seconds of one zonal pass (tiling, dataset, inference, stitch,
    D2H, write) with a prebuilt model, as the bench times it
    (``bench.run_zonal``; data parallel over ``devices`` when given), the
    engine's phase timings of that pass and the label raster it wrote."""
    import torch

    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal.stripes import LAST_TIMINGS

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, paths = bench.run_zonal(cfg, torch.device(DEVICE), model, devices)
    return time.perf_counter() - t0, dict(LAST_TIMINGS), paths["AERIAL_LABEL-COSIA"]


def synthetic_raster(seed: int = 0):
    """(3, SIDE, SIDE) uint8 raster with the spatial correlation of aerial
    imagery: a 32 x 32 normal field per band, bilinearly upsampled, scaled
    to mean 110 and std 45, plus per-pixel noise of std 12."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.normal(size=(1, 3, 32, 32)).astype(np.float32))
    field = torch.nn.functional.interpolate(low, size=(SIDE, SIDE), mode="bilinear",
                                            align_corners=False)[0].numpy()
    field = 110 + 45 * field / field.std() + rng.normal(size=field.shape) * 12
    return np.clip(field, 0, 255).astype(np.uint8)


def one_batch(raster, spot=None) -> dict:
    """BATCH tiles of 512 px cut from the slice's raster at a 432 px stride
    (uint8 on the card, as the device tiling gives them), the matching 64 px
    tiles of ``spot`` when given, and the label placeholder."""
    import torch

    offs = [(y, x) for y in range(0, SIDE - 512, 432) for x in range(0, SIDE - 512, 432)][:BATCH]
    batch = {"AERIAL_RGBI": torch.stack([torch.from_numpy(raster[:, y:y + 512, x:x + 512])
                                         for y, x in offs]).to(DEVICE),
             "AERIAL_LABEL-COSIA": torch.zeros((len(offs), 1, 512, 512), device=DEVICE)}
    if spot is not None:
        f = round(SPOT_RES / RES)
        batch["SPOT_RGBI"] = torch.stack([
            torch.from_numpy(spot[:, y // f:y // f + 512 // f, x // f:x // f + 512 // f])
            for y, x in offs]).to(DEVICE)
    return batch


def _step(model, norm: dict):
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi

    return zi.ZonalStep(model, "argmax", 40, 512, 1, 1, torch.bfloat16, norm,
                        torch.device(DEVICE))


def _labels(step, batch, dtype, plain: bool = False):
    step.compute_dtype = dtype
    with plain_versions() if plain else contextlib.nullcontext():
        return step.forward_convert(batch)["AERIAL_LABEL-COSIA"]


def slice_inputs(write_geotiff) -> tuple:
    """The slice's raster (``synthetic_raster(0)`` at RES, EPSG:2154) and
    its random weights from a seeded torch.Generator, written as a
    checkpoint that run_inference loads like a published one: (raster
    path, weights path, raster, transform)."""
    from safetensors.torch import save_file

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    os.makedirs(os.path.join(TMP, "out"), exist_ok=True)
    img = os.path.join(TMP, "raster.tif")
    raster = synthetic_raster(0)
    transform = zi.from_origin(700000.0, 6600000.0, RES, RES)
    write_geotiff(img, raster, transform, "EPSG:2154", compress="lzw", tile_size=512)
    weights = os.path.join(TMP, "weights.safetensors")
    seed_cfg = zi.initialize_geometry_and_resolutions(dict(slice_config(img, weights)))
    zi._set_labels(seed_cfg)
    seed_model, _ = build_inference_model({**seed_cfg, "model_weights": ""},
                                          device="cpu", seed=0)
    save_file({k: v.contiguous() for k, v in seed_model.state_dict().items()}, weights)
    return img, weights, raster, transform


def phase_slice(card: str, write_geotiff, io_desc: str) -> dict:
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    say("slice", f"host IO: {io_desc}")
    img, weights, raster, transform = slice_inputs(write_geotiff)
    cfg = slice_config(img, weights)

    # the user entry point, with every launch count at 0 just before it
    fns = zero_launches({"prep", "window_attn", "ffn", "merge", "epilogue"})
    t0 = time.perf_counter()
    paths = zi.run_inference(dict(cfg))
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    say("slice", f"run_inference {t_entry:.2f} s (model build, checkpoint load and "
        f"first cuDNN autotune included); launches during it: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not run on the main path: {launches}")

    out_path = paths["AERIAL_LABEL-COSIA"]
    with zi.open_raster(out_path) as src:
        pred = src.read()
        t = src.transform
        geo_ok = ((src.height, src.width) == (SIDE, SIDE) and src.count == 1
                  and src.crs == "EPSG:2154"
                  and np.allclose([t.a, t.b, t.c, t.d, t.e, t.f],
                                  [transform.a, transform.b, transform.c,
                                   transform.d, transform.e, transform.f]))
    if not geo_ok:
        raise AssertionError("output GeoTIFF geometry differs from the raster's")
    if pred.max() >= N_CLASSES:
        raise AssertionError(f"label {pred.max()} >= {N_CLASSES}")
    n_tiles = len(zi.generate_patches_from_reference(
        zi.initialize_geometry_and_resolutions(dict(cfg))))
    say("slice", f"output {pred.shape} uint8, labels {int(pred.min())}..{int(pred.max())}, "
        f"geometry ok; {n_tiles} tiles")

    # one batch: kernels vs a forward made of the plain versions
    pcfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    zi._set_labels(pcfg)
    model, _ = build_inference_model(pcfg, device="cuda")
    norm = {"AERIAL_RGBI": ("custom", cfg["modalities"]["AERIAL_RGBI"]["normalization"]["means"],
                            cfg["modalities"]["AERIAL_RGBI"]["normalization"]["stds"])}
    step = _step(model, norm)
    batch = one_batch(raster)

    def forward(plain: bool, dtype) -> torch.Tensor:
        return _labels(step, batch, dtype, plain)

    pred_k, pred_r = forward(False, torch.bfloat16), forward(True, torch.bfloat16)
    agree = (pred_k == pred_r).float().mean().item()
    # context: the same comparison in float32, and bf16 drift against float32
    pred_k32, pred_r32 = forward(False, torch.float32), forward(True, torch.float32)
    agree32 = (pred_k32 == pred_r32).float().mean().item()
    drift_k = (pred_k == pred_r32).float().mean().item()
    drift_r = (pred_r == pred_r32).float().mean().item()
    # bounds: random weights leave near-tied logits, so bf16 rounding alone
    # flips up to about 1% of the labels (the plain bf16 forward against the
    # float32 one); the kernels must match the plain versions in float32,
    # agree on >= 99% of the pixels in bf16, and drift no further from
    # float32 than the plain versions do
    say("slice", f"argmax agreement kernels vs plain versions, one batch of {BATCH}: "
        f"float32 {agree32:.5f} (bound >= 0.999), bf16 {agree:.5f} (bound >= 0.99); "
        f"bf16 vs the float32 plain forward: kernels {drift_k:.5f}, plain {drift_r:.5f} "
        f"(bound: kernels >= plain - 0.002)")
    if agree32 < 0.999 or agree < 0.99 or drift_k < drift_r - 0.002:
        raise AssertionError("kernel forward disagrees with the plain forward")

    # bench.py's metric: read -> tile -> infer -> stitch -> write with a
    # prebuilt model, one warm-up pass then one timed pass
    (first, _, _), (wall, phases, out) = [_zonal_pass(cfg, model) for _ in range(2)]
    with zi.open_raster(out) as src:
        pred_default = src.read().copy()
    km2 = SIDE * SIDE * RES * RES / 1e6
    say("slice", f"warm wall {wall:.3f} s (first pass {first:.3f} s), "
        f"{n_tiles / wall:.2f} tiles/s, {km2 / wall * 3600:.1f} km2/h on {card}; "
        "phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()
                                   if k.endswith("_s")))

    # the reference's fused-block switch: K8 in every block, K3 in none; one
    # warm-up pass, then the timed pass with the counts at 0 just before it
    with switch("FLAIR_SWIN_FINISH", "1"):
        _zonal_pass(cfg, model)
        fin = zero_launches({"prep", "window_attn", "ffn", "finish", "merge", "epilogue"})
        wall_f, _, out = _zonal_pass(cfg, model)
    launches_f = {k: fn.launches for k, fn in fin.items()}
    with zi.open_raster(out) as src:
        pred_finish = src.read()
    agree_f = float((pred_finish == pred_default).mean())
    say("slice", f"FLAIR_SWIN_FINISH=1 pass: launches {launches_f} (bound: finish 48, ffn 0); "
        f"bf16 label agreement with the default pass {agree_f:.5f} (bound >= 0.99); "
        f"warm wall {wall_f:.3f} s, {n_tiles / wall_f:.2f} tiles/s (default pass "
        f"{n_tiles / wall:.2f} tiles/s, same run)")
    if launches_f["finish"] != 48 or launches_f["ffn"] != 0 or agree_f < 0.99:
        raise AssertionError("the FLAIR_SWIN_FINISH=1 pass did not run K8 in every block "
                             "or disagrees with the default pass")
    return {**launches, "finish": launches_f["finish"]}


def phase_bench(write_geotiff) -> dict:
    """The port's bench (``python -m flair_for_aigle_tpu_torch.bench``'s
    measurement) at its defaults: a 5000 x 5000 raster at 0.2 m/px, batch
    16, bf16, under the current host IO. Prints its JSON line; checks that
    the km2/h is positive, that the tile count is the port's tiling of the
    raster, that the labels are < 19, and that K1, K2, K3, K5 and K4 each
    launched during the timed runs (their counts set to 0 just before the
    first). Returns those counts."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    fns: dict = {}
    work = os.path.join(TMP, "bench")
    result, labels = bench.measure(
        torch.device(DEVICE), work, write_geotiff,
        before_timed=lambda: fns.update(zero_launches(
            {"prep", "window_attn", "ffn", "merge", "epilogue"})))
    launches = {k: fn.launches for k, fn in fns.items()}
    print(json.dumps(result), flush=True)
    d = result["detail"]
    cfg = zi.initialize_geometry_and_resolutions(
        bench.make_cfg(os.path.join(work, "km2.tif"), os.path.join(work, "out")))
    n_tiles = len(zi.generate_patches_from_reference(cfg))
    with zi.open_raster(labels) as src:
        pred = src.read()
    side = bench.KM2_SIDE_PX
    say("bench", f"{result['value']:.2f} km2/h, {d['tiles_per_s']:.2f} tiles/s, best of "
        f"{len(d['all_runs_s'])} runs {d['elapsed_s']:.4f} s; {d['tiles']} tiles (the port's "
        f"tiling: {n_tiles}); labels {pred.shape} {int(pred.min())}..{int(pred.max())} "
        f"(bound < {N_CLASSES}); launches during the timed runs {launches}; io: {d['io']}; "
        f"{d['card']}")
    if not (result["value"] > 0 and d["tiles"] == n_tiles and pred.shape == (1, side, side)
            and pred.max() < N_CLASSES and all(launches.values())):
        raise AssertionError("the bench's result, tiles or labels are wrong, or a kernel "
                             "of the zonal path did not run during its timed runs")
    return launches


S2_SIDE, S2_DATES, S2_BANDS = 41, 12, 10  # Sentinel-2 over the slice's extent
MM_BATCH_TRAIN = TRAIN_BATCH


def multimodal_inputs(write_geotiff, raster) -> dict:
    """The slice's aerial raster and a Sentinel-2 time series over the
    same extent: 41 x 41 px (the extent over 41, 9.99 m/px), 12 monthly
    dates x 10 bands of uint16 reflectance-like values with a smooth field
    per band and date, a dates_txt file, and a cloud mask raster (snow and
    cloud band per date) that clouds date 6 over the northern half, so
    tiles there keep 11 dates and pad the 12th."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi

    d = os.path.join(TMP, "multimodal")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    res = SIDE * RES / S2_SIDE
    low = torch.from_numpy(rng.normal(size=(1, S2_DATES * S2_BANDS, 6, 6)).astype(np.float32))
    field = torch.nn.functional.interpolate(low, size=(S2_SIDE, S2_SIDE), mode="bilinear",
                                            align_corners=False)[0].numpy()
    s2 = np.clip(1500 + 600 * field + rng.normal(size=field.shape) * 50, 1, 10000)
    mask = np.zeros((2 * S2_DATES, S2_SIDE, S2_SIDE), np.uint8)
    mask[2 * 6 + 1, :S2_SIDE // 2] = 99
    paths = {k: os.path.join(d, f"{k}.tif") for k in ("aerial", "s2", "mask")}
    paths["dates"] = os.path.join(d, "dates.txt")
    write_geotiff(paths["aerial"], raster, zi.from_origin(700000.0, 6600000.0, RES, RES),
                  "EPSG:2154", compress="lzw", tile_size=512)
    for key, arr in (("s2", s2.astype(np.uint16)), ("mask", mask)):
        write_geotiff(paths[key], arr, zi.from_origin(700000.0, 6600000.0, res, res),
                      "EPSG:2154")
    with open(paths["dates"], "w") as f:
        f.write("\n".join(f"2021{m:02d}15" for m in range(1, S2_DATES + 1)))
    return paths


def multimodal_config(paths: dict, weights: str) -> dict:
    """The slice's configuration (bench.py's zonal defaults: 512 px tiles,
    40 px margin, batch 16, bf16, attn_f32 False, device normalisation)
    with SENTINEL2_TS on: all 10 bands of every date, the dates file, the
    cloud filter, 12 fixed time steps, the zonal UTAE defaults
    (``multitemp_model_ref_date``)."""
    cfg = slice_config(paths["aerial"], weights)
    cfg["output_name"] = "chip_smoke_mm"
    cfg["fixed_time_steps"] = S2_DATES
    cfg["multitemp_model_ref_date"] = "05-15"
    cfg["modalities"]["inputs"]["SENTINEL2_TS"] = True
    cfg["modalities"]["SENTINEL2_TS"] = {
        "input_img_path": paths["s2"], "channels": list(range(1, S2_BANDS + 1)),
        "dates_txt": paths["dates"], "filter_clouds": True,
        "filter_clouds_img_path": paths["mask"], "temporal_average": False}
    return cfg


def phase_multimodal(card: str, write_geotiff) -> tuple[dict, dict]:
    """The multimodal / time-series zonal path at full width: swin-base-
    UPerNet on AERIAL_RGBI fused with a UTAE on SENTINEL2_TS (the FLAIR-HUB
    fusion model), through ``run_inference`` (the host loader route: a
    time series disables device-resident tiling). Then one float32
    training step of the same model at batch 5 with modality dropout and
    the aux losses on. Returns the launches of the zonal run and of the
    training step."""
    import numpy as np
    import torch
    from safetensors.torch import save_file

    from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint
    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
    from flair_for_aigle_tpu_torch.zonal.model_utils import (
        build_inference_model,
        compute_patch_sizes,
    )

    paths = multimodal_inputs(write_geotiff, synthetic_raster(0))
    weights = os.path.join(TMP, "multimodal", "weights.safetensors")
    cfg = multimodal_config(paths, weights)
    pcfg = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    pcfg["output_type"] = "argmax"
    zi._set_labels(pcfg)
    seed_model, _ = build_inference_model({**pcfg, "model_weights": ""}, device="cpu", seed=0)
    save_file({k: v.contiguous() for k, v in seed_model.state_dict().items()}, weights)
    mt = seed_model.plan["multitemp"]
    n_utae = sum(p.numel() for p in seed_model.encoders["SENTINEL2_TS"].parameters())
    del seed_model
    patch_sizes = compute_patch_sizes(pcfg)
    say("multimodal", f"{cfg['monotemp_arch']} on AERIAL_RGBI {SIDE}x{SIDE} at {RES} m + UTAE "
        f"on SENTINEL2_TS {S2_SIDE}x{S2_SIDE} at {SIDE * RES / S2_SIDE:.5f} m ({S2_DATES} dates "
        f"x {S2_BANDS} bands, fixed T {cfg['fixed_time_steps']}, cloud filter); patch sizes "
        f"{patch_sizes}; UTAE widths {mt['encoder_widths']}, out_conv {mt['out_conv']}, "
        f"{mt['n_head']} heads, d_model {mt['d_model']}, {n_utae} parameters; "
        f"device_tiling_plan {zi.device_tiling_plan(pcfg)}")
    tile = cfg["img_pixels_detection"]
    s2_patch = int(round(tile / (SIDE * RES / S2_SIDE / RES)))
    if zi.device_tiling_plan(pcfg) is not None or patch_sizes["SENTINEL2_TS"] != s2_patch:
        raise AssertionError("the time-series route or the Sentinel patch size is wrong")

    # the user entry point, with every launch count at 0 just before it
    names = ("prep", "window_attn", "ffn", "merge", "epilogue")
    fns = zero_launches(set(names))
    t0 = time.perf_counter()
    out_paths = zi.run_inference(copy.deepcopy(cfg), device=DEVICE)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    launches = {k: fns[k].launches for k in names}
    with zi.open_raster(out_paths["AERIAL_LABEL-COSIA"]) as src:
        pred = src.read()
        geo_ok = (src.height, src.width, src.count, src.crs) == (SIDE, SIDE, 1, "EPSG:2154")
    n_tiles = len(zi.generate_patches_from_reference(pcfg))
    say("multimodal", f"run_inference {t_entry:.2f} s (model build, checkpoint load and first "
        f"cuDNN autotune included): {n_tiles} tiles, labels {pred.shape} "
        f"{int(pred.min())}..{int(pred.max())} (bound < {N_CLASSES}), geometry "
        f"{'ok' if geo_ok else 'WRONG'}; launches during it {launches} (bound > 0 each)")
    if not (geo_ok and pred.max() < N_CLASSES and all(launches.values())):
        raise AssertionError("the multimodal zonal run's output is wrong or a kernel of the "
                             "path did not run")

    # one batch of the run's own inputs (host loader): kernels vs a forward
    # made of the plain versions, same weights, same batch
    model, _ = build_inference_model(pcfg, device=DEVICE)
    ds = zi.prep_dataset(pcfg, zi.generate_patches_from_reference(pcfg), patch_sizes)
    host = BatchedLoader(ds, batch_size=BATCH)._make_batch(list(range(BATCH)))
    ds.close()
    batch = {k: torch.from_numpy(host[k]).to(DEVICE)
             for k in ("AERIAL_RGBI", "SENTINEL2_TS", "SENTINEL2_DATES")}
    batch["AERIAL_LABEL-COSIA"] = torch.zeros((BATCH, 1, tile, tile), device=DEVICE)
    pad_frames = int((batch["SENTINEL2_TS"].flatten(2) == 0).all(-1).sum())
    norm = {"AERIAL_RGBI": ("custom", cfg["modalities"]["AERIAL_RGBI"]["normalization"]["means"],
                            cfg["modalities"]["AERIAL_RGBI"]["normalization"]["stds"])}
    step = _step(model, norm)

    def forward(plain: bool, dtype) -> torch.Tensor:
        return _labels(step, batch, dtype, plain)

    pred_k, pred_r = forward(False, torch.bfloat16), forward(True, torch.bfloat16)
    pred_r32 = forward(True, torch.float32)
    agree = (pred_k == pred_r).float().mean().item()
    agree32 = (forward(False, torch.float32) == pred_r32).float().mean().item()
    # context, as in the slice: bf16 drift from the float32 plain forward
    drift_k = (pred_k == pred_r32).float().mean().item()
    drift_r = (pred_r == pred_r32).float().mean().item()
    say("multimodal", f"argmax agreement kernels vs plain versions, one batch of {BATCH} "
        f"({tuple(batch['SENTINEL2_TS'].shape)} host float32 time series, cast to the "
        f"compute dtype on the card, {pad_frames} padded frames, dates "
        f"{batch['SENTINEL2_DATES'].dtype}): float32 {agree32:.5f} (bound >= 0.999), bf16 "
        f"{agree:.5f} (bound >= 0.99); bf16 vs the float32 plain forward: kernels "
        f"{drift_k:.5f}, plain {drift_r:.5f} (bound: kernels >= plain - 0.002)")
    if agree32 < 0.999 or agree < 0.99 or drift_k < drift_r - 0.002:
        raise AssertionError("the multimodal kernel forward disagrees with the plain forward")

    # bench.py's metric on this configuration: one warm-up pass, one timed
    (first, _, _), (wall, phases, _) = [_zonal_pass(cfg, model) for _ in range(2)]
    km2 = SIDE * SIDE * RES * RES / 1e6
    say("multimodal", f"warm wall {wall:.3f} s (first pass {first:.3f} s), "
        f"{n_tiles / wall:.2f} tiles/s, {km2 / wall * 3600:.1f} km2/h on {card}; phases (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items() if k.endswith("_s")))
    del model, step, batch

    # one float32 training step of the same model (its weights, aux heads
    # added) at batch 5, modality dropout and the aux losses on
    root = os.path.join(TMP, "multimodal", "train")
    tcfg = train_config(root)
    tcfg["modalities"]["inputs"]["SENTINEL2_TS"] = True
    tcfg["modalities"]["inputs_channels"]["AERIAL_RGBI"] = [1, 2, 3]
    for mod in ("AERIAL_RGBI", "SENTINEL2_TS"):
        tcfg["modalities"]["aux_loss"][mod] = True
        tcfg["modalities"]["modality_dropout"][mod] = 0.5
    tmodel = build_model(tcfg)
    report = load_checkpoint(tmodel, weights)
    tmodel.to(DEVICE)
    rng = np.random.default_rng(2)
    b, t, s2px = MM_BATCH_TRAIN, S2_DATES, patch_sizes["SENTINEL2_TS"]
    ts = rng.normal(size=(b, t, S2_BANDS, s2px, s2px)).astype(np.float32)
    ts[1, -1] = 0.0  # a padded date
    labels = rng.integers(0, N_CLASSES, (b, TRAIN_PX, TRAIN_PX))
    tb = {"AERIAL_RGBI": rng.normal(size=(b, 3, TRAIN_PX, TRAIN_PX)).astype(np.float32),
          "SENTINEL2_TS": ts,
          "SENTINEL2_DATES": np.sort(rng.integers(-180, 180, (b, t))).astype(np.float32),
          "AERIAL_LABEL-COSIA": np.transpose(np.eye(N_CLASSES, dtype=np.float32)[labels],
                                             (0, 3, 1, 2))}
    opt = make_optimizer(tcfg["hyperparams"], [p for p in tmodel.parameters() if p.requires_grad])
    steps = make_steps(tmodel, tcfg, opt, DEVICE, aux_loss_fix=True,
                       generator=torch.Generator(device=DEVICE).manual_seed(0))
    train_names = ("prep", "window_attn", "window_attn_bwd", "ffn", "merge")
    tfns = zero_launches(set(train_names))
    t0 = time.perf_counter()
    loss, grads, _, _ = steps.loss_and_grads(tb)
    opt.step(grads, 1e-5)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    train_launches = {k: tfns[k].launches for k in train_names}
    named = [n for n, p in tmodel.named_parameters() if p.requires_grad]
    checked = {"encoders.SENTINEL2_TS.": [0, 0], "fusion_handler.": [0, 0]}
    bad = []
    for n, g in zip(named, grads):
        for pre, c in checked.items():
            if n.startswith(pre):
                c[1] += 1
                ok = g is not None and bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
                c[0] += ok
                if not ok:
                    bad.append(n)
    say("multimodal", f"train_step float32 batch {b} ({TRAIN_PX} px, {t} dates, modality "
        f"dropout and aux losses on, weights of the zonal run: {len(report['loaded'])} loaded, "
        f"{len(report['missing'])} initialised) {t_step:.2f} s: loss {loss.item():.6f}; "
        f"finite non-zero gradients: UTAE {checked['encoders.SENTINEL2_TS.'][0]}/"
        f"{checked['encoders.SENTINEL2_TS.'][1]}, fusion_handler "
        f"{checked['fusion_handler.'][0]}/{checked['fusion_handler.'][1]}; launches "
        f"{train_launches}")
    if not math.isfinite(loss.item()) or bad or not all(train_launches.values()):
        raise AssertionError(f"multimodal training step: loss {loss.item()}, gradients "
                             f"missing or not finite for {bad[:8]}, launches {train_launches}")
    del steps, tmodel, grads, opt
    torch.cuda.empty_cache()
    return launches, train_launches



# the families phase: archs run through run_inference at the slice's
# configuration, then archs taken through one forward_convert batch
FAMILY_ARCHS = ["resnet34-unet", "resnet50-deeplabv3plus", "efficientnet_b4-unetplusplus",
                "convnext_base-upernet", "swin_base_patch4_window12_384-fpn"]
FORWARD_ARCHS = ["resnet34-linknet", "resnet34-manet", "resnet34-pan", "resnet34-pspnet",
                 "resnet34-deeplabv3"]
SPOT_RES = 1.6  # SPOT_RGBI at 1.6 m: 64 px tiles over the aerial 512 px ones
FAMILY_TRAIN_ARCH = "resnet34-fpn"
ZONAL_KERNELS = ("prep", "window_attn", "ffn", "merge", "finish", "epilogue")


def f32_top2_gap(step, batch):
    """(the float32 top-2 logit gap at every output pixel of the batch,
    the batch's largest float32 |logit|): the logits the labels come from,
    upsampled and cropped as the epilogue does on the stride-4 route,
    cropped on the full-resolution one."""
    import torch

    from flair_for_aigle_tpu_torch.ops.epilogue import _interp_matrix

    m, ts = step.margin, step.tile_size
    with torch.no_grad():
        lg = step.model({k: step._apply_norm(k, v).float() for k, v in batch.items()}
                        )[0]["AERIAL_LABEL-COSIA"].float()
        if step.model.stride4:
            r = torch.as_tensor(_interp_matrix(ts // 4, 4, m, ts - m), device=lg.device)
            lg = torch.einsum("ia,bxyk,jy->bkij", r, lg, r)
        else:
            lg = lg[:, :, m:ts - m, m:ts - m]
        top = lg.topk(2, dim=1).values
    return (top[:, 0] - top[:, 1])[:, None], lg.abs().max()


def kernels_vs_plain(step, batch, k16, k32) -> tuple[str, bool]:
    """The Swin kernels' labels (``k16``, ``k32``) against a forward made of
    the plain versions on the same batch. Float32 must agree on >= 0.999;
    in bf16 both routes flip near-tied labels of random weights, so the
    kernels must drift no further from the plain float32 labels than the
    plain bf16 ones do (within 0.002, the slice's bound), and whether bf16
    reaches 0.99 is reported."""
    import torch

    p16, p32 = (_labels(step, batch, torch.bfloat16, True),
                _labels(step, batch, torch.float32, True))
    a16, a32 = [(k == p).float().mean().item() for k, p in ((k16, p16), (k32, p32))]
    drift_k, drift_r = [(k == p32).float().mean().item() for k in (k16, p16)]
    ok = a32 >= 0.999 and drift_k >= drift_r - 0.002
    return (f"kernels vs plain versions: float32 {a32:.5f} (bound >= 0.999), bf16 {a16:.5f} "
            f"(0.99 {'met' if a16 >= 0.99 else 'NOT met'}); bf16 vs the float32 plain "
            f"forward: kernels {drift_k:.5f}, plain {drift_r:.5f} (bound: kernels >= "
            f"plain - 0.002)"), ok


@contextlib.contextmanager
def window_attn_launches_by_t():
    """K2's launches inside the block, keyed by the tokens of a window T."""
    from flair_for_aigle_tpu_torch.ops import window_attn

    orig, by_t = window_attn.fused_window_attention, {}

    def counted(x, *args, **kwargs):
        # the wrapper counts on the module's name, this function inside
        before = counted.launches
        out = orig(x, *args, **kwargs)
        by_t[int(x.shape[1])] = by_t.get(int(x.shape[1]), 0) + counted.launches - before
        return out

    counted.launches = orig.launches
    window_attn.fused_window_attention = counted
    try:
        yield by_t
    finally:
        orig.launches = counted.launches
        window_attn.fused_window_attention = orig


def phase_families(card: str, write_geotiff) -> dict:
    """The other encoder and decoder families at full width on the slice's
    raster and configuration (2048 x 2048 at 0.2 m, 512 px tiles, margin
    40, batch 16, bf16, 19 classes, random seeded weights): five archs
    through ``run_inference``, five more through one ``forward_convert``
    batch, two mono modalities at two resolutions in one FlairHubModel, and
    one float32 training step of resnet34-fpn. Returns every kernel's
    launches over the run_inference calls and the two-mono batch."""
    import numpy as np
    import torch
    from safetensors.torch import save_file

    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps
    from flair_for_aigle_tpu_torch.train.trainer import step_seed
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    d = os.path.join(TMP, "families")
    os.makedirs(d, exist_ok=True)
    raster = synthetic_raster(0)
    img = os.path.join(d, "raster.tif")
    transform = zi.from_origin(700000.0, 6600000.0, RES, RES)
    write_geotiff(img, raster, transform, "EPSG:2154", compress="lzw", tile_size=512)
    batch = one_batch(raster)
    aerial_norm = slice_config(img, "")["modalities"]["AERIAL_RGBI"]["normalization"]
    norm = {"AERIAL_RGBI": ("custom", aerial_norm["means"], aerial_norm["stds"])}
    total = dict.fromkeys(ZONAL_KERNELS, 0)
    swin_path = {"prep", "window_attn", "ffn", "merge"}

    def route(arch: str) -> set:
        """The kernels an arch must launch; it must launch no other."""
        return ((swin_path if arch.startswith("swin") else set())
                | ({"epilogue"} if arch.endswith("-upernet") else set()))

    for arch in FAMILY_ARCHS:
        # random weights from a seeded torch.Generator, written as the
        # checkpoint that run_inference loads
        weights = os.path.join(d, arch + ".safetensors")
        cfg = {**slice_config(img, weights), "monotemp_arch": arch,
               "output_name": "families_" + arch.split("-")[-1]}
        pcfg = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
        zi._set_labels(pcfg)
        seed_model, _ = build_inference_model({**pcfg, "model_weights": ""}, device="cpu")
        save_file({k: v.contiguous() for k, v in seed_model.state_dict().items()}, weights)
        del seed_model
        fns = zero_launches(set(ZONAL_KERNELS))
        t0 = time.perf_counter()
        out = zi.run_inference(copy.deepcopy(cfg), device=DEVICE)["AERIAL_LABEL-COSIA"]
        torch.cuda.synchronize()
        t_entry = time.perf_counter() - t0
        launches = {k: fns[k].launches for k in ZONAL_KERNELS}
        for k, n in launches.items():
            total[k] += n
        with zi.open_raster(out) as src:
            pred = src.read()
            t = src.transform
            geo_ok = ((src.height, src.width, src.count, src.crs) == (SIDE, SIDE, 1, "EPSG:2154")
                      and np.allclose([t.a, t.b, t.c, t.d, t.e, t.f], [
                          transform.a, transform.b, transform.c, transform.d, transform.e,
                          transform.f]))
        must = route(arch)
        route_ok = all(bool(n) == (k in must) for k, n in launches.items())
        model, _ = build_inference_model(pcfg, device=DEVICE)
        head = "stride-4 head + K4" if model.stride4 else "full-resolution head + crop + argmax"
        say("families", f"{arch}: run_inference {t_entry:.2f} s (model build included), "
            f"{head}; labels {pred.shape} {int(pred.min())}..{int(pred.max())} (bound < "
            f"{N_CLASSES}), geometry {'ok' if geo_ok else 'WRONG'}; launches {launches} "
            f"(bound: > 0 for {sorted(must) or 'none'}, 0 for the others)")
        if not (geo_ok and pred.max() < N_CLASSES and route_ok):
            raise AssertionError(f"{arch}: wrong output or route, launches {launches}")

        step = _step(model, norm)
        k16, k32 = _labels(step, batch, torch.bfloat16), _labels(step, batch, torch.float32)
        agree = (k16 == k32).float().mean().item()
        # random weights leave near-tied logits, and bf16 rounding flips
        # them whatever computes them: tools/bf16_label_agreement.py runs
        # this batch through both packages on the CPU, and the JAX package's
        # own bf16 labels miss 0.99 for resnet34-unet there. So 0.99 is
        # reported, and the run fails below 0.98, where a wrong dtype route
        # would fall; the float32 top-2 gap at the flipped labels says how
        # near to ties they sit
        gap, top = f32_top2_gap(step, batch)
        worst = float(gap[k16 != k32].max() / top) if agree < 1 else 0.0
        msg = (f"{arch}: argmax agreement of one batch of {BATCH}, bf16 vs float32 on the "
               f"card {agree:.5f} (0.99 {'met' if agree >= 0.99 else 'NOT met'}; bound "
               f">= 0.98); the largest float32 top-2 gap at a flipped label {worst:.5f} of "
               f"the largest |logit| {float(top):.5f}")
        ok = agree >= 0.98
        if arch.startswith("swin"):
            plain_msg, plain_ok = kernels_vs_plain(step, batch, k16, k32)
            msg += "; " + plain_msg
            ok = ok and plain_ok
        (first, _, _), (wall, _, _) = [_zonal_pass(cfg, model) for _ in range(2)]
        n_tiles = len(zi.generate_patches_from_reference(pcfg))
        say("families", f"{msg}; warm wall {wall:.3f} s (first pass {first:.3f} s), "
            f"{n_tiles / wall:.2f} tiles/s on {card}")
        if not ok:
            raise AssertionError(f"{arch}: the bf16 labels disagree beyond the bound")
        del model, step
        torch.cuda.empty_cache()

    # the other decoders on resnet34: one batch through forward_convert
    for arch in FORWARD_ARCHS:
        cfg = {**slice_config(img, ""), "monotemp_arch": arch}
        pcfg = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
        zi._set_labels(pcfg)
        model, _ = build_inference_model(pcfg, device=DEVICE)
        pred = _labels(_step(model, norm), batch, torch.bfloat16)
        ok = tuple(pred.shape) == (BATCH, 1, 432, 432) and int(pred.max()) < N_CLASSES
        say("families", f"{arch}: forward_convert bf16, labels {tuple(pred.shape)} "
            f"{pred.dtype} {int(pred.min())}..{int(pred.max())} (bound: ({BATCH}, 1, 432, 432), "
            f"< {N_CLASSES})")
        if not ok:
            raise AssertionError(f"{arch}: forward_convert gave wrong labels")
        del model
        torch.cuda.empty_cache()

    # two mono modalities at two resolutions in one swin-base-UPerNet model:
    # AERIAL_RGBI at 0.2 m (512 px tiles) and SPOT_RGBI at 1.6 m (64 px)
    f = round(SPOT_RES / RES)
    spot = raster.reshape(3, SIDE // f, f, SIDE // f, f).mean((2, 4))
    spot = np.concatenate([spot, spot.mean(0, keepdims=True)]).astype(np.uint8)
    batch2 = one_batch(raster, spot)
    spot_img = os.path.join(d, "spot.tif")
    write_geotiff(spot_img, spot, zi.from_origin(700000.0, 6600000.0, SPOT_RES, SPOT_RES),
                  "EPSG:2154")
    cfg = slice_config(img, "")
    cfg["modalities"]["inputs"]["SPOT_RGBI"] = True
    cfg["modalities"]["SPOT_RGBI"] = {"input_img_path": spot_img, "channels": [1, 2, 3, 4]}
    pcfg = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    zi._set_labels(pcfg)
    model, _ = build_inference_model(pcfg, device=DEVICE)
    step = _step(model, {**norm, "SPOT_RGBI": ("custom", [110.0] * 4, [45.0] * 4)})
    fns = zero_launches(set(ZONAL_KERNELS))
    with window_attn_launches_by_t() as by_t:
        k16 = _labels(step, batch2, torch.bfloat16)
    launches = {k: fns[k].launches for k in ZONAL_KERNELS}
    for k, n in launches.items():
        total[k] += n
    plain_msg, plain_ok = kernels_vs_plain(step, batch2, k16, _labels(step, batch2,
                                                                      torch.float32))
    say("families", f"two mono modalities (AERIAL_RGBI {tuple(batch2['AERIAL_RGBI'].shape)} at "
        f"{RES} m + SPOT_RGBI {tuple(batch2['SPOT_RGBI'].shape)} at {SPOT_RES} m) in one "
        f"{cfg['monotemp_arch']}, one batch: launches {launches}; K2 launches by T "
        f"{dict(sorted(by_t.items()))} (bound: T = 4 among them); argmax agreement "
        f"{plain_msg}")
    if not (by_t.get(4) and all(launches[k] for k in swin_path | {"epilogue"}) and plain_ok):
        raise AssertionError("the two-mono batch missed a kernel, K2 at T = 4, or an agreement")
    del model, step
    torch.cuda.empty_cache()

    # one float32 training step of resnet34-fpn at batch 5, FPN's channel
    # dropout drawn from the step-keyed generator
    tcfg = train_config(os.path.join(d, "train"))
    tcfg["models"]["monotemp_model"]["arch"] = FAMILY_TRAIN_ARCH
    tmodel = build_model(tcfg).to(DEVICE)
    rng = np.random.default_rng(3)
    b = TRAIN_BATCH
    labels = rng.integers(0, N_CLASSES, (b, TRAIN_PX, TRAIN_PX))
    n_ch = len(tcfg["modalities"]["inputs_channels"]["AERIAL_RGBI"])
    tb = {"AERIAL_RGBI": rng.normal(size=(b, n_ch, TRAIN_PX, TRAIN_PX)).astype(np.float32),
          "AERIAL_LABEL-COSIA": np.transpose(np.eye(N_CLASSES, dtype=np.float32)[labels],
                                             (0, 3, 1, 2))}
    params = [p for p in tmodel.parameters() if p.requires_grad]
    opt = make_optimizer(tcfg["hyperparams"], params)
    gen = torch.Generator(device=DEVICE)
    steps = make_steps(tmodel, tcfg, opt, DEVICE, generator=gen)
    seed = int(tcfg["hyperparams"].get("seed", 0))
    stats0 = {n: t.clone() for n, t in tmodel.named_buffers() if n.endswith("running_mean")}
    t0 = time.perf_counter()
    gen.manual_seed(step_seed(seed, 0))
    loss, grads, _, _ = steps.loss_and_grads(tb)
    opt.step(grads, 1e-4)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    bad = [n for (n, _), g in zip(((n, p) for n, p in tmodel.named_parameters()
                                   if p.requires_grad), grads)
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    moved = sum(not torch.equal(t, dict(tmodel.named_buffers())[n]) for n, t in stats0.items())
    # the dropout's draws: the same step's seed again gives the same loss,
    # another step's seed another one (training mode, the weights after the
    # step)
    dev = {k: torch.from_numpy(v).to(DEVICE) for k, v in tb.items()}
    again = []
    with torch.no_grad():
        for s in (1, 1, 2):
            gen.manual_seed(step_seed(seed, s))
            again.append(steps.compute_loss(*tmodel(dev, generator=gen), dev)[0].item())
    keyed = abs(again[0] - again[1]) <= 1e-6 * abs(again[0]) and \
        abs(again[0] - again[2]) > 1e-4 * abs(again[0])
    say("families", f"{FAMILY_TRAIN_ARCH} train_step float32 batch {b} ({TRAIN_PX} px) "
        f"{t_step:.2f} s: loss {loss.item():.6f}; finite non-zero gradients "
        f"{len(params) - len(bad)}/{len(params)} parameters; BatchNorm running means moved "
        f"{moved}/{len(stats0)}; FPN dropout from the step-keyed generator: loss at step 1's "
        f"seed {again[0]:.6f} and {again[1]:.6f}, at step 2's {again[2]:.6f}")
    if not math.isfinite(loss.item()) or bad or moved != len(stats0) or not keyed:
        raise AssertionError(f"{FAMILY_TRAIN_ARCH} step: loss {loss.item()}, bad gradients "
                             f"{bad[:8]}, running means moved {moved}/{len(stats0)}, "
                             f"dropout losses {again}")
    del steps, tmodel, grads, opt
    torch.cuda.empty_cache()
    return total


def train_config(root: str) -> dict:
    """The reference's default training configuration (configs/train/
    *.yaml, merged in file order as its read_config does) on the synthetic
    split: random seeded weights (no published checkpoint here) and 2
    epochs; everything else as configured."""
    import yaml

    cfg: dict = {}
    cdir = os.path.join(REPO, "configs", "train")
    for name in sorted(os.listdir(cdir)):
        if name.endswith(".yaml"):
            with open(os.path.join(cdir, name)) as f:
                cfg.update(yaml.safe_load(f) or {})
    cfg["paths"].update(out_folder=os.path.join(root, "out"), out_model_name="chip-smoke",
                        ckpt_model_path="",
                        **{f"{s}_csv": os.path.join(root, f"{s}.csv") for s in TRAIN_N})
    cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = False
    cfg["hyperparams"]["num_epochs"] = 2
    return cfg


def synthetic_split(cfg: dict, root: str, write_geotiff, seed: int = 0):
    """FLAIR-HUB-style patches (tests/test_training.py:19-50 at 512 px):
    4-band uint8 images and 1-band labels of 19 classes in 32 px blocks,
    the intensity correlated with the class. Returns the (train, val, test)
    split dicts of ``data/paths.py get_datasets``: through the CSVs when
    pandas imports, else built here in the same structure."""
    import numpy as np

    from flair_for_aigle_tpu_torch.zonal import inference as zi

    rng = np.random.default_rng(seed)
    task = cfg["labels"][0]
    files = {}
    for split, n in TRAIN_N.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        files[split] = []
        for i in range(n):
            area = f"D01_2020-{split}-{i:03d}"
            img = os.path.join(root, split, f"IMG_{area}_0_{i}.tif")
            lab = os.path.join(root, split, f"LAB_{area}_0_{i}.tif")
            blocks = rng.integers(0, N_CLASSES, (TRAIN_PX // 32, TRAIN_PX // 32))
            labels = np.kron(blocks, np.ones((32, 32))).astype(np.uint8)
            pixels = (labels[None].repeat(4, 0) * 12.0
                      + rng.normal(0, 8, (4, TRAIN_PX, TRAIN_PX))).clip(0, 255).astype(np.uint8)
            tr = zi.from_origin(700000.0 + i * 200, 6600000.0, RES, RES)
            write_geotiff(img, pixels, tr, "EPSG:2154")
            write_geotiff(lab, labels[None], tr, "EPSG:2154")
            files[split].append((img, lab))
        with open(cfg["paths"][f"{split}_csv"], "w") as f:
            f.write("\n".join([f"AERIAL_RGBI,{task}"] + [f"{a},{b}" for a, b in files[split]]))
            f.write("\n")
    try:
        import pandas  # noqa: F401  (the reference's CSV reader needs it)
    except ImportError as e:
        how = f"pandas missing ({e}): split dicts built in get_datasets' structure"
        dicts = []
        for split in TRAIN_N:
            d = {m: [] for m in cfg["modalities"]["inputs"]}
            d["AERIAL_RGBI"] = [a for a, _ in files[split]]
            d[task] = [b for _, b in files[split]]
            d.update({"SENTINEL2_MSK-SC": [], "DATES_S2": {}, "DATES_S1_ASC": {},
                      "DATES_S1_DESC": {}})
            dicts.append(d)
        return tuple(dicts), how
    from flair_for_aigle_tpu_torch.train.stages import get_datasets

    return get_datasets(cfg), "pandas imports: split dicts from the CSVs (get_datasets)"


def _route_step(cfg, batch, plain: bool, bf16: bool, env=None):
    """(ms per training step, peak device GiB) of the port's train_step on
    one batch, through the kernels or the plain versions; ``env``: an
    environment switch (name, value) set around the steps."""
    import torch

    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps

    c = copy.deepcopy(cfg)
    if bf16:
        c["hyperparams"]["compute_dtype"] = "bfloat16"
    torch.cuda.empty_cache()
    model = build_model(c).to(DEVICE)
    opt = make_optimizer(c["hyperparams"], model.parameters())
    steps = make_steps(model, c, opt, DEVICE)
    with (plain_versions() if plain else contextlib.nullcontext(),
          switch(*env) if env else contextlib.nullcontext()):
        for _ in range(STEPS_WARM):
            steps.train_step(batch, 1e-5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(STEPS_TIMED):
            loss = steps.train_step(batch, 1e-5)["loss"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STEPS_TIMED * 1e3
    if not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss on the {'plain' if plain else 'kernel'} route")
    return ms, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train(card: str, write_geotiff) -> tuple:
    import torch

    from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu_torch.train.stages import (
        build_data_module,
        build_model,
        predict_stage,
        training_stage,
    )
    from flair_for_aigle_tpu_torch.train.task import make_steps
    from flair_for_aigle_tpu_torch.train.trainer import load_state_safetensors

    root = os.path.join(TMP, "train")
    # a run before this one in the same checkout left its checkpoints there
    shutil.rmtree(root, ignore_errors=True)
    cfg = train_config(root)
    (d_train, d_val, d_test), how = synthetic_split(cfg, root, write_geotiff)
    say("train", f"host probe: {how}")
    dm = build_data_module(cfg, d_train, d_val, d_test)
    out_dir = os.path.join(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"])
    out_pred = os.path.join(out_dir, "results_chip-smoke")
    os.makedirs(out_pred, exist_ok=True)
    hp = cfg["hyperparams"]
    say("train", f"{cfg['models']['monotemp_model']['arch']}, {N_CLASSES} classes, "
        f"{TRAIN_PX} px, batch {hp['batch_size']}, {hp['optimizer']} lr {hp['learning_rate']}, "
        f"{hp['scheduler']} warmup {hp['warmup_fraction']}, "
        f"{hp.get('compute_dtype', 'float32')}, attn_f32 "
        f"{cfg['models']['monotemp_model'].get('attn_f32', True)}, augmentation "
        f"{cfg['modalities']['pre_processings']['use_augmentation']}, {hp['num_epochs']} epochs "
        f"of {TRAIN_N['train'] // hp['batch_size']} steps")

    history = []
    # the user entry points, with every launch count at 0 just before them
    fns = zero_launches({"prep", "window_attn", "window_attn_bwd", "ffn", "merge"})
    t0 = time.perf_counter()
    model = training_stage(cfg, dm, out_dir, device=DEVICE,
                           epoch_hook=lambda e, m: history.append(m))
    predict_stage(cfg, dm, out_pred, model, device=DEVICE)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    say("train", f"training_stage + predict_stage {t_entry:.2f} s; launches during them: "
        f"{launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not run on the training path: {launches}")
    losses = [(m["train_loss"], m["val_loss"]) for m in history]
    if len(history) != hp["num_epochs"] or not all(map(math.isfinite, sum(losses, ()))):
        raise AssertionError(f"losses not finite or epochs missing: {losses}")
    say("train", "epochs (train_loss, val_loss, val_miou): " + "; ".join(
        f"{m['train_loss']:.4f}, {m['val_loss']:.4f}, {m['val_miou']:.4f}" for m in history))

    ckpts = sorted(glob.glob(os.path.join(out_dir, "checkpoints", "*.safetensors")))
    best = [p for p in ckpts if os.path.basename(p).startswith("ckpt-epoch")]
    if len(best) != 1 or not any(os.path.basename(p).startswith("last_") for p in ckpts):
        raise AssertionError(f"checkpoints: {ckpts}")
    load_state_safetensors(FlairHubModel(cfg), best[0])
    task = cfg["labels"][0]
    preds = glob.glob(os.path.join(out_pred, "predictions_chip-smoke", task, "PRED_*.tif"))
    metrics_file = os.path.join(out_pred, "metrics_chip-smoke", task, "metrics.json")
    with open(metrics_file) as f:
        metrics = json.load(f)
    if len(preds) != TRAIN_N["test"] or "Avg_metrics" not in metrics:
        raise AssertionError(f"predictions {len(preds)} / metrics {sorted(metrics)}")
    say("train", f"checkpoints {[os.path.basename(p) for p in ckpts]}; "
        f"{os.path.basename(best[0])} loads strictly into a fresh model; "
        f"{len(preds)} prediction rasters; metrics.json Avg_metrics {metrics['Avg_metrics']}")

    # one float32 step at batch 5: gradients through the kernels vs the
    # plain versions, same weights, same batch; then through the kernels
    # under each fused-block switch (counts at 0 just before each step)
    batch = next(iter(dm.train_dataloader()))
    steps = make_steps(build_model(cfg).to(DEVICE), cfg, None, DEVICE)
    with plain_versions():
        loss_p, grads_p, _, _ = steps.loss_and_grads(batch)
    flat_p = torch.cat([g.flatten() for g in grads_p]).double()
    gmax = flat_p.abs().max().item()
    names = [n for n, p in steps.model.named_parameters() if p.requires_grad]
    step_launches = {}
    for route, env, want in (("kernels", None, {"ffn_bwd": 0, "finish": 0}),
                             ("FLAIR_FFN_BWD=kernel", SWITCHED["ffn_bwd"], {"ffn_bwd": 24}),
                             ("FLAIR_SWIN_FINISH=1", SWITCHED["finish"], {"finish": 24, "ffn": 0})):
        with switch(*env) if env else contextlib.nullcontext():
            fns_s = zero_launches({"ffn", "ffn_bwd", "finish"})
            loss_k, grads_k, _, _ = steps.loss_and_grads(batch)
            torch.cuda.synchronize()
        got = {k: fns_s[k].launches for k in want}
        step_launches[route] = got
        flat_k = torch.cat([g.flatten() for g in grads_k]).double()
        cos = torch.nn.functional.cosine_similarity(flat_k, flat_p, dim=0).item()
        rel = [((a - b).abs().max() / max(b.abs().max().item(), 1e-6 * gmax)).item()
               for a, b in zip(grads_k, grads_p)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        say("train", f"gradient check, one float32 step at batch {hp['batch_size']}, {route}: "
            f"loss {loss_k.item():.6f}, plain {loss_p.item():.6f}; cosine {cos:.7f} (bound >= "
            f"0.9999); worst per-tensor relative error {rel[worst]:.3e} ({names[worst]}; "
            f"relative to the tensor's largest gradient, floored at 1e-6 of the model's); "
            f"launches {got} (bound {want})")
        if not cos >= 0.9999 or got != want:
            raise AssertionError(f"{route}: gradients disagree with the plain ones (cosine "
                                 f"{cos}) or launches {got} != {want}")
        del grads_k, flat_k
    del steps, grads_p, flat_p

    timing = {}
    for dtype in ("float32", "bfloat16"):
        for route in ("kernels", "plain", "FLAIR_FFN_BWD=kernel"):
            timing[(dtype, route)] = _route_step(
                cfg, batch, route == "plain", dtype == "bfloat16",
                SWITCHED["ffn_bwd"] if route.startswith("FLAIR") else None)
    cli_launches = _cli_run(cfg, root, pandas_ok=how.startswith("pandas imports"))
    say("train", f"train_step at batch {hp['batch_size']} on {card} ({STEPS_TIMED} steps after "
        f"{STEPS_WARM} warm-up; ms/step, peak GiB): " + "; ".join(
            f"{d} {r} {ms:.1f} ms {gib:.2f} GiB" for (d, r), (ms, gib) in timing.items()))
    return ({k: launches[k] + cli_launches.get(k, 0) for k in launches},
            {"ffn_bwd": step_launches["FLAIR_FFN_BWD=kernel"]["ffn_bwd"],
             "finish": step_launches["FLAIR_SWIN_FINISH=1"]["finish"]}, cfg, batch)


def _cli_run(cfg: dict, root: str, pandas_ok: bool) -> dict:
    """The user's command, ``python -m flair_for_aigle_tpu_torch.train_main
    --config <yaml>``, run in this process for one epoch on the same split
    (it reads the CSVs, so it needs pandas); returns its kernel launches."""
    if not pandas_ok:
        say("train", "train_main CLI not run: it reads the split CSVs through pandas, "
            "which this host lacks")
        return {}
    import yaml

    from flair_for_aigle_tpu_torch.train_main import main as train_main

    c = copy.deepcopy(cfg)
    c["paths"]["out_model_name"] = "chip-smoke-cli"
    c["hyperparams"]["num_epochs"] = 1
    path = os.path.join(root, "cli.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    fns = zero_launches({"prep", "window_attn", "window_attn_bwd", "ffn", "merge"})
    t0 = time.perf_counter()
    train_main(["--config", path])
    launches = {k: fn.launches for k, fn in fns.items()}
    out = os.path.join(c["paths"]["out_folder"], "chip-smoke-cli")
    task = c["labels"][0]
    n_ckpt = len(glob.glob(os.path.join(out, "checkpoints", "*.safetensors")))
    n_pred = len(glob.glob(os.path.join(out, "results_chip-smoke-cli",
                                        "predictions_chip-smoke-cli", task, "PRED_*.tif")))
    metrics = os.path.join(out, "results_chip-smoke-cli", "metrics_chip-smoke-cli", task,
                           "metrics.json")
    say("train", f"train_main --config {os.path.relpath(path, REPO)} (1 epoch + predict) "
        f"{time.perf_counter() - t0:.2f} s: {n_ckpt} checkpoints, {n_pred} prediction "
        f"rasters, metrics.json {'written' if os.path.exists(metrics) else 'MISSING'}; "
        f"launches {launches}")
    if not (all(launches.values()) and n_ckpt == 2 and n_pred == TRAIN_N["test"]
            and os.path.exists(metrics)):
        raise AssertionError("the train_main CLI run is incomplete")
    return launches


def phase_tool() -> dict:
    """The A/B tool's command, ``python -m
    flair_for_aigle_tpu_torch.tools.exp_attn_dots``, once in a process of
    its own at its defaults (its launch counts start at 0 there); returns
    the kernel launches it reports."""
    from flair_for_aigle_tpu_torch.ops.attn_dots import attn_dots_reference
    from flair_for_aigle_tpu_torch.tools import exp_attn_dots as tool

    g = tool.geometry({})
    bound = attn_dots_bound(attn_dots_reference(*tool.inputs(g["bnw"], g["c"], DEVICE),
                                                num_heads=g["nh"]))
    env = {k: v for k, v in os.environ.items() if k not in ("DB", "DHW", "DC", "DNH", "BW")}
    cmd = [sys.executable, "-m", "flair_for_aigle_tpu_torch.tools.exp_attn_dots"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    rows = [json.loads(line) for line in lines[1:]]
    launches = json.loads([line for line in proc.stderr.splitlines()
                           if line.startswith('{"launches"')][-1])["launches"]
    say("tool", f"{' '.join(cmd[1:])} (B{g['b']} {g['hw']}x{g['hw']}x{g['c']}, {g['nh']} heads, "
        f"bw {g['bw']}) {wall:.2f} s: {' | '.join(lines)}; max_abs_diff bound {bound:.3e}; "
        f"launches {launches}")
    if not (len(rows) == 3 and [list(r) for r in rows] == [["max_abs_diff"], ["per_head_ms"],
                                                             ["grouped_ms"]]
            and rows[0]["max_abs_diff"] <= bound and rows[1]["per_head_ms"] > 0
            and rows[2]["grouped_ms"] > 0 and all(launches.values())):
        raise AssertionError("the A/B tool's output is incomplete, its kernels disagree "
                             "or they did not run")
    return launches


# the [multigpu] phase: data parallelism on the one card, as two zonal
# replicas, two training ranks over gloo and one over NCCL, and the dry run
DP_DEVICES = ["cuda:0", "cuda:0"]
DP_BATCH = 4  # the training comparison's global batch
DP_RANK_TIMEOUT = 400  # seconds for the ranks of one run


@contextlib.contextmanager
def launches_per_step(names):
    """Each ``ZonalStep``'s launches of the named kernels inside the block,
    in the order the steps first ran: ``[{kernel: count}]`` (the wrappers'
    own counts, read around every ``forward_convert``)."""
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    fns = {k: fn for k, fn in kernel_fns().items() if k in names}
    per: dict = {}
    original = zi.ZonalStep.forward_convert

    def counted(self, batch):
        before = {k: fn.launches for k, fn in fns.items()}
        out = original(self, batch)
        mine = per.setdefault(id(self), dict.fromkeys(fns, 0))
        for k, fn in fns.items():
            mine[k] += fn.launches - before[k]
        return out

    zi.ZonalStep.forward_convert = counted
    counts: list = []
    try:
        yield counts
    finally:
        zi.ZonalStep.forward_convert = original
        counts.extend(per.values())


# the zonal path's kernel wrappers (``kernel_fns``) and how many of their
# leading positional arguments hold the batch's rows (the rest are
# parameters)
ROW_ARGS = {"prep": 1, "window_attn": 1, "ffn": 2, "merge": 1, "finish": 2, "epilogue": 1}


@contextlib.contextmanager
def wrapped_kernels(names, around):
    """Inside the block each named kernel wrapper (``kernel_fns``) is
    replaced on its module by a shim that returns ``around(name, wrapper,
    args, kwargs)``. A wrapper counts its launches on its module's name for
    it, which then names the shim: they go back to its own count after."""
    fns = {k: fn for k, fn in kernel_fns().items() if k in names}
    shims = {}
    for key, fn in fns.items():
        def shim(*args, _key=key, _fn=fn, **kwargs):
            return around(_key, _fn, args, kwargs)
        shim.launches = 0
        shims[key] = shim
        setattr(sys.modules[fn.__module__], fn.__name__, shim)
    try:
        yield shims
    finally:
        for key, fn in fns.items():
            setattr(sys.modules[fn.__module__], fn.__name__, fn)
            fn.launches += shims[key].launches


def _tensors(v) -> list:
    import torch

    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _tensors(x)]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


def _first_rows(v, full_rows: int, rows: int):
    """``v`` with every tensor whose leading dimension is ``full_rows`` (or a
    multiple, as windows are of tiles) cut to its share of ``rows`` of them."""
    import torch

    if isinstance(v, torch.Tensor):
        n = v.shape[0] if v.dim() else 0
        return v[:n * rows // full_rows] if n and n % full_rows == 0 else v
    if isinstance(v, dict):
        return {k: _first_rows(x, full_rows, rows) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_first_rows(x, full_rows, rows) for x in v)
    return v


@contextlib.contextmanager
def captured(model, keep_args: bool):
    """Every module of ``model`` (forward hooks: in the order the calls
    end) and every kernel wrapper of the zonal path, in call order:
    ``[{"name", "kernel", "ins", "outs", "call"}]``; ``call`` re-runs the
    module or the wrapper on the arguments given (kept when ``keep_args``)."""
    recs: list = []
    handles = []
    stack: list = []  # the module calls under way, by call number
    calls = iter(range(1 << 62))

    def pre(m, args):
        stack.append(next(calls))

    for name, mod in model.named_modules():
        def hook(m, args, kwargs, out, name=name or "model"):
            call = stack.pop()
            recs.append({"name": name, "kernel": None, "ins": _tensors(args),
                         "outs": _tensors(out), "call": m, "id": call, "within": tuple(stack),
                         "args": args if keep_args else None, "kwargs": kwargs})
        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(hook, with_kwargs=True))
    def record(key, fn, args, kwargs):
        out = fn(*args, **kwargs)
        recs.append({"name": f"kernel {key}", "kernel": key,
                     "ins": _tensors(args[:ROW_ARGS[key]]), "outs": _tensors(out),
                     "call": fn, "id": None, "within": tuple(stack),
                     "args": args if keep_args else None, "kwargs": kwargs})
        return out

    try:
        with wrapped_kernels(ROW_ARGS, record):
            yield recs
    finally:
        for h in handles:
            h.remove()


def _share_differing(shard: list, full: list) -> tuple[float, float]:
    """(share of elements that differ, largest difference) between the
    shard's tensors and the first rows of the full batch's."""
    n = diff = 0
    worst = 0.0
    for a, b in zip(shard, full):
        b = b[:a.shape[0]] if a.dim() and b.dim() and b.shape[0] != a.shape[0] else b
        if a.shape != b.shape:
            return float("nan"), float("nan")
        ne = a != b
        n += a.numel()
        diff += int(ne.sum())
        if ne.any():
            worst = max(worst, (a.float() - b.float()).abs().max().item())
    return diff / max(n, 1), worst


@contextlib.contextmanager
def resize_through_cublas():
    """``ops/resize.py``'s products through cuBLAS's default kernels inside
    the block, as the port ran them before it took cuBLASLt for them."""
    import torch

    from flair_for_aigle_tpu_torch.ops import resize

    @contextlib.contextmanager
    def cublas(device):
        saved = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library("cublas")
        try:
            yield
        finally:
            torch.backends.cuda.preferred_blas_library(saved)

    shipped = resize._batch_invariant_blas
    resize._batch_invariant_blas = cublas
    try:
        yield
    finally:
        resize._batch_invariant_blas = shipped


def replica_diagnosis(step, batch: dict, rows: int) -> dict:
    """Layer by layer, what a replica's shard (the first ``rows`` tiles of
    ``batch``, as its own batch) computes against the same tiles as the
    first rows of the one-device batch: for every module of the model and
    every kernel wrapper, in forward order, whether its inputs are
    bit-identical and the share of its outputs that differ, and the calls
    at fault. Then each kernel call of the full batch again on its own
    inputs' first rows (its output there must equal the full call's rows
    bit for bit: a kernel's row may not depend on the rows sharing its
    launch), and the PSP pools' products alone (``pool_products``).
    Returns the findings."""
    import torch

    full_rows = next(iter(batch.values())).shape[0]
    shard = {k: v[:rows] for k, v in batch.items()}
    with captured(step.model, False) as rec_s:
        lab_s = step.forward_convert(shard)
    with captured(step.model, True) as rec_f:
        lab_f = step.forward_convert(batch)
    torch.cuda.synchronize()
    if [r["name"] for r in rec_s] != [r["name"] for r in rec_f]:
        raise AssertionError("the shard and the full batch ran different modules")
    # a call is at fault where its inputs agree and its output differs, and
    # no call made inside it (a submodule, a kernel) is at fault: then its
    # own code outside those calls made the difference
    table, culprits, inner = [], [], set()
    for s, f in zip(rec_s, rec_f):
        same_in = _share_differing(s["ins"], f["ins"])[0] == 0
        share, worst = _share_differing(s["outs"], f["outs"])
        table.append((f["name"], same_in, share, worst))
        if share and same_in:
            if f["id"] not in inner:
                culprits.append(f)
            inner.update(f["within"])
    first = next((t for t in table if t[2]), None)
    task = next(iter(lab_f))
    labels = _share_differing([lab_s[task]], [lab_f[task]])[0]
    logits = next(t for t in table if t[0] == "model")
    # each kernel call of the full batch on its own inputs' first rows
    kernels: dict = {}
    for f in rec_f:
        if f["kernel"] is None:
            continue
        k = ROW_ARGS[f["kernel"]]
        n = f["args"][0].shape[0]
        args = [_first_rows(a, n, n * rows // full_rows) if i < k else a
                for i, a in enumerate(f["args"])]
        with torch.no_grad():
            out = f["call"](*args, **f["kwargs"])
        d = kernels.setdefault(f["kernel"], [0, 0])
        d[0] += 1
        d[1] += _share_differing(_tensors(out), f["outs"])[0] == 0
    return {"table": table, "first": first, "culprits": [f["name"] for f in culprits],
            "kernels": kernels, "labels": labels, "logits": logits[2],
            "pool_products": pool_products(rec_f, rows, full_rows)}


def pool_products(rec_f: list, rows: int, full_rows: int) -> dict:
    """The PSP module's adaptive pools (``ops/resize.py``: two float32
    einsums over the deepest feature) on the shard's rows against the full
    batch's, through cuBLAS's default kernels and through cuBLASLt (the
    route ``_apply_hw`` takes on the card): {backend: {pool size: share of
    the pooled values that differ}}."""
    import torch

    from flair_for_aigle_tpu_torch.ops import resize

    psp = next(f for f in rec_f if f["name"].endswith("decoder.psp"))
    x = psp["ins"][0]
    h, w = x.shape[-3], x.shape[-2]
    out = {}
    for backend in ("cublas", "cublaslt"):
        saved = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library(backend)
        res = {}
        try:
            for size in (1, 2, 3, 6):
                mh = torch.as_tensor(resize._pool_matrix(h, size), device=x.device)
                mw = torch.as_tensor(resize._pool_matrix(w, size), device=x.device)

                def pool(v):
                    v = torch.einsum("oh,...hwc->...owc", mh, v.float())
                    return torch.einsum("pw,...owc->...opc", mw, v)

                n = x.shape[0] * rows // full_rows
                res[size] = _share_differing([pool(x[:n])], [pool(x)])[0]
        finally:
            torch.backends.cuda.preferred_blas_library(saved)
        out[backend] = res
    return out


def diagnosis_lines(diag: dict, dtype: str) -> None:
    first = diag["first"]
    dtype = f"{dtype}, {diag['route']}"
    say("multigpu", f"per-layer diagnosis {dtype}, tiles 0-{BATCH // 2 - 1} as a replica's batch "
        f"of {BATCH // 2} against rows 0-{BATCH // 2 - 1} of the one-device batch of {BATCH}: "
        f"{len(diag['table'])} module and kernel outputs; first differing in forward order: "
        + (f"{first[0]} (inputs bit-identical {first[1]}, share {first[2]:.3e}, largest "
           f"difference {first[3]:.3e})" if first else "none")
        + f"; logits byte-identical {diag['logits'] == 0} (share differing "
        f"{diag['logits']:.3e}); labels differing {diag['labels']:.3e}")
    say("multigpu", f"per-layer diagnosis {dtype}: calls at fault (inputs agree, output "
        f"differs, no call inside them at fault: their own code made the difference): "
        f"{diag['culprits'][:12]}{' ...' if len(diag['culprits']) > 12 else ''} "
        f"({len(diag['culprits'])}); each kernel call again on its inputs' first rows, "
        f"bit-identical to the full call's rows (calls, identical): {diag['kernels']}")
    say("multigpu", f"per-layer diagnosis {dtype}: the PSP module's adaptive pools (two float32 "
        f"einsums, ops/resize.py _apply_hw) on the shard's rows against the full batch's, share "
        f"of pooled values differing by pool size: " + "; ".join(
            f"{b} " + ", ".join(f"{k}x{k} {v:.3e}" for k, v in r.items())
            for b, r in diag["pool_products"].items()))
    differing = [(n, s) for n, _, s, _ in diag["table"] if s]
    say("multigpu", f"per-layer diagnosis {dtype}: share differing per output, forward order "
        f"({len(differing)} of {len(diag['table'])} differ): "
        + ", ".join(f"{n} {s:.2e}" for n, s in differing[:40])
        + (" ..." if len(differing) > 40 else ""))
    os.makedirs(TMP, exist_ok=True)
    name = f"replica_diagnosis_{dtype.replace(', ', '_').replace(' ', '_')}.json"
    with open(os.path.join(TMP, name), "w") as f:
        json.dump(diag, f, indent=0, default=str)


def multigpu_zonal(card: str) -> dict:
    """The slice's raster and configuration through ``bench.run_zonal`` on
    one device and on two replicas of the one card (``devices=[cuda:0,
    cuda:0]``, 8 tiles each a batch), in bf16 and float32: the per-layer
    diagnosis of a replica's batch (``replica_diagnosis``), launches per
    replica, byte identity of the labels, warm tiles/s. Returns the
    two-replica bf16 pass's launches."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    img, weights = os.path.join(TMP, "raster.tif"), os.path.join(TMP, "weights.safetensors")
    names = {"prep", "window_attn", "ffn", "merge", "epilogue"}
    dp_launches = {}
    batch = one_batch(synthetic_raster(0))
    for dtype in ("bfloat16", "float32"):
        cfg = {**slice_config(img, weights), "compute_dtype": dtype}
        pcfg = zi.initialize_geometry_and_resolutions(dict(cfg))
        zi._set_labels(pcfg)
        model, _ = build_inference_model(pcfg, device=DEVICE)
        n_tiles = len(zi.generate_patches_from_reference(pcfg))
        # layer by layer: a replica's batch of 8 against the same tiles'
        # rows of the one-device batch of 16
        mod = cfg["modalities"]["AERIAL_RGBI"]["normalization"]
        step = _step(model, {"AERIAL_RGBI": ("custom", mod["means"], mod["stds"])})
        step.compute_dtype = getattr(torch, dtype)
        with resize_through_cublas():
            before = replica_diagnosis(step, batch, BATCH // 2)
        diagnosis_lines({**before, "route": "resize products through cuBLAS"}, dtype)
        diag = replica_diagnosis(step, batch, BATCH // 2)
        diagnosis_lines({**diag, "route": "as shipped (cuBLASLt)"}, dtype)
        if dtype == "bfloat16":
            resize_route_times(step, batch, card)
        del step
        passes = {}
        for mode, devices in (("one device", None), ("two replicas", DP_DEVICES)):
            _zonal_pass(cfg, model, devices)  # warm-up (replica copies, autotune)
            fns = zero_launches(names)
            with launches_per_step(names) as per:
                wall, _, out = _zonal_pass(cfg, model, devices)
            with zi.open_raster(out) as src:
                labels = src.read().copy()
            passes[mode] = (wall, labels, per, {k: fn.launches for k, fn in fns.items()})
        (w1, l1, p1, n1), (w2, l2, p2, n2) = passes["one device"], passes["two replicas"]
        agree = float((l1 == l2).mean())
        same = bool(np.array_equal(l1, l2))
        kernels_same = all(c == n for c, n in diag["kernels"].values())
        say("multigpu", f"zonal {dtype}, devices {DP_DEVICES} ({BATCH // 2} tiles a replica a "
            f"batch) against one device, {n_tiles} tiles: label agreement {agree:.6f}, "
            f"byte-identical {same} (bound: byte-identical); the diagnosis batch: logits "
            f"byte-identical {diag['logits'] == 0}, every kernel call bit-identical on the "
            f"shard's rows {kernels_same} (bound: both); launches per replica "
            f"{p2} (one-device pass {p1}; bound: each replica the one-device pass's); warm "
            f"{n_tiles / w1:.2f} tiles/s one device, {n_tiles / w2:.2f} tiles/s two replicas, "
            f"on {card}")
        if (not same or diag["logits"] or not kernels_same or len(p1) != 1 or len(p2) != 2
                or any(p != p1[0] for p in p2)
                or not all(n1.values()) or n2 != {k: 2 * v for k, v in n1.items()}):
            raise AssertionError("the two-replica zonal pass differs from the one-device "
                                 "pass or did not run every kernel on each replica")
        if dtype == "bfloat16":
            dp_launches = n2
        del model
    return dp_launches


def resize_route_times(step, batch: dict, card: str, pairs: int = 40) -> None:
    """One batch's forward and epilogue (``forward_convert``) with
    ``ops/resize.py``'s products through cuBLAS's default kernels and
    through cuBLASLt (as shipped), ``pairs`` of each, alternating which
    runs first: CUDA-event ms and host ms of each (reported, no bound)."""
    import statistics

    import torch

    for route in (resize_through_cublas, contextlib.nullcontext):
        with route():
            step.forward_convert(batch)
    ms: dict = {"cuBLAS": [], "cuBLASLt": []}
    host: dict = {"cuBLAS": [], "cuBLASLt": []}
    for i in range(pairs):
        for name in ("cuBLAS", "cuBLASLt") if i % 2 == 0 else ("cuBLASLt", "cuBLAS"):
            with resize_through_cublas() if name == "cuBLAS" else contextlib.nullcontext():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a.record()
                step.forward_convert(batch)
                b.record()
                host[name].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                ms[name].append(a.elapsed_time(b))
    say("multigpu", f"one batch of {BATCH} through forward_convert, the resize products through "
        f"cuBLAS against cuBLASLt, {pairs} alternating pairs: " + "; ".join(
            f"{k} CUDA events median {statistics.median(v):.3f} ms (quartiles "
            f"{statistics.quantiles(v, n=4)[0]:.3f}-{statistics.quantiles(v, n=4)[2]:.3f}), host "
            f"median {statistics.median(host[k]):.3f} ms" for k, v in ms.items())
        + f"; cuBLASLt faster in {sum(b < a for a, b in zip(*ms.values()))} of {pairs} pairs, "
        f"on {card}")


def dp_batch():
    """The training comparison's global batch: DP_BATCH normalised 512 px
    AERIAL_RGBI patches and one-hot labels of 19 classes in 32 px blocks,
    from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(5)
    blocks = rng.integers(0, N_CLASSES, (DP_BATCH, TRAIN_PX // 32, TRAIN_PX // 32))
    labels = np.kron(blocks, np.ones((1, 32, 32), np.int64))
    img = rng.normal(size=(DP_BATCH, 3, TRAIN_PX, TRAIN_PX)).astype(np.float32)
    img += labels[:, None] * 0.1
    onehot = (labels[:, None] == np.arange(N_CLASSES)[None, :, None, None])
    return {"AERIAL_RGBI": img.astype(np.float32), "AERIAL_LABEL-COSIA": onehot.astype(np.float32)}


def dp_step(rank: int, world: int) -> dict:
    """One AdamW step of the default training configuration (float32,
    swin-base-UPerNet, weights from its seed) on shard ``rank`` of
    ``world`` of ``dp_batch``, the generator seeded by (seed, 0): the loss,
    the flat gradients and parameters after the step (host), every
    BatchNorm running statistic, and the kernels' launches."""
    import torch

    from flair_for_aigle_tpu_torch.parallel import dist
    from flair_for_aigle_tpu_torch.parallel.mesh import ShardedGenerator, shard_batch
    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps
    from flair_for_aigle_tpu_torch.train.trainer import step_seed

    cfg = train_config(os.path.join(TMP, "dp"))
    hp = cfg["hyperparams"]
    model = build_model(cfg).to(DEVICE)
    dist.broadcast_module(model)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = make_optimizer(hp, params)
    gen = ShardedGenerator(DEVICE, rank, world)
    steps = make_steps(model, cfg, optimizer, DEVICE, generator=gen)
    gen.manual_seed(step_seed(hp["seed"], 0))
    names = {"prep", "window_attn", "window_attn_bwd", "ffn", "merge"}
    fns = zero_launches(names)
    loss, grads, _, _ = steps.loss_and_grads(shard_batch(dp_batch(), rank, world))
    optimizer.step(grads, hp["learning_rate"])
    torch.cuda.synchronize()
    return {"loss": float(loss), "lr": hp["learning_rate"],
            "arch": cfg["models"]["monotemp_model"]["arch"],
            "grads": torch.cat([g.flatten() for g in grads]).cpu(),
            "params": torch.cat([p.detach().flatten() for p in params]).cpu(),
            "stats": {k: v.detach().cpu() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "launches": {k: fn.launches for k, fn in fns.items()}}


def train_rank(out_dir: str) -> int:
    """A rank of the two-rank training comparison (``run_ranks``' torchrun
    environment): gloo with CUDA tensors, both ranks on card 0."""
    import hashlib

    import torch

    sys.path.insert(0, REPO)
    from flair_for_aigle_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.initialize(device="cuda:0", backend="gloo")
    rank, world = dist.process_index(), dist.world_size()
    res = dp_step(rank, world)
    res["params_sha256"] = hashlib.sha256(res["params"].numpy().tobytes()).hexdigest()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "rank0.pt"))
    print(json.dumps({"rank": rank, "loss": res["loss"], "launches": res["launches"],
                      "params_sha256": res["params_sha256"]}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _differ(a: dict, b: dict) -> list:
    """What two ``dp_step`` results differ in, bit for bit."""
    import torch

    return [k for k, same in (
        ("loss", a["loss"] == b["loss"]), ("gradients", torch.equal(a["grads"], b["grads"])),
        ("parameters", torch.equal(a["params"], b["params"])),
        ("statistics", all(torch.equal(v, b["stats"][k]) for k, v in a["stats"].items())))
        if not same]


def multigpu_train(card: str) -> dict:
    """One AdamW step from the same weights and seed three ways: (c) no
    process group, (b) one NCCL rank (world size 1), (a) two gloo ranks on
    the one card, each taking half of the global batch. (b) must equal (c)
    bit for bit; (a) must give a gradient cosine >= 0.9999 against (c),
    every parameter within 3 learning rates and every BatchNorm running
    statistic within 1e-3 of its tensor's largest magnitude. Returns the
    ranks' summed launches."""
    import torch
    import torch.nn.functional as F

    from flair_for_aigle_tpu_torch.parallel import dist
    from flair_for_aigle_tpu_torch.tools.dryrun_multichip import free_port, run_ranks

    out_dir = os.path.join(TMP, "dp")
    os.makedirs(out_dir, exist_ok=True)
    # (b) against (c) in one process, so that both take the same library
    # algorithms; deterministic ones, so that a repeat gives the same bits
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        c = dp_step(0, 1)
        dist.initialize(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                        device="cuda:0")
        backend = torch.distributed.get_backend()
        b = dp_step(0, 1)
        torch.distributed.destroy_process_group()
        differ = _differ(b, c)
        again = _differ(dp_step(0, 1), c) if differ else []
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    say("multigpu", f"train (b) one {backend} rank, world size 1, against (c) no process "
        f"group: {c['arch']} float32, {TRAIN_PX} px, batch {DP_BATCH}, one AdamW step: "
        f"loss {b['loss']:.7f} / {c['loss']:.7f}; bit-identical loss, gradients, parameters "
        f"and BatchNorm statistics: {not differ} (bound: True)")
    if backend != "nccl" or differ:
        raise AssertionError(f"the NCCL world-1 step differs from the step with no group in "
                             f"{differ}; a repeat of (c) differs in {again}")
    del b
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    outs = run_ranks(lambda r: [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                                "--train-rank", out_dir], 2, DP_RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = [json.loads([ln for ln in out.splitlines() if ln.startswith('{"rank"')][-1])
             for out in outs]
    a = torch.load(os.path.join(out_dir, "rank0.pt"), weights_only=False)
    cos = F.cosine_similarity(a["grads"].double(), c["grads"].double(), dim=0).item()
    dparam = (a["params"] - c["params"]).abs().max().item()
    stat_err = max(((a["stats"][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item()
                   for k, v in c["stats"].items())
    launches = {k: sum(ln["launches"][k] for ln in lines) for k in lines[0]["launches"]}
    say("multigpu", f"train (a) two gloo ranks on {DP_DEVICES[0]} ({DP_BATCH // 2} samples "
        f"each), against (c): loss {a['loss']:.7f} / {c['loss']:.7f}; gradient cosine "
        f"{cos:.8f} (bound >= 0.9999); largest parameter change {dparam:.3e} (bound <= 3 lr = "
        f"{3 * c['lr']:.3e}); BatchNorm statistics worst relative error {stat_err:.3e} (bound "
        f"<= 1e-3, {len(c['stats'])} tensors); the ranks' parameters bit-identical: "
        f"{lines[0]['params_sha256'] == lines[1]['params_sha256']}; K6 launches per rank "
        f"{[ln['launches']['window_attn_bwd'] for ln in lines]} (bound: 24 each); ranks' wall "
        f"{wall:.1f} s (their start included), on {card}")
    if not (cos >= 0.9999 and dparam <= 3 * c["lr"] and stat_err <= 1e-3
            and lines[0]["params_sha256"] == lines[1]["params_sha256"]
            and all(ln["launches"]["window_attn_bwd"] == 24 for ln in lines)
            and all(all(ln["launches"].values()) for ln in lines)):
        raise AssertionError("the two-rank step disagrees with the one-process step")
    return launches


def multigpu_dryrun() -> None:
    """``tools/dryrun_multichip.py`` at W = 2 on the card (two gloo ranks
    on card 0; the kernels are built already)."""
    cmd = [sys.executable, "-m", "flair_for_aigle_tpu_torch.tools.dryrun_multichip",
           "--world", "2", "--device", "cuda", "--backend", "gloo",
           "--timeout", str(DP_RANK_TIMEOUT)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=DP_RANK_TIMEOUT + 60)
    ok = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip(2) ok")]
    say("multigpu", f"{' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {ok[-1] if ok else 'no result'}")
    if proc.returncode != 0 or not ok:
        raise RuntimeError(f"the dry run failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def phase_multigpu(card: str) -> dict:
    """Data parallelism on the one card: the zonal engine over two
    replicas, a training step over two gloo ranks and one NCCL rank, and
    the dry run. Returns the launches of the two-replica zonal pass and of
    the two training ranks."""
    t0 = time.perf_counter()
    zonal = multigpu_zonal(card)
    train = multigpu_train(card)
    multigpu_dryrun()
    say("multigpu", f"phase {time.perf_counter() - t0:.1f} s")
    return {k: zonal.get(k, 0) + train.get(k, 0) for k in {*zonal, *train}}


# --- the stripe D2H codec, per-block remat, the profiler ----------------------

# the [codec] phase's passes: the engine's codec keys (zonal/inference.py
# d2h_codec_choice); the port's default for an absent pack_d2h is raw
CODEC_PASSES = {"raw": {"pack_d2h": False},
                "pack5": {"pack_d2h": True, "d2h_codec": "pack5"},
                "auto": {"pack_d2h": True, "d2h_codec": "auto"}}


def codec_tiers() -> None:
    """``StripeCodec`` with RLE on two piecewise-constant 2048 x 5000
    canvases on the card (the bench's width, inside a canvas padded as the
    engine pads it), four stripes of 512 rows each: 8 horizontal class
    layers (8 runs a stripe: the rle-small tier) and 40 vertical bands of
    125 px (20480 runs a stripe: rle-mid). Every ``encode`` runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises); the
    stripes are separated by a synchronise, standing for the batches that
    separate them in a run, so the first probe's count lands before the
    next encode. Each stripe lands byte for byte."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal.stripes import StripeCodec

    w, rows = bench.KM2_SIDE_PX, 4 * 512
    y = torch.arange(rows, device=DEVICE)[:, None]
    x = torch.arange(w, device=DEVICE)[None, :]
    for name, img, tier in (("8 layers", (y // 64 % N_CLASSES).expand(rows, w), "small"),
                            ("40 bands", (x // 125 % N_CLASSES).expand(rows, w), "mid")):
        canvas = torch.zeros((1, rows + 432, w + 432), dtype=torch.uint8, device=DEVICE)
        canvas[0, :rows, :w] = img.to(torch.uint8)
        codec = StripeCodec(True, True, {"T": w})
        recs = []
        for i in range(4):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                recs.append(codec.encode(canvas, "T", i * 512, (i + 1) * 512))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        codec.plan_all(recs)
        dst = np.zeros((1, rows, w), np.uint8)
        nbytes = sum(codec.decode_into(r, dst[:, r["y0"]:r["y0"] + r["h"]]) for r in recs)
        same = np.array_equal(dst, canvas[:, :rows, :w].cpu().numpy())
        tiers = [r.get("tier") for r in recs]
        say("codec", f"StripeCodec on the card, {name} ({rows} x {w}): mode {codec.mode}, "
            f"tiers {tiers}, runs {[r['nr'] for r in recs]}, {nbytes} bytes fetched against "
            f"{rows * w} raw; byte-identical {same}; encode under sync debug mode 'error': "
            "no host sync")
        if not same or codec.mode != "rle" or set(tiers) != {tier}:
            raise AssertionError(f"StripeCodec's {tier} tier did not land the {name} canvas")


def phase_codec() -> dict:
    """The bench's 5000 x 5000 raster (written by the bench phase) at batch
    16, bf16, under the three codec settings: a warm-up pass each, then one
    timed pass each with the launch counts at 0 just before the first and
    read after the last. The three label rasters must be byte-identical,
    and the pack5 and auto passes must unpack natively. Then the RLE tiers
    on synthetic canvases (``codec_tiers``). Returns the timed passes'
    launches."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    img = os.path.join(TMP, "bench", "km2.tif")
    cfgs = {}
    for name, keys in CODEC_PASSES.items():
        cfgs[name] = {**bench.make_cfg(img, os.path.join(TMP, "codec", name)), **keys}
        os.makedirs(cfgs[name]["output_path"], exist_ok=True)
    model = None
    for cfg in cfgs.values():
        model, _, _ = bench.run_zonal(cfg, torch.device(DEVICE), model)
    fns = zero_launches({"prep", "window_attn", "ffn", "merge", "epilogue"})
    labels = {}
    for name, cfg in cfgs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, n_tiles, paths = bench.run_zonal(cfg, torch.device(DEVICE), model)
        wall = time.perf_counter() - t0
        t = dict(zi.LAST_TIMINGS)
        with zi.open_raster(paths["AERIAL_LABEL-COSIA"]) as src:
            labels[name] = src.read().copy()
        say("codec", f"{name} ({cfg.get('pack_d2h')}, {cfg.get('d2h_codec', '-')}): "
            f"{n_tiles / wall:.2f} tiles/s ({wall:.4f} s); d2h_codec_mode "
            f"{t.get('d2h_codec_mode')}, rle_probes {t.get('rle_probes', 0)}, d2h_bytes "
            f"{t.get('d2h_bytes')}, finalize_plan_s {t.get('finalize_plan_s')}, "
            f"finalize_wait_s {t.get('finalize_wait_s')}, finalize_unpack_s "
            f"{t.get('finalize_unpack_s')}, unpack_route {t.get('unpack_route', '-')}, "
            f"finalize_s {t.get('finalize_s')}, dispatch_s {t.get('dispatch_s')} on {bench.card(torch.device(DEVICE))}")
        if name != "raw" and t.get("unpack_route") != "native":
            raise AssertionError(f"{name}: the packed stripes unpacked by "
                                 f"{t.get('unpack_route')}, not natively")
    launches = {k: fn.launches for k, fn in fns.items()}
    same = all(np.array_equal(labels["raw"], labels[n]) for n in ("pack5", "auto"))
    say("codec", f"label rasters {labels['raw'].shape} byte-identical across raw, pack5 and "
        f"auto: {same}; launches during the timed passes {launches}")
    if not same or not all(launches.values()):
        raise AssertionError("the codecs' rasters differ, or a kernel did not run")
    codec_tiers()
    return launches


def _with_remat(cfg: dict, flag: bool, arch: str | None = None) -> dict:
    c = copy.deepcopy(cfg)
    c["models"]["monotemp_model"]["remat"] = flag
    if arch:
        c["models"]["monotemp_model"]["arch"] = arch
    return c


def _statistics(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def remat_batchnorm(batch) -> None:
    """One float32 AdamW step of efficientnet-b4-U-Net++ (the default
    training configuration otherwise) with and without remat, from the
    same weights on the same batch, cuDNN deterministic: the loss and
    every BatchNorm running statistic equal bit for bit."""
    import torch

    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps

    cfg = train_config(os.path.join(TMP, "train"))
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for flag in (False, True):
            c = _with_remat(cfg, flag, "efficientnet_b4-unetplusplus")
            model = build_model(c).to(DEVICE)
            opt = make_optimizer(c["hyperparams"], model.parameters())
            m = make_steps(model, c, opt, DEVICE).train_step(batch, c["hyperparams"][
                "learning_rate"])
            torch.cuda.synchronize()
            out[flag] = (float(m["loss"]), _statistics(model))
            del model, opt
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, s0), (l1, s1) = out[False], out[True]
    differ = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    worst = max((s0[k] - s1[k]).abs().max().item() for k in s0)
    say("remat", f"efficientnet_b4-unetplusplus float32 step at batch 5: loss {l0:.6f} without "
        f"remat, {l1:.6f} with; {len(s0)} BatchNorm running statistics, {len(differ)} differ "
        f"(largest difference {worst:.3e}; bound: all equal)")
    if differ or l0 != l1:
        raise AssertionError(f"remat changed the BatchNorm statistics: {differ[:4]}")


def phase_remat(card: str, cfg: dict, batch) -> dict:
    """``models.monotemp_model.remat`` on the default training
    configuration (swin-base-UPerNet, 512 px, batch 5, float32): one step's
    gradients with and without remat, from the same weights on the same
    batch, on the default route and under each fused-block switch (cosine
    >= 0.9999, largest absolute difference; the launch counts at 0 just
    before each remat step: the forward kernels run twice, in the forward
    and in the recompute); ms/step and peak device memory of each route
    with and without remat; then the EfficientNet BatchNorm check
    (``remat_batchnorm``). Returns the remat steps' launches."""
    import torch

    from flair_for_aigle_tpu_torch.train.stages import build_model
    from flair_for_aigle_tpu_torch.train.task import make_steps

    t_phase = time.perf_counter()
    plain = build_model(cfg).to(DEVICE)
    rem = build_model(_with_remat(cfg, True)).to(DEVICE)
    rem.load_state_dict(plain.state_dict())
    names = ("prep", "window_attn", "window_attn_bwd", "ffn", "merge", "ffn_bwd", "finish")
    launches: dict = {}
    routes = (("kernels", None), ("FLAIR_FFN_BWD=kernel", SWITCHED["ffn_bwd"]),
              ("FLAIR_SWIN_FINISH=1", SWITCHED["finish"]))
    for route, env in routes:
        res = {}
        with switch(*env) if env else contextlib.nullcontext():
            for flag, model in ((False, plain), (True, rem)):
                steps = make_steps(model, _with_remat(cfg, flag), None, DEVICE)
                fns = zero_launches(names)
                loss, grads, _, _ = steps.loss_and_grads(batch)
                torch.cuda.synchronize()
                res[flag] = (loss.item(), torch.cat([g.flatten() for g in grads]).double(),
                             {k: fn.launches for k, fn in fns.items()})
                del grads, steps
        (l0, g0, n0), (l1, g1, n1) = res[False], res[True]
        cos = torch.nn.functional.cosine_similarity(g0, g1, dim=0).item()
        diff = (g0 - g1).abs().max().item()
        say("remat", f"gradients, one float32 step at batch 5, {route}: loss {l0:.6f} without "
            f"remat, {l1:.6f} with; cosine {cos:.9f} (bound >= 0.9999), largest absolute "
            f"difference {diff:.3e} (largest gradient {g0.abs().max().item():.3e}); launches "
            f"without {n0}, with {n1}")
        if not cos >= 0.9999 or n1["window_attn"] != 2 * n0["window_attn"] or \
                n1["window_attn_bwd"] != n0["window_attn_bwd"]:
            raise AssertionError(f"{route}: remat's gradients or launches are wrong")
        for k, v in n1.items():
            launches[k] = launches.get(k, 0) + v
        del res, g0, g1
    # nothing of the gradient checks may stay allocated: the timed steps'
    # peak memory counts every live tensor
    del plain, rem
    torch.cuda.empty_cache()
    timing = {}
    for route, env in routes:
        for flag in (False, True):
            timing[(route, flag)] = _route_step(_with_remat(cfg, flag), batch, False, False, env)
    say("remat", f"train_step at batch 5, float32, on {card} ({STEPS_TIMED} steps after "
        f"{STEPS_WARM}; ms/step, peak GiB): " + "; ".join(
            f"{r} {'remat' if f else 'no remat'} {ms:.1f} ms {gib:.2f} GiB"
            for (r, f), (ms, gib) in timing.items()))
    remat_batchnorm(batch)
    say("remat", f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# kernels the profile trace must name: K2's bf16 core, K3's LayerNorm and
# products, K4
PROFILE_KERNELS = {"K2 core": "attn_core_bf16_kernel", "K3 LayerNorm": "ffn_ln_kernel",
                   "K3 products": "gemm_mma_kernel", "K4": "epilogue_kernel"}


def phase_profile() -> dict:
    """``utils/profiling.py profile_trace`` around one zonal batch (the
    slice's model, weights and raster, bf16, batch 16, after a warm-up
    batch): its Chrome trace must name K2's core and K3's and K4's kernels.
    Returns the batch's launches (counts at 0 just before it)."""
    import torch

    from flair_for_aigle_tpu_torch.utils.profiling import profile_trace
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    cfg = slice_config(os.path.join(TMP, "raster.tif"), os.path.join(TMP, "weights.safetensors"))
    pcfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    zi._set_labels(pcfg)
    model, _ = build_inference_model(pcfg, device="cuda")
    mod = cfg["modalities"]["AERIAL_RGBI"]["normalization"]
    step = _step(model, {"AERIAL_RGBI": ("custom", mod["means"], mod["stds"])})
    batch = one_batch(synthetic_raster(0))
    _labels(step, batch, torch.bfloat16)
    torch.cuda.synchronize()
    logdir = os.path.join(TMP, "profile")
    shutil.rmtree(logdir, ignore_errors=True)
    fns = zero_launches({"prep", "window_attn", "ffn", "merge", "epilogue"})
    t0 = time.perf_counter()
    with profile_trace(logdir):
        _labels(step, batch, torch.bfloat16)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {k: sum(v in n for n in kernels) for k, v in PROFILE_KERNELS.items()}
    say("profile", f"profile_trace around one zonal batch ({BATCH} tiles, bf16): "
        f"{os.path.relpath(files[0], REPO)}, {os.path.getsize(files[0])} bytes, "
        f"{len(events)} events, {len(kernels)} distinct kernels; kernel names naming "
        f"{found}; launches {launches}; {wall:.2f} s with the profiler on")
    if len(files) != 1 or not all(found.values()) or not all(launches.values()):
        raise AssertionError(f"the trace does not name the port's kernels: {found}")
    return launches


# --- class_prob and the repository's own zonal configuration -----------------

ZONAL_YAML = os.path.join(REPO, "configs", "config_model_zonal_segmentation.yaml")


def _raster(path: str):
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    with zi.open_raster(path) as src:
        return src.read().copy(), src.count


def phase_class_prob(card: str) -> tuple[dict, object]:
    """``output_type: class_prob`` on the slice's raster, configuration and
    checkpoint (swin-base-UPerNet, bf16, batch 16, 19 classes: a 19-band
    2048 x 2048 canvas): ``run_inference`` with the launch counts at 0 just
    before it (K4's class_prob epilogue once a batch), then, with a
    prebuilt model, a warm-up and a timed pass, the same pass under
    ``plain_versions()`` and an argmax pass. Bounds (bf16): >= 99 % of the
    bytes within 2 uint8 steps of the plain pass (the epilogue's bf16
    contract); the argmax over the bands equals the argmax pass's labels
    wherever the class_prob top-two gap exceeds 2 steps. Returns the run's
    launches and the argmax pass's labels."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    t0 = time.perf_counter()
    img, weights = os.path.join(TMP, "raster.tif"), os.path.join(TMP, "weights.safetensors")
    cfg = {**slice_config(img, weights), "output_type": "class_prob",
           "output_path": os.path.join(TMP, "class_prob")}
    os.makedirs(cfg["output_path"], exist_ok=True)
    fns = zero_launches({"prep", "window_attn", "ffn", "merge", "epilogue"})
    paths = zi.run_inference(dict(cfg))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    probs, count = _raster(paths["AERIAL_LABEL-COSIA"])
    n_tiles = len(zi.generate_patches_from_reference(
        zi.initialize_geometry_and_resolutions(dict(cfg))))
    n_batches = -(-n_tiles // BATCH)
    if (count != N_CLASSES or probs.shape != (N_CLASSES, SIDE, SIDE)
            or launches["epilogue"] != n_batches or not all(launches.values())):
        raise AssertionError(f"the class_prob pass wrote {probs.shape} in {count} bands or "
                             f"did not run K4 once a batch: {launches}")
    model, _, _ = bench.run_zonal(cfg, torch.device(DEVICE))
    wall, _, out = _zonal_pass(cfg, model)
    probs_k, _ = _raster(out)
    with plain_versions():
        _, _, out = _zonal_pass(_out_dir(cfg, "plain"), model)
    probs_p, _ = _raster(out)
    _, _, out = _zonal_pass({**_out_dir(cfg, "argmax"), "output_type": "argmax"}, model)
    labels, _ = _raster(out)
    steps = np.abs(probs_k.astype(np.int16) - probs_p.astype(np.int16))
    within2 = float((steps <= 2).mean())
    top2 = np.sort(probs_k, axis=0)[-2:].astype(np.int16)
    clear = (top2[1] - top2[0]) > 2
    top = np.argmax(probs_k, axis=0)
    mism = int((top[clear] != labels[0][clear]).sum())
    sums = np.abs(probs_k.astype(np.int32).sum(axis=0) - 255).max()
    say("class_prob", f"run_inference output_type class_prob, {n_tiles} tiles at batch {BATCH} "
        f"bf16: {probs.shape} uint8 in {count} bands, identical to the timed pass "
        f"{np.array_equal(probs, probs_k)}; launches during it {launches} (bound: epilogue "
        f"{n_batches}, once a batch); bytes within 2 uint8 steps of the plain versions' pass "
        f"{within2:.6f} (bound >= 0.99), largest step {int(steps.max())}; argmax over the bands "
        f"against the argmax pass's labels where the top-two gap > 2 steps ({float(clear.mean()):.4f} "
        f"of the pixels): {mism} differ (bound 0); bands' sum within {int(sums)} of 255; warm "
        f"{n_tiles / wall:.2f} tiles/s ({wall:.3f} s) on {card}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if within2 < 0.99 or mism:
        raise AssertionError("the class_prob pass disagrees with the plain versions' or with "
                             "the argmax pass")
    return launches, labels


def _out_dir(cfg: dict, suffix: str) -> dict:
    """``cfg`` writing into a sibling of its output directory, made here."""
    path = f"{cfg['output_path']}_{suffix}"
    os.makedirs(path, exist_ok=True)
    return {**cfg, "output_path": path}


def zonal_yaml(path: str, out_dir: str, **changes) -> dict:
    """The repository's zonal YAML with the input raster (the slice's),
    ``model_weights`` (the slice's seeded checkpoint) and ``output_path``
    changed, and ``changes`` on top; written to ``path``."""
    import yaml

    with open(ZONAL_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["modalities"]["AERIAL_RGBI"]["input_img_path"] = os.path.join(TMP, "raster.tif")
    cfg.update(model_weights=os.path.join(TMP, "weights.safetensors"), output_path=out_dir,
               **changes)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


@contextlib.contextmanager
def k2_modes():
    """K2's launches inside the block by (dtype, attn_f32): ``{(dtype,
    attn_f32): launches}``."""
    modes: dict = {}

    def tally(key, fn, args, kwargs):
        before = shims[key].launches
        out = fn(*args, **kwargs)
        mode = (str(args[0].dtype).replace("torch.", ""), kwargs.get("attn_f32", True))
        modes[mode] = modes.get(mode, 0) + shims[key].launches - before
        return out

    with wrapped_kernels({"window_attn"}, tally) as shims:
        yield modes


def phase_zonal_main(card: str, argmax_labels) -> dict:
    """The repository's own zonal configuration
    (``configs/config_model_zonal_segmentation.yaml``: swin-base-UPerNet,
    512 px, margin 40, bf16, ``attn_f32: True``, batch 8, ``pack_d2h:
    True``, ``d2h_codec: auto``) on the slice's raster and checkpoint,
    through the port's CLI in process (``zonal_main.main(["--config",
    path])``), with the launch counts at 0 just before it: K2 in bf16 at
    attn_f32 True, the codec on (``d2h_codec_mode``); the same file under
    ``plain_versions()``: label agreement >= 0.99; agreement with the
    slice's attn_f32 False pass (reported); warm tiles/s at batch 8 with a
    prebuilt model. Returns the CLI run's launches."""
    import numpy as np
    import torch

    from flair_for_aigle_tpu_torch import bench, zonal_main
    from flair_for_aigle_tpu_torch.zonal.config import load_config
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    t0 = time.perf_counter()
    root = os.path.join(TMP, "zonal_main")
    path = os.path.join(root, "zonal.yaml")
    cfg = zonal_yaml(path, os.path.join(root, "out"))
    fns = zero_launches({"prep", "window_attn", "ffn", "merge", "epilogue"})
    with k2_modes() as modes:
        zonal_main.main(["--config", path])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    timings = dict(zi.LAST_TIMINGS)
    out = glob.glob(os.path.join(root, "out", "*_AERIAL_LABEL-COSIA_argmax_i.tif"))
    labels, count = _raster(out[0])
    plain_path = os.path.join(root, "plain.yaml")
    zonal_yaml(plain_path, os.path.join(root, "plain"))
    with plain_versions():
        zonal_main.main(["--config", plain_path])
    out = glob.glob(os.path.join(root, "plain", "*_AERIAL_LABEL-COSIA_argmax_i.tif"))
    plain, _ = _raster(out[0])
    agree = float((labels == plain).mean())
    agree_slice = float((labels == argmax_labels).mean())
    # warm tiles/s at the file's batch with a prebuilt model
    run_cfg = _out_dir(load_config(path), "timed")
    model, n_tiles, _ = bench.run_zonal(run_cfg, torch.device(DEVICE))
    wall, phases, _ = _zonal_pass(run_cfg, model)
    n_batches = -(-n_tiles // cfg["batch_size"])
    say("zonal_main", f"python -m flair_for_aigle_tpu_torch.zonal_main --config <{os.path.basename(ZONAL_YAML)} "
        f"with the slice's raster and checkpoint>: compute_dtype {cfg['compute_dtype']}, "
        f"attn_f32 {cfg['attn_f32']}, batch_size {cfg['batch_size']}, pack_d2h {cfg['pack_d2h']}, "
        f"d2h_codec {cfg['d2h_codec']}; {labels.shape} uint8 in {count} band, labels "
        f"{int(labels.min())}..{int(labels.max())}; launches {launches}, K2 by (dtype, "
        f"attn_f32) {modes} (bound: all 24 a batch x {n_batches} batches in bfloat16 at "
        f"attn_f32 True); d2h_codec_mode {timings.get('d2h_codec_mode')}, d2h_bytes "
        f"{timings.get('d2h_bytes')}; label agreement with the plain versions on the same file "
        f"{agree:.6f} (bound >= 0.99); with the slice's attn_f32 False pass at batch {BATCH} "
        f"{agree_slice:.6f} (reported); warm {n_tiles / wall:.2f} tiles/s at batch "
        f"{cfg['batch_size']} ({wall:.3f} s; dispatch_s {phases.get('dispatch_s', 0):.4f}) on "
        f"{card}; phase {time.perf_counter() - t0:.1f} s")
    if (modes != {("bfloat16", True): 24 * n_batches} or not all(launches.values())
            or timings.get("d2h_codec_mode") not in ("rle", "pack5") or agree < 0.99
            or count != 1 or labels.max() >= N_CLASSES):
        raise AssertionError("the zonal CLI on the repository's configuration did not run K2 "
                             "at attn_f32 True in bf16 with the codec on, or disagrees with the "
                             "plain versions")
    return launches


def main() -> int:
    if sys.argv[1:2] == ["--train-rank"]:
        return train_rank(sys.argv[2])
    if not os.path.isdir(os.path.join(REPO, "flair_for_aigle_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(flair_for_aigle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from flair_for_aigle_tpu_torch.zonal.memory_io import host_io

    env = phase_env()
    phase_build()
    stats = phase_kernels()
    with host_io() as (write_geotiff, io_desc):
        zonal = phase_slice(env["card"], write_geotiff, io_desc)
        profile = phase_profile()
        bench = phase_bench(write_geotiff)
        codec = phase_codec()
        multimodal, multimodal_train = phase_multimodal(env["card"], write_geotiff)
        families = phase_families(env["card"], write_geotiff)
        train, train_switched, train_cfg, train_batch = phase_train(env["card"], write_geotiff)
        remat = phase_remat(env["card"], train_cfg, train_batch)
        del train_batch
        multigpu = phase_multigpu(env["card"])
        class_prob, argmax_labels = phase_class_prob(env["card"])
        zonal_main = phase_zonal_main(env["card"], argmax_labels)
        del argmax_labels
    tool = phase_tool()
    # launches: the main path's runs (zonal, the bench's timed runs, the
    # multimodal zonal run and training step, training stages and CLI), for
    # K7 and K8 the runs under their switches (the zonal finish pass, one
    # training step each), and the A/B tool's run; library_ms: the A/B
    # kernels' two bf16 torch.bmm at the tool's defaults, else null (no
    # single PyTorch call computes the other, fused functions)
    runs = {"zonal": zonal, "bench": bench, "multimodal": multimodal,
            "multimodal_train": multimodal_train, "families": families, "train": train,
            "train_switched": train_switched, "multigpu": multigpu,
            "tool": tool, "codec": codec, "remat": remat, "profile": profile,
            "class_prob": class_prob, "zonal_main": zonal_main}
    # K2's bf16 attention core alone, summed over the stages at attn_f32
    # False (the slice's), and its float32 core at attn_f32 True (the
    # training configuration's, with its bound at 3xTF32's rate beside),
    # with their resources at T = 144
    extra = {"window_attn": {}}
    for key, name in (("core", "window_attn_core"), ("core_f32", "window_attn_core_f32")):
        core, info = stats[name], stats[name]["info"]
        extra["window_attn"].update({
            f"{key}_ms": core["ms"], f"{key}_plain_ms": core["plain_ms"],
            f"{key}_bound_ms": core["bound_ms"], f"{key}_library_ms": core["library_ms"],
            f"{key}_regs": info["regs"], f"{key}_spill_bytes": info["spill_bytes"],
            f"{key}_blocks_per_sm": info["blocks_per_sm"]})
    extra["window_attn"]["core_f32_bound_3xtf32_ms"] = stats["window_attn_core_f32"][
        "bound_3xtf32_ms"]
    extra["window_attn"]["clamp"] = stats["window_attn"]["clamp"]
    # K6's bf16 and float32 cores alone, summed over the stages at attn_f32
    # True (the training configuration's), with their resources at T = 144
    extra["window_attn_bwd"] = {}
    for key, name in (("core", "window_attn_bwd_core"), ("core_f32", "window_attn_bwd_core_f32")):
        core, info = stats[name], stats[name]["info"]
        extra["window_attn_bwd"].update({
            f"{key}_ms": core["ms"], f"{key}_plain_ms": core["plain_ms"],
            f"{key}_bound_ms": core["bound_ms"], f"{key}_library_ms": core["library_ms"],
            f"{key}_regs": info["regs"], f"{key}_spill_bytes": info["spill_bytes"],
            f"{key}_blocks_per_sm": info["blocks_per_sm"],
            f"{key}_warps_per_sm": info["warps_per_sm"]})
    # K3 summed over the stages: bf16 at batch 2 (the entry's own numbers),
    # float32 at batch 2 (with its bound at 3xTF32's rate) and bf16 at the
    # zonal batch; each by CUDA events (ms, plain_ms) and as device time
    # beside its two products through cuBLAS; and the worst resources of
    # its GEMM kernels
    dev = ("device_ms", "plain_device_ms", "cublas_device_ms")
    # K2 summed over the stages: bf16 at attn_f32 False (the entry's own
    # numbers) and float32 at attn_f32 True (with its bound at 3xTF32's
    # rate), each by CUDA events and as device time beside its two
    # products through cuBLAS; and the worst resources of its projections'
    # GEMM kernels
    st = stats["window_attn_f32"]
    extra["window_attn"].update({
        **{k: stats["window_attn"][k] for k in dev}, **stats["window_attn"]["info"],
        **{f"f32_{k}": st[k] for k in ("ms", "plain_ms", "bound_ms", "bound_3xtf32_ms", *dev)}})
    extra["ffn"] = {**{k: stats["ffn"][k] for k in dev}, **stats["ffn"]["info"]}
    for key, name in (("f32", "ffn_f32"), (f"b{BATCH}", "ffn_b16")):
        st = stats[name]
        extra["ffn"].update({f"{key}_{k}": st[k]
                             for k in ("ms", "plain_ms", "bound_ms", *dev)})
    extra["ffn"]["f32_bound_3xtf32_ms"] = stats["ffn_f32"]["bound_3xtf32_ms"]
    # K6 (float32, attn_f32 True) also as device time, its four products
    # alone (gemm_mma.cuh) with the weights' transposed copies, the same
    # products through cuBLAS (a yardstick), and its GEMMs' worst resources;
    # the A/B kernels' resources
    st = stats["window_attn_bwd"]
    extra["window_attn_bwd"].update({
        **{k: st[k] for k in ("device_ms", "plain_device_ms", "gemm_products_device_ms",
                              "weight_transpose_device_ms", "cublas_device_ms",
                              "wgrad_b5_worst_ratio")},
        **st["gemm_info"]})
    # K7 summed over the stages: float32 at batch 2 (the entry's own
    # numbers), bf16 at batch 2 and float32 at the training batch, each by
    # CUDA events and as device time beside its five products through
    # cuBLAS, float32 with its bound at 3xTF32's rate; its GEMMs' worst
    # resources
    st = stats["ffn_bwd"]
    extra["ffn_bwd"] = {**{k: st[k] for k in (*dev, "bound_3xtf32_ms")}, **st["gemm_info"]}
    for key, name in (("bf16", "ffn_bwd_bf16"), (f"b{TRAIN_BATCH}", f"ffn_bwd_b{TRAIN_BATCH}")):
        st = stats[name]
        extra["ffn_bwd"].update({f"{key}_{k}": st[k] for k in ("ms", "plain_ms", "bound_ms", *dev)})
    extra["ffn_bwd"][f"b{TRAIN_BATCH}_bound_3xtf32_ms"] = stats[f"ffn_bwd_b{TRAIN_BATCH}"][
        "bound_3xtf32_ms"]
    for name in ("attn_dots_per_head", "attn_dots_grouped"):
        extra[name] = dict(stats[name]["info"])
    # K1 (bf16) and K5 (float32) at batch 2 also as device time, beside
    # their yardstick (K1: F.layer_norm over the same input; K5: the
    # reduction alone through cuBLAS); at batch 2 in the other dtype; at the
    # zonal batch (bf16) and the training batch (float32), each by CUDA
    # events and as device time; their kernels' worst resources
    for op, yard, other in (("prep", "layer_norm", "f32"), ("merge", "cublas", "bf16")):
        st = stats[op]
        extra[op] = {"device_ms": st["device_ms"], "plain_device_ms": st["plain_device_ms"],
                     f"{yard}_device_ms": st["library_device_ms"], **st["info"]}
        for pre in (other, f"b{BATCH}", f"b{TRAIN_BATCH}"):
            st = stats[f"{op}_{pre}"]
            extra[op].update({f"{pre}_{k}": st[k] for k in (
                "ms", "plain_ms", "bound_ms", "device_ms", "plain_device_ms")})
            extra[op][f"{pre}_{yard}_device_ms"] = st["library_device_ms"]
    # K8 (bf16, the entry's own) also as device time, beside K3 on the same
    # rows and its two products through cuBLAS; float32 likewise; its
    # gather pass's worst resources. K4 (bf16 argmax at batch 2, the
    # entry's own) also as device time beside F.interpolate alone; at the
    # zonal batch; class_prob at both; its argmax kernel's resources
    fin = ("device_ms", "plain_device_ms", "ffn_device_ms", "cublas_device_ms")
    st = stats["finish_f32"]
    extra["finish"] = {**{k: stats["finish"][k] for k in fin}, **stats["finish"]["info"],
                       **{f"f32_{k}": st[k] for k in ("ms", "plain_ms", "bound_ms",
                                                      "bound_3xtf32_ms", *fin)}}
    epi = ("ms", "plain_ms", "bound_ms", "device_ms", "plain_device_ms", "interpolate_device_ms")
    info = stats["epilogue"]["info"]
    extra["epilogue"] = {**{k: stats["epilogue"][k] for k in epi[3:]},
                         **{k: info[k] for k in ("regs", "spill_bytes", "blocks_per_sm")}}
    for pre, name in ((f"b{BATCH}", f"epilogue_b{BATCH}"), ("class_prob", "epilogue_class_prob"),
                      (f"class_prob_b{BATCH}", f"epilogue_class_prob_b{BATCH}")):
        extra["epilogue"].update({f"{pre}_{k}": stats[name][k] for k in epi})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r.get(name, 0) for r in runs.values()),
         **{f"launches_{k}": r.get(name, 0) for k, r in runs.items()},
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"],
         "bound_by": "bytes" if stats[name]["bytes_ms"] >= stats[name]["ops_ms"] else "operations",
         "library_ms": stats[name]["library_ms"], **extra.get(name, {})}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"],
                                              "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
