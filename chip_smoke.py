#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flair_for_aigle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):

1. environment: the card (name and power limit from nvidia-smi), TF32 off;
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
   had before K5's producer joined the GEMM's body, and no spill;
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
6. tool: the port's A/B tool, ``python -m
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
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
    return {"card": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


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
    """bench.py's zonal configuration (bench.py:55-90) for the port."""
    return {
        "output_path": os.path.join(TMP, "out"), "output_name": "chip_smoke",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": weights, "batch_size": BATCH, "num_worker": 4,
        "img_pixels_detection": 512, "margin": 40, "output_px_meters": RES,
        "compute_dtype": "bfloat16", "attn_f32": False, "normalize_on_device": True,
        "emit_label_placeholders": False,
        "monotemp_arch": "swin_base_patch4_window12_384-upernet",
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom",
                                              "means": [105.66, 111.35, 102.18],
                                              "stds": [52.23, 45.62, 44.30]}},
        },
        "tasks": [{"name": "AERIAL_LABEL-COSIA", "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLASSES)}}],
    }


def _zonal_pass(cfg: dict, model) -> tuple[float, dict, str]:
    """Wall seconds of one zonal pass (tiling, dataset, inference, stitch,
    D2H, write) with a prebuilt model, as bench.py times it, the engine's
    phase timings of that pass and the label raster it wrote."""
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
    from flair_for_aigle_tpu_torch.zonal.stripes import LAST_TIMINGS

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = zi.initialize_geometry_and_resolutions(dict(cfg))
    c["output_type"] = "argmax"
    tiles = zi.generate_patches_from_reference(c)
    patch_sizes = compute_patch_sizes(c)
    dataset = zi.prep_dataset(c, tiles, patch_sizes)
    loader = zi.BatchedLoader(dataset, batch_size=BATCH, num_workers=c["num_worker"])
    ref_img = zi.open_raster(c["modalities"]["AERIAL_RGBI"]["input_img_path"])
    output_files, paths = zi.init_outputs(c, ref_img)
    zi.inference_and_write(model, loader, tiles, c, output_files, ref_img,
                           torch.device("cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref_img.close()
    dataset.close()
    return wall, dict(LAST_TIMINGS), paths["AERIAL_LABEL-COSIA"]


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


def phase_slice(card: str, write_geotiff, io_desc: str) -> dict:
    import numpy as np
    import torch
    from safetensors.torch import save_file

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    say("slice", f"host IO: {io_desc}")
    os.makedirs(TMP, exist_ok=True)
    img = os.path.join(TMP, "raster.tif")
    raster = synthetic_raster(0)
    transform = zi.from_origin(700000.0, 6600000.0, RES, RES)
    write_geotiff(img, raster, transform, "EPSG:2154", compress="lzw", tile_size=512)
    weights = os.path.join(TMP, "weights.safetensors")
    cfg = slice_config(img, weights)
    # random weights from a seeded torch.Generator, written as a checkpoint
    # that run_inference loads like a published one
    seed_cfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    zi._set_labels(seed_cfg)
    seed_model, _ = build_inference_model({**seed_cfg, "model_weights": ""},
                                          device="cpu", seed=0)
    save_file({k: v.contiguous() for k, v in seed_model.state_dict().items()}, weights)
    del seed_model

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
    step = zi.ZonalStep(model, "argmax", 40, 512, 1, 1, torch.bfloat16, norm, torch.device("cuda"))
    offs = [(y, x) for y in range(0, SIDE - 512, 432) for x in range(0, SIDE - 512, 432)][:BATCH]
    tiles = torch.stack([torch.from_numpy(raster[:, y:y + 512, x:x + 512]) for y, x in offs]).cuda()
    batch = {"AERIAL_RGBI": tiles,
             "AERIAL_LABEL-COSIA": torch.zeros((len(offs), 1, 512, 512), device="cuda")}

    def forward(plain: bool, dtype) -> torch.Tensor:
        step.compute_dtype = dtype
        with plain_versions() if plain else contextlib.nullcontext():
            return step.forward_convert(batch)["AERIAL_LABEL-COSIA"]

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
    say("slice", f"argmax agreement kernels vs plain versions, one batch of {len(offs)}: "
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


def phase_train(card: str, write_geotiff) -> tuple[dict, dict]:
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
             "finish": step_launches["FLAIR_SWIN_FINISH=1"]["finish"]})


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


def main() -> int:
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
        train, train_switched = phase_train(env["card"], write_geotiff)
    tool = phase_tool()
    # launches: the main path's runs (zonal, training stages and CLI), for
    # K7 and K8 the runs under their switches (the zonal finish pass, one
    # training step each), and the A/B tool's run; library_ms: the A/B
    # kernels' two bf16 torch.bmm at the tool's defaults, else null (no
    # single PyTorch call computes the other, fused functions)
    runs = {"zonal": zonal, "train": train, "train_switched": train_switched, "tool": tool}
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
                              "weight_transpose_device_ms", "cublas_device_ms")},
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
