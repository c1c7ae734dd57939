"""Every kernel wrapper of flair_for_aigle_tpu_torch.ops with small inputs,
for the tests that feed it views off a 16-byte boundary: the kernels read
16 bytes at a time, so each wrapper hands them a copy of such a view
(``_build.aligned``) and computes what the plain version computes on it.
Shared by the CPU tests (tests/test_torch_offset_views.py) and the card
tests (tests/test_torch_kernels_cuda.py)."""

import torch

from flair_for_aigle_tpu_torch.ops import (
    attn_dots,
    dw_ln,
    epilogue,
    ffn,
    finish,
    merge,
    prep,
    window_attn,
)


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view equal to t whose data starts one element past the
    start of a fresh buffer: 2 or 4 bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 in (2, 4), v.data_ptr() % 16
    return v


def _attn_params(randn, c, nh, t):
    return [randn(3 * c, c, std=c ** -0.5), randn(3 * c, std=0.02),
            randn(c, c, std=c ** -0.5), randn(c, std=0.02), randn(nh, t, t, std=0.5)]


def _ffn_params(randn, c):
    return [randn(c, std=0.1) + 1, randn(c, std=0.1), randn(4 * c, c, std=c ** -0.5),
            randn(4 * c, std=0.02), randn(c, 4 * c, std=(4 * c) ** -0.5), randn(c, std=0.02)]


#: the wrappers, by the kernel each launches
WRAPPERS = ["prep", "window_attn", "window_attn_bwd", "window_attn_core",
            "window_attn_core_bwd", "window_attn_bwd_gemm", "window_attn_bwd_wgrad", "ffn",
            "ffn_bwd", "merge", "finish", "epilogue", "attn_dots_per_head", "attn_dots_grouped",
            "dw_ln"]


def wrapper_case(name: str, dtype, device, seed: int = 0):
    """(wrapper, plain version, tensor arguments, keyword arguments) of the
    named wrapper at a small size: activations in ``dtype``, parameters
    float32 (as the models hold them); attn_dots takes bf16 alone, at the
    A/B tool's window and head width."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g, device=device) * std).to(dt)

    ws, ss, grid, c, nh = 4, 2, (2, 2), 64, 2
    t, bnw = ws * ws, 2 * grid[0] * grid[1]
    akw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=True)
    if name == "prep":
        return (prep.fused_ln_shift_partition, prep.fused_ln_shift_partition_reference,
                [randn(2, 6, 6, 32, dt=dtype), randn(32, std=0.1) + 1, randn(32, std=0.1)],
                dict(ws=ws, ss=ss))
    if name == "window_attn":
        return (window_attn.fused_window_attention, window_attn.fused_window_attention_reference,
                [randn(bnw, t, c, dt=dtype), *_attn_params(randn, c, nh, t)], akw)
    if name == "window_attn_bwd":
        return (window_attn.fused_window_attention_backward,
                window_attn.fused_window_attention_backward_reference,
                [randn(bnw, t, c, dt=dtype), randn(bnw, t, c, dt=dtype),
                 *_attn_params(randn, c, nh, t)], akw)
    if name == "window_attn_core":
        return (window_attn.window_attention_core, window_attn.window_attention_core_reference,
                [randn(bnw * t, 3 * c, dt=dtype), randn(nh, t, t, std=0.5)], akw)
    if name == "window_attn_core_bwd":
        return (window_attn.window_attention_core_backward,
                window_attn.window_attention_core_backward_reference,
                [randn(bnw * t, 3 * c, dt=dtype), randn(bnw * t, c, dt=dtype),
                 randn(nh, t, t, std=0.5)], akw)
    if name in ("window_attn_bwd_gemm", "window_attn_bwd_wgrad"):
        # K6's products alone on 200 rows: dx = dqkv Wqkv (a (200, 3C), b
        # the weight's transposed copy (C, 3C)), dWqkv = dqkv^T x (a (200,
        # 3C), b (200, C))
        wgrad = name.endswith("wgrad")
        b = randn(200, c, dt=dtype) if wgrad else randn(c, 3 * c, std=c ** -0.5, dt=dtype)
        return (window_attn.backward_gemm, window_attn.backward_gemm_reference,
                [randn(200, 3 * c, dt=dtype), b], dict(wgrad=wgrad))
    if name == "ffn":
        return (ffn.fused_ln_mlp_residual, ffn.fused_ln_mlp_residual_reference,
                [randn(37, c, dt=dtype), randn(37, c, std=0.5, dt=dtype), *_ffn_params(randn, c)],
                {})
    if name == "ffn_bwd":
        s, b, w1, b1, w2, _ = _ffn_params(randn, c)
        x, a, gy = (randn(37, c, dt=dtype) for _ in range(3))
        # the plain version takes g last
        return (ffn.fused_ln_mlp_residual_backward,
                lambda gy, *rest: ffn.fused_ln_mlp_residual_backward_reference(*rest, gy),
                [gy, x, a, s, b, w1, b1, w2], {})
    if name == "merge":
        return (merge.fused_patch_merge, merge.fused_patch_merge_reference,
                [randn(2, 8, 8, 32, dt=dtype), randn(128, std=0.1) + 1, randn(128, std=0.1),
                 randn(64, 128, std=128 ** -0.5)], {})
    if name == "finish":
        return (finish.fused_reverse_ln_mlp_residual,
                finish.fused_reverse_ln_mlp_residual_reference,
                [randn(2 * 2 * 2, t, c, dt=dtype), randn(2, 7, 6, c, dt=dtype),
                 *_ffn_params(randn, c)], dict(ws=ws, ss=ss))
    if name == "epilogue":
        return (epilogue.upsample_crop_convert, epilogue.upsample_crop_convert_reference,
                [randn(2, 5, 16, 16, std=3.0, dt=dtype)], dict(margin=8, output_type="class_prob"))
    if name == "dw_ln":
        return (dw_ln.depthwise7_ln, dw_ln.depthwise7_ln_reference,
                [randn(2, 9, 6, 32, dt=dtype), randn(32, 1, 7, 7, std=1 / 7),
                 randn(32, std=0.1), randn(32, std=0.1) + 1, randn(32, std=0.1)], {})
    if name in ("attn_dots_per_head", "attn_dots_grouped"):
        fn = getattr(attn_dots, name)
        ref = attn_dots.attn_dots_reference
        return (fn, lambda q, k, v, num_heads, bw: ref(q, k, v, num_heads=num_heads),
                [randn(2, attn_dots.T, 128, dt=torch.bfloat16) for _ in range(3)],
                dict(num_heads=4, bw=1))
    raise KeyError(name)


def outputs(result) -> tuple:
    return result if isinstance(result, tuple) else (result,)
