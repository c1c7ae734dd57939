"""The CUDA kernels of flair_for_aigle_tpu_torch against their plain
PyTorch versions, on the card. Every test skips without a CUDA device.

Run on a machine with a card (the repository's conftest imports jax, which
these tests do not need):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and cover what the full-size smoke run (chip_smoke.py)
does not: windows smaller than 12 (T = 64, 16, 4, as swin at small inputs
clamps them), non-square window grids, odd token counts for the GEMM edges,
and the whole swin_micro-upernet model on the card against the CPU, in
inference and in a training step. Tolerances: float32 1e-4 relative to the
largest reference magnitude; bfloat16 4 units in the last place at that
magnitude (1 for the prologue). The attention backward (K6) against
autograd through the plain forward: float32 2e-3 relative to each
gradient's largest magnitude, bfloat16 median relative error < 0.04 per
gradient (tests/test_window_attn_kernel.py's bounds for the TPU backward).
The fused finish (K8) has K3's bounds (after its gather it computes K3's
function), the ffn backward (K7) K6's, at the four swin-base@512 stages at
batch 2 and at an odd shape. The A/B tool's two attention-product kernels:
one bfloat16 unit in the last place at the largest magnitude against their
plain version, bit-identical to each other and from call to call. Every
wrapper on views off a 16-byte boundary launches its kernel on aligned
copies and returns bit for bit what it returns on fresh tensors
(tests/_offset_views.py's cases). K2, whose projections run gemm_mma.cuh's
bias epilogue, twice bit-identical; that epilogue's tiles without spill at
two blocks per SM. K6's do, dx and weight-gradient products alone
(gemm_mma.cuh's rounding epilogue and its C = A^T B layout) against a
float64 product on ragged shapes, twice bit-identical, their kernels
without spill at two blocks per SM. The A/B kernels at swin-base's four
stage geometries at batch 16 (bw 1 and 4), and their residency: no spill,
three blocks per SM per head, two grouped.
"""

import pytest
import torch

from flair_for_aigle_tpu_torch.ops import (
    attn_dots,
    epilogue,
    ffn,
    finish,
    merge,
    prep,
    window_attn,
)
# by its module name (pytest puts tests/ on the path): the card machine has
# another package named tests
from _offset_views import WRAPPERS, offset_view, outputs, wrapper_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _assert_close(got, want, dtype, bf16_ulps=4):
    scale = max(1.0, want.float().abs().max().item())
    tol = (bf16_ulps * 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,ws,ss", [(20, 28, 128, 12, 6), (8, 8, 256, 8, 0),
                                         (6, 6, 96, 4, 2)])
def test_prep_kernel(dev, dtype, h, w, c, ws, ss):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((3, h, w, c), generator=g, device=dev).to(dtype)
    s = torch.randn(c, generator=g, device=dev) * 0.1 + 1
    b = torch.randn(c, generator=g, device=dev) * 0.1
    prep.fused_ln_shift_partition.launches = 0
    got = prep.fused_ln_shift_partition(x, s, b, ws=ws, ss=ss)
    want = prep.fused_ln_shift_partition_reference(x, s, b, ws=ws, ss=ss)
    torch.cuda.synchronize()
    assert prep.fused_ln_shift_partition.launches == 1
    _assert_close(got, want, dtype, bf16_ulps=1)


# (window, shift, window grid, C, heads): T = 144, 64, 16 and 4
ATTN_GEOMS = [(12, 6, (2, 3), 128, 4), (8, 0, (1, 1), 256, 8), (4, 2, (3, 2), 96, 3),
              (2, 0, (1, 1), 1024, 32)]
# K6 also at an odd T = 49: padded rows and columns, bias rows not 16-byte aligned
BWD_GEOMS = ATTN_GEOMS + [(7, 3, (2, 2), 64, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", ATTN_GEOMS)
def test_window_attn_kernel(dev, dtype, attn_f32, ws, ss, grid, c, nh):
    g = torch.Generator(device=dev).manual_seed(1)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    x = torch.randn((bnw, t, c), generator=g, device=dev).to(dtype)
    p = (torch.randn((3 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(3 * c, generator=g, device=dev) * 0.02,
         torch.randn((c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(c, generator=g, device=dev) * 0.02,
         torch.randn((nh, t, t), generator=g, device=dev) * 0.5)
    kw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=attn_f32)
    got = window_attn.fused_window_attention(x, *p, **kw)
    want = window_attn.fused_window_attention_reference(x, *p, **kw)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", BWD_GEOMS)
def test_window_attn_core_kernel(dev, dtype, attn_f32, ws, ss, grid, c, nh):
    """K2's attention core alone against its plain version; two calls
    bit-identical, one launch each. bf16: both round in the same places in
    the same order, and only their float32 sums (P V, the row sums) run in
    another order, so at most 1 % of the outputs may differ at all, by 4
    bf16 units at the largest magnitude. float32 (the 3xTF32 core): within
    1e-4 of the largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(10)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    qkv = torch.randn((bnw * t, 3 * c), generator=g, device=dev).to(dtype)
    bias = torch.randn((nh, t, t), generator=g, device=dev) * 0.5
    kw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=attn_f32)
    window_attn.window_attention_core.launches = 0
    got = window_attn.window_attention_core(qkv, bias, **kw)
    again = window_attn.window_attention_core(qkv, bias, **kw)
    want = window_attn.window_attention_core_reference(qkv, bias, **kw)
    torch.cuda.synchronize()
    assert window_attn.window_attention_core.launches == 2
    assert got.shape == (bnw * t, c) and got.dtype == dtype
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    _assert_close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= 0.01


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
def test_window_attn_core_resources(dev, attn_f32, dtype):
    """At T = 144 both cores spill nothing and keep two blocks (18 warps)
    per SM: the bf16 core in 35 KB of shared memory, the float32 core in
    104 KB (float32 q rows, k and v split into tf32 halves)."""
    info = window_attn.window_attention_core_info(144, attn_f32, dtype)
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 2, info


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c", [(37, 128), (300, 96), (64, 1024), (37, 96),
                                 (512, 1024), (2048, 512)])
def test_ffn_kernel(dev, dtype, n, c):
    """K3 against its plain version, and two calls bit-identical: odd row
    counts and C = 96 for the tiles' ragged edges; at 512 x 1024 (batch 2,
    stage 4) and 2048 x 512 (stage 3) fc2 splits K."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n, c), generator=g, device=dev).to(dtype)
    a = (torch.randn((n, c), generator=g, device=dev) * 0.5).to(dtype)
    p = (torch.randn(c, generator=g, device=dev) * 0.1 + 1,
         torch.randn(c, generator=g, device=dev) * 0.1,
         torch.randn((4 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(4 * c, generator=g, device=dev) * 0.02,
         torch.randn((c, 4 * c), generator=g, device=dev) * (4 * c) ** -0.5,
         torch.randn(c, generator=g, device=dev) * 0.02)
    got = ffn.fused_ln_mlp_residual(x, a, *p)
    again = ffn.fused_ln_mlp_residual(x, a, *p)
    want = ffn.fused_ln_mlp_residual_reference(x, a, *p)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_kernel_refuses_offset_views(dev, dtype):
    """x one element into a larger buffer, and b1 likewise, are no longer
    refused: the wrapper hands K3 aligned copies of them, so the card runs
    K3 on the same values as with fresh tensors, bit for bit, and matches
    the plain version."""
    n, c = 37, 96
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n, c), generator=g, device=dev).to(dtype)
    a = (torch.randn((n, c), generator=g, device=dev) * 0.5).to(dtype)
    p = [torch.randn(c, generator=g, device=dev) * 0.1 + 1,
         torch.randn(c, generator=g, device=dev) * 0.1,
         torch.randn((4 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(4 * c, generator=g, device=dev) * 0.02,
         torch.randn((c, 4 * c), generator=g, device=dev) * (4 * c) ** -0.5,
         torch.randn(c, generator=g, device=dev) * 0.02]
    x_off = torch.empty(n * c + 1, dtype=dtype, device=dev)[1:].view(n, c)
    x_off.copy_(x)
    b1_off = torch.empty(4 * c + 1, device=dev)[1:]
    b1_off.copy_(p[3])
    assert x_off.data_ptr() % 16 and b1_off.data_ptr() % 16
    q = [*p[:3], b1_off, *p[4:]]
    ffn.fused_ln_mlp_residual.launches = 0
    got = ffn.fused_ln_mlp_residual(x_off, a, *q)
    fresh = ffn.fused_ln_mlp_residual(x, a, *p)
    torch.cuda.synchronize()
    assert ffn.fused_ln_mlp_residual.launches == 2
    assert torch.equal(got, fresh)
    _assert_close(got, ffn.fused_ln_mlp_residual_reference(x, a, *p), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_offset_views_launch_the_kernel_on_aligned_copies(dev, name, dtype):
    """Every tensor argument a view off a 16-byte boundary: the wrapper
    launches its kernel (no misaligned address) on aligned copies and gets
    bit for bit what it gets on fresh tensors, which the card suite holds
    against the plain versions (attn_dots takes bf16 in both cases)."""
    fn, _, args, kw = wrapper_case(name, dtype, dev)
    fn.launches = 0
    got = outputs(fn(*(offset_view(a) for a in args), **kw))
    fresh = outputs(fn(*args, **kw))
    torch.cuda.synchronize()
    assert fn.launches == 2
    for a, b in zip(got, fresh):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", BWD_GEOMS)
def test_window_attn_kernel_repeats_exactly(dev, dtype, attn_f32, ws, ss, grid, c, nh):
    """K2, its projections on gemm_mma.cuh's tiles with the bias epilogue:
    two calls bit-identical, one launch each (T = 49: ragged rows)."""
    g = torch.Generator(device=dev).manual_seed(13)
    t = ws * ws
    bnw = 3 * grid[0] * grid[1]
    x = torch.randn((bnw, t, c), generator=g, device=dev).to(dtype)
    p = (torch.randn((3 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(3 * c, generator=g, device=dev) * 0.02,
         torch.randn((c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(c, generator=g, device=dev) * 0.02,
         torch.randn((nh, t, t), generator=g, device=dev) * 0.5)
    kw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=attn_f32)
    window_attn.fused_window_attention.launches = 0
    got = window_attn.fused_window_attention(x, *p, **kw)
    again = window_attn.fused_window_attention(x, *p, **kw)
    want = window_attn.fused_window_attention_reference(x, *p, **kw)
    torch.cuda.synchronize()
    assert window_attn.fused_window_attention.launches == 2
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attn_gemm_resources(dev, dtype):
    """No tile of K2's projections (gemm_mma.cuh, bias epilogue; K6's qkv
    recompute instantiates the same kernel) spills, and every one holds two
    blocks per SM."""
    info = window_attn.window_attention_gemm_info(dtype)
    assert len(info) == (1 if dtype == torch.float32 else 2), info
    for name, i in info.items():
        assert i["spill_bytes"] == 0 and i["blocks_per_sm"] >= 2, (name, i)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_gemm_resources(dev, dtype):
    """No K3 GEMM kernel spills, and every one holds two blocks per SM, as
    the design states (bf16 128 x 128: 108 KB of shared memory a block;
    float32 64 x 128: 96 KB)."""
    for name, info in ffn.ffn_info(128, 512, dtype).items():
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 2, (name, info)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("output_type", ["argmax", "class_prob"])
def test_epilogue_kernel(dev, dtype, output_type):
    g = torch.Generator(device=dev).manual_seed(3)
    lg = (torch.randn((3, 7, 16, 16), generator=g, device=dev) * 3).to(dtype)
    got = epilogue.upsample_crop_convert(lg, margin=8, output_type=output_type)
    want = epilogue.upsample_crop_convert_reference(lg, margin=8, output_type=output_type)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.uint8
    if output_type == "argmax":
        assert (got != want).float().mean().item() <= 1e-3
    else:
        assert (got.int() - want.int()).abs().max().item() <= 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn((4, 144, 64), device=dev)
    w = torch.randn((192, 64), device=dev)
    with pytest.raises(ValueError):  # head dim 16
        window_attn.fused_window_attention(
            x, w, w[:, 0], w[:64], w[:64, 0], torch.zeros((4, 144, 144), device=dev),
            num_heads=4, window_size=12, shift_size=0, grid_hw=(2, 2))
    with pytest.raises(ValueError):  # float16
        prep.fused_ln_shift_partition(torch.randn((1, 12, 12, 32), device=dev).half(),
                                      torch.ones(32), torch.zeros(32), ws=12, ss=0)
    with pytest.raises(ValueError):  # odd H
        merge.fused_patch_merge(torch.randn((1, 7, 8, 32), device=dev), torch.ones(128),
                                torch.zeros(128), torch.ones((64, 128)))
    with pytest.raises(ValueError):  # float16
        window_attn.fused_window_attention_backward(
            x.half(), x.half(), w, w[:, 0], w[:64], w[:64, 0],
            torch.zeros((2, 144, 144), device=dev), num_heads=2, window_size=12,
            shift_size=0, grid_hw=(2, 2))


def test_swin_micro_model_on_the_card_matches_cpu(dev):
    from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu_torch.models.layers import init_weights
    from flair_for_aigle_tpu_torch.zonal.model_utils import prepare_model_config

    cfg = prepare_model_config({
        "model_weights": "", "monotemp_arch": "swin_micro_patch4_window12_384-upernet",
        "modalities": {"inputs": {"AERIAL_RGBI": True}, "AERIAL_RGBI": {"channels": [1, 2, 3]}},
        "tasks": [{"name": "T", "active": True, "class_names": ["a", "b", "c", "d", "e"]}]})
    cfg["zonal_stride4_logits"] = True
    model = init_weights(FlairHubModel(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    batch = {"AERIAL_RGBI": x, "T": torch.zeros(2, 1, 64, 64)}
    with torch.no_grad():
        want = model(batch)[0]["T"]
        model.to(dev)
        got = model({k: v.to(dev) for k, v in batch.items()})[0]["T"].cpu()
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,out_c", [((2, 16, 16, 128), 256), ((1, 8, 12, 96), 192),
                                         ((3, 6, 6, 512), 1024)])
def test_merge_kernel(dev, dtype, shape, out_c):
    g = torch.Generator(device=dev).manual_seed(4)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    p = (torch.randn(4 * c, generator=g, device=dev) * 0.1 + 1,
         torch.randn(4 * c, generator=g, device=dev) * 0.1,
         torch.randn((out_c, 4 * c), generator=g, device=dev) * (4 * c) ** -0.5)
    merge.fused_patch_merge.launches = 0
    got = merge.fused_patch_merge(x, *p)
    want = merge.fused_patch_merge_reference(x, *p)
    torch.cuda.synchronize()
    assert merge.fused_patch_merge.launches == 1
    _assert_close(got, want, dtype)


def _assert_grads_close(got, want, dtype):
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            assert (a - b).abs().max().item() <= 2e-3 * max(b.abs().max().item(), 1e-6)
        else:
            assert ((a - b).abs() / b.abs().clamp(min=1e-2)).median().item() < 0.04


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", BWD_GEOMS)
def test_window_attn_backward_kernel(dev, dtype, attn_f32, ws, ss, grid, c, nh):
    g = torch.Generator(device=dev).manual_seed(5)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    x = torch.randn((bnw, t, c), generator=g, device=dev).to(dtype)
    gy = torch.randn((bnw, t, c), generator=g, device=dev).to(dtype)
    p = (torch.randn((3 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(3 * c, generator=g, device=dev) * 0.02,
         torch.randn((c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(c, generator=g, device=dev) * 0.02,
         torch.randn((nh, t, t), generator=g, device=dev) * 0.5)
    kw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=attn_f32)
    window_attn.fused_window_attention_backward.launches = 0
    got = window_attn.fused_window_attention_backward(gy, x, *p, **kw)
    want = window_attn.fused_window_attention_backward_reference(gy, x, *p, **kw)
    torch.cuda.synchronize()
    assert window_attn.fused_window_attention_backward.launches == 1
    assert [a.shape for a in got] == [a.shape for a in want]
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_kernel_repeats_exactly(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(6)
    c, nh = 256, 8
    x, gy = (torch.randn((8, 144, c), generator=g, device=dev).to(dtype) for _ in range(2))
    p = (torch.randn((3 * c, c), generator=g, device=dev) * c ** -0.5,
         torch.randn(3 * c, generator=g, device=dev), torch.randn((c, c), generator=g, device=dev),
         torch.randn(c, generator=g, device=dev), torch.randn((nh, 144, 144), generator=g, device=dev))
    kw = dict(num_heads=nh, window_size=12, shift_size=6, grid_hw=(2, 2))
    a = window_attn.fused_window_attention_backward(gy, x, *p, **kw)
    b = window_attn.fused_window_attention_backward(gy, x, *p, **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def _ulps(ref, n):
    return n * 2.0 ** -7 * ref.float().abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", BWD_GEOMS)
def test_window_attn_bwd_core_kernel(dev, dtype, attn_f32, ws, ss, grid, c, nh):
    """K6's attention core alone against its plain version; two calls
    bit-identical (no atomics, fixed-order sums), one launch each. float32
    (the 3xTF32 core): every output within 1e-4 of its largest magnitude.
    bf16: both round where the Pallas body rounds; the kernel sums in
    another float32 order and takes dq, dk as three exact bf16 products of
    ds's split: o at most 1 % differing and 4 bf16 units at its largest
    magnitude (K2's core), dq, dk, dv 4 units at each one's largest
    magnitude, dbias and dbqkv (float32) 1e-4 of their largest magnitude;
    dbias without attn_f32 4 bf16 units there: its scores are rounded to
    bf16, and a score whose tensor-core float32 sum differs from the plain
    version's in the last bit can round to the neighbouring bf16 value
    (chip_smoke.py bwd_core_errors)."""
    g = torch.Generator(device=dev).manual_seed(11)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    qkv = torch.randn((bnw * t, 3 * c), generator=g, device=dev).to(dtype)
    do = torch.randn((bnw * t, c), generator=g, device=dev).to(dtype)
    bias = torch.randn((nh, t, t), generator=g, device=dev) * 0.5
    kw = dict(num_heads=nh, window_size=ws, shift_size=ss, grid_hw=grid, attn_f32=attn_f32)
    window_attn.window_attention_core_backward.launches = 0
    got = window_attn.window_attention_core_backward(qkv, do, bias, **kw)
    again = window_attn.window_attention_core_backward(qkv, do, bias, **kw)
    want = window_attn.window_attention_core_backward_reference(qkv, do, bias, **kw)
    torch.cuda.synchronize()
    assert window_attn.window_attention_core_backward.launches == 2
    assert [a.shape for a in got] == [a.shape for a in want]
    assert [a.dtype for a in got] == [a.dtype for a in want]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    o, dqkv, dbias, dbqkv = got

    def rel(ref):
        return 1e-4 * ref.abs().max().item()

    act = rel if dtype == torch.float32 else (lambda ref: _ulps(ref, 4))
    if dtype == torch.bfloat16:
        assert (o != want[0]).float().mean().item() <= 0.01
    pairs = [(o, want[0], act(want[0]))]
    pairs += [(dqkv[:, i * c:(i + 1) * c], want[1][:, i * c:(i + 1) * c],
               act(want[1][:, i * c:(i + 1) * c])) for i in range(3)]
    pairs += [(dbias, want[2], rel(want[2]) if attn_f32 or dtype == torch.float32
               else _ulps(want[2], 4)),
              (dbqkv, want[3], rel(want[3]))]
    for a, b, tol in pairs:
        assert torch.isfinite(a.float()).all()
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
def test_window_attn_bwd_core_passes_agree_on_p(dev, dtype, attn_f32):
    """Pass K recomputes each score as K Q^T, the transposed product of
    pass Q's Q K^T, and must round it, and so p, as pass Q does: p read out
    of both passes (bf16 pc; float32 p as the tensor cores take it) is
    bit-identical (T = 144, shifted windows)."""
    from chip_smoke import core_p_readouts

    g = torch.Generator(device=dev).manual_seed(12)
    ws, grid, c, nh = 12, (2, 3), 128, 4
    t = ws * ws
    bnw = grid[0] * grid[1]
    qkv = torch.randn((bnw * t, 3 * c), generator=g, device=dev).to(dtype)
    bias = torch.randn((nh, t, t), generator=g, device=dev) * 0.5
    pq, pk = core_p_readouts(qkv, bias, nh, window_size=ws, shift_size=6, grid_hw=grid,
                             attn_f32=attn_f32)
    assert torch.equal(pq, pk)


@pytest.mark.parametrize("dtype,warps", [(torch.bfloat16, 16), (torch.float32, 9)])
@pytest.mark.parametrize("attn_f32", [True, False])
def test_window_attn_bwd_core_resources(dev, attn_f32, dtype, warps):
    """At T = 144 K6's cores spill nothing and keep their design's warps
    resident per SM: the bf16 core at least 16 (two blocks of 9), the
    float32 core 9 (one block of 9 warps: 144 KB of float32 rows and rings)."""
    info = window_attn.window_attention_core_backward_info(144, attn_f32, dtype)
    assert info["spill_bytes"] == 0 and info["warps_per_sm"] >= warps, info


def test_swin_ops_pass_gradients_on_the_card(dev):
    """Every parameter of a shifted swin block and a patch merge gets the
    gradient the CPU computes (the kernel wrappers are differentiable)."""
    from flair_for_aigle_tpu_torch.models.layers import init_weights
    from flair_for_aigle_tpu_torch.models.swin import PatchMerging, SwinBlock

    torch.manual_seed(0)
    for mod, shape in ((SwinBlock(128, 4, 12, shift=True), (2, 20, 28, 128)),
                       (PatchMerging(128, 256), (2, 16, 16, 128))):
        init_weights(mod, torch.Generator().manual_seed(1))
        for p in mod.parameters():  # no zero-initialised parameter
            p.data.add_(torch.randn(p.shape) * 0.02)
        x = torch.randn(shape)
        r = torch.randn_like(mod(x))
        grads = {}
        for d in ("cpu", dev):
            mod.to(d).zero_grad()
            xd = x.to(d).detach().requires_grad_()
            (mod(xd) * r.to(d)).sum().backward()
            # copies: moving the module to the card moves the CPU .grad too
            grads[str(d)] = {n: p.grad.to("cpu", copy=True) for n, p in mod.named_parameters()}
            grads[str(d)]["x"] = xd.grad.to("cpu", copy=True)
        for n, want in grads["cpu"].items():
            got = grads[str(dev)][n]
            assert got.abs().max() > 0, n
            _assert_close(got, want, torch.float32)


def test_training_step_on_the_card_matches_cpu(dev):
    """One training-mode loss + gradients of swin_micro-upernet through the
    kernels (K1, K2 + K6, K3, K5) against the CPU's plain versions."""
    from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu_torch.models.layers import init_weights
    from flair_for_aigle_tpu_torch.train.optim import make_optimizer
    from flair_for_aigle_tpu_torch.train.task import make_steps
    from flair_for_aigle_tpu_torch.zonal.model_utils import prepare_model_config

    cfg = prepare_model_config({
        "model_weights": "", "monotemp_arch": "swin_micro_patch4_window12_384-upernet",
        "modalities": {"inputs": {"AERIAL_RGBI": True}, "AERIAL_RGBI": {"channels": [1, 2, 3]}},
        "tasks": [{"name": "T", "active": True, "class_names": ["a", "b", "c", "d", "e"]}]})
    cfg["labels_configs"]["T"]["value_weights"] = {"default": 1}
    cfg["modalities"]["aux_loss"] = {}
    cfg["hyperparams"] = {"optimizer": "adamw", "learning_rate": 1e-4}
    rng = torch.Generator().manual_seed(2)
    batch = {"AERIAL_RGBI": torch.randn((2, 3, 64, 64), generator=rng).numpy(),
             "T": torch.nn.functional.one_hot(torch.randint(0, 5, (2, 64, 64), generator=rng),
                                              5).permute(0, 3, 1, 2).float().numpy()}
    out = {}
    for d in ("cpu", dev):
        model = init_weights(FlairHubModel(cfg), torch.Generator().manual_seed(0)).to(d)
        steps = make_steps(model, cfg, make_optimizer(cfg["hyperparams"], model.parameters()), d)
        loss, grads, _, _ = steps.loss_and_grads(batch)
        out[str(d)] = (loss.item(), torch.cat([g.flatten().cpu() for g in grads]))
    (l0, g0), (l1, g1) = out["cpu"], out[str(dev)]
    assert abs(l0 - l1) <= 1e-4 * abs(l0)
    assert torch.nn.functional.cosine_similarity(g0, g1, dim=0).item() >= 0.9999


# swin-base@512 stages at batch 2 (H = W, C; window 12, shift 6) and an odd
# padded geometry with a small window
FINISH_GEOMS = [(128, 128, 128, 12, 6), (64, 64, 256, 12, 6), (32, 32, 512, 12, 6),
                (16, 16, 1024, 12, 6), (20, 28, 96, 4, 2)]


def _ffn_params(g, dev, c):
    return (torch.randn(c, generator=g, device=dev) * 0.1 + 1,
            torch.randn(c, generator=g, device=dev) * 0.1,
            torch.randn((4 * c, c), generator=g, device=dev) * c ** -0.5,
            torch.randn(4 * c, generator=g, device=dev) * 0.02,
            torch.randn((c, 4 * c), generator=g, device=dev) * (4 * c) ** -0.5,
            torch.randn(c, generator=g, device=dev) * 0.02)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w,c,ws,ss", FINISH_GEOMS)
def test_finish_kernel(dev, dtype, h, w, c, ws, ss):
    g = torch.Generator(device=dev).manual_seed(7)
    nw = -(-h // ws) * -(-w // ws)
    win = torch.randn((2 * nw, ws * ws, c), generator=g, device=dev).to(dtype)
    x = torch.randn((2, h, w, c), generator=g, device=dev).to(dtype)
    p = _ffn_params(g, dev, c)
    finish.fused_reverse_ln_mlp_residual.launches = 0
    got = finish.fused_reverse_ln_mlp_residual(win, x, *p, ws=ws, ss=ss)
    want = finish.fused_reverse_ln_mlp_residual_reference(win, x, *p, ws=ws, ss=ss)
    torch.cuda.synchronize()
    assert finish.fused_reverse_ln_mlp_residual.launches == 1
    assert got.shape == x.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c", [(32768, 128), (8192, 256), (2048, 512), (512, 1024), (37, 96)])
def test_ffn_backward_kernel(dev, dtype, n, c):
    g = torch.Generator(device=dev).manual_seed(8)
    x, a, gy = (torch.randn((n, c), generator=g, device=dev).to(dtype) for _ in range(3))
    s, b, w1, b1, w2, _ = _ffn_params(g, dev, c)
    ffn.fused_ln_mlp_residual_backward.launches = 0
    got = ffn.fused_ln_mlp_residual_backward(gy, x, a, s, b, w1, b1, w2)
    want = ffn.fused_ln_mlp_residual_backward_reference(x, a, s, b, w1, b1, w2, gy)
    torch.cuda.synchronize()
    assert ffn.fused_ln_mlp_residual_backward.launches == 1
    assert [t.shape for t in got] == [t.shape for t in want]
    assert [t.dtype for t in got] == [t.dtype for t in want]
    _assert_grads_close(got, want, dtype)
    again = ffn.fused_ln_mlp_residual_backward(gy, x, a, s, b, w1, b1, w2)
    assert all(torch.equal(u, v) for u, v in zip(got, again))  # no atomics


@pytest.mark.parametrize("switch", ["FLAIR_SWIN_FINISH", "FLAIR_FFN_BWD"])
def test_swin_block_switches_on_the_card_match_cpu(dev, switch, monkeypatch):
    """A shifted, padded swin block under each of the reference's fused-block
    switches: forward and every gradient on the card (K8, or K7 in the
    backward) against the CPU's plain versions."""
    from flair_for_aigle_tpu_torch.models.layers import init_weights
    from flair_for_aigle_tpu_torch.models.swin import SwinBlock

    monkeypatch.setenv(switch, "1" if switch == "FLAIR_SWIN_FINISH" else "kernel")
    mod = init_weights(SwinBlock(128, 4, 12, shift=True), torch.Generator().manual_seed(1))
    for p in mod.parameters():  # no zero-initialised parameter
        p.data.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(2)) * 0.02)
    x = torch.randn((2, 20, 28, 128), generator=torch.Generator().manual_seed(3))
    r = torch.randn((2, 20, 28, 128), generator=torch.Generator().manual_seed(4))
    out, grads = {}, {}
    for d in ("cpu", dev):
        mod.to(d).zero_grad()
        xd = x.to(d).detach().requires_grad_()
        finish.fused_reverse_ln_mlp_residual.launches = 0
        ffn.fused_ln_mlp_residual_backward.launches = 0
        y = mod(xd)
        (y * r.to(d)).sum().backward()
        out[str(d)] = y.detach().to("cpu", copy=True)
        grads[str(d)] = {n: p.grad.to("cpu", copy=True) for n, p in mod.named_parameters()}
        grads[str(d)]["x"] = xd.grad.to("cpu", copy=True)
    launches = (finish.fused_reverse_ln_mlp_residual.launches
                if switch == "FLAIR_SWIN_FINISH" else ffn.fused_ln_mlp_residual_backward.launches)
    assert launches == 1
    _assert_close(out[str(dev)], out["cpu"], torch.float32)
    for n, want in grads["cpu"].items():
        _assert_close(grads[str(dev)][n], want, torch.float32)


@pytest.mark.parametrize("bw", [1, 2])
@pytest.mark.parametrize("c,nh", [(128, 4), (256, 8)])
def test_attn_dots_kernels(dev, c, nh, bw):
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((4, 144, c), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    want = attn_dots.attn_dots_reference(q, k, v, num_heads=nh)
    got = {}
    for fn in (attn_dots.attn_dots_per_head, attn_dots.attn_dots_grouped):
        fn.launches = 0
        a = fn(q, k, v, num_heads=nh, bw=bw)
        b = fn(q, k, v, num_heads=nh, bw=bw)
        torch.cuda.synchronize()
        assert fn.launches == 2
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        assert torch.equal(a, b)
        _assert_close(a, want, torch.bfloat16, bf16_ulps=1)
        got[fn.__name__] = a
    assert torch.equal(got["attn_dots_per_head"], got["attn_dots_grouped"])


def test_attn_dots_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 144, 128), device=dev, dtype=torch.bfloat16)
    for fn in (attn_dots.attn_dots_per_head, attn_dots.attn_dots_grouped):
        with pytest.raises(ValueError):  # float32
            fn(x.float(), x.float(), x.float(), num_heads=4)
        with pytest.raises(ValueError):  # head dim 64
            fn(x, x, x, num_heads=2)
        y = x[:, :64].contiguous()
        with pytest.raises(ValueError):  # T = 64
            fn(y, y, y, num_heads=4)
        with pytest.raises(ValueError):  # 4 windows, 3 per block
            fn(x, x, x, num_heads=4, bw=3)


# K6's products alone: (M, K, N) of rnd(a b^T) (do, dx; b the weight's
# transposed copy), (K, M, N) of a^T b (dWproj, dWqkv), ragged against the
# tiles; 17000 rows take bf16's 128 x 128 tile
ROUND_SHAPES = [(392, 384, 128), (1000, 96, 96), (17000, 128, 128), (200, 1024, 512)]
WGRAD_SHAPES = [(392, 384, 128), (5001, 256, 256), (1152, 1024, 1024), (77, 96, 96)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wgrad,shape", [(False, s) for s in ROUND_SHAPES]
                         + [(True, s) for s in WGRAD_SHAPES])
def test_window_attn_backward_gemm_matches_float64(dev, dtype, wgrad, shape):
    """One of K6's products on gemm_mma.cuh against the float64 product of
    the same (rounded) inputs: float32 (3xTF32) and the float32 weight
    gradients within 1e-4 of the largest magnitude, bf16 do / dx within one
    bf16 unit there; two calls bit-identical."""
    g = torch.Generator(device=dev).manual_seed(11)
    d0, d1, d2 = shape
    a = torch.randn((d0, d1), generator=g, device=dev).to(dtype)
    b = torch.randn((d0, d2) if wgrad else (d2, d1), generator=g, device=dev).to(dtype)
    window_attn.backward_gemm.launches = 0
    got = window_attn.backward_gemm(a, b, wgrad=wgrad)
    again = window_attn.backward_gemm(a, b, wgrad=wgrad)
    torch.cuda.synchronize()
    assert window_attn.backward_gemm.launches == 2
    want = (a.double().t() @ b.double()) if wgrad else (a.double() @ b.double().t())
    assert got.shape == want.shape
    assert got.dtype == (torch.float32 if wgrad else dtype)
    assert torch.equal(got, again)
    _assert_close(got, want, torch.float32 if wgrad else dtype, bf16_ulps=1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attn_backward_gemm_resources(dev, dtype):
    """No kernel of K6's products (the rounding epilogue at every tile of
    the dtype's plan, the weight gradients at theirs) spills, and every one
    holds two blocks per SM."""
    info = window_attn.window_attention_backward_gemm_info(dtype)
    assert len(info) == (2 if dtype == torch.float32 else 3), info
    for name, i in info.items():
        assert i["spill_bytes"] == 0 and i["blocks_per_sm"] >= 2, (name, i)


# swin-base@512's stages at batch 16: (windows, C, heads)
DOTS_STAGES = [(16 * 121, 128, 4), (16 * 36, 256, 8), (16 * 9, 512, 16), (16 * 4, 1024, 32)]


@pytest.mark.parametrize("bw", [1, 4])
@pytest.mark.parametrize("bnw,c,nh", DOTS_STAGES)
def test_attn_dots_kernels_at_the_stage_geometries(dev, bnw, c, nh, bw):
    """Both A/B kernels at a stage's geometry against their plain version
    (one bf16 unit at the largest magnitude), bit-identical to each other
    and from call to call."""
    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn((bnw, 144, c), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    want = attn_dots.attn_dots_reference(q, k, v, num_heads=nh)
    got = {}
    for fn in (attn_dots.attn_dots_per_head, attn_dots.attn_dots_grouped):
        a = fn(q, k, v, num_heads=nh, bw=bw)
        assert torch.equal(a, fn(q, k, v, num_heads=nh, bw=bw))
        _assert_close(a, want, torch.bfloat16, bf16_ulps=1)
        got[fn.__name__] = a
    assert torch.equal(got["attn_dots_per_head"], got["attn_dots_grouped"])


@pytest.mark.parametrize("grouped,blocks", [(False, 3), (True, 2)])
def test_attn_dots_resources(dev, grouped, blocks):
    """No spill; per head (two stages of 69 KB) three blocks per SM,
    grouped (one stage of 108 KB, swizzled rows) two."""
    info = attn_dots.attn_dots_info(grouped)
    assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= blocks, info
