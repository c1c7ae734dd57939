"""The CUDA kernels of flair_for_aigle_tpu_torch against their plain
PyTorch versions, on the card. Every test skips without a CUDA device.

Run on a machine with a card (the repository's conftest imports jax, which
these tests do not need):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Shapes are small and cover what the full-size smoke run (chip_smoke.py)
does not: windows smaller than 12 (T = 64, 16, 4, as swin at small inputs
clamps them), non-square window grids, odd token counts for the GEMM edges,
and the whole swin_micro-upernet model on the card against the CPU.
Tolerances: float32 1e-4 relative to the largest reference magnitude;
bfloat16 4 units in the last place at that magnitude (1 for the prologue).
"""

import pytest
import torch

from flair_for_aigle_tpu_torch.ops import epilogue, ffn, prep, window_attn

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,ss,grid,c,nh", [(12, 6, (2, 3), 128, 4), (8, 0, (1, 1), 256, 8),
                                            (4, 2, (3, 2), 96, 3), (2, 0, (1, 1), 1024, 32)])
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
@pytest.mark.parametrize("n,c", [(37, 128), (300, 96), (64, 1024)])
def test_ffn_kernel(dev, dtype, n, c):
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
    want = ffn.fused_ln_mlp_residual_reference(x, a, *p)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


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
