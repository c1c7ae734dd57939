"""K2 plain version (flair_for_aigle_tpu_torch.ops.window_attn) vs the
Pallas window-attention kernel in interpret mode, and the port's
WindowAttention / SwinBlock modules vs the JAX modules through converted
weights, on the same numpy inputs.

Tolerances as tests/test_window_attn_kernel.py uses them: 2e-5 for float32,
2e-3 for bfloat16 (one to a few bf16 ulps at the outputs' scale; the
scores and softmax round to bf16 at several points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.swin import SwinBlock as JSwinBlock
from flair_for_aigle_tpu.models.swin import WindowAttention as JWindowAttention
from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.swin import SwinBlock, WindowAttention
from flair_for_aigle_tpu_torch.ops import window_attn
from flair_for_aigle_tpu_torch.ops.prep import window_partition, window_reverse

C, NH, WS = 128, 4, 12


@pytest.mark.parametrize("dtype,attn_f32", [("float32", True), ("float32", False),
                                            ("bfloat16", True), ("bfloat16", False)])
@pytest.mark.parametrize("shift", [0, 6])
def test_window_attention_plain_matches_pallas(shift, dtype, attn_f32):
    nwh = nww = 2
    bnw, t = nwh * nww, WS * WS
    rng = np.random.default_rng(shift + 10 * attn_f32)
    x = rng.normal(size=(bnw, t, C)).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * 0.05).astype(np.float32)
    bqkv = (rng.normal(size=(3 * C,)) * 0.05).astype(np.float32)
    wproj = (rng.normal(size=(C, C)) * 0.05).astype(np.float32)
    bproj = (rng.normal(size=(C,)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(NH, t, t)) * 0.5).astype(np.float32)
    kw = dict(num_heads=NH, window_size=WS, shift_size=shift, grid_hw=(nwh, nww),
              attn_f32=attn_f32)

    want = jwa.fused_window_attention(
        jnp.asarray(x.copy()).astype(dtype), jnp.asarray(wqkv.copy()),
        jnp.asarray(bqkv.copy()), jnp.asarray(wproj.copy()),
        jnp.asarray(bproj.copy()), jnp.asarray(bias.copy()), interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = window_attn.fused_window_attention(
        torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(wqkv.T.copy()),
        torch.from_numpy(bqkv.copy()), torch.from_numpy(wproj.T.copy()),
        torch.from_numpy(bproj.copy()), torch.from_numpy(bias.copy()), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    tol = 2e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_shift_mask_patterns_rebuild_the_bank():
    from flair_for_aigle_tpu_torch.models.swin import _shift_attn_mask
    from flair_for_aigle_tpu_torch.ops.window_attn import _grid_mask, shift_mask_bank

    for ws, ss, nwh, nww in [(12, 6, 2, 3), (4, 2, 3, 3)]:
        grid = _grid_mask(ws, ss, nwh, nww)
        # the arithmetic form equals timm's mask over the padded raster
        np.testing.assert_array_equal(grid, _shift_attn_mask(nwh * ws, nww * ws, ws, ss))
        bank = shift_mask_bank(ws, ss)
        for wi in range(nwh):
            for wj in range(nww):
                np.testing.assert_array_equal(
                    grid[wi * nww + wj], bank[(wi == nwh - 1) * 2 + (wj == nww - 1)])
        np.testing.assert_array_equal(bank, jwa.shift_mask_bank(ws, ss))


def _converted(variables) -> dict:
    return state_dict_from_flax(variables["params"])


@pytest.mark.parametrize("shift", [0, 6])
def test_window_attention_module_matches_jax(shift):
    # padded, pre-rolled raster through the XLA path of the JAX module
    y = np.random.default_rng(2).normal(size=(2, 24, 24, C)).astype(np.float32)
    jmod = JWindowAttention(dim=C, num_heads=NH, table_window=WS,
                            window_size=(WS, WS), shift_size=shift,
                            kernel_mode="off")
    variables = jmod.init(jax.random.key(1), jnp.asarray(y.copy()))
    want = np.asarray(jmod.apply(variables, jnp.asarray(y.copy())))
    tmod = WindowAttention(C, NH, WS)
    tmod.load_state_dict(_converted(variables), strict=True)
    with torch.no_grad():
        win = window_partition(torch.from_numpy(y.copy()), WS).contiguous()
        got = tmod(win, window_size=WS, shift_size=shift, grid_hw=(2, 2))
        got = window_reverse(got, WS, 24, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_swin_block_module_matches_jax():
    # 20 x 20: window 12 pads to 24 and shifts by 6
    x = np.random.default_rng(3).normal(size=(2, 20, 20, C)).astype(np.float32)
    jblk = JSwinBlock(dim=C, num_heads=NH, window_size=WS, shift=True,
                      kernel_mode="off")
    variables = jblk.init(jax.random.key(4), jnp.asarray(x.copy()))
    want = np.asarray(jblk.apply(variables, jnp.asarray(x.copy())))
    tblk = SwinBlock(C, NH, WS, shift=True)
    tblk.load_state_dict(_converted(variables), strict=True)
    with torch.no_grad():
        got = tblk(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
