"""The attention core of K2 alone (flair_for_aigle_tpu_torch.ops.window_attn
``window_attention_core``): its plain version against the whole plain K2 and
against the Pallas window-attention kernel in interpret mode, on the same
numpy inputs. The float32 core's precision scheme, 3xTF32 (both products,
q k^T and e v, as a_lo b_hi + a_hi b_lo + a_hi b_hi of operands split into
tf32 halves, float32 accumulation), emulated on the plain core, against
both the Pallas kernel and the exact plain core.

The Pallas kernel has no core-only entry: with the output projection set to
the identity and its bias to 0, its output is its core's (the product with
the identity is exact in float32 and rounds back to the core's own values).
Tolerances as tests/test_window_attn_kernel.py uses them: 2e-5 for float32,
2e-3 for bfloat16.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.ops import window_attn
from tests._tf32 import matmul_3xtf32


def _inputs(seed: int, bnw: int, t: int, c: int, nh: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bnw, t, c)).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * c)) * 0.05).astype(np.float32)
    bqkv = (rng.normal(size=(3 * c,)) * 0.05).astype(np.float32)
    wproj = (rng.normal(size=(c, c)) * 0.05).astype(np.float32)
    bproj = (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(nh, t, t)) * 0.5).astype(np.float32)
    return x, wqkv, bqkv, wproj, bproj, bias


def _torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a.copy()).to(dtype)


@pytest.mark.parametrize("ws", [2, 4, 8, 12])
@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_between_the_projections_is_the_plain_k2(ws, half_shift, attn_f32, dtype):
    c, nh, grid = 64, 2, (2, 3)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    x, wqkv, bqkv, wproj, bproj, bias = _inputs(ws + 100 * half_shift, bnw, t, c, nh)
    kw = dict(num_heads=nh, window_size=ws, shift_size=ws // 2 if half_shift else 0,
              grid_hw=grid, attn_f32=attn_f32)
    xt = _torch(x, dtype)
    wq, bq, wp, bp, b = (_torch(a) for a in (wqkv.T, bqkv, wproj.T, bproj, bias))
    want = window_attn.fused_window_attention_reference(xt, wq, bq, wp, bp, b, **kw)
    qkv = window_attn._linear(xt.reshape(bnw * t, c), wq, bq)
    o = window_attn.window_attention_core_reference(qkv, b, **kw)
    assert o.shape == (bnw * t, c) and o.dtype == dtype
    got = window_attn._linear(o, wp, bp).reshape(bnw, t, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_plain_matches_pallas(dtype, attn_f32, shift):
    c, nh, ws, grid = 128, 4, 12, (2, 2)
    t = ws * ws
    bnw = grid[0] * grid[1]
    x, wqkv, bqkv, _, _, bias = _inputs(7 + shift + attn_f32, bnw, t, c, nh)
    eye, zero = np.eye(c, dtype=np.float32), np.zeros((c,), np.float32)
    kw = dict(num_heads=nh, window_size=ws, shift_size=shift, grid_hw=grid,
              attn_f32=attn_f32)
    want = jwa.fused_window_attention(
        jnp.asarray(x.copy()).astype(dtype), jnp.asarray(wqkv.copy()),
        jnp.asarray(bqkv.copy()), jnp.asarray(eye), jnp.asarray(zero),
        jnp.asarray(bias.copy()), interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32)).reshape(bnw * t, c)
    tdt = getattr(torch, dtype)
    qkv = window_attn._linear(_torch(x, tdt).reshape(bnw * t, c), _torch(wqkv.T),
                              _torch(bqkv))
    got = window_attn.window_attention_core_reference(qkv, _torch(bias), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    tol = 2e-5 if dtype == "float32" else 2e-3
    # bf16 scores: the interpret mode sums the bf16 probabilities of a row
    # into a denominator one bf16 unit away from the port's float32 sum
    # rounded once; without the output projection
    # to average it, that unit (<= 2^-7 relative) and the output's own
    # rounding (another unit) reach single outputs
    rtol = 2.0 ** -6 if dtype == "bfloat16" and not attn_f32 else tol
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=tol)


@pytest.mark.parametrize("attn_f32", [True, False])
def test_core_wrapper_takes_the_plain_version_on_cpu_tensors(attn_f32):
    c, nh, ws, grid = 64, 2, 4, (3, 2)
    t = ws * ws
    bnw = grid[0] * grid[1]
    rng = np.random.default_rng(3)
    qkv = _torch(rng.normal(size=(bnw * t, 3 * c)).astype(np.float32), torch.bfloat16)
    bias = _torch((rng.normal(size=(nh, t, t)) * 0.5).astype(np.float32))
    kw = dict(num_heads=nh, window_size=ws, shift_size=2, grid_hw=grid, attn_f32=attn_f32)
    window_attn.window_attention_core.launches = 0
    got = window_attn.window_attention_core(qkv, bias, **kw)
    assert window_attn.window_attention_core.launches == 0
    assert torch.equal(got, window_attn.window_attention_core_reference(qkv, bias, **kw))


def _core_3xtf32(qkv, bias, **kw):
    """The plain float32 core with both products (q k^T, e v) taken as
    3xTF32."""
    with mock.patch.object(torch, "matmul", matmul_3xtf32):
        return window_attn.window_attention_core_reference(qkv, bias, **kw)


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("ws", [4, 12])
def test_3xtf32_core_matches_pallas(ws, half_shift, attn_f32):
    """The float32 core's precision scheme is accurate enough for the
    Pallas kernel's float32 tolerance: the 3xTF32-emulated core against the
    kernel in interpret mode (identity output projection), 2e-5."""
    c, nh, grid = 128, 4, (2, 2)
    t = ws * ws
    bnw = grid[0] * grid[1]
    shift = ws // 2 if half_shift else 0
    x, wqkv, bqkv, _, _, bias = _inputs(17 + ws + half_shift + 2 * attn_f32, bnw, t, c, nh)
    eye, zero = np.eye(c, dtype=np.float32), np.zeros((c,), np.float32)
    kw = dict(num_heads=nh, window_size=ws, shift_size=shift, grid_hw=grid,
              attn_f32=attn_f32)
    want = jwa.fused_window_attention(
        jnp.asarray(x.copy()), jnp.asarray(wqkv.copy()), jnp.asarray(bqkv.copy()),
        jnp.asarray(eye), jnp.asarray(zero), jnp.asarray(bias.copy()), interpret=True, **kw)
    want = np.asarray(want, np.float32).reshape(bnw * t, c)
    qkv = window_attn._linear(_torch(x).reshape(bnw * t, c), _torch(wqkv.T), _torch(bqkv))
    got = _core_3xtf32(qkv, _torch(bias), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("ws", [4, 12])
def test_3xtf32_core_matches_the_exact_plain_core(ws, half_shift, attn_f32):
    """The 3xTF32 core against the plain float32 core: within 1e-4 of the
    largest magnitude, the bound the card tests hold the float32 kernel to
    (each product is off by about 2^-21 of its magnitude)."""
    c, nh, grid = 64, 2, (2, 3)
    t = ws * ws
    bnw = 2 * grid[0] * grid[1]
    rng = np.random.default_rng(ws + 10 * half_shift + 7 * attn_f32)
    qkv = _torch(rng.normal(size=(bnw * t, 3 * c)).astype(np.float32))
    bias = _torch((rng.normal(size=(nh, t, t)) * 0.5).astype(np.float32))
    kw = dict(num_heads=nh, window_size=ws, shift_size=ws // 2 if half_shift else 0,
              grid_hw=grid, attn_f32=attn_f32)
    want = window_attn.window_attention_core_reference(qkv, bias, **kw)
    got = _core_3xtf32(qkv, bias, **kw)
    assert not torch.equal(got, want)  # the emulation took effect
    tol = 1e-4 * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
