"""K2's and K6's float32 projections on the card's precision scheme, and
their GEMM plan, on the CPU.

On the card K2's qkv and output projections and K6's qkv recompute run
``csrc/gemm_mma.cuh``'s tensor-core GEMM with its bias epilogue, in
float32 as 3xTF32 (about 2^-21 of each product). Here that scheme is
emulated on the plain versions by patching ``torch.matmul`` with
``tests/_tf32.py``'s ``matmul_3xtf32`` over the projections alone
(``window_attn._linear``), the core left exact: K2's plain version against
the Pallas kernel in interpret mode at 2e-5 (tests/test_window_attn_kernel.py's
float32 bound) and within 1e-5 of the exact plain version's largest
magnitude, as tests/test_torch_ffn_3xtf32.py holds K3. K6's plain backward
(autograd through the plain forward) takes the emulated product forward and
the exact products backward, as the card does (K6's do, dx and weight
gradients stay exact float32): against the Pallas backward in interpret
mode, and within 1e-5 of the exact plain backward, gradient by gradient.

``attn_gemm_tiles`` is Python, so its promises are checked here: at
swin-base's four stages at batch 2, 5 and 16 every projection gives the
H100's 132 SMs a block with the largest such tile of its dtype, at the
full K.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.ops import mma_plan, window_attn
from tests._tf32 import matmul_3xtf32
from tests._torch_threads import few_torch_threads  # noqa: F401

_LINEAR = window_attn._linear
H100_SMS = 132
# swin-base@512's stages: (H = W, C)
STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]
NAMES = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]


class _Product3xTF32(torch.autograd.Function):
    """x w^T as the card's float32 GEMM takes it (3xTF32), with the exact
    float32 products backward (K6's do, dx and weight-gradient GEMMs)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_3xtf32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w, g.t() @ x


def _linear_3xtf32(x, w, b):
    """``window_attn._linear`` with its product on 3xTF32."""
    with mock.patch.object(torch, "matmul", lambda a, bt: _Product3xTF32.apply(a, bt.t())):
        return _LINEAR(x, w, b)


def _case(ws, c, nh, seed):
    rng = np.random.default_rng(seed)
    t, bnw = ws * ws, 2 * 2
    return [rng.normal(size=(bnw, t, c)).astype(np.float32),
            (rng.normal(size=(c, 3 * c)) * c ** -0.5).astype(np.float32),
            (rng.normal(size=(3 * c,)) * 0.05).astype(np.float32),
            (rng.normal(size=(c, c)) * c ** -0.5).astype(np.float32),
            (rng.normal(size=(c,)) * 0.05).astype(np.float32),
            (rng.normal(size=(nh, t, t)) * 0.5).astype(np.float32),
            rng.normal(size=(bnw, t, c)).astype(np.float32)]


def _port(vals):
    x, wqkv, bqkv, wproj, bproj, bias, _ = vals
    return [torch.from_numpy(v.copy()) for v in (x, wqkv.T, bqkv, wproj.T, bproj, bias)]


GEOMS = [(4, 128, 4, 0), (4, 128, 4, 2), (12, 64, 2, 6)]


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,c,nh,shift", GEOMS)
def test_3xtf32_projections_match_pallas_and_the_exact_plain_version(ws, c, nh, shift, attn_f32):
    vals = _case(ws, c, nh, ws + c + shift)
    kw = dict(num_heads=nh, window_size=ws, shift_size=shift, grid_hw=(2, 2), attn_f32=attn_f32)
    want = np.asarray(jwa.fused_window_attention(
        *(jnp.asarray(v.copy()) for v in vals[:6]), interpret=True, **kw))
    port = _port(vals)
    with mock.patch.object(window_attn, "_linear", _linear_3xtf32):
        got = window_attn.fused_window_attention_reference(*port, **kw).numpy()
    exact = window_attn.fused_window_attention_reference(*port, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()
    # the emulation rounds: it is not the exact product
    assert not np.array_equal(got, exact)


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,c,nh,shift", GEOMS)
def test_3xtf32_qkv_recompute_backward_matches_pallas_and_the_exact_plain_version(
        ws, c, nh, shift, attn_f32):
    vals = _case(ws, c, nh, 100 + ws + c + shift)
    kw = dict(num_heads=nh, window_size=ws, shift_size=shift, grid_hw=(2, 2), attn_f32=attn_f32)
    jargs = tuple(jnp.asarray(v.copy()) for v in vals[:6])
    want = jwa._kernel_bwd(jargs, jnp.asarray(vals[6].copy()), interpret=True, **kw)
    want = [np.asarray(v, np.float32) for v in want]
    want[1], want[3] = want[1].T, want[3].T           # (C, 3C) -> nn.Linear (3C, C)
    port = _port(vals)
    g = torch.from_numpy(vals[6].copy())
    with mock.patch.object(window_attn, "_linear", _linear_3xtf32):
        got = window_attn.fused_window_attention_backward_reference(g, *port, **kw)
    exact = window_attn.fused_window_attention_backward_reference(g, *port, **kw)
    for name, a, e, w in zip(NAMES, got, exact, want):
        a, e = a.numpy(), e.numpy()
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, rtol=2e-5, atol=2e-5, err_msg=name)
        assert np.abs(a - e).max() <= 1e-5 * np.abs(e).max(), name


def _tiles(m, n, code):
    bm, bn = mma_plan.MMA_TILES[code]
    return -(-m // bm) * -(-n // bn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 5, 16])  # zonal pairs, training, zonal batch
def test_projection_plan_gives_every_sm_a_block_with_the_largest_tile(batch, dtype):
    tiles = mma_plan.PLAN_TILES[dtype]
    for hw, c in STAGES:
        m = batch * (-(-hw // 12)) ** 2 * 144  # window rows: T = 144, padded grid
        codes = window_attn.attn_gemm_tiles(m, c, H100_SMS, dtype)
        for code, n in zip(codes, (3 * c, c)):  # qkv, proj
            assert code in tiles
            assert _tiles(m, n, code) >= H100_SMS, (batch, hw, n)
            bigger = tiles[:tiles.index(code)]
            assert all(_tiles(m, n, big) < H100_SMS for big in bigger), (batch, hw, n)
            # K is never split: the plan's k_chunk is the full K
            assert mma_plan.gemm_plan(m, n, c, H100_SMS, dtype) == (code, c, 1)

