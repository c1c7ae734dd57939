"""K2's and K6's float32 products on the card's precision scheme, and
their GEMM plans, on the CPU.

On the card K2's qkv and output projections and all of K6's products (its
qkv recompute, do = g Wproj, dx = dqkv Wqkv, dWproj = g^T o and dWqkv =
dqkv^T x) run ``csrc/gemm_mma.cuh``'s tensor-core GEMM, in float32 as
3xTF32 (about 2^-21 of each product). Here that scheme is emulated on the
plain versions by patching ``torch.matmul`` with ``tests/_tf32.py``'s
``matmul_3xtf32`` over the projections alone (``window_attn._linear``),
the core left exact: K2's plain version against the Pallas kernel in
interpret mode at 2e-5 (tests/test_window_attn_kernel.py's float32 bound)
and within 1e-5 of the exact plain version's largest magnitude, as
tests/test_torch_ffn_3xtf32.py holds K3. K6's plain backward (autograd
through the plain forward) takes the emulated product forward and, in one
test, the exact products backward (the qkv recompute alone), in another
the emulated products backward too (do, dx and both weight gradients, as
the card takes them): each against the Pallas backward in interpret mode,
and within 1e-5 of the exact plain backward, gradient by gradient.

``attn_gemm_tiles`` and ``_bwd_plan`` are Python, so their promises are
checked here: at swin-base's four stages at batch 2, 5 and 16 every
projection gives the H100's 132 SMs a block with the largest such tile of
its dtype, at the full K; and each weight gradient's chunks of whole
pipeline steps cover K exactly once and give every SM a block, within one
wave of resident blocks unless that would make a partial longer than
``WGRAD_ROWS`` rows, with the partials' buffer sized from the plan.
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
    float32 products backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_3xtf32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w, g.t() @ x


class _Products3xTF32(_Product3xTF32):
    """The same, with the products backward on 3xTF32 too: K6's do and dx
    (g w) and weight gradients (g^T x) as the card's GEMM takes them."""

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return matmul_3xtf32(g, w), matmul_3xtf32(g.t(), x)


def _linear_3xtf32(x, w, b, product=_Product3xTF32):
    """``window_attn._linear`` with its product on 3xTF32."""
    with mock.patch.object(torch, "matmul", lambda a, bt: product.apply(a, bt.t())):
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


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,c,nh,shift", GEOMS)
def test_3xtf32_backward_products_match_pallas_and_the_exact_plain_version(
        ws, c, nh, shift, attn_f32):
    """K6's float32 scheme whole: the qkv recompute, do, dx, dWproj and
    dWqkv all on 3xTF32 (the core exact)."""
    vals = _case(ws, c, nh, 200 + ws + c + shift)
    kw = dict(num_heads=nh, window_size=ws, shift_size=shift, grid_hw=(2, 2), attn_f32=attn_f32)
    jargs = tuple(jnp.asarray(v.copy()) for v in vals[:6])
    want = jwa._kernel_bwd(jargs, jnp.asarray(vals[6].copy()), interpret=True, **kw)
    want = [np.asarray(v, np.float32) for v in want]
    want[1], want[3] = want[1].T, want[3].T           # (C, 3C) -> nn.Linear (3C, C)
    port = _port(vals)
    g = torch.from_numpy(vals[6].copy())
    with mock.patch.object(window_attn, "_linear",
                           lambda x, w, b: _linear_3xtf32(x, w, b, _Products3xTF32)):
        got = window_attn.fused_window_attention_backward_reference(g, *port, **kw)
    exact = window_attn.fused_window_attention_backward_reference(g, *port, **kw)
    for name, a, e, w in zip(NAMES, got, exact, want):
        a, e = a.numpy(), e.numpy()
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, rtol=2e-5, atol=2e-5, err_msg=name)
        assert np.abs(a - e).max() <= 1e-5 * np.abs(e).max(), name
    # the emulation rounds the backward products: dx and the weight
    # gradients are not the exact ones
    for i in (0, 1, 3):
        assert not np.array_equal(got[i].numpy(), exact[i].numpy()), NAMES[i]


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



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 5, 16])  # zonal pairs, training, zonal batch
def test_backward_plan_splits_the_weight_gradients_into_whole_steps(batch, dtype):
    """K6's plan at swin-base's stages: dWproj (C, C) and dWqkv (3C, C) on
    the weight gradients' tile, K = B*nW*T cut into chunks of whole pipeline
    steps that cover it exactly once (the last one ragged), every SM a
    block and no more than one wave of the kernel's resident blocks unless
    the chunks are at ``WGRAD_ROWS``, the longest a partial may be; do and
    dx take K2's output-projection tile; the partials' buffer holds every
    partial of both weight gradients and dbproj's column sums."""
    step = mma_plan.K_STEP[dtype]
    slots = mma_plan.RESIDENT * H100_SMS
    for hw, c in STAGES:
        nh = c // 32
        bnw = batch * (-(-hw // 12)) ** 2
        m = bnw * 144
        plan = window_attn._bwd_plan(bnw, nh, 144, c, H100_SMS, 4 * H100_SMS, dtype)
        assert (plan.tile_qkv, plan.tile_proj) == window_attn.attn_gemm_tiles(m, c, H100_SMS,
                                                                              dtype)
        assert plan.tile_w == mma_plan.WGRAD_TILE
        need = 0
        for rows, k_chunk in ((c, plan.k_chunk_proj), (3 * c, plan.k_chunk_qkv)):
            assert k_chunk % step == 0, (hw, rows)
            parts = -(-m // k_chunk)
            ranges = [(z * k_chunk, min(m, (z + 1) * k_chunk)) for z in range(parts)]
            assert ranges[0][0] == 0 and ranges[-1][1] == m
            assert all(a < b for a, b in ranges)
            assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
            blocks = _tiles(rows, c, plan.tile_w) * parts
            assert H100_SMS <= blocks, (hw, rows, blocks)
            assert k_chunk <= mma_plan.WGRAD_ROWS, (hw, rows, k_chunk)
            assert (blocks <= max(slots, _tiles(rows, c, plan.tile_w))
                    or k_chunk == mma_plan.WGRAD_ROWS), (hw, rows, blocks)
            assert mma_plan.wgrad_plan(rows, c, m, H100_SMS, dtype) == (plan.tile_w, k_chunk,
                                                                        parts)
            need = max(need, parts * rows * c)
        assert plan.wpart == need
        assert plan.wpart >= -(-m // plan.k_chunk_proj) * c  # dbproj's column sums
