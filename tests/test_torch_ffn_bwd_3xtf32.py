"""K7's float32 precision scheme and its plan, on the CPU.

On the card K7 takes its five float32 products (the fc1 recompute, dh =
g W2, dW2 = g^T h, dW1 = dh0c^T ln and dln = dh0c W1) as 3xTF32 on the
tensor cores (``csrc/gemm_mma.cuh``). Here that scheme is emulated on K7's
plain version by patching its one product helper (``ops/ffn.py _matmul``)
with ``tests/_tf32.py``'s ``matmul_3xtf32`` (tf32 rounding on the bits,
three products for each), and held against the Pallas backward in
interpret mode (``_kernel_bwd``, as ``tests/test_torch_ffn_bwd.py`` runs
it) at that file's float32 tolerance (1e-4), and against the exact plain
version within 1e-5 of each gradient's largest magnitude. The Pallas
backward takes row counts in multiples of 8 only, so an odd count runs it
on the next multiple of 8 with the output gradient 0 on the added rows
(they add nothing to any parameter gradient) and compares dx on the
leading rows.

``ops/ffn.py _bwd_plan`` (the products' tiles and their splits of K) is
Python, so its promises are checked here at swin-base@512's four stages
at batch 2 and 5 on 132 SMs: each split covers its K exactly once in whole
pipeline steps (the weight gradients' partials of at most
``WGRAD_ROWS`` rows), the partials' buffer is sized from the plan, fc1 takes
K3's tile (``mlp_plan``), and db1's partials are one per row block of the
dh product's tile.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import ffn as jffn
from flair_for_aigle_tpu_torch.ops import ffn, mma_plan
from tests._tf32 import matmul_3xtf32

NAMES = ["dx", "dattn", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"]
# swin-base@512's stages: (H = W, C); hidden = 4 C
STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]
H100_SMS = 132


def _inputs(seed, rows, padded, c):
    """The Pallas backward's inputs at ``padded`` rows (weights (C, hidden),
    (hidden, C)) and the output gradient, 0 past ``rows``."""
    hidden = 4 * c
    rng = np.random.default_rng(seed)
    vals = [rng.normal(size=(padded, c)), rng.normal(size=(padded, c)),
            rng.normal(size=c) * 0.1 + 1, rng.normal(size=c) * 0.1,
            rng.normal(size=(c, hidden)) * c ** -0.5, rng.normal(size=hidden) * 0.05,
            rng.normal(size=(hidden, c)) * hidden ** -0.5, rng.normal(size=c) * 0.05]
    g = rng.normal(size=(padded, c))
    g[rows:] = 0.0
    return [v.astype(np.float32) for v in vals], g.astype(np.float32)


def _port(vals, g, rows):
    """K7's plain version's arguments: the first ``rows`` rows, weights in
    the nn.Linear layout, g last."""
    x, a, s, b, w1, b1, w2, _ = vals
    return [torch.from_numpy(v.copy()) for v in
            (x[:rows], a[:rows], s, b, w1.T, b1, w2.T, g[:rows])]


@pytest.mark.parametrize("c", [96, 128])
@pytest.mark.parametrize("rows", [64, 37])
def test_3xtf32_ffn_backward_matches_pallas_and_the_exact_plain_version(rows, c):
    padded = -(-rows // 8) * 8
    vals, g = _inputs(rows + c, rows, padded, c)
    want = jffn._kernel_bwd([jnp.asarray(v.copy()) for v in vals], jnp.asarray(g.copy()),
                            eps=1e-5, interpret=True)
    assert want is not None
    want = [np.asarray(v) for v in want]
    want[0], want[1] = want[0][:rows], want[1][:rows]
    want[4], want[6] = want[4].T, want[6].T  # nn.Linear layout
    port = _port(vals, g, rows)
    with mock.patch.object(ffn, "_matmul", matmul_3xtf32):
        got = [t.numpy() for t in ffn.fused_ln_mlp_residual_backward_reference(*port)]
    exact = [t.numpy() for t in ffn.fused_ln_mlp_residual_backward_reference(*port)]
    for name, t, e, ex in zip(NAMES, got, want, exact):
        assert t.shape == e.shape == ex.shape, name
        np.testing.assert_allclose(t, e, rtol=1e-4, atol=1e-4, err_msg=name)
        assert np.abs(t - ex).max() <= 1e-5 * np.abs(ex).max(), name
    # the emulation rounds: it is not the exact product
    assert not all(np.array_equal(t, ex) for t, ex in zip(got, exact))


def test_plain_version_takes_its_five_products_through_one_helper():
    vals, g = _inputs(5, 16, 16, 32)
    port = _port(vals, g, 16)
    calls = []

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a, b)

    with mock.patch.object(ffn, "_matmul", spy):
        got = ffn.fused_ln_mlp_residual_backward_reference(*port)
    want = ffn.fused_ln_mlp_residual_backward_reference(*port)
    # fc1, dW2 = g^T h, dh = g W2, dW1 = dh0c^T ln, dln = dh0c W1
    assert calls == [((16, 32), (32, 128)), ((32, 16), (16, 128)), ((16, 32), (32, 128)),
                     ((128, 16), (16, 32)), ((16, 128), (128, 32))]
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    vals, g = _inputs(3, 37, 40, 96)
    x, a, s, b, w1, b1, w2, gy = _port(vals, g, 37)
    ffn.fused_ln_mlp_residual_backward.launches = 0
    got = ffn.fused_ln_mlp_residual_backward(gy, x, a, s, b, w1, b1, w2)
    assert ffn.fused_ln_mlp_residual_backward.launches == 0
    want = ffn.fused_ln_mlp_residual_backward_reference(x, a, s, b, w1, b1, w2, gy)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def _chunks(k, k_chunk):
    return [(z * k_chunk, min(k, (z + 1) * k_chunk)) for z in range(-(-k // k_chunk))]


def _covers_once(k, k_chunk, step):
    """The K ranges of blocks z = 0, 1, ... follow each other from 0 to K
    with nothing left over and nothing twice, each of whole pipeline
    steps (the last may end at K)."""
    ranges = _chunks(k, k_chunk)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(ranges[z][1] == ranges[z + 1][0] for z in range(len(ranges) - 1))
    assert len(ranges) == 1 or k_chunk % step == 0
    return len(ranges)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 5])  # the smoke's batch, training
def test_bwd_plan_at_the_swin_base_stages(batch, dtype, monkeypatch):
    monkeypatch.setattr(ffn, "n_sm", lambda device: H100_SMS)
    step = mma_plan.K_STEP[dtype]
    for hw, c in STAGES:
        n, hidden = batch * hw * hw, 4 * c
        plan = ffn._bwd_plan(n, c, hidden, H100_SMS, dtype)
        # fc1 (n x hidden over C) takes K3's fc1 tile, so that h is K3's;
        # dh (the same shape) takes it too, and db1 has a partial per row
        # block of it
        assert plan.tile_h == ffn.mlp_plan(n, c, hidden, "cuda", dtype)[0]
        assert plan.tile_h in mma_plan.PLAN_TILES[dtype]
        assert plan.db1_blocks == -(-n // mma_plan.MMA_TILES[plan.tile_h][0])
        # the weight gradients over the n rows: whole steps, K once, no
        # partial longer than WGRAD_ROWS, and no shorter than wgrad_plan's
        # one wave of resident blocks asks for
        assert plan.tile_w == mma_plan.WGRAD_TILE
        nz_w2 = _covers_once(n, plan.k_chunk_w2, step)
        nz_w1 = _covers_once(n, plan.k_chunk_w1, step)
        for k_chunk, m, nn in ((plan.k_chunk_w2, c, hidden), (plan.k_chunk_w1, hidden, c)):
            assert k_chunk <= mma_plan.WGRAD_ROWS
            assert k_chunk == min(mma_plan.WGRAD_ROWS,
                                  mma_plan.wgrad_plan(m, nn, n, H100_SMS, dtype)[1]), (n, c)
        # dln over hidden: cut, into whole steps, only where its smallest
        # tile leaves SMs idle
        nz_dln = _covers_once(hidden, plan.k_chunk_dln, step)
        assert (plan.tile_dln, plan.k_chunk_dln, nz_dln) == mma_plan.gemm_plan(
            n, c, hidden, H100_SMS, dtype, split=True)
        # one buffer holds each split product's partials in turn
        need = [nz_w2 * c * hidden, nz_w1 * hidden * c] + ([nz_dln * n * c] if nz_dln > 1 else [])
        assert plan.part == max(need), (n, c)
        assert plan.rows >= 8 and -(-n // plan.rows) <= 4 * H100_SMS


def test_bwd_plan_cuts_dln_at_batch_2_stages_3_and_4_only():
    for dtype in (torch.bfloat16, torch.float32):
        cut = {(b, c) for b in (2, 5) for hw, c in STAGES
               if ffn._bwd_plan(b * hw * hw, c, 4 * c, H100_SMS, dtype).k_chunk_dln < 4 * c}
        assert cut == {(2, 512), (2, 1024)}, dtype
