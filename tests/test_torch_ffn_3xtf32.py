"""K3's float32 precision scheme and its GEMM plan, on the CPU.

On the card K3 takes both float32 products (fc1 and fc2) as 3xTF32 on the
tensor cores (``csrc/gemm_mma.cuh``). Here that scheme is emulated on K3's
plain version by patching ``torch.matmul`` with ``tests/_tf32.py``'s
``matmul_3xtf32`` (tf32 rounding on the bits, three products for each),
and held against the Pallas kernel in interpret mode at
``test_ffn_plain_matches_pallas``'s float32 tolerance (2e-4), and against
the exact plain version within 1e-5 of the output's largest magnitude. The
Pallas kernel takes row counts in multiples of 8 only, so an odd count
runs it on the next multiple of 8 and compares the leading rows (every
output row depends on its own input row alone).

``ops/mma_plan.py gemm_plan`` (the tile and fc2's split of K) is Python, so its
promises are checked here: every SM gets a block at the shapes the system
runs, the tile is the largest that does, and a split cuts K into whole
pipeline steps, in order, with nothing left over.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas.ffn import fused_ln_mlp_residual as jffn
from flair_for_aigle_tpu_torch.ops import ffn, mma_plan
from tests._tf32 import matmul_3xtf32

# swin-base@512's stages: (H = W, C); hidden = 4 C
STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]
H100_SMS = 132


def _inputs(seed, rows, c):
    hidden = 4 * c
    rng = np.random.default_rng(seed)
    vals = [rng.normal(size=(rows, c)), rng.normal(size=(rows, c)) * 0.5,
            rng.normal(size=(c,)) * 0.1 + 1, rng.normal(size=(c,)) * 0.1,
            rng.normal(size=(c, hidden)) * c ** -0.5, rng.normal(size=(hidden,)) * 0.02,
            rng.normal(size=(hidden, c)) * hidden ** -0.5, rng.normal(size=(c,)) * 0.02]
    return [v.astype(np.float32) for v in vals]


def _port(vals, rows):
    """K3's inputs for the port: the first ``rows`` rows, weights in the
    nn.Linear layout."""
    x, a, s, b, w1, b1, w2, b2 = vals
    return [torch.from_numpy(v.copy()) for v in
            (x[:rows], a[:rows], s, b, w1.T, b1, w2.T, b2)]


@pytest.mark.parametrize("c", [96, 128])
@pytest.mark.parametrize("rows", [64, 37])
def test_3xtf32_ffn_matches_pallas_and_the_exact_plain_version(rows, c):
    padded = -(-rows // 8) * 8
    vals = _inputs(rows + c, padded, c)
    want = np.asarray(jffn(*(jnp.asarray(v.copy()) for v in vals), interpret=True))[:rows]
    port = _port(vals, rows)
    with mock.patch.object(torch, "matmul", matmul_3xtf32):
        got = ffn.fused_ln_mlp_residual_reference(*port).numpy()
    exact = ffn.fused_ln_mlp_residual_reference(*port).numpy()
    assert got.shape == (rows, c)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()
    # the emulation rounds: it is not the exact product
    assert not np.array_equal(got, exact)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    port = _port(_inputs(3, 40, 96), 37)
    ffn.fused_ln_mlp_residual.launches = 0
    got = ffn.fused_ln_mlp_residual(*port)
    assert ffn.fused_ln_mlp_residual.launches == 0
    assert torch.equal(got, ffn.fused_ln_mlp_residual_reference(*port))


def _tiles(m, n, code):
    bm, bn = mma_plan.MMA_TILES[code]
    return -(-m // bm) * -(-n // bn)


def _products(batch):
    """(m, n, k, split) of fc1 and fc2 at each stage for ``batch`` tiles of
    512 px."""
    for hw, c in STAGES:
        m = batch * hw * hw
        yield m, 4 * c, c, False
        yield m, c, 4 * c, True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 5, 16])  # zonal pairs, training, zonal batch
def test_plan_gives_every_sm_a_block_with_the_largest_tile(batch, dtype):
    tiles = mma_plan.PLAN_TILES[dtype]
    for m, n, k, split in _products(batch):
        code, k_chunk, nz = mma_plan.gemm_plan(m, n, k, H100_SMS, dtype, split=split)
        assert code in tiles
        assert _tiles(m, n, code) * nz >= H100_SMS, (m, n, k)
        # no larger tile of the dtype's gives every SM a block at the full K
        bigger = tiles[:tiles.index(code)]
        assert all(_tiles(m, n, big) < H100_SMS for big in bigger), (m, n, k)
        if nz > 1:  # only fc2 splits, and only where the smallest tile falls short
            assert split and code == tiles[-1]
            assert _tiles(m, n, code) < H100_SMS
        else:
            assert k_chunk == k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_splits_fc2_at_batch_2_stages_3_and_4_only(dtype):
    splits = {(b, m, n, k) for b in (2, 5, 16) for m, n, k, split in _products(b)
              if mma_plan.gemm_plan(m, n, k, H100_SMS, dtype, split=split)[2] > 1}
    assert splits == {(2, 2048, 512, 2048), (2, 512, 1024, 4096)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_sm", [8, 114, 132])
@pytest.mark.parametrize("k", [64, 384, 1000, 2048, 4096])
def test_split_cuts_k_into_whole_steps_in_order(k, n_sm, dtype):
    """The K ranges of blocks z = 0 .. nz - 1 follow each other from 0 to K
    with nothing left over and nothing twice; each is whole pipeline steps
    (the last may end at K), at least MIN_STEPS of them where K is split;
    the grid fills the SMs it is given where K allows."""
    m, n = 64, 128  # one smallest tile: the most a split has to make up
    k_step = mma_plan.K_STEP[dtype]
    code, k_chunk, nz = mma_plan.gemm_plan(m, n, k, n_sm, dtype, split=True)
    assert k_chunk % k_step == 0 or nz == 1
    ranges = [(z * k_chunk, min(k, (z + 1) * k_chunk)) for z in range(nz)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(lo < hi for lo, hi in ranges)
    assert all(ranges[z][1] == ranges[z + 1][0] for z in range(nz - 1))
    if nz > 1:
        assert k_chunk >= mma_plan.MIN_STEPS * k_step
    steps = k // k_step
    assert _tiles(m, n, code) * nz >= min(n_sm, max(1, steps // mma_plan.MIN_STEPS))
    # the plan is a function of its arguments: two calls agree
    assert mma_plan.gemm_plan(m, n, k, n_sm, dtype, split=True) == (code, k_chunk, nz)


def test_fc1_never_splits():
    for k in (64, 1024, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            assert mma_plan.gemm_plan(8, 64, k, H100_SMS, dtype)[1:] == (k, 1)


def test_ffn_info_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ffn.ffn_info(100, 400)
    with pytest.raises(ValueError):
        ffn.ffn_info(2048, 8192)
