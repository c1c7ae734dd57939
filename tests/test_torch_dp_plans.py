"""The kernels' launch plans at swin-base@512 on a card of 132 SMs (the
H100), on the CPU: K3's ``mlp_plan`` (fc1 tile, fc2 tile, fc2's K chunk
and partials), K2's ``attn_gemm_tiles`` (qkv and output projection tiles),
K5's ``merge_plan`` (tile, K chunk, partials) and K1's ``prep_plan``
(group, vectors a lane, positions a unit, threads, blocks), each pinned at
the batches the paths run: 2 and 5 (training), 8 (a zonal replica of two
at the slice's batch) and 16 (the zonal batch).

A replica plans from its own rows. At batch 8 its plans differ from the
one-device batch of 16 in K3's bf16 fc2 tile at stage 4 (64 x 128 in
place of 128 x 128) and in K1's positions a unit; on the card every
kernel call of a replica's batch is still bit-identical to the same rows
of the batch of 16 (``chip_smoke.py`` ``[multigpu]``
``replica_diagnosis``): a tile steps each row's sums through K in the
same order, and K1's unit only orders its walk. The labels' dependence on
the replica count came from the PSP pools' cuBLAS products, which run
through cuBLASLt on the card since (``ops/resize.py
_batch_invariant_blas``); on the CPU that helper leaves the products as
they are.
"""

import pytest
import torch

from flair_for_aigle_tpu_torch.ops import ffn, merge, prep, resize, window_attn

SMS = 132
STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]  # (H = W, C), window 12
MERGES = STAGES[:3]
BF, F32 = torch.bfloat16, torch.float32

#: (dtype, batch) -> (mlp_plan per stage, attn_gemm_tiles per stage,
#: merge_plan per merge, prep_plan per stage)
PLANS = {
    (BF, 2): ([(0, 0, 512, 1), (0, 1, 1024, 1), (0, 1, 1024, 2), (1, 1, 1408, 3)],
              [(0, 0), (0, 0), (0, 1), (0, 1)],
              [(1, 512, 1), (1, 512, 2), (1, 704, 3)],
              [(16, 1, 1, 256, 528), (32, 1, 1, 256, 528), (32, 2, 1, 256, 264),
               (32, 4, 1, 256, 144)]),
    (BF, 5): ([(0, 0, 512, 1), (0, 0, 1024, 1), (0, 0, 2048, 1), (0, 1, 4096, 1)],
              [(0, 0)] * 4,
              [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
              [(16, 1, 2, 256, 528), (32, 1, 1, 256, 528), (32, 2, 1, 256, 264),
               (32, 4, 1, 256, 360)]),
    (BF, 8): ([(0, 0, 512, 1), (0, 0, 1024, 1), (0, 0, 2048, 1), (0, 1, 4096, 1)],
              [(0, 0)] * 4,
              [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
              [(16, 1, 4, 256, 528), (32, 1, 2, 256, 528), (32, 2, 1, 256, 264),
               (32, 4, 1, 256, 396)]),
    (BF, 16): ([(0, 0, 512, 1), (0, 0, 1024, 1), (0, 0, 2048, 1), (0, 0, 4096, 1)],
               [(0, 0)] * 4,
               [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
               [(16, 1, 8, 256, 528), (32, 1, 4, 256, 528), (32, 2, 2, 256, 264),
                (32, 4, 1, 256, 396)]),
    (F32, 2): ([(1, 1, 512, 1), (1, 1, 1024, 1), (1, 1, 1024, 2), (1, 1, 1376, 3)],
               [(1, 1)] * 4,
               [(1, 512, 1), (1, 512, 2), (1, 688, 3)],
               [(32, 1, 2, 256, 528), (32, 2, 1, 256, 528), (32, 4, 1, 256, 264),
                (32, 8, 1, 256, 144)]),
    (F32, 5): ([(1, 1, 512, 1), (1, 1, 1024, 1), (1, 1, 2048, 1), (1, 1, 4096, 1)],
               [(1, 1)] * 4,
               [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
               [(32, 1, 5, 256, 528), (32, 2, 1, 256, 528), (32, 4, 1, 256, 264),
                (32, 8, 1, 256, 360)]),
    (F32, 8): ([(1, 1, 512, 1), (1, 1, 1024, 1), (1, 1, 2048, 1), (1, 1, 4096, 1)],
               [(1, 1)] * 4,
               [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
               [(32, 1, 8, 256, 528), (32, 2, 2, 256, 528), (32, 4, 1, 256, 264),
                (32, 8, 1, 256, 396)]),
    (F32, 16): ([(1, 1, 512, 1), (1, 1, 1024, 1), (1, 1, 2048, 1), (1, 1, 4096, 1)],
                [(1, 1)] * 4,
                [(1, 512, 1), (1, 1024, 1), (1, 2048, 1)],
                [(32, 1, 16, 256, 528), (32, 2, 4, 256, 528), (32, 4, 2, 256, 264),
                 (32, 8, 1, 256, 396)]),
}


def _padded(hw: int) -> int:
    return hw + (12 - hw % 12) % 12


def plans(dtype, b: int, monkeypatch) -> tuple:
    monkeypatch.setattr(ffn, "n_sm", lambda device: SMS)
    return ([ffn.mlp_plan(b * hw * hw, c, 4 * c, "cuda", dtype) for hw, c in STAGES],
            [window_attn.attn_gemm_tiles(b * _padded(hw) ** 2, c, SMS, dtype)
             for hw, c in STAGES],
            [merge.merge_plan(b * (hw // 2) ** 2, 2 * c, 4 * c, SMS, dtype) for hw, c in MERGES],
            [tuple(prep.prep_plan(c, dtype, SMS, b * _padded(hw) ** 2)) for hw, c in STAGES])


@pytest.mark.parametrize("dtype,batch", sorted(PLANS, key=lambda k: (str(k[0]), k[1])))
def test_plans_at_swin_base_are_unchanged(dtype, batch, monkeypatch):
    assert plans(dtype, batch, monkeypatch) == PLANS[(dtype, batch)]


def test_a_replica_of_two_differs_from_the_batch_of_16_only_in_k3_fc2_and_k1_units(monkeypatch):
    for dtype in (BF, F32):
        rep, one = plans(dtype, 8, monkeypatch), plans(dtype, 16, monkeypatch)
        assert rep[1:3] == one[1:3]  # K2's projections, K5's merges
        fc2 = [(i, r[1], o[1]) for i, (r, o) in enumerate(zip(rep[0], one[0])) if r != o]
        assert fc2 == ([(3, 1, 0)] if dtype == BF else [])
        assert all(r[:2] == o[:2] and r[3:] == o[3:] for r, o in zip(rep[3], one[3]))


def test_resize_products_keep_the_cpu_blas_as_it_is():
    """``_apply_hw``'s cuBLASLt route is for CUDA tensors only: on the CPU
    the preferred BLAS stays untouched and the pool is its plain float32
    einsum pair."""
    before = torch.backends.cuda.preferred_blas_library()
    x = torch.randn(3, 16, 16, 8, generator=torch.Generator().manual_seed(0))
    got = resize.adaptive_avg_pool_nhwc(x, 3, 3)
    mh = torch.as_tensor(resize._pool_matrix(16, 3))
    want = torch.einsum("pw,...owc->...opc", mh, torch.einsum("oh,...hwc->...owc", mh, x))
    assert torch.backends.cuda.preferred_blas_library() == before
    assert torch.equal(got, want)
