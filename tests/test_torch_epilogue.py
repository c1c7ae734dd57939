"""K4 plain version (flair_for_aigle_tpu_torch.ops.epilogue) vs the Pallas
upsample + crop + convert epilogue in interpret mode, on the same numpy
logits (K=5, h4=16, margin 8); and the kernel's tiling (``epilogue_plan``)
modelled in numpy: its staged ranges hold every tap, and its tiled,
separable float32 form equals the untiled two-tap form bit for bit.

argmax: byte-equal except at pixels whose top-2 upsampled logits tie within
1e-6 (float association may differ there). class_prob: within one uint8
step at float32 and two at bfloat16 (reference epilogue.py:18-21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas.epilogue import upsample_crop_convert as jepi
from flair_for_aigle_tpu_torch.ops import epilogue

K, H4, MARGIN = 5, 16, 8


def _upsampled(lg: np.ndarray) -> np.ndarray:
    """(B, K, inner, inner) float64 align-corners x4 logits of the kept
    pixels (the reference's interpolation matrices)."""
    inner = H4 * 4 - 2 * MARGIN
    r = epilogue._interp_matrix(H4, 4, MARGIN, MARGIN + inner).astype(np.float64)
    return np.einsum("ia,bkax,jx->bkij", r, lg.astype(np.float64), r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("output_type", ["argmax", "class_prob"])
def test_epilogue_plain_matches_pallas(output_type, dtype):
    lg = (np.random.default_rng(0).normal(size=(2, K, H4, H4)) * 3).astype(np.float32)
    jlg = jnp.asarray(lg.copy()).astype(dtype)
    want = np.asarray(jepi(jlg, margin=MARGIN, scale=4, output_type=output_type,
                           interpret=True))
    tlg = torch.from_numpy(lg.copy()).to(getattr(torch, dtype))
    got = epilogue.upsample_crop_convert(tlg, margin=MARGIN, scale=4,
                                         output_type=output_type).numpy()
    inner = H4 * 4 - 2 * MARGIN
    n_out = 1 if output_type == "argmax" else K
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, n_out, inner, inner)
    if output_type == "argmax":
        up = np.sort(_upsampled(np.asarray(jlg.astype(jnp.float32))), axis=1)
        near_tie = (up[:, -1] - up[:, -2]) < 1e-6
        differ = got[:, 0] != want[:, 0]
        assert not np.any(differ & ~near_tie)
    else:
        steps = 1 if dtype == "float32" else 2
        assert np.abs(got.astype(int) - want.astype(int)).max() <= steps


def test_interp_taps_match_matrix():
    for in_size, lo, hi in [(16, 8, 56), (128, 40, 472), (4, 0, 16)]:
        m = epilogue._interp_matrix(in_size, 4, lo, hi)
        i_lo, i_hi, w_lo, w_hi = epilogue._taps(in_size, 4, lo, hi)
        rebuilt = np.zeros_like(m)
        rows = np.arange(hi - lo)
        np.add.at(rebuilt, (rows, i_lo), w_lo)
        np.add.at(rebuilt, (rows, i_hi), w_hi)
        np.testing.assert_array_equal(rebuilt, m)


# epilogue_plan's tiles: every margin of the zonal configurations at three
# widths; a margin that leaves no pixel is refused
PLAN_CASES = [(h4, m) for h4 in (16, 32, 128) for m in (0, 8, 40, 64)]


@pytest.mark.parametrize("h4,margin", PLAN_CASES)
def test_epilogue_plan_stages_every_tap(h4, margin):
    """A model of the kernel's reads: each tile's output pixels take both
    row taps from the rows the tile stages and all their column taps from
    the tile's staged columns, through the tables as the kernel reads them;
    each pixel's three weights place its two column weights at its two
    taps; a block's groups fit its 256 threads."""
    inner = 4 * h4 - 2 * margin
    if inner <= 0:
        with pytest.raises(ValueError):
            epilogue.epilogue_plan(h4, 4, margin)
        return
    plan = epilogue.epilogue_plan(h4, 4, margin)
    p, gt, tr = plan.p, plan.gt, plan.tr
    rlo, rhi, cw_lo, cw_hi = epilogue._taps(h4, 4, margin, margin + inner)
    clo, chi = rlo, rhi  # h4 == w4: the columns' taps are the rows'
    groups = -(-inner // p)
    assert tr * gt <= epilogue.EPI_THREADS and p in (2, 4)
    assert plan.row_tiles == -(-inner // tr) and plan.col_tiles == -(-groups // gt)
    assert plan.nc % epilogue.EPI_CHUNK == 0
    # rows: each output row's taps, relative to its tile's first staged row
    i = np.arange(inner)
    first, n_rows = plan.row_tile[i // tr, 0], plan.row_tile[i // tr, 1]
    ra, rb = plan.row_loc[:, 0], plan.row_loc[:, 1]
    np.testing.assert_array_equal(first + ra, rlo)
    np.testing.assert_array_equal(first + rb, rhi)
    assert (ra >= 0).all() and (rb < n_rows).all() and (n_rows <= plan.nr).all()
    assert (first + n_rows <= h4).all()
    # columns: each pixel's taps among its group's three staged columns
    j = np.arange(inner)
    g = j // p
    cs = plan.col_start[g // gt]
    assert (cs % epilogue.EPI_CHUNK == 0).all()
    base = plan.group_base[g]
    assert (base >= 0).all() and (base + 2 < plan.nc).all()
    d = clo - (cs + base)
    assert set(np.unique(d)) <= {0, 1} and (chi - (cs + base) <= 2).all()
    want = np.zeros((inner, 3), np.float32)
    np.add.at(want, (j, d), cw_lo)
    np.add.at(want, (j, d + 1), cw_hi)
    np.testing.assert_array_equal(plan.col_w[:inner], want)
    assert not plan.col_w[inner:].any()


def _two_tap(lg, h4, margin):
    """The untiled two-tap form in float32 (rows, then columns), no FMA:
    (B, K, inner, inner)."""
    inner = 4 * h4 - 2 * margin
    rlo, rhi, rw_lo, rw_hi = epilogue._taps(h4, 4, margin, margin + inner)
    ta = lg[:, :, rlo, :] * rw_lo[:, None] + lg[:, :, rhi, :] * rw_hi[:, None]
    return ta[..., rlo] * rw_lo + ta[..., rhi] * rw_hi


def _tiled(lg, h4, margin):
    """The kernel's tiled, separable form in float32 through the plan's
    tables: per tile the staged rows and columns (zeros past w4), each row
    tap once per (output row, staged column, class), then each pixel from
    its group's three row taps and its three weights, in the kernel's
    order (no FMA)."""
    plan = epilogue.epilogue_plan(h4, 4, margin)
    inner = 4 * h4 - 2 * margin
    b, k = lg.shape[:2]
    padded = np.zeros((b, k, h4, h4 + plan.nc), np.float32)
    padded[..., :h4] = lg
    out = np.zeros((b, k, inner, inner), np.float32)
    for rt in range(plan.row_tiles):
        rs, nr = plan.row_tile[rt]
        rows = np.arange(rt * plan.tr, min(inner, (rt + 1) * plan.tr))
        loc, w = plan.row_loc[rows], plan.row_w[rows]
        for ct in range(plan.col_tiles):
            cs = plan.col_start[ct]
            s = padded[:, :, rs:rs + nr, cs:cs + plan.nc]
            rtap = (s[:, :, loc[:, 0]] * w[:, 0, None] + s[:, :, loc[:, 1]] * w[:, 1, None])
            groups = np.arange(ct * plan.gt, min(-(-inner // plan.p), (ct + 1) * plan.gt))
            for o in range(plan.p):
                j = groups * plan.p + o
                keep = j < inner
                j, base = j[keep], plan.group_base[groups[keep]]
                cw = plan.col_w[j]
                v = [rtap[..., base + t] for t in range(3)]
                u = (v[0] * cw[:, 0] + v[1] * cw[:, 1]) + v[2] * cw[:, 2]
                out[:, :, rows[:, None], j[None, :]] = u
    return out


@pytest.mark.parametrize("h4,margin", [(16, 8), (16, 7), (13, 3), (32, 40), (128, 40)])
def test_tiled_separable_form_equals_the_two_tap_form(h4, margin):
    """Bit for bit in float32: the tiled form reads the same row and column
    taps with the same weights (a pixel's third weight is 0, adding an
    exact 0); margin 7 leaves a ragged last group (inner 50), h4 = 13 rows
    that are no whole number of 16-byte chunks."""
    lg = (np.random.default_rng(1).normal(size=(2, K, h4, h4)) * 3).astype(np.float32)
    np.testing.assert_array_equal(_tiled(lg, h4, margin), _two_tap(lg, h4, margin))


def test_tiled_labels_match_pallas():
    """The tiled form's argmax (ties to the lowest class) against the
    Pallas argmax epilogue in interpret mode: equal except at near-ties."""
    lg = (np.random.default_rng(0).normal(size=(2, K, H4, H4)) * 3).astype(np.float32)
    want = np.asarray(jepi(jnp.asarray(lg.copy()), margin=MARGIN, scale=4,
                           output_type="argmax", interpret=True))[:, 0]
    got = np.argmax(_tiled(lg, H4, MARGIN), axis=1)
    up = np.sort(_upsampled(lg), axis=1)
    near_tie = (up[:, -1] - up[:, -2]) < 1e-6
    assert not np.any((got != want) & ~near_tie)
