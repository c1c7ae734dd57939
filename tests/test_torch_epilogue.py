"""K4 plain version (flair_for_aigle_tpu_torch.ops.epilogue) vs the Pallas
upsample + crop + convert epilogue in interpret mode, on the same numpy
logits (K=5, h4=16, margin 8).

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
