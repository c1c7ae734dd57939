"""K1's and K5's timing tool (flair_for_aigle_tpu_torch.tools.time_prep_merge)
measures the card's time only: without a card it raises instead of timing
the CPU. Its inputs have the shapes the two ops take at each stage."""

import pytest
import torch

from flair_for_aigle_tpu_torch.tools import time_prep_merge


def test_time_prep_merge_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    with pytest.raises(RuntimeError, match="card"):
        time_prep_merge.main(["--batch", "1"])


@pytest.mark.parametrize("op", ["prep", "merge"])
def test_time_prep_merge_inputs_fit_the_ops(op):
    """The inputs of one stage, run through the op's plain version: K1 to
    (B nW, 144, C) windows, K5 to (B, H/2, W/2, 2C)."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g) * std).to(dt)

    args = time_prep_merge.inputs(op, 2, 16, 32, torch.bfloat16, randn)
    assert args[0].shape == (2, 16, 16, 32) and args[0].dtype == torch.bfloat16
    if op == "prep":
        from flair_for_aigle_tpu_torch.ops import prep

        out = prep.fused_ln_shift_partition(*args, ws=time_prep_merge.WS, ss=time_prep_merge.SS)
        assert out.shape == (2 * 2 * 2, 144, 32)
    else:
        from flair_for_aigle_tpu_torch.ops import merge

        assert merge.fused_patch_merge(*args).shape == (2, 8, 8, 64)
