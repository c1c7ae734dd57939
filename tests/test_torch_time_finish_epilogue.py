"""K8's and K4's timing tool (flair_for_aigle_tpu_torch.tools.time_finish_epilogue)
measures the card's time only: without a card it raises instead of timing
the CPU. Its inputs have the shapes the two ops take, and its gathered
rows are the ones K8's gather pass reads."""

import pytest
import torch

from flair_for_aigle_tpu_torch.ops import epilogue, finish
from flair_for_aigle_tpu_torch.tools import time_finish_epilogue as tool


def _randn():
    g = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g) * std).to(dt)

    return randn


def test_time_finish_epilogue_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    with pytest.raises(RuntimeError, match="card"):
        tool.main(["--batch", "1"])


@pytest.mark.parametrize("hw", [16, 20])
def test_finish_inputs_fit_the_op(hw):
    """One stage's inputs (window 12, shift 6; 20 pads to 24) through the
    op's plain version, and the tool's gathered rows are the gather pass's."""
    win, x, p = tool.finish_inputs(2, hw, 32, torch.float32, _randn())
    assert win.shape == (2 * (-(-hw // 12)) ** 2, 144, 32) and x.shape == (2, hw, hw, 32)
    assert finish.fused_reverse_ln_mlp_residual(win, x, *p, ws=tool.WS, ss=tool.SS).shape == x.shape
    _, a = finish.finish_gather_reference(win, x, *p[:2], ws=tool.WS, ss=tool.SS)
    assert torch.equal(tool._gathered(win, x).reshape(-1, 32), a)


def test_epilogue_inputs_fit_the_op():
    lg = tool.epilogue_inputs(1, torch.bfloat16, _randn())
    assert lg.shape == (1, 19, 128, 128) and lg.dtype == torch.bfloat16
    out = epilogue.upsample_crop_convert(lg, margin=tool.MARGIN, scale=4)
    assert out.shape == (1, 1, 432, 432) and out.dtype == torch.uint8
