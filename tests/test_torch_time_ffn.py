"""K3's and K7's timing tool (flair_for_aigle_tpu_torch.tools.time_ffn)
measures the card's time only: without a card it raises instead of timing
the CPU, forward or backward."""

import pytest
import torch

from flair_for_aigle_tpu_torch.tools import time_ffn


def test_time_ffn_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    with pytest.raises(RuntimeError, match="card"):
        time_ffn.main(["--batch", "1"])



def test_time_ffn_backward_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    with pytest.raises(RuntimeError, match="card"):
        time_ffn.main(["--batch", "1", "--backward"])
