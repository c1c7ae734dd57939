"""The controls on the card, at the published widths and a size a test run
holds: a precision one step below the configuration's in the system's
place comes out not correct under the cells' limits.

    python3 -m pytest benchmark/tests -q -m cuda     (on the card)
"""

import pytest
import torch

from benchmark import context, control, registry


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["zonal-swinb-dalle-b16", "zonal-convnextb-dalle-b16"])
def test_fp8_control_fails_on_the_card(card, workload):
    ctx = context.make(registry.load_benchmark(), workload, 2 ** 31 + 101, 0, False, card,
                       traffic_override={"side_px": 1024, "pool": 1})
    got = control.zonal_control(ctx, dalles=1)["fp8"]
    assert got["label_gap"] > ctx.limits["label_gap"]


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(card):
    ctx = context.make(registry.load_benchmark(), "train-swinb-f32-b16", 2 ** 31 + 102, 0,
                       False, card, traffic_override={"batch_size": 2, "px": 256, "pool": 3})
    got = control.train_control(ctx)
    for name in ("tf32", "half_batch"):
        assert any(got[name][k] > ctx.limits[k] for k in got[name]), (name, got[name])
