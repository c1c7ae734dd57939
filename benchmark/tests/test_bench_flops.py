"""The FLOP counters against a hand count, and against torch's own
counter on the reference models, at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import registry

DEC = {"name": "upernet", "pyramid_channels": 8, "segmentation_channels": 4}
SWIN = {"family": "swin", "num_classes": 3, "decoder": DEC,
        "encoder": {"embed_dim": 4, "depths": [1, 1], "num_heads": [1, 1],
                    "window_size": 2, "patch_size": 4, "mlp_ratio": 4}}
CONVNEXT = {"family": "convnext", "num_classes": 3, "decoder": DEC,
            "encoder": {"dims": [4, 8], "depths": [1, 1], "patch_size": 4, "mlp_ratio": 4,
                        "dw_kernel": 7}}
# UPerNet on maps of 4 and 8 channels at 4x4 and 2x2: PSP pools 2 s^2 8 2
# for s in 1, 2, 3, 6 (1600), PSP out 2 4 16 8 (1024), FPN skip 2 16 4 8
# (1024), bottleneck 2 16 9 16 4 (18432), head 2 16 9 4 3 (3456)
DECODER = 1600 + 1024 + 1024 + 18432 + 3456


def test_swin_hand_count():
    # patch embed 2 16 48 4; stage 1 (16 tokens, C 4, 4 windows of 4):
    # linear 2 16 4 48, attention 2 2 4 16 4; merge 2 4 16 8; stage 2 (4
    # tokens, C 8, 1 window): linear 2 4 8 96, attention 2 2 1 16 8
    encoder = 6144 + (6144 + 1024) + 1024 + (6144 + 512)
    fam = registry.family("swin")
    assert fam.forward_flops(SWIN, 16, 3) == encoder + DECODER


def test_convnext_hand_count():
    # stem 2 16 48 4; block 1: depthwise 2 16 49 4, mlp 2 2 16 4 16;
    # downsample 2 4 16 8; block 2: depthwise 2 4 49 8, mlp 2 2 4 8 32
    encoder = 6144 + (6272 + 4096) + 1024 + (3136 + 4096)
    fam = registry.family("convnext")
    assert fam.forward_flops(CONVNEXT, 16, 3) == encoder + DECODER


@pytest.mark.parametrize("cfg,px", [(SWIN, 16), (CONVNEXT, 16)])
def test_counter_matches_torch_on_the_reference(cfg, px):
    fam = registry.family(cfg["family"])
    model = fam.build(cfg, 3).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.randn(1, 3, px, px))
    assert counter.get_total_flops() == fam.forward_flops(cfg, px, 3)


def test_published_sizes():
    """Swin-B at 512 px about 190 GFLOP a tile; ConvNeXt-B about the same."""
    for name in ("swinb-upernet", "convnextb-upernet"):
        cfg = registry.config(registry.load_benchmark(), name)
        g = registry.family(cfg["family"]).forward_flops(cfg, 512, 3) / 1e9
        assert 150 < g < 260, (name, g)


def test_k2_and_k3_count_the_blocks_as_the_model_counter_does():
    """K2's and K3's work over a batch is the Swin blocks' operations of
    ``block_flops``: projections on the real tokens, attention on the
    padded windows (swin-base at 512 px pads stages 2-4)."""
    cfg = registry.config(registry.load_benchmark(), "swinb-upernet")
    fam = registry.family("swin")
    sts = fam.stages(cfg, 512)
    assert any(st.hp * st.wp > st.tokens for st in sts)
    geo = {"stages": sts, "mlp_ratio": 4}
    k2, _ = registry.kernel("k2_window_attn").work(geo, 16, 2)
    k3, _ = registry.kernel("k3_ffn").work(geo, 16, 2)
    assert k2 + k3 == 16 * sum(st.depth * fam.block_flops(st, 4) for st in sts)
