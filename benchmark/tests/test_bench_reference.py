"""The plain reference against the port's plain path at a small size on
the CPU, and the frozen copies against what they were copied from."""

import numpy as np
import pytest
import torch

from benchmark import registry, weights
from benchmark.drivers import zonal as dzonal
from benchmark.reference import train as tref
from benchmark.tests import small


@pytest.mark.parametrize("workload", ["zonal-swinb-dalle-b16", "zonal-convnextb-dalle-b16"])
def test_models_agree(workload):
    ctx = small.context_for(workload, 7, compute_dtype="float32")
    z = dzonal.zonal_config(ctx, "")
    mod, task = dzonal.modality_and_task(z)
    fam = registry.family(ctx.config["family"])
    port = dzonal.build_model(ctx, z, fam, mod, task)
    ref = dzonal.reference_model(ctx, fam, 3)
    x = torch.randn(2, 3, 96, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = port({mod: x, task: torch.zeros(2, 1, 96, 96)})[0][task]
        want = ref(x)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("workload", ["zonal-swinb-dalle-b16", "zonal-convnextb-dalle-b16"])
def test_zonal_run_in_float32_writes_the_reference_labels(workload):
    out = small.run(workload, 11, compute_dtype="float32")
    assert out["checks"]["label_gap"]["value"] <= 1e-5
    assert out["checks"]["unowned_written"]["value"] == 0
    checked = out["info"]["checked_dalles"]
    assert checked and out["info"]["label_differ_share"] == [0.0] * len(checked)


def test_training_run_follows_the_reference():
    out = small.run("train-swinb-f32-b16", 13)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["loss_gap"] < 1e-5
    assert checks["grad_norm_gap"] < 1e-3 and checks["update_norm_gap"] < 1e-3


def test_one_cycle_is_the_recipes():
    from flair_for_aigle_tpu_torch.train.optim import one_cycle_lr

    ours, theirs = tref.one_cycle_lr(5e-5, 1000, 0.2), one_cycle_lr(5e-5, 1000, 0.2)
    assert [ours(k) for k in range(0, 1000, 7)] == [theirs(k) for k in range(0, 1000, 7)]


def test_loss_and_adamw_are_the_recipes():
    from flair_for_aigle_tpu_torch.train.losses import weighted_cross_entropy
    from flair_for_aigle_tpu_torch.train.optim import Optimizer

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(2, 5, 8, 8, generator=g)
    cls = torch.randint(0, 5, (2, 8, 8), generator=g)
    onehot = torch.nn.functional.one_hot(cls, 5).permute(0, 3, 1, 2).float()
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.5])
    assert tref.weighted_cross_entropy(logits, onehot, w).item() == pytest.approx(
        weighted_cross_entropy(logits, cls, w).item(), rel=1e-6)
    p_ref = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)}
    p_port = [p_ref["a"].clone(), p_ref["b"].clone()]
    ours = tref.AdamW(p_ref, 0.9, 0.999, 0.01)
    theirs = Optimizer(p_port, "adamw", 0.9, 0.999, 0.01)
    for k in range(3):
        grads = [torch.randn(4, 3, generator=g), torch.randn(3, generator=g)]
        ours.step({"a": grads[0], "b": grads[1]}, 1e-3 * (k + 1))
        theirs.step(grads, 1e-3 * (k + 1))
    for mine, port in zip(p_ref.values(), p_port):
        assert torch.allclose(mine, port, rtol=1e-6, atol=1e-7)


def test_weights_come_from_the_seed():
    fam = registry.family("swin")
    cfg = small.context_for("zonal-swinb-dalle-b16", 1).config
    spec = weights.reference_layout(fam, cfg, 3, torch.device("cpu"))
    a = weights.make(spec, 5, torch.device("cpu"))
    b = weights.make(spec, 5, torch.device("cpu"))
    c = weights.make(spec, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if a[k].dtype.is_floating_point
                   and not k.endswith(("running_mean", "running_var")))
    qkv = a["encoder.model.layers.0.blocks.0.attn.qkv.weight"]
    assert qkv.std().item() == pytest.approx(qkv.shape[1] ** -0.5, rel=0.05)


def test_pixels_come_from_the_seed():
    from benchmark.frozen import raster

    traffic = {"pool": 2, "side_px": 64, "fields_px": 24, "plots_px": 8,
               "built_share": 0.5, "texture": 12, "shade": 0, "shade_px": 32}
    a = raster.pixel_pool(2 ** 31 + 9, traffic, 3, torch.device("cpu"))
    b = raster.pixel_pool(2 ** 31 + 9, traffic, 3, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and a[0].dtype == np.uint8
    assert a[0].shape == (3, 64, 64) and not np.array_equal(a[0], a[1])


def test_pixels_are_parcels_with_texture():
    """Neighbouring pixels mostly share a parcel's colour, within the
    texture's noise: the label maps have runs, as land cover has."""
    from benchmark.frozen import raster

    traffic = {"pool": 1, "side_px": 256, "fields_px": 96, "plots_px": 16,
               "built_share": 0.5, "texture": 12, "shade": 0, "shade_px": 32}
    px = raster.pixel_pool(7, traffic, 3, torch.device("cpu"))[0].astype(np.int32)
    step = np.abs(px[:, :, 1:] - px[:, :, :-1]).max(axis=0)
    assert np.mean(step <= 2 * traffic["texture"]) > 0.9
    assert np.mean(step > 2 * traffic["texture"]) > 0.005  # parcel edges
    ids = raster.voronoi(torch.Generator().manual_seed(3), 256, 96, torch.device("cpu"))
    assert 4 <= len(torch.unique(ids)) <= (256 // 96 + 3) ** 2
