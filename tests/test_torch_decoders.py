"""The port's decoder families against the JAX package's, on the CPU.

Every decoder on a resnet34 encoder, and the JAX tests' cross-family
combinations, as one-modality ``FlairHubModel``s: seeded flax variables
(``tests/test_torch_utae.py _fill``) load strictly into the port's model
through ``state_dict_from_flax`` (LinkNet's transposed convolutions
included), the same seeded batch goes through both in eval mode, float32,
and the logits agree within atol = rtol = 5e-4. The inputs are 64 px, PAN's
128 px: PAN dilates to stride 16 and its attention pyramid pools that map
three times more.

Also: the archs that the JAX package refuses (DeepLab and PSPNet on a
transformer encoder, an unknown decoder) raise the same error class with
the same message, and the training-time dropouts (FPN's and PSPNet's
channel dropout, DeepLab's element-wise one) draw from the caller's
generator and act in training only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models import flair_model as jfm
from flair_for_aigle_tpu_torch.models import flair_model as tfm
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.layers import init_weights
from tests._fixtures import make_config
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_utae import _fill

TASK, CLASSES = "T1", 6
DECODERS = ["unet", "unetplusplus", "upernet", "fpn", "deeplabv3plus", "deeplabv3",
            "linknet", "manet", "pan", "pspnet"]
ARCHS = [f"resnet34-{d}" for d in DECODERS] + [
    "swin_micro_patch4_window4_64-fpn", "convnext_micro-fpn",
    "convnext_micro-unetplusplus", "efficientnet_micro-unet",
    "efficientnet_micro-linknet", "convnext_micro-upernet"]


def config(arch: str) -> dict:
    return make_config(arch=arch, tasks=((TASK, CLASSES),))


def batch(arch: str, seed: int = 1) -> dict:
    px = 128 if arch.endswith("-pan") else 64
    x = np.random.default_rng(seed).normal(size=(2, 3, px, px)).astype(np.float32)
    return {"AERIAL_RGBI": x, TASK: np.zeros((2, CLASSES, px, px), np.float32)}


def pair(arch: str, b: dict, seed: int = 0):
    """(JAX model, its seeded variables, the port's model holding them)."""
    jmodel = jfm.FlairHubModel(config=config(arch))
    shapes = jax.eval_shape(lambda a: jmodel.init(jax.random.key(0), a),
                            {k: jnp.asarray(v) for k, v in b.items()})
    rng = np.random.default_rng(seed)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    tmodel = tfm.FlairHubModel(config(arch))
    tmodel.load_state_dict(state_dict_from_flax(v["params"], v.get("batch_stats")),
                           strict=True)
    return jmodel, v, tmodel.eval()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch):
    b = batch(arch)
    jmodel, v, tmodel = pair(arch, b)
    want = np.asarray(jmodel.apply(v, {k: jnp.asarray(x) for k, x in b.items()})[0][TASK])
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(x.copy()) for k, x in b.items()})[0][TASK].numpy()
    assert got.shape == want.shape == b[TASK].shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("arch", ["swin_micro_patch4_window4_64-deeplabv3plus",
                                  "swin_micro_patch4_window4_64-pspnet",
                                  "convnext_micro-deeplabv3", "efficientnet_micro-pan",
                                  "resnet34-segformer"])
def test_archs_the_jax_package_refuses_raise_the_same(arch):
    b = {k: jnp.asarray(x) for k, x in batch(arch).items()}
    with pytest.raises(ValueError) as jerr:
        jfm.FlairHubModel(config=config(arch)).init(jax.random.key(0), b)
    with pytest.raises(ValueError) as terr:
        tfm.FlairHubModel(config(arch))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch,channel_wise", [("resnet34-fpn", True),
                                               ("resnet34-pspnet", True),
                                               ("resnet34-deeplabv3plus", False)])
def test_decoder_dropout_draws_from_the_generator(arch, channel_wise):
    """Training mode: the same seed gives the same decoder output, another
    seed another; a channel dropout zeroes whole channels of a sample.
    Eval mode ignores the generator."""
    model = init_weights(tfm.FlairHubModel(config(arch)), torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(x) for k, x in batch(arch).items()}
    decoder = model.main_decoders[TASK].seg_model.decoder
    model.train()
    with torch.no_grad():
        feats = model.encoders["AERIAL_RGBI"].seg_model(b["AERIAL_RGBI"].permute(0, 2, 3, 1))
        a, same, other = [decoder(*feats, generator=torch.Generator().manual_seed(s))
                          for s in (5, 5, 6)]
    assert torch.equal(a, same) and not torch.equal(a, other)
    zero = (a == 0).flatten(1, 2).all(1)  # (B, C): whole channels zero
    if channel_wise:
        assert zero.any() and not zero.all()
    else:
        assert not zero.any() and (a == 0).any()
    model.eval()
    with torch.no_grad():
        e1, e2 = [model(b, generator=torch.Generator().manual_seed(s))[0][TASK] for s in (5, 6)]
    assert torch.equal(e1, e2)
