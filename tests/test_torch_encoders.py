"""The port's ResNet, ConvNeXt and EfficientNet encoders against the JAX
package's, on the CPU.

Seeded flax variables (``tests/test_torch_utae.py _fill``, shapes from
``eval_shape``) load strictly into the port's encoder through
``state_dict_from_flax``; the same seeded numpy batch goes through both in
float32. Each encoder runs in eval mode (its running statistics): every
feature of the pyramid within atol = rtol = 5e-4; and in train mode (batch
statistics): every feature within 5e-4 of its largest magnitude, and the
updated running means and variances within atol = rtol = 1e-5. Train mode
gets the looser feature bound because each BatchNorm renormalises by the
batch's own statistics, which carries the two packages' float32 rounding
(XLA's and oneDNN's convolutions) from block to block undamped: through
ResNet-50's 16 blocks the deepest features differ by up to 1.8e-3 on a
magnitude of 6.9.
ResNet runs at output stride 32, 16 and 8 (smp's make_dilated) and
truncated to depth 3 (PSPNet's encoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models import monotemp as jmt
from flair_for_aigle_tpu_torch.models import monotemp as tmt
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_utae import _close, _fill

PX = 64
TOL = dict(atol=5e-4, rtol=5e-4)

CASES = {
    "resnet18": dict(os=32, depth=5),
    "resnet34": dict(os=32, depth=5),
    "resnet50": dict(os=32, depth=5),
    "resnet34-os16": dict(os=16, depth=5),
    "resnet50-os16": dict(os=16, depth=5),
    "resnet18-os8": dict(os=8, depth=5),
    "resnet50-os8": dict(os=8, depth=5),
    "resnet34-depth3": dict(os=32, depth=3),
    "convnext_micro": dict(os=32, depth=5),
    "efficientnet_micro": dict(os=32, depth=5),
}


def carry(name: str, x: np.ndarray, seed: int = 0):
    """(JAX encoder, its seeded variables, the port's encoder holding them)."""
    enc = name.split("-")[0]
    kw = dict(output_stride=CASES[name]["os"], depth=CASES[name]["depth"])
    jmod = jmt.make_encoder(enc, x.shape[-1], name="encoder", **kw)
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.key(0), a), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    tmod = tmt.make_encoder(enc, x.shape[-1], **kw)
    tmod.load_state_dict(state_dict_from_flax(v["params"], v.get("batch_stats")),
                         strict=True)
    return jmod, v, tmod


def batch(seed: int = 1, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, PX, PX, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_matches_jax(name, train):
    x = batch()
    jmod, v, tmod = carry(name, x)
    if train:
        want, upd = jmod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tmod.train()
    else:
        want = jmod.apply(v, jnp.asarray(x))
        tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.copy()))
    assert len(got) == len(want) == CASES[name]["depth"] + 1
    assert tuple(tmod.out_channels) == tuple(f.shape[-1] for f in want)
    assert tuple(tmt.encoder_out_channels(name.split("-")[0], 3))[:len(want)] == \
        tuple(jmt.encoder_out_channels(name.split("-")[0], 3))[:len(want)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if train and g.numel():
            _close(g.numpy(), np.asarray(w), 5e-4)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if train:
        sd = tmod.state_dict()
        want_stats = state_dict_from_flax({}, jax.device_get(upd.get("batch_stats", {})))
        assert set(want_stats) == {k for k in sd if k.endswith(("running_mean", "running_var"))}
        assert bool(want_stats) == (not name.startswith("convnext"))
        before = state_dict_from_flax({}, v.get("batch_stats", {}))
        for k, w in want_stats.items():
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
            assert not np.allclose(sd[k].numpy(), before[k].numpy())


def test_dilated_resnet_keeps_the_stride_32_parameters():
    """make_dilated changes strides and dilations only: the state dict of
    each output stride has the same keys and shapes, and the deepest
    feature lands at stride 16 / 8."""
    shapes = {}
    for os_ in (32, 16, 8):
        enc = tmt.make_encoder("resnet50", 3, output_stride=os_)
        shapes[os_] = {k: tuple(t.shape) for k, t in enc.state_dict().items()}
        with torch.no_grad():
            feats = enc.eval()(torch.zeros(1, PX, PX, 3))
        assert feats[-1].shape[1] == PX // os_
    assert shapes[32] == shapes[16] == shapes[8]
    trunc = tmt.make_encoder("resnet34", 3, depth=3).state_dict()
    assert not any(k.startswith(("layer3", "layer4")) for k in trunc)


@pytest.mark.parametrize("variant", ["b0", "b4", "b7", "micro"])
def test_efficientnet_channel_math_matches_jax(variant):
    name = f"efficientnet_{variant}"
    assert tmt.effnet_spec(name) == jmt.effnet_spec(name)
    assert tmt.encoder_out_channels(name, 4) == jmt.encoder_out_channels(name, 4)
    enc = tmt.make_encoder(name, 4)
    assert enc.out_channels == jmt.encoder_out_channels(name, 4)


@pytest.mark.parametrize("name", ["convnext_tiny", "convnext_base.fb_in22k",
                                  "tu-convnext_micro", "swin_base_patch4_window12_384",
                                  "resnet101", "efficientnet_b3.ra2_in1k"])
def test_encoder_names_resolve_as_jax(name):
    assert tmt.encoder_out_channels(name, 3) == tuple(jmt.encoder_out_channels(name, 3))
    assert tmt.convnext_spec(name) == jmt.convnext_spec(name)
    assert tmt.swin_spec(name) == jmt.swin_spec(name)


@pytest.mark.parametrize("name,kw", [
    ("vgg16", {}), ("convnext_huge", {}), ("efficientnet_b9", {}),
    ("convnext_micro", dict(output_stride=16)),
    ("efficientnet_micro", dict(output_stride=8)),
    ("swin_micro_patch4_window4_64", dict(depth=3)),
])
def test_rejected_encoders_raise_the_jax_error(name, kw):
    with pytest.raises(ValueError) as jerr:
        jmt.make_encoder(name, 3, name="encoder", **kw)
    with pytest.raises(ValueError) as terr:
        tmt.make_encoder(name, 3, **kw)
    assert str(terr.value) == str(jerr.value)
