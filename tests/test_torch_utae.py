"""The port's UTAE and its layers against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the flax module and the port's,
with seeded flax parameters and BatchNorm statistics (``_fill``) carried
over by ``state_dict_from_flax`` and loaded strictly.

* Each layer the UTAE needs (reflect-padded ``TorchConv``,
  ``TorchConvTranspose``, ``TorchGroupNorm`` on maps and on (N, T, C)
  sequences, ``TorchInstanceNorm``, ``avg_pool2d``) within 1e-5 of the
  reference's largest magnitude, float32.
* ``positional_encoding`` and ``temporal_pad_mask``.
* UTAE with padded dates in the three aggregation modes at stride 1 (the
  zonal configuration's), with ``return_maps``, and with ``encoder=True``
  (strided): every output within 1e-4 of its largest magnitude in float32.

``tests/test_torch_utae_strided.py`` holds the strided, bf16 and
training-mode cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models import layers as jl
from flair_for_aigle_tpu.models import utae as ju
from flair_for_aigle_tpu_torch.models import layers as tl
from flair_for_aigle_tpu_torch.models import utae as tu
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax


def _fill(tree, rng, col):
    """Seeded values for every leaf of an ``eval_shape`` tree: kernels
    uniform within 1 / sqrt(fan-in), norm scales near one, biases and the
    learned query normal, BatchNorm means normal and variances in [0.5, 2]
    (so eval-mode normalisation is not the identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, col)
            continue
        shape = v.shape
        if col == "batch_stats":
            x = (rng.normal(0, 0.3, shape) if k == "mean"
                 else rng.uniform(0.5, 2.0, shape))
        elif k == "kernel":
            b = 1.0 / np.sqrt(max(1, int(np.prod(shape[:-1]))))
            x = rng.uniform(-b, b, shape)
        elif k == "scale":
            x = 1.0 + rng.normal(0, 0.1, shape)
        else:
            x = rng.normal(0, 0.5 if k.endswith(".Q") else 0.1, shape)
        out[k] = x.astype(np.float32)
    return out


def _carry(jmod, tmod, *args, seed=0, patterns=None, **kw):
    """Seeded flax variables of the shapes ``jmod`` takes on ``args`` (no
    init run), loaded strictly into the port's module through
    ``state_dict_from_flax`` (``patterns``: the paths of transposed
    convolutions, default UTAE's); returns the flax variables."""
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.key(seed), *a, **kw), *args)
    rng = np.random.default_rng(seed)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    extra = {} if patterns is None else {"transpose_conv_patterns": patterns}
    tmod.load_state_dict(state_dict_from_flax(v.get("params", {}), v.get("batch_stats"),
                                              **extra), strict=True)
    return v


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


LAYERS = {
    "conv_reflect": (lambda: jl.TorchConv(6, 3, 1, 1, padding_mode="reflect"),
                     lambda: tl.TorchConv(4, 6, 3, 1, 1, padding_mode="reflect"),
                     (2, 9, 7, 4)),
    "conv_reflect_strided": (lambda: jl.TorchConv(5, 4, 2, 1, padding_mode="reflect"),
                             lambda: tl.TorchConv(3, 5, 4, 2, 1, padding_mode="reflect"),
                             (2, 10, 10, 3)),
    "conv_transpose_k4s2p1": (lambda: jl.TorchConvTranspose(5, 4, 2, 1),
                              lambda: tl.TorchConvTranspose(3, 5, 4, 2, 1),
                              (2, 5, 6, 3)),
    "conv_transpose_k3s1p1": (lambda: jl.TorchConvTranspose(4, 3, 1, 1),
                              lambda: tl.TorchConvTranspose(6, 4, 3, 1, 1),
                              (1, 7, 7, 6)),
    "group_norm_map": (lambda: jl.TorchGroupNorm(num_groups=4),
                       lambda: tl.TorchGroupNorm(4, 8), (3, 5, 6, 8)),
    "group_norm_sequence": (lambda: jl.TorchGroupNorm(num_groups=4),
                            lambda: tl.TorchGroupNorm(4, 16), (7, 5, 16)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make_j, make_t, shape = LAYERS[name]
    x = (np.random.default_rng(3).normal(size=shape) * 3 + 1).astype(np.float32)
    jmod, tmod = make_j(), make_t()
    # a transposed convolution alone: its kernel's path is just "kernel"
    v = _carry(jmod, tmod, jnp.asarray(x),
               patterns=("kernel",) if "transpose" in name else ())
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.copy())).numpy()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shape,k", [((2, 8, 6, 3), 2), ((1, 2, 9, 9, 4), 3)])
def test_instance_norm_and_avg_pool_match_jax(shape, k):
    x = (np.random.default_rng(4).normal(size=shape) * 2 + 3).astype(np.float32)
    jn = jl.TorchInstanceNorm()
    want = np.asarray(jn.apply({}, jnp.asarray(x)))
    _close(tl.TorchInstanceNorm()(torch.from_numpy(x.copy())).numpy(), want, 1e-5)
    want = np.asarray(jl.avg_pool2d(jnp.asarray(x), k))
    _close(tl.avg_pool2d(torch.from_numpy(x.copy()), k).numpy(), want, 1e-6)


def test_positional_encoding_and_pad_mask_match_jax():
    rng = np.random.default_rng(1)
    bp = rng.integers(-200, 200, size=(3, 9)).astype(np.float32)
    want = np.asarray(ju.positional_encoding(jnp.asarray(bp), 16, 1000, repeat=4))
    got = tu.positional_encoding(torch.from_numpy(bp), 16, 1000, repeat=4)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-6)
    x = rng.normal(size=(2, 6, 5, 5, 3)).astype(np.float32)
    x[0, 4:] = 0.0
    x[1, 1] = 0.0
    x[1, 2, 0, 0, 0] = 0.0  # one zero pixel does not pad a frame
    want = np.asarray(ju.temporal_pad_mask(jnp.asarray(x), 0.0))
    got = tu.temporal_pad_mask(torch.from_numpy(x), 0.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 3


UTAE_CFG = dict(input_dim=4, encoder_widths=(16, 16, 32), decoder_widths=(8, 16, 32),
                out_conv=(8, 7), agg_mode="att_group", encoder_norm="group", n_head=4,
                d_model=32, d_k=4, pad_value=0.0, padding_mode="reflect")
STRIDES = {"strided": dict(str_conv_k=4, str_conv_s=2, str_conv_p=1),
           "stride1": dict(str_conv_k=3, str_conv_s=1, str_conv_p=1)}


def _ts_inputs(pad_frames=2, seed=0, b=2, t=6, c=4, hw=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, hw, hw, c)).astype(np.float32)
    x[:, t - pad_frames:] = 0.0
    x[1, 1] = 0.0  # a padded date in the middle of the series
    dates = np.sort(rng.integers(-180, 180, size=(b, t))).astype(np.float32)
    return x, dates


def _utae_pair(kw, x, dates):
    jmod, tmod = ju.UTAE(**kw), tu.UTAE(**kw).eval()
    v = _carry(jmod, tmod, jnp.asarray(x), jnp.asarray(dates))
    return jmod, tmod, v


@pytest.mark.parametrize("agg_mode", ["att_group", "att_mean", "mean"])
def test_utae_with_padded_dates_matches_jax(agg_mode, stride="stride1"):
    kw = {**UTAE_CFG, **STRIDES[stride], "agg_mode": agg_mode, "return_maps": True}
    x, dates = _ts_inputs()
    jmod, tmod, v = _utae_pair(kw, x, dates)
    want_out, want_maps = jmod.apply(v, jnp.asarray(x), jnp.asarray(dates))
    with torch.no_grad():
        out, maps = tmod(torch.from_numpy(x.copy()), torch.from_numpy(dates.copy()))
    _close(out.numpy(), want_out, 1e-4)
    assert out.shape[1:3] == (x.shape[2], x.shape[3])
    assert len(maps) == len(want_maps) == 3
    for g, w in zip(maps, want_maps):
        _close(g.numpy(), w, 1e-4)


def test_utae_encoder_mode_matches_jax():
    kw = {**UTAE_CFG, **STRIDES["strided"], "encoder": True}
    x, dates = _ts_inputs(pad_frames=1, seed=5)
    jmod, tmod, v = _utae_pair(kw, x, dates)
    assert not hasattr(tmod, "out_conv")
    want_out, want_maps = jmod.apply(v, jnp.asarray(x), jnp.asarray(dates))
    with torch.no_grad():
        out, maps = tmod(torch.from_numpy(x.copy()), torch.from_numpy(dates.copy()))
    _close(out.numpy(), want_out, 1e-4)
    for g, w in zip(maps, want_maps):
        _close(g.numpy(), w, 1e-4)
