"""The port's UTAE against the JAX package's, on the CPU: the strided,
bf16 and training-mode cases (helpers from ``tests/test_torch_utae.py``).

* UTAE strided (k4 s2 p1: transposed convolutions that double the maps,
  the attention resized up to the skips) with padded dates, within 1e-4 of
  each output's largest magnitude in float32.
* UTAE in bf16 on reflectance-like inputs with padded dates, against the
  JAX forward in bf16 (the zonal step's compute dtype), within 4e-2 of the
  largest magnitude: both round every convolution to bf16, in different
  orders.
* ``_smart_forward`` with a BatchNorm encoder in training mode: the padded
  frames count in the batch statistics, so the outputs and the running
  statistics are the JAX package's, and the padded frames come out as
  ``pad_value``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flair_for_aigle_tpu.models import utae as ju
from flair_for_aigle_tpu_torch.models import utae as tu
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from tests.test_torch_utae import STRIDES, UTAE_CFG, _close, _ts_inputs, _utae_pair


def test_strided_utae_with_padded_dates_matches_jax():
    kw = {**UTAE_CFG, **STRIDES["strided"], "return_maps": True}
    x, dates = _ts_inputs()
    jmod, tmod, v = _utae_pair(kw, x, dates)
    want_out, want_maps = jmod.apply(v, jnp.asarray(x), jnp.asarray(dates))
    with torch.no_grad():
        out, maps = tmod(torch.from_numpy(x.copy()), torch.from_numpy(dates.copy()))
    _close(out.numpy(), want_out, 1e-4)
    assert [m.shape[1] for m in maps] == [4, 8, 16]
    for g, w in zip(maps, want_maps):
        _close(g.numpy(), w, 1e-4)


def test_utae_bf16_matches_the_jax_bf16_forward():
    kw = {**UTAE_CFG, **STRIDES["stride1"]}
    x, dates = _ts_inputs(seed=2)
    x = x * 300 + 1000  # reflectance-like values, as the zonal step casts them
    x[:, -2:] = 0.0
    x[1, 1] = 0.0
    jmod, tmod, v = _utae_pair(kw, x, dates)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jmod.apply(v, xb, jnp.asarray(dates)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.copy()).to(torch.bfloat16),
                   torch.from_numpy(dates.copy()))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 4e-2)


def test_smart_forward_counts_padded_frames_in_batch_statistics():
    x, _ = _ts_inputs(pad_frames=2, seed=7, c=3, hw=8)
    jmod = ju.ConvBlock(nkernels=[3, 8, 8], pad_value=0.0, norm="batch")
    tmod = tu.ConvBlock([3, 8, 8], pad_value=0.0, norm="batch").train()
    v = jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x), smart=True))
    tmod.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]), strict=True)
    want, upd = jmod.apply(v, jnp.asarray(x), train=True, smart=True,
                           mutable=["batch_stats"])
    got = tmod(torch.from_numpy(x.copy()), smart=True)
    _close(got.detach().numpy(), want, 1e-5)
    assert (got[:, -2:] == 0).all() and (got[1, 1] == 0).all()
    stats = state_dict_from_flax({}, jax.device_get(upd["batch_stats"]))
    for k, w in stats.items():
        _close(tmod.state_dict()[k].numpy(), w.numpy(), 1e-5)
