"""K6's plain version — the port's window-attention backward on the CPU,
autograd through the plain forward — vs the Pallas backward kernels in
interpret mode (``_kernel_bwd``), and torch autograd through the port's
WindowAttention module (bias-table gradient included) vs ``jax.grad``
through the JAX module, on the same numpy inputs.

Geometries: a monolithic one (C = 128, 4 heads) and the gated head-chunked
one of tests/test_window_attn_kernel.py:349-387 (C = 1024, 32 heads), both
at window 4 with shift 0 and 2. Tolerances from those tests: float32
rtol = atol = 2e-3; bfloat16 median relative error < 0.04 per gradient
(the two sides round through bf16 at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.swin import WindowAttention as JWindowAttention
from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.swin import WindowAttention
from flair_for_aigle_tpu_torch.ops import window_attn
from flair_for_aigle_tpu_torch.ops.prep import window_partition, window_reverse
from tests._torch_threads import few_torch_threads  # noqa: F401


NAMES = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
WS, NWH, NWW = 4, 2, 2


def _case(c, nh, seed):
    rng = np.random.default_rng(seed)
    t, bnw = WS * WS, NWH * NWW
    std = 0.05 if c == 128 else 0.02
    return (rng.normal(size=(bnw, t, c)).astype(np.float32),
            (rng.normal(size=(c, 3 * c)) * std).astype(np.float32),
            (rng.normal(size=(3 * c,)) * std).astype(np.float32),
            (rng.normal(size=(c, c)) * std).astype(np.float32),
            (rng.normal(size=(c,)) * std).astype(np.float32),
            (rng.normal(size=(nh, t, t)) * 0.5).astype(np.float32),
            rng.normal(size=(bnw, t, c)).astype(np.float32))


@pytest.mark.parametrize("c,nh,dtype,attn_f32", [
    (128, 4, "float32", True), (128, 4, "float32", False),
    (128, 4, "bfloat16", True), (128, 4, "bfloat16", False),
    (1024, 32, "float32", True), (1024, 32, "bfloat16", False)])
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_backward_matches_pallas_backward(c, nh, dtype, attn_f32, shift):
    x, wqkv, bqkv, wproj, bproj, bias, g = _case(c, nh, 7 + shift + c)
    if c == 1024:  # the geometry gates the monolithic TPU kernel: chunked
        assert jwa._pick_bw_bwd(NWH * NWW, WS * WS, c, nh, 4) == 0
    kw = dict(num_heads=nh, window_size=WS, shift_size=shift, grid_hw=(NWH, NWW),
              attn_f32=attn_f32)
    jargs = (jnp.asarray(x.copy()).astype(dtype), *(jnp.asarray(v.copy()).astype(dtype)
             for v in (wqkv, bqkv, wproj, bproj)), jnp.asarray(bias.copy()))
    want = jwa._kernel_bwd(jargs, jnp.asarray(g.copy()).astype(dtype), interpret=True, **kw)
    assert want is not None
    want = [np.asarray(v, np.float32) for v in want]
    want[1], want[3] = want[1].T, want[3].T           # (C, 3C) -> nn.Linear (3C, C)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(v.copy()).to(tdt) for v in (x, wqkv.T, bqkv, wproj.T, bproj)]
    got = window_attn.fused_window_attention_backward(
        torch.from_numpy(g.copy()).to(tdt), *targs, torch.from_numpy(bias.copy()), **kw)
    for name, a, e in zip(NAMES, got, want):
        a = a.float().numpy()
        assert a.shape == e.shape and np.all(np.isfinite(a)), name
        if dtype == "float32":
            np.testing.assert_allclose(a, e, rtol=2e-3, atol=2e-3, err_msg=name)
        else:
            assert np.median(np.abs(a - e) / np.maximum(np.abs(e), 1e-2)) < 0.04, name


@pytest.mark.parametrize("shift", [0, 2])
def test_window_attention_module_grads_match_jax(shift):
    c, nh = 128, 4
    y = np.random.default_rng(11).normal(size=(2, 8, 8, c)).astype(np.float32)
    r = np.random.default_rng(12).normal(size=(2, 8, 8, c)).astype(np.float32)
    jmod = JWindowAttention(dim=c, num_heads=nh, table_window=WS, window_size=(WS, WS),
                            shift_size=shift, kernel_mode="off")
    variables = jmod.init(jax.random.key(3), jnp.asarray(y.copy()))

    def jloss(params, yy):
        return jnp.sum(jmod.apply({"params": params}, yy) * jnp.asarray(r))

    jg_params, jg_y = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(y.copy()))
    want = state_dict_from_flax(jax.device_get(jg_params))
    tmod = WindowAttention(c, nh, WS)
    tmod.load_state_dict(state_dict_from_flax(variables["params"]), strict=True)
    ty = torch.from_numpy(y.copy()).requires_grad_()
    win = window_partition(ty, WS).contiguous()
    out = window_reverse(tmod(win, window_size=WS, shift_size=shift, grid_hw=(2, 2)), WS, 8, 8)
    (out * torch.from_numpy(r)).sum().backward()
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jg_y), rtol=2e-4, atol=2e-4)
