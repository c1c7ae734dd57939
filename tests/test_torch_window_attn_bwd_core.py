"""K6's attention core alone (flair_for_aigle_tpu_torch.ops.window_attn
``window_attention_core_backward``): its plain version, composed with K6's
GEMMs in the Pallas order, against the Pallas backward kernel in interpret
mode (``_kernel_bwd``), and in float32 against autograd through the plain
forward core, on the same numpy inputs.

The composition: qkv = rnd(rnd(x Wqkv^T) + bqkv), do = rnd(g Wproj), the
core's (o, dqkv, dbias, dbqkv), then dWproj = g^T o, dWqkv = dqkv^T x, dx =
rnd(dqkv Wqkv) and dbproj = the column sums of g, as ``_bwd_kernel_body``
(:446-528) orders them. Tolerances of tests/test_torch_window_attn_bwd.py:
float32 2e-3; bfloat16 median relative error < 0.04 per gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.ops import window_attn
from tests._torch_threads import few_torch_threads  # noqa: F401

NAMES = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
C, NH, GRID = 64, 2, (2, 2)


def _case(ws: int, seed: int):
    rng = np.random.default_rng(seed)
    t, bnw = ws * ws, GRID[0] * GRID[1]
    return (rng.normal(size=(bnw, t, C)).astype(np.float32),
            (rng.normal(size=(C, 3 * C)) * 0.08).astype(np.float32),
            (rng.normal(size=(3 * C,)) * 0.08).astype(np.float32),
            (rng.normal(size=(C, C)) * 0.08).astype(np.float32),
            (rng.normal(size=(C,)) * 0.08).astype(np.float32),
            (rng.normal(size=(NH, t, t)) * 0.5).astype(np.float32),
            rng.normal(size=(bnw, t, C)).astype(np.float32))


def _composed(x, wqkv, bqkv, wproj, bias, g, **kw):
    """K6 on the CPU: its GEMMs around the plain core, in the Pallas order.
    Weights in the nn.Linear layout; returns (dx, dwqkv, dbqkv, dwproj,
    dbproj, dbias)."""
    bnw, t, c = x.shape
    dt = x.dtype
    x2, g2 = x.reshape(bnw * t, c), g.reshape(bnw * t, c)
    qkv = window_attn._linear(x2, wqkv, bqkv)
    do = torch.matmul(g2, wproj.to(dt))
    o, dqkv, dbias, dbqkv = window_attn.window_attention_core_backward(
        qkv, do, bias, **kw)
    dwproj = torch.matmul(g2.float().t(), o.float())
    dwqkv = torch.matmul(dqkv.float().t(), x2.float())
    dx = torch.matmul(dqkv, wqkv.to(dt)).reshape(bnw, t, c)
    return dx, dwqkv, dbqkv, dwproj, g2.float().sum(0), dbias


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("ws", [4, 12])
def test_plain_core_in_k6_matches_pallas_backward(ws, half_shift, dtype, attn_f32):
    x, wqkv, bqkv, wproj, bproj, bias, g = _case(ws, 3 + ws + half_shift)
    kw = dict(num_heads=NH, window_size=ws, shift_size=ws // 2 if half_shift else 0,
              grid_hw=GRID, attn_f32=attn_f32)
    jargs = (jnp.asarray(x.copy()).astype(dtype), *(jnp.asarray(v.copy()).astype(dtype)
             for v in (wqkv, bqkv, wproj, bproj)), jnp.asarray(bias.copy()))
    want = jwa._kernel_bwd(jargs, jnp.asarray(g.copy()).astype(dtype), interpret=True, **kw)
    want = [np.asarray(v, np.float32) for v in want]
    want[1], want[3] = want[1].T, want[3].T           # (C, 3C) -> nn.Linear (3C, C)
    tdt = getattr(torch, dtype)
    got = _composed(*(torch.from_numpy(v.copy()).to(tdt) for v in (x, wqkv.T, bqkv, wproj.T)),
                    torch.from_numpy(bias.copy()), torch.from_numpy(g.copy()).to(tdt), **kw)
    for name, a, e in zip(NAMES, got, want):
        a = a.float().numpy()
        assert a.shape == e.shape and np.all(np.isfinite(a)), name
        if dtype == "float32":
            np.testing.assert_allclose(a, e, rtol=2e-3, atol=2e-3, err_msg=name)
        else:
            assert np.median(np.abs(a - e) / np.maximum(np.abs(e), 1e-2)) < 0.04, name


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,shift", [(4, 2), (12, 6), (12, 0)])
def test_plain_core_matches_autograd_through_the_forward_core(ws, shift, attn_f32):
    """float32: the plain core's closed-form softmax backward against
    autograd through ``window_attention_core_reference``. Both compute the
    same float32 function; autograd takes the derivative of the deferred
    normalisation (and, without attn_f32, of the row max, whose terms sum
    to 0) in another algebraic form, so the two differ by float32 rounding
    alone: 1e-5 of each output's largest magnitude."""
    rng = np.random.default_rng(ws + shift + attn_f32)
    t, bnw = ws * ws, GRID[0] * GRID[1]
    qkv = torch.from_numpy(rng.normal(size=(bnw * t, 3 * C)).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(NH, t, t)) * 0.5).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(bnw * t, C)).astype(np.float32))
    kw = dict(num_heads=NH, window_size=ws, shift_size=shift, grid_hw=GRID, attn_f32=attn_f32)
    o, dqkv, dbias, dbqkv = window_attn.window_attention_core_backward_reference(
        qkv, do, bias, **kw)
    qkv_a, bias_a = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    o_a = window_attn.window_attention_core_reference(qkv_a, bias_a, **kw)
    o_a.backward(do)
    for name, a, e in (("o", o, o_a.detach()), ("dq", dqkv[:, :C], qkv_a.grad[:, :C]),
                       ("dk", dqkv[:, C:2 * C], qkv_a.grad[:, C:2 * C]),
                       ("dv", dqkv[:, 2 * C:], qkv_a.grad[:, 2 * C:]),
                       ("dbias", dbias, bias_a.grad), ("dbqkv", dbqkv, qkv_a.grad.sum(0))):
        tol = 1e-5 * e.abs().max().item()
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("attn_f32", [True, False])
def test_core_backward_wrapper_takes_the_plain_version_on_cpu_tensors(attn_f32):
    ws, t = 4, 16
    bnw = GRID[0] * GRID[1]
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(bnw * t, 3 * C)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.normal(size=(bnw * t, C)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy((rng.normal(size=(NH, t, t)) * 0.5).astype(np.float32))
    kw = dict(num_heads=NH, window_size=ws, shift_size=2, grid_hw=GRID, attn_f32=attn_f32)
    window_attn.window_attention_core_backward.launches = 0
    got = window_attn.window_attention_core_backward(qkv, do, bias, **kw)
    assert window_attn.window_attention_core_backward.launches == 0
    want = window_attn.window_attention_core_backward_reference(qkv, do, bias, **kw)
    assert [a.dtype for a in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    assert [a.shape for a in got] == [(bnw * t, C), (bnw * t, 3 * C), (NH, t, t), (3 * C,)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
