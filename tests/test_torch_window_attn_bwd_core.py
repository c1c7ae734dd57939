"""K6's attention core alone (flair_for_aigle_tpu_torch.ops.window_attn
``window_attention_core_backward``): its plain version, composed with K6's
GEMMs in the Pallas order, against the Pallas backward kernel in interpret
mode (``_kernel_bwd``), and in float32 against autograd through the plain
forward core, on the same numpy inputs. The float32 core's precision
scheme, 3xTF32 (every product as a_lo b_hi + a_hi b_lo + a_hi b_hi of
operands split into tf32 halves, float32 accumulation), emulated on the
plain core, against both the Pallas backward and the exact plain core.

The composition: qkv = rnd(rnd(x Wqkv^T) + bqkv), do = rnd(g Wproj), the
core's (o, dqkv, dbias, dbqkv), then dWproj = g^T o, dWqkv = dqkv^T x, dx =
rnd(dqkv Wqkv) and dbproj = the column sums of g, as ``_bwd_kernel_body``
(:446-528) orders them. Tolerances of tests/test_torch_window_attn_bwd.py:
float32 2e-3; bfloat16 median relative error < 0.04 per gradient.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.ops import window_attn
from tests._tf32 import matmul_3xtf32, split, tf32
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


def _composed(x, wqkv, bqkv, wproj, bias, g, core=None, **kw):
    """K6 on the CPU: its GEMMs around the plain core (or ``core``), in the
    Pallas order. Weights in the nn.Linear layout; returns (dx, dwqkv,
    dbqkv, dwproj, dbproj, dbias)."""
    bnw, t, c = x.shape
    dt = x.dtype
    x2, g2 = x.reshape(bnw * t, c), g.reshape(bnw * t, c)
    qkv = window_attn._linear(x2, wqkv, bqkv)
    do = torch.matmul(g2, wproj.to(dt))
    o, dqkv, dbias, dbqkv = (core or window_attn.window_attention_core_backward)(
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


def _core_3xtf32(qkv, do, bias, **kw):
    """The plain float32 core with every product (q k^T, p v, p^T do,
    do v^T, ds k, ds^T q) taken as 3xTF32."""
    with mock.patch.object(torch, "matmul", matmul_3xtf32):
        return window_attn.window_attention_core_backward_reference(qkv, do, bias, **kw)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's unit at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -23, -(one + ulp / 2),
                      one + 3 * ulp / 2, 3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0e-39, 0.0])
    got = tf32(x)
    assert torch.equal(got[:4], want[:4].float())
    assert got[4].item() == pytest.approx(3.0e-39, rel=2 ** -10) and got[5].item() == 0.0
    assert not (got.view(torch.int32) & 0x1FFF).any()  # the low 13 bits are clear


def test_the_tf32_split_holds_float32_to_2_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    x = x * torch.exp2(torch.from_numpy(np.random.default_rng(1).integers(-20, 20, 4096)).float())
    hi, lo = split(x)
    assert (((hi.double() + lo.double()) - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("half_shift", [False, True])
@pytest.mark.parametrize("ws", [4, 12])
def test_3xtf32_core_in_k6_matches_pallas_backward(ws, half_shift, attn_f32):
    """The float32 core's precision scheme is accurate enough for K6's
    float32 bound: the 3xTF32 core composed with K6's GEMMs against the
    Pallas backward in float32, 2e-3 (the test above)."""
    x, wqkv, bqkv, wproj, bproj, bias, g = _case(ws, 13 + ws + half_shift)
    kw = dict(num_heads=NH, window_size=ws, shift_size=ws // 2 if half_shift else 0,
              grid_hw=GRID, attn_f32=attn_f32)
    jargs = (jnp.asarray(x.copy()), *(jnp.asarray(v.copy()) for v in (wqkv, bqkv, wproj, bproj)),
             jnp.asarray(bias.copy()))
    want = jwa._kernel_bwd(jargs, jnp.asarray(g.copy()), interpret=True, **kw)
    want = [np.asarray(v, np.float32) for v in want]
    want[1], want[3] = want[1].T, want[3].T           # (C, 3C) -> nn.Linear (3C, C)
    got = _composed(*(torch.from_numpy(v.copy()) for v in (x, wqkv.T, bqkv, wproj.T)),
                    torch.from_numpy(bias.copy()), torch.from_numpy(g.copy()),
                    core=_core_3xtf32, **kw)
    for name, a, e in zip(NAMES, got, want):
        a = a.float().numpy()
        assert a.shape == e.shape and np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, e, rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("attn_f32", [True, False])
@pytest.mark.parametrize("ws,shift", [(4, 2), (12, 6), (12, 0)])
def test_3xtf32_core_matches_the_exact_plain_core(ws, shift, attn_f32):
    """The 3xTF32 core against the plain float32 core: each output within
    1e-4 of its largest magnitude, the bound the card tests hold the float32
    kernel to (each product is off by about 2^-21 of its magnitude)."""
    rng = np.random.default_rng(ws + shift + 7 * attn_f32)
    t, bnw = ws * ws, GRID[0] * GRID[1]
    qkv = torch.from_numpy(rng.normal(size=(bnw * t, 3 * C)).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(NH, t, t)) * 0.5).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(bnw * t, C)).astype(np.float32))
    kw = dict(num_heads=NH, window_size=ws, shift_size=shift, grid_hw=GRID, attn_f32=attn_f32)
    want = window_attn.window_attention_core_backward_reference(qkv, do, bias, **kw)
    got = _core_3xtf32(qkv, do, bias, **kw)
    names = ("o", "dqkv", "dbias", "dbqkv")
    for name, a, e in zip(names, got, want):
        assert not torch.equal(a, e), name  # the emulation took effect
        tol = 1e-4 * e.abs().max().item()
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("bnw,nh,slots,groups", [
    # bf16 core at T = 144: 2 blocks on each of 132 SMs; swin-base@512 at
    # batch 2, the grids measured before residency set them
    (242, 4, 264, 61), (72, 8, 264, 24), (18, 16, 264, 9), (8, 32, 264, 8),
    # float32 core: 1 block a SM; batch 2 and batch 5 (stage 3: 45 windows
    # of 16 heads, one wave of 128 blocks)
    (242, 4, 132, 31), (18, 16, 132, 6), (45, 16, 132, 8), (180, 8, 132, 15)])
def test_core_groups_fill_one_wave_of_the_resident_blocks(bnw, nh, slots, groups):
    got = window_attn._core_groups(bnw, nh, slots)
    per = -(-bnw // got)
    assert got == groups
    assert got * nh <= slots and (got - 1) * per < bnw <= got * per
