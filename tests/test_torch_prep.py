"""K1 plain version (flair_for_aigle_tpu_torch.ops.prep) vs the Pallas
prologue kernel in interpret mode, on the same numpy inputs.

Tolerances: float32 within 1e-5 (same math, summation order may differ);
bfloat16 within one bf16 unit in the last place of the reference value, or
1e-5 absolute near zero (the float32 LN differs by that much before the
rounding, which at |v| ~ 1e-6 is many bf16 ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import prep as jprep
from flair_for_aigle_tpu_torch.ops import prep


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.abs(v.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7), 2.0 ** -133)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,ss", [(24, 0), (24, 6), (20, 0), (20, 6)])
def test_prep_plain_matches_pallas(hw, ss, dtype):
    b, c, ws = 2, 128, 12
    rng = np.random.default_rng(hw * 10 + ss)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    s = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)

    want = jprep.fused_ln_shift_partition(
        jnp.asarray(x.copy()).astype(dtype), jnp.asarray(s.copy()),
        jnp.asarray(bias.copy()), ws=ws, ss=ss, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = prep.fused_ln_shift_partition(
        torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(s.copy()),
        torch.from_numpy(bias.copy()), ws=ws, ss=ss)
    assert got.dtype == tdt
    got = got.float().numpy()
    hp = hw + (ws - hw % ws) % ws
    assert got.shape == want.shape == (b * (hp // ws) ** 2, ws * ws, c)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= np.maximum(_bf16_ulp(want), 1e-5))


def test_window_partition_roundtrip():
    x = torch.arange(2 * 24 * 36 * 3, dtype=torch.float32).reshape(2, 24, 36, 3)
    win = prep.window_partition(x, 12)
    assert win.shape == (2 * 2 * 3, 144, 3)
    assert torch.equal(prep.window_reverse(win, 12, 24, 36), x)


@pytest.mark.parametrize("hw,ss", [(24, 0), (20, 6)])
def test_prep_gradient_matches_jax_vjp(hw, ss):
    """Autograd through the port's op (its backward recomputes through the
    plain version) vs ``jax.vjp`` of the Pallas op, float32, 1e-4."""
    import jax

    b, c, ws = 2, 128, 12
    rng = np.random.default_rng(hw + ss)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    s = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    hp = hw + (ws - hw % ws) % ws
    g = rng.normal(size=(b * (hp // ws) ** 2, ws * ws, c)).astype(np.float32)
    _, pullback = jax.vjp(
        lambda *a: jprep.fused_ln_shift_partition(*a, ws=ws, ss=ss, interpret=True),
        *(jnp.asarray(v.copy()) for v in (x, s, bias)))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in (x, s, bias)]
    prep.fused_ln_shift_partition(*leaves, ws=ws, ss=ss).backward(torch.from_numpy(g))
    for name, t, e in zip(["dx", "dscale", "dbias"], leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4, atol=1e-4, err_msg=name)
