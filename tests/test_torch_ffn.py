"""K3 plain version (flair_for_aigle_tpu_torch.ops.ffn) vs the Pallas
residual + LN + MLP + residual kernel in interpret mode, on the same numpy
inputs.

Tolerances: float32 2e-4 as tests/test_ffn_kernel.py uses it. bfloat16:
one ulp of the kernel's XLA twin (``_xla_forward``) per element, and one
ulp at the output's largest magnitude against the interpret-mode kernel,
which sits that far from its own twin at bf16. The Pallas GELU evaluates erf through the A&S 7.1.27
polynomial (|err| <= 2.7e-7), torch's is exact: the difference sits far
inside the float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas.ffn import _xla_forward
from flair_for_aigle_tpu.ops.pallas.ffn import fused_ln_mlp_residual as jffn
from flair_for_aigle_tpu_torch.ops import ffn


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -20)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_plain_matches_pallas(dtype):
    c, hidden = 128, 512
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 8, c)).astype(np.float32)
    a = rng.normal(size=(2, 4, 8, c)).astype(np.float32)
    ln_s = (rng.normal(size=(c,)) * 0.1 + 1).astype(np.float32)
    ln_b = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(c, hidden)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(hidden,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(hidden, c)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(c,)) * 0.05).astype(np.float32)

    acts = [jnp.asarray(v.copy()).astype(dtype) for v in (x, a)]
    params = [jnp.asarray(v.copy()) for v in (ln_s, ln_b, w1, b1, w2, b2)]
    want = np.asarray(jffn(*acts, *params, interpret=True).astype(jnp.float32))
    twin = np.asarray(_xla_forward(*acts, *params, eps=1e-5).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = ffn.fused_ln_mlp_residual(
        torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(a.copy()).to(tdt),
        torch.from_numpy(ln_s.copy()), torch.from_numpy(ln_b.copy()),
        torch.from_numpy(w1.T.copy()), torch.from_numpy(b1.copy()),
        torch.from_numpy(w2.T.copy()), torch.from_numpy(b2.copy()))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        # bf16: one ulp of the kernel's XLA twin at every element; against
        # the interpret-mode kernel, which itself sits up to one ulp at the
        # output's scale from its twin, one ulp at that scale
        assert np.all(np.abs(got - twin) <= _bf16_ulp(twin))
        scale_ulp = _bf16_ulp(np.abs(want).max())
        assert np.abs(got - want).max() <= scale_ulp
        assert np.abs(twin - want).max() <= scale_ulp


def test_gelu_exact_matches_torch_gelu():
    h = torch.linspace(-6, 6, 1001)
    np.testing.assert_allclose(
        ffn.gelu_exact(h).numpy(),
        torch.nn.functional.gelu(h, approximate="none").numpy(),
        rtol=1e-5, atol=1e-6)


def test_ffn_gradient_matches_jax_vjp():
    """Autograd through the port's op (its backward recomputes through the
    plain version) vs ``jax.vjp`` of the Pallas op (its default
    recompute route), float32, 1e-4."""
    import jax

    c, hidden = 128, 512
    rng = np.random.default_rng(5)
    vals = [rng.normal(size=(2, 4, 8, c)), rng.normal(size=(2, 4, 8, c)),
            rng.normal(size=(c,)) * 0.1 + 1, rng.normal(size=(c,)) * 0.1,
            rng.normal(size=(c, hidden)) * 0.05, rng.normal(size=(hidden,)) * 0.05,
            rng.normal(size=(hidden, c)) * 0.05, rng.normal(size=(c,)) * 0.05]
    vals = [v.astype(np.float32) for v in vals]
    g = rng.normal(size=(2, 4, 8, c)).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: jffn(*a, interpret=True),
                          *(jnp.asarray(v.copy()) for v in vals))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    want[4], want[6] = want[4].T, want[6].T           # nn.Linear layout
    tv = [v.T if i in (4, 6) else v for i, v in enumerate(vals)]
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in tv]
    ffn.fused_ln_mlp_residual(*leaves).backward(torch.from_numpy(g))
    names = ["dx", "dattn", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"]
    for name, t, e in zip(names, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4, atol=1e-4, err_msg=name)
