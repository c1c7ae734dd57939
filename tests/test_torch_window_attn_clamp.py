"""The min(s, 80) clamp of the attn_f32 softmax: K2's forward and K6's
backward on the CPU (their plain versions) against the Pallas kernels in
interpret mode, on the inputs of tests/test_window_attn_kernel.py:222-313.

A +200 spike in every score row lies far past exp's float32 range without
a shift; the clamp leaves the one dominant entry's softmax as it is (the
clamped spike still wins by e^80), so the port must be finite and agree
with the reference at that file's tolerances: 2e-4 forward, 1e-3 for each
of the six gradients. With every score at +200 the softmax saturates to
uniform and only finiteness is asserted, as the reference does. Geometry:
B*nW = 12 (a 2 x 3 window grid, batch 2), T = 16 (window 4), C = 128, 4
heads, shift 0 and 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.ops.pallas import window_attn as jwa
from flair_for_aigle_tpu_torch.ops import window_attn
from tests._torch_threads import few_torch_threads  # noqa: F401

NAMES = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
T, C, NH, WS = 16, 128, 4, 4


def _weights(rng, zero_biases: bool):
    wqkv = rng.normal(size=(C, 3 * C)) * 0.05
    bqkv = np.zeros(3 * C) if zero_biases else rng.normal(size=(3 * C,)) * 0.05
    wproj = rng.normal(size=(C, C)) * 0.05
    bproj = np.zeros(C) if zero_biases else rng.normal(size=(C,)) * 0.05
    return [a.astype(np.float32) for a in (wqkv, bqkv, wproj, bproj)]


def spike_case():
    """tests/test_window_attn_kernel.py:233-245: one +200 spike in every
    score row, scattered across columns and heads."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(12, T, C)).astype(np.float32)
    wqkv, bqkv, wproj, bproj = _weights(rng, False)
    bias = rng.normal(size=(NH, T, T)).astype(np.float32) * 0.5
    for h in range(NH):
        for i in range(T):
            bias[h, i, (i * 7 + h) % T] = 200.0
    g = rng.normal(size=(12, T, C)).astype(np.float32)
    return (x, wqkv, bqkv, wproj, bproj, bias), g, (2, 3)


def saturated_case():
    """tests/test_window_attn_kernel.py:284-294: every score at +200."""
    rng = np.random.default_rng(19)
    x = rng.normal(size=(4, T, C)).astype(np.float32)
    wqkv, bqkv, wproj, bproj = _weights(rng, True)
    bias = np.full((NH, T, T), 200.0, np.float32)
    g = rng.normal(size=(4, T, C)).astype(np.float32)
    return (x, wqkv, bqkv, wproj, bproj, bias), g, (2, 2)


def _port(args, g, shift, grid):
    """K2 and K6 on CPU tensors (their plain versions); the weights in the
    nn.Linear layout, the weight gradients back in the Pallas one."""
    x, wqkv, bqkv, wproj, bproj, bias = (torch.from_numpy(a.copy()) for a in args)
    kw = dict(num_heads=NH, window_size=WS, shift_size=shift, grid_hw=grid, attn_f32=True)
    targs = (x, wqkv.t().contiguous(), bqkv, wproj.t().contiguous(), bproj, bias)
    out = window_attn.fused_window_attention(*targs, **kw)
    grads = [v.numpy() for v in window_attn.fused_window_attention_backward(
        torch.from_numpy(g.copy()), *targs, **kw)]
    grads[1], grads[3] = grads[1].T, grads[3].T
    return out.numpy(), grads


def _pallas(args, g, shift, grid):
    jargs = tuple(jnp.asarray(a.copy()) for a in args)
    kw = dict(num_heads=NH, window_size=WS, shift_size=shift, grid_hw=grid, interpret=True)
    out = jwa._kernel_call(*jargs, out_dtype=jnp.float32, **kw)
    grads = jwa._kernel_bwd(jargs, jnp.asarray(g.copy()), **kw)
    assert grads is not None
    return np.asarray(out), [np.asarray(v, np.float32) for v in grads]


@pytest.mark.parametrize("shift", [0, 2])
def test_extreme_scores_finite_and_match_pallas(shift):
    args, g, grid = spike_case()
    got, got_grads = _port(args, g, shift, grid)
    want, want_grads = _pallas(args, g, shift, grid)
    assert np.all(np.isfinite(got)), "forward NaN/inf at score 200"
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for name, a, e in zip(NAMES, got_grads, want_grads):
        assert a.shape == e.shape and np.all(np.isfinite(a)), f"{name} NaN/inf at score 200"
        np.testing.assert_allclose(a, e, rtol=1e-3, atol=1e-3, err_msg=name)


def test_extreme_scores_hit_the_clamp():
    """The spike case really drives scores past CLAMP: without the clamp
    the attn_f32 form's exp(s - 30) overflows float32."""
    (x, wqkv, bqkv, _, _, bias), _, grid = spike_case()
    qkv = torch.from_numpy(x).reshape(-1, C) @ torch.from_numpy(wqkv) + torch.from_numpy(bqkv)
    q, k, _ = window_attn._split_heads(qkv, NH, T)
    s = window_attn._scores(q, k, torch.from_numpy(bias), window_size=WS, shift_size=0,
                            grid_hw=grid, attn_f32=True)
    assert float(s.max()) > window_attn.CLAMP + 100
    assert not torch.isfinite(torch.exp(s - window_attn.SHIFT)).all()


def test_saturated_scores_stay_finite():
    args, g, grid = saturated_case()
    got, got_grads = _port(args, g, 0, grid)
    assert np.all(np.isfinite(got))
    for name, a in zip(NAMES, got_grads):
        assert np.all(np.isfinite(a)), name
