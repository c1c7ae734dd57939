"""K5 plain version (flair_for_aigle_tpu_torch.ops.merge) vs the Pallas
patch-merge kernel in interpret mode, its gradient vs ``jax.vjp``, and the
port's PatchMerging module vs the JAX module, on the same numpy inputs.

Tolerances: float32 2e-4 (LayerNorm over 512 channels and a 512-deep
float32 product, summed in another order). bfloat16: one ulp at the
output's largest magnitude (the LN rounds to bf16 before the product, so a
rounding flip there moves an output by that much). Gradients (float32,
both sides recompute through the plain twin): 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.swin import PatchMerging as JPatchMerging
from flair_for_aigle_tpu.ops.pallas import merge as jmerge
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.swin import PatchMerging
from flair_for_aigle_tpu_torch.ops import merge
from tests._torch_threads import few_torch_threads  # noqa: F401


C, OUT = 128, 256


def _inputs(seed=0, shape=(1, 16, 16, C)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    s = (rng.normal(size=(4 * shape[-1],)) * 0.1 + 1).astype(np.float32)
    b = (rng.normal(size=(4 * shape[-1],)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(4 * shape[-1], OUT)) * 0.05).astype(np.float32)  # JAX (in, out)
    return x, s, b, w


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -20))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_plain_matches_pallas(dtype):
    x, s, b, w = _inputs()
    want = jmerge.fused_patch_merge(jnp.asarray(x.copy()).astype(dtype), jnp.asarray(s.copy()),
                                    jnp.asarray(b.copy()), jnp.asarray(w.copy()),
                                    interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = merge.fused_patch_merge(torch.from_numpy(x.copy()).to(tdt), torch.from_numpy(s.copy()),
                                  torch.from_numpy(b.copy()), torch.from_numpy(w.T.copy()))
    assert got.dtype == tdt and got.shape == want.shape == (1, 8, 8, OUT)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())


def test_merge_gradient_matches_jax_vjp():
    x, s, b, w = _inputs(1)
    g = np.random.default_rng(2).normal(size=(1, 8, 8, OUT)).astype(np.float32)
    _, pullback = jax.vjp(lambda *a: jmerge.fused_patch_merge(*a, interpret=True),
                          *(jnp.asarray(v.copy()) for v in (x, s, b, w)))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    leaves = [torch.from_numpy(v.copy()).requires_grad_() for v in (x, s, b, w.T)]
    out = merge.fused_patch_merge(*leaves)
    out.backward(torch.from_numpy(g.copy()))
    got = [t.grad.numpy() for t in leaves]
    got[3] = got[3].T
    for name, a, e in zip(["dx", "dscale", "dbias", "dw"], got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hw", [16, 15])
def test_patch_merging_module_matches_jax(hw):
    # 15: the odd pad stays outside the fused op, as in the reference
    x = np.random.default_rng(3).normal(size=(2, hw, hw, C)).astype(np.float32)
    jmod = JPatchMerging(OUT, kernel_mode="off")
    variables = jmod.init(jax.random.key(0), jnp.asarray(x.copy()))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x.copy())))
    tmod = PatchMerging(C, OUT)
    tmod.load_state_dict(state_dict_from_flax(variables["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x.copy())).numpy()
    assert got.shape == want.shape == (2, (hw + 1) // 2, (hw + 1) // 2, OUT)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
