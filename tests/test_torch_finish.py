"""K8 plain version (flair_for_aigle_tpu_torch.ops.finish) vs the Pallas
fused finish (window reverse + crop + un-shift + residual + LN + MLP +
residual) in interpret mode, on the same numpy inputs; and the port's
SwinBlock under ``FLAIR_SWIN_FINISH=1`` vs the JAX SwinBlock with its
kernels on under the same variable.

Geometries are tests/test_prep_kernel.py's (C 128, hidden 256): 24 x 24
unshifted and shifted, 20 x 20 padded and shifted, 16 x 16 with window 4.
Tolerances as the JAX tests use them: forward float32 2e-5 (the block
3e-5), gradients 1e-4.

The gather pass's plain version (``finish_gather_reference``, the kernel's
index map) is held against window reverse + crop + roll, and K3's plain
version on the gathered rows against the Pallas finish.

Each comparison checks that the JAX side really ran its Pallas finish
kernel: the op is called directly (it has no gate) and its ``_build_call``
is watched; the JAX block consults ``finish.supports``, which must hold for
the block's shapes, or the block would silently run the unfused path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.swin import SwinBlock as JSwinBlock
from flair_for_aigle_tpu.ops.pallas import finish as jfin
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.swin import SwinBlock
from flair_for_aigle_tpu_torch.ops import finish
from flair_for_aigle_tpu_torch.ops.ffn import fused_ln_mlp_residual_reference
from flair_for_aigle_tpu_torch.ops.prep import _padded, window_reverse
from tests._torch_threads import few_torch_threads  # noqa: F401

C, HIDDEN = 128, 256


@pytest.fixture
def pallas_calls(monkeypatch):
    """Geometries for which the JAX package built its Pallas finish call."""
    seen = []
    build = jfin._build_call

    def watched(b, h, w, *rest):
        seen.append((h, w))
        return build(b, h, w, *rest)

    monkeypatch.setattr(jfin, "_build_call", watched)
    return seen


def _inputs(seed, b, h, w, ws):
    rng = np.random.default_rng(seed)
    hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
    nw = (hp // ws) * (wp // ws)
    f = np.float32
    return [rng.standard_normal((b * nw, ws * ws, C)).astype(f),
            rng.standard_normal((b, h, w, C)).astype(f),
            (rng.standard_normal(C) * 0.1 + 1).astype(f),
            (rng.standard_normal(C) * 0.1).astype(f),
            (rng.standard_normal((C, HIDDEN)) * 0.05).astype(f),
            (rng.standard_normal(HIDDEN) * 0.05).astype(f),
            (rng.standard_normal((HIDDEN, C)) * 0.05).astype(f),
            (rng.standard_normal(C) * 0.05).astype(f)]


def _torch_args(vals):
    """numpy inputs in the JAX layout -> torch tensors, weights in the
    nn.Linear layout."""
    return [torch.from_numpy((v.T if i in (4, 6) else v).copy()) for i, v in enumerate(vals)]


@pytest.mark.parametrize("h,w,ws,ss", [(24, 24, 12, 0), (24, 24, 12, 6), (20, 20, 12, 6),
                                       (16, 16, 4, 2)])
def test_finish_plain_matches_pallas(h, w, ws, ss, pallas_calls):
    vals = _inputs(5, 2, h, w, ws)
    want = np.asarray(jfin.fused_reverse_ln_mlp_residual(
        *(jnp.asarray(v.copy()) for v in vals), ws=ws, ss=ss, interpret=True))
    assert pallas_calls == [(h, w)]
    got = finish.fused_reverse_ln_mlp_residual(*_torch_args(vals), ws=ws, ss=ss)
    assert got.shape == (2, h, w, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_finish_gradient_matches_jax_grad(pallas_calls):
    """Padded and shifted: autograd through the port's op (its backward
    recomputes through the plain version) vs ``jax.vjp`` of the Pallas op."""
    h = w = 20
    ws, ss = 12, 6
    vals = _inputs(6, 2, h, w, ws)
    g = np.random.default_rng(7).standard_normal((2, h, w, C)).astype(np.float32)
    _, pullback = jax.vjp(
        lambda *a: jfin.fused_reverse_ln_mlp_residual(*a, ws=ws, ss=ss, interpret=True),
        *(jnp.asarray(v.copy()) for v in vals))
    want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    assert pallas_calls == [(h, w)]
    want[4], want[6] = want[4].T, want[6].T  # nn.Linear layout
    leaves = [t.requires_grad_() for t in _torch_args(vals)]
    finish.fused_reverse_ln_mlp_residual(*leaves, ws=ws, ss=ss).backward(torch.from_numpy(g))
    names = ["dwin", "dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"]
    for name, t, e in zip(names, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("h,shift", [(16, True), (8, False)])
def test_swin_block_with_finish_matches_jax(h, shift, monkeypatch, pallas_calls):
    monkeypatch.setenv("FLAIR_SWIN_PREP", "1")
    monkeypatch.setenv("FLAIR_SWIN_FINISH", "1")
    nh, ws = 4, 4
    assert jfin.supports(h, h, C, 4 * C, ws, 4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, h, h, C)).astype(np.float32)
    r = rng.standard_normal((2, h, h, C)).astype(np.float32)
    jblk = JSwinBlock(dim=C, num_heads=nh, window_size=ws, shift=shift, kernel_mode="on")
    variables = jblk.init(jax.random.key(3), jnp.asarray(x.copy()))
    want = np.asarray(jblk.apply(variables, jnp.asarray(x.copy())))

    def jloss(params, xx):
        return jnp.sum(jblk.apply({"params": params}, xx) * jnp.asarray(r))

    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(variables["params"], jnp.asarray(x.copy()))
    assert pallas_calls and set(pallas_calls) == {(h, h)}

    calls = []
    fused = finish.fused_reverse_ln_mlp_residual
    monkeypatch.setattr(finish, "fused_reverse_ln_mlp_residual",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    tblk = SwinBlock(C, nh, ws, shift=shift)
    tblk.load_state_dict(state_dict_from_flax(variables["params"]), strict=True)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    got = tblk(tx)
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=3e-5, atol=3e-5)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), rtol=1e-4, atol=1e-4)
    jgrads = state_dict_from_flax(jax.device_get(jg_params))
    for name, p in tblk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("h,w,ws,ss", [(20, 20, 12, 0), (20, 20, 12, 6), (20, 28, 12, 6),
                                       (7, 5, 4, 2), (24, 24, 12, 6)])
def test_finish_gather_reference_is_reverse_crop_roll(h, w, ws, ss):
    """The gather pass's index map (``finish_gather_reference``) picks for
    every output token the row that window reverse + crop + the +ss roll
    puts there, padded H and W included (no pad row or column is read),
    and its LN rows are K3's plain LayerNorm of x + a."""
    vals = _torch_args(_inputs(11, 2, h, w, ws))
    win, x, s, b = vals[:4]
    ln, a = finish.finish_gather_reference(win, x, s, b, ws=ws, ss=ss)
    y = window_reverse(win, ws, _padded(h, ws), _padded(w, ws))[:, :h, :w]
    if ss:
        y = torch.roll(y, (ss, ss), dims=(1, 2))
    assert torch.equal(a, y.reshape(-1, C))
    x2 = (x.reshape(-1, C) + a).float()
    want = torch.nn.functional.layer_norm(x2, (C,), s, b, eps=1e-5)
    torch.testing.assert_close(ln, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,ws,ss", [(20, 20, 12, 6), (24, 24, 12, 0)])
def test_ffn_plain_on_gathered_rows_matches_pallas_finish(h, w, ws, ss, pallas_calls):
    """What the kernel computes after its gather pass, K3's function on (x,
    a), against the Pallas finish in interpret mode: float32 2e-5."""
    vals = _inputs(12, 2, h, w, ws)
    want = np.asarray(jfin.fused_reverse_ln_mlp_residual(
        *(jnp.asarray(v.copy()) for v in vals), ws=ws, ss=ss, interpret=True))
    assert pallas_calls == [(h, w)]
    win, x, *params = _torch_args(vals)
    _, a = finish.finish_gather_reference(win, x, *params[:2], ws=ws, ss=ss)
    got = fused_ln_mlp_residual_reference(x, a.reshape(x.shape), *params)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
