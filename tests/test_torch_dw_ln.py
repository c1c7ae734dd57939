"""K9, a ConvNeXt block's 7x7 depthwise convolution, its bias and its
LayerNorm as one op (``ops/dw_ln.py depthwise7_ln``), on the CPU, where the
wrapper runs its plain version.

* The plain version against the JAX ``ConvNeXtBlock``'s ``conv_dw`` ->
  ``norm`` (the block's captured ``norm`` output, seeded flax variables
  carried by ``state_dict_from_flax``), float32, within 1e-5 of the largest
  magnitude; in float32 it is bit for bit the layers it replaced
  (``TorchConv`` depthwise, then ``TorchLayerNorm``); in bf16 it rounds once.
* The port's whole ``ConvNeXtBlock`` and ``ConvNeXtEncoder``
  (convnext_micro, 64 px) against the JAX package's, forward and
  gradients: features within ``tests/test_torch_encoders.py``'s atol =
  rtol = 5e-4, gradients (parameters and input) within
  ``tests/test_torch_remat.py``'s 1e-3 of each tensor's largest magnitude
  plus 1e-6 of the largest gradient.
* The op's backward is the plain version's vjp, bit for bit, in both
  dtypes; the wrapper raises on C not a multiple of 8.
* ``dw_ln_plan`` at every ConvNeXt width at 512 px (batches 2, 5, 16, both
  dtypes, 132 SMs): a whole number of channel vectors a chunk, the tile's
  shared memory within the H100's 227 KB, every output pixel in a tile;
  ConvNeXt-B's four bf16 stages pinned.
* A numpy model of the kernel's walk (its halo, taps and results laid out
  and addressed as ``csrc/dw_ln.cu`` lays them out, chunk by chunk and
  strip by strip, under the plan) against the plain version at
  ConvNeXt-B's stage geometries and at ragged shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models import convnext as jconvnext
from flair_for_aigle_tpu.models import monotemp as jmt
from flair_for_aigle_tpu_torch.models import convnext
from flair_for_aigle_tpu_torch.models import monotemp as tmt
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.layers import TorchConv, TorchLayerNorm, init_weights
from flair_for_aigle_tpu_torch.ops import dw_ln
from flair_for_aigle_tpu_torch.utils import profiling
from flair_for_aigle_tpu_torch.zonal import inference as zi
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_utae import _carry, _close, _fill

EPS = 1e-6


def _params(c: int, seed: int = 0, scale: float = 1.0):
    """(w_dw (C, 1, 7, 7), b_dw, ln_w, ln_b) float32, as the model holds them."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((c, 1, 7, 7), generator=g) / 7 * scale,
            torch.randn(c, generator=g) * 0.1, torch.randn(c, generator=g) * 0.1 + 1,
            torch.randn(c, generator=g) * 0.1)


def _grads_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    gmax = max(w.abs().max().item() for w in want.values())
    for k, g in got.items():
        err = (g.double() - want[k].double()).abs().max().item()
        assert err <= 1e-3 * want[k].abs().max().item() + 1e-6 * gmax, (k, err)


@pytest.mark.parametrize("shape", [(2, 9, 11, 32), (1, 16, 16, 64), (2, 5, 3, 16)])
def test_plain_version_matches_the_jax_conv_dw_then_norm(shape):
    c = shape[-1]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jmod, tmod = jconvnext.ConvNeXtBlock(dim=c), convnext.ConvNeXtBlock(c)
    v = _carry(jmod, tmod, jnp.asarray(x))
    _, inter = jmod.apply(v, jnp.asarray(x), capture_intermediates=True,
                          mutable=["intermediates"])
    want = np.asarray(inter["intermediates"]["norm"]["__call__"][0])
    got = dw_ln.depthwise7_ln_reference(torch.from_numpy(x.copy()), tmod.conv_dw.weight,
                                        tmod.conv_dw.bias, tmod.norm.weight, tmod.norm.bias)
    _close(got.detach().numpy(), want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_layers_it_replaced_in_float32_and_rounds_once(dtype):
    c = 48
    conv, norm = TorchConv(c, c, 7, 1, 3, groups=c), TorchLayerNorm(c, eps=EPS)
    w, b, g, bt = _params(c)
    with torch.no_grad():
        for p, q in ((conv.weight, w), (conv.bias, b), (norm.weight, g), (norm.bias, bt)):
            p.copy_(q)
    x = torch.randn((2, 10, 13, c), generator=torch.Generator().manual_seed(2)).to(dtype)
    got = dw_ln.depthwise7_ln(x, w, b, g, bt, eps=EPS)
    assert got.dtype == dtype and got.shape == x.shape
    with torch.no_grad():
        layers = norm(conv(x))
    if dtype == torch.float32:
        assert torch.equal(got, layers)
    else:
        # the float32 op on the bf16-rounded input and parameters, rounded once
        once = dw_ln.depthwise7_ln_reference(x.float(), w.bfloat16().float(),
                                             b.bfloat16().float(), g, bt, eps=EPS)
        assert torch.equal(got, once.bfloat16())
        # the layers round the conv and its bias to bf16 before the norm
        assert (got.float() - layers.float()).abs().max().item() <= 4 * 2.0 ** -7 * max(
            1.0, layers.float().abs().max().item())


def test_block_matches_jax_forward_and_gradients():
    c = 32
    x = (np.random.default_rng(3).normal(size=(2, 12, 10, c))).astype(np.float32)
    jmod, tmod = jconvnext.ConvNeXtBlock(dim=c), convnext.ConvNeXtBlock(c)
    v = _carry(jmod, tmod, jnp.asarray(x))
    ct = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = tmod(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jmod.apply(v, jnp.asarray(x))),
                               atol=5e-4, rtol=5e-4)
    (y * torch.from_numpy(ct)).sum().backward()

    def loss(params, xx):
        return (jmod.apply({"params": params}, xx) * ct).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    want = {k: t for k, t in state_dict_from_flax(jax.device_get(gp), None).items()}
    want["x"] = torch.from_numpy(np.asarray(gx))
    got = {n: p.grad for n, p in tmod.named_parameters()}
    got["x"] = xt.grad
    _grads_close(got, want)


def test_encoder_matches_jax_forward_and_gradients():
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jmt.make_encoder("convnext_micro", 3, name="encoder")
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.key(0), a), jnp.asarray(x))
    rng = np.random.default_rng(0)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    tmod = tmt.make_encoder("convnext_micro", 3)
    tmod.load_state_dict(state_dict_from_flax(v["params"], None), strict=True)
    feats_j = jmod.apply(v, jnp.asarray(x))
    cts = [np.random.default_rng(10 + i).normal(size=f.shape).astype(np.float32)
           for i, f in enumerate(feats_j)]
    xt = torch.from_numpy(x.copy()).requires_grad_()
    feats = tmod(xt)
    for f, w in zip(feats, feats_j):
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(w), atol=5e-4, rtol=5e-4)
    sum((f * torch.from_numpy(ct)).sum() for f, ct in zip(feats, cts) if f.numel()).backward()

    def loss(params, xx):
        fs = jmod.apply({"params": params}, xx)
        return sum((f * ct).sum() for f, ct in zip(fs, cts) if f.size)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    want = dict(state_dict_from_flax(jax.device_get(gp), None))
    want["x"] = torch.from_numpy(np.asarray(gx))
    got = {n: p.grad for n, p in tmod.named_parameters()}
    got["x"] = xt.grad
    _grads_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_the_plain_versions_vjp(dtype):
    c = 24
    params = [p.requires_grad_() for p in _params(c, seed=5)]
    x = torch.randn((2, 7, 9, c), generator=torch.Generator().manual_seed(6)).to(dtype)
    x.requires_grad_()
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    got = torch.autograd.grad(dw_ln.depthwise7_ln(x, *params), [x, *params], gy)
    want = torch.autograd.grad(dw_ln.depthwise7_ln_reference(x, *params), [x, *params], gy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("c", [4, 12, 20, 100])
def test_wrapper_raises_on_channels_not_a_multiple_of_8(c):
    with pytest.raises(ValueError, match="multiple of 8"):
        dw_ln.depthwise7_ln(torch.randn(1, 8, 8, c), *_params(c))
    with pytest.raises(ValueError, match="multiple of 8"):
        dw_ln.dw_ln_plan(1, 8, 8, c, torch.bfloat16, 132)


def test_taps_are_made_once_a_weight_version():
    """``dw_ln_taps``: (C / 8, 49, 8) float32 rounded to the dtype, kept on
    the weight; an in-place change of the weight (an optimizer step, a
    loaded state) makes them again."""
    w = torch.nn.Parameter(_params(16)[0])
    t = dw_ln.dw_ln_taps(w, torch.bfloat16, "cpu")
    assert t.shape == (2, 49, 8) and t.dtype == torch.float32
    assert torch.equal(t[1, :, 3], w.detach()[11, 0].reshape(49).bfloat16().float())
    assert dw_ln.dw_ln_taps(w, torch.bfloat16, "cpu") is t
    assert not torch.equal(dw_ln.dw_ln_taps(w, torch.float32, "cpu"), t)
    with torch.no_grad():
        w.mul_(2)
    again = dw_ln.dw_ln_taps(w, torch.bfloat16, "cpu")
    assert again is not t and torch.equal(again, 2 * t)


def test_cpu_launches_no_kernel_and_the_block_keeps_timms_keys():
    block = convnext.ConvNeXtBlock(16)
    init_weights(block, torch.Generator().manual_seed(0))
    assert set(block.state_dict()) == {"conv_dw.weight", "conv_dw.bias", "norm.weight",
                                       "norm.bias", "mlp.fc1.weight", "mlp.fc1.bias",
                                       "mlp.fc2.weight", "mlp.fc2.bias", "gamma"}
    dw_ln.depthwise7_ln.launches = 0
    with torch.no_grad():
        block(torch.randn(1, 8, 8, 16))
    assert dw_ln.depthwise7_ln.launches == 0
    # the zonal record counts K9's launches (one a ConvNeXt block on the card),
    # a key the kernel's module declares, not the engine
    assert profiling.declared()["dw_ln_launches"] == 0
    assert "dw_ln_launches" not in zi.RECORD_KEYS


# every ConvNeXt width at 512 px: (H = W, C) of the four stages
CONVNEXT_STAGES = sorted({(512 // 4 >> i, dims[i])
                          for dims, _ in tmt._CONVNEXT_SIZES.values() for i in range(4)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 5, 16])
def test_plan_fits_the_card_at_every_convnext_width(dtype, batch):
    for hw, c in CONVNEXT_STAGES:
        p = dw_ln.dw_ln_plan(batch, hw, hw, c, dtype, 132)
        assert (p.tw, p.th) in dw_ln.DW_TILES
        assert 0 < p.cc <= c and p.cc % 8 == 0
        assert p.smem == dw_ln.dw_ln_smem(p.tw, p.th, p.cc, c, dtype) <= dw_ln.SMEM_BLOCK
        assert 1 <= p.resident <= dw_ln.DW_MIN_BLOCKS
        assert p.resident * (p.smem + 1024) <= dw_ln.SMEM_SM
        assert p.blocks == min(batch * p.tiles_x * p.tiles_y, 132 * p.resident)
        assert p.tiles_x * p.tw >= hw > (p.tiles_x - 1) * p.tw
        assert p.tiles_y * p.th >= hw > (p.tiles_y - 1) * p.th


def test_plan_at_convnext_base_zonal_stages():
    """ConvNeXt-B at 512 px, batch 16, bf16 (the zonal cell): stage 1 two
    blocks an SM; the tiles and chunks the H100 ran fastest of those that
    fit (a sweep of every tile at two or three chunk widths)."""
    plans = [dw_ln.dw_ln_plan(16, hw, hw, c, torch.bfloat16, 132)[:5]
             for hw, c in ((128, 128), (64, 256), (32, 512), (16, 1024))]
    assert plans == [(8, 8, 64, 109312, 2), (16, 8, 32, 185216, 1), (8, 8, 64, 207616, 1),
                     (8, 4, 64, 192768, 1)]


def _kernel_model(x, w, b, g, bt, plan, eps=EPS):
    """``csrc/dw_ln.cu``'s walk in numpy float32 under ``plan``, with its
    shared-memory layouts and addresses: per tile and chunk, the halo
    [cv][pixel + 1 pad][8] (zeros past the image), the chunk's rows of
    ``dw_ln_taps`` [cv][49][8], a
    thread's strip of DW_ROWS rows of one channel vector (all strips side by
    side here) taking the taps column by column and the halo rows once
    each, the results [pixel][C + 4]; then the LayerNorm of each pixel in
    the image."""
    bsz, h, wd, c = x.shape
    tw, th, cc = plan.tw, plan.th, plan.cc
    hw, hpix = tw + 6, (th + 6) * (tw + 6)
    rows = dw_ln.DW_ROWS
    taps = dw_ln.dw_ln_taps(torch.from_numpy(w), torch.float32, "cpu").numpy()
    out = np.zeros_like(x)
    strips = np.arange(tw * th // rows)
    xl, sr = strips % tw, strips // tw
    bases = sr * rows * hw + xl
    hy, hx = np.divmod(np.arange(hpix), hw)
    for bi in range(bsz):
        for ty in range(plan.tiles_y):
            for tx in range(plan.tiles_x):
                y0, x0 = ty * th, tx * tw
                yy, xx = y0 - 3 + hy, x0 - 3 + hx
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < wd)
                res = np.zeros(th * tw * (c + 4), np.float32)
                for c0 in range(0, c, cc):
                    ncv = min(cc, c - c0) // 8
                    halo = np.zeros((ncv, hpix + 1, 8), np.float32)
                    vals = x[bi, yy[inside], xx[inside], c0:c0 + 8 * ncv]
                    halo[:, np.flatnonzero(inside)] = vals.reshape(-1, ncv, 8).transpose(1, 0, 2)
                    wsm = taps[c0 // 8:c0 // 8 + ncv]
                    acc = np.zeros((ncv, len(strips), rows, 8), np.float32)
                    for kx in range(7):
                        for r in range(rows + 6):
                            v = halo[:, bases + r * hw + kx]
                            for ky in range(7):
                                if 0 <= r - ky < rows:
                                    acc[:, :, r - ky] += wsm[:, None, ky * 7 + kx] * v
                    acc += b[c0:c0 + 8 * ncv].reshape(ncv, 1, 1, 8)
                    for o in range(rows):
                        px = (sr * rows + o) * tw + xl
                        at = px[:, None] * (c + 4) + c0 + np.arange(8 * ncv)
                        res[at] = acc[:, :, o].transpose(1, 0, 2).reshape(len(strips), -1)
                pys, pxs = np.divmod(np.arange(th * tw), tw)
                keep = (y0 + pys < h) & (x0 + pxs < wd)
                rowsel = np.flatnonzero(keep)[:, None] * (c + 4) + np.arange(c)
                vals = res[rowsel]
                mean = vals.mean(-1, keepdims=True, dtype=np.float32)
                var = ((vals - mean) ** 2).mean(-1, keepdims=True, dtype=np.float32)
                normed = (vals - mean) / np.sqrt(var + eps) * g + bt
                out[bi, y0 + pys[keep], x0 + pxs[keep]] = normed
    return out


# ConvNeXt-B's four stages under the zonal batch's bf16 plans, then ragged
# shapes under float32 plans: H, W no whole number of tiles, C = 96 (a
# chunk of 12 channel vectors), C = 1024 and 2048 (chunks of 128)
WALK_CASES = [(16, 128, 128, 128, torch.bfloat16), (16, 64, 64, 256, torch.bfloat16),
              (16, 32, 32, 512, torch.bfloat16), (16, 16, 16, 1024, torch.bfloat16),
              (2, 13, 17, 96, torch.float32), (1, 5, 7, 1024, torch.float32),
              (1, 9, 6, 16, torch.float32), (1, 11, 10, 2048, torch.bfloat16)]


@pytest.mark.parametrize("b,h,w,c,plan_dtype", WALK_CASES)
def test_kernel_walk_matches_the_plain_version(b, h, w, c, plan_dtype):
    """The model walks one image (two for the ragged C = 96) of the
    batch the plan is made for."""
    plan = dw_ln.dw_ln_plan(b, h, w, c, plan_dtype, 132)
    b = min(b, 2 if c == 96 else 1)
    rng = np.random.default_rng(c + h)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    params = [p.numpy() for p in _params(c, seed=c)]
    got = _kernel_model(x, *params, plan)
    want = dw_ln.depthwise7_ln_reference(torch.from_numpy(x), *map(torch.from_numpy, params))
    _close(got, want.numpy(), 1e-5)
