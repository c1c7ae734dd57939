"""Per-block rematerialisation (``models.monotemp_model.remat``) in the port,
on the CPU, against the step without it and against the JAX encoders run
with ``remat=True``.

* Encoders (swin_micro, convnext_micro, efficientnet_micro; 64 px, batch 2,
  float32, training mode, seeded flax variables carried by
  ``state_dict_from_flax``): a loss made of every feature of the pyramid
  gives, under ``remat``, the plain encoder's features, gradients and
  BatchNorm running statistics bit for bit (the recompute updates no
  statistic); against the JAX encoder with ``remat=True`` (EfficientNet:
  without, as the JAX package's remat EfficientNet raises while tracing,
  ``test_jax_remat_efficientnet_cannot_trace``), the gradients
  within ``tests/test_torch_train_step.py``'s tolerance (1e-3 of each
  tensor's largest magnitude plus 1e-6 of the largest gradient) and the
  statistics within ``tests/test_torch_encoders.py``'s (1e-5).
* No random draw enters a checkpointed block: the blocks' forward and
  backward under ``remat`` call none of torch's samplers and leave the
  global RNG state as it was.
* The config key reaches the blocks (``FlairHubModel`` -> ``make_encoder``
  -> ``TimmUniversalEncoder``; ResNet takes none, as in the JAX package),
  and only in training mode with autograd recording.
* A toy ``train_step`` (AdamW) with ``remat: True`` equals the one without,
  bit for bit: loss, confusion matrix, parameters and statistics.
* Two gloo ranks with ``remat`` on an EfficientNet-U-Net equal one process
  bit for bit, and one process (with remat) as the data-parallel tests
  hold the port: loss 1e-6 relative, confusion matrix equal, BatchNorm
  statistics 1e-6 of each tensor's largest magnitude (plus 1e-6 of the
  largest of their kind), gradients 1e-3 (float32's own error through this
  model's BatchNorms is ~2e-3 of the largest stem gradient, so 1e-6 holds
  for swin-UPerNet in ``tests/test_torch_dp_train.py`` but not here).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flair_for_aigle_tpu.models import monotemp as jmt
from flair_for_aigle_tpu_torch.models import convnext, efficientnet, layers, swin
from flair_for_aigle_tpu_torch.models import monotemp as tmt
from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.train import optim
from flair_for_aigle_tpu_torch.train.stages import build_model
from flair_for_aigle_tpu_torch.train.task import make_steps
from tests import _torch_dp
from tests._fixtures import make_config
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_utae import _fill

PX, B = 64, 2
ENCODERS = ["swin_micro_patch4_window12_384", "convnext_micro", "efficientnet_micro"]


def _input(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, PX, PX, 3)).astype(np.float32)


def _weights(shapes, seed: int = 2) -> list:
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _port_step(enc, x, w):
    """(features, gradients by name, state dict) of one training-mode
    forward and backward of sum(feature_i * w_i)."""
    enc.train()
    enc.zero_grad(set_to_none=True)
    feats = enc(torch.from_numpy(x.copy()))
    loss = sum((f * torch.from_numpy(wi)).sum() for f, wi in zip(feats, w) if f.numel())
    loss.backward()
    return ([f.detach().clone() for f in feats],
            {n: p.grad.clone() for n, p in enc.named_parameters()},
            {k: v.clone() for k, v in enc.state_dict().items()})


# The JAX package's remat EfficientNet cannot be traced: ``nn.checkpoint``
# of DsBlock / IrBlock receives ``train`` as a traced argument, which the
# block's BatchNorm turns into a Python bool (``efficientnet.py:133``,
# TracerBoolConversionError; ``test_jax_remat_efficientnet_cannot_trace``).
# Its EfficientNet is held against the JAX encoder without remat, which
# computes the same function.
JAX_REMAT = {"swin_micro_patch4_window12_384": True, "convnext_micro": True,
             "efficientnet_micro": False}


@pytest.fixture(scope="module", params=ENCODERS)
def encoder_runs(request):
    name, x = request.param, _input()
    jmod = jmt.make_encoder(name, 3, name="encoder", remat=JAX_REMAT[name])
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.key(0), a), jnp.asarray(x))
    rng = np.random.default_rng(0)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    sd = state_dict_from_flax(v["params"], v.get("batch_stats"))
    feats_shape = [f.shape for f in jax.eval_shape(
        lambda a: jmod.apply(v, a, train=True, mutable=["batch_stats"])[0], jnp.asarray(x))]
    w = _weights(feats_shape)
    runs = {}
    for flag in (False, True):
        enc = tmt.make_encoder(name, 3, remat=flag)
        enc.load_state_dict(sd, strict=True)
        runs[flag] = _port_step(enc, x, w)

    def jloss(params):
        feats, upd = jmod.apply({**v, "params": params}, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        return sum((f * wi).sum() for f, wi in zip(feats, w) if f.size), upd

    jgrads, upd = jax.jit(jax.grad(jloss, has_aux=True))(v["params"])
    return {"name": name, "plain": runs[False], "remat": runs[True],
            "jgrads": state_dict_from_flax(jax.device_get(jgrads), None),
            "jstats": state_dict_from_flax({}, jax.device_get(upd.get("batch_stats", {})))}


def test_remat_equals_the_plain_encoder_bit_for_bit(encoder_runs):
    (f0, g0, s0), (f1, g1, s1) = encoder_runs["plain"], encoder_runs["remat"]
    for a, b in zip(f0, f1):
        assert torch.equal(a, b)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    stats = [k for k in s0 if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == encoder_runs["name"].startswith("efficientnet")
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_remat_matches_the_jax_remat_encoder(encoder_runs):
    _, grads, state = encoder_runs["remat"]
    want = encoder_runs["jgrads"]
    assert grads.keys() == want.keys()
    gmax = max(g.abs().max().item() for g in want.values())
    for k, g in grads.items():
        err = (g.double() - want[k].double()).abs().max().item()
        assert err <= 1e-3 * want[k].abs().max().item() + 1e-6 * gmax, (k, err)
    for k, w in encoder_runs["jstats"].items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_jax_remat_efficientnet_cannot_trace():
    x = jnp.asarray(_input())
    jmod = jmt.make_encoder("efficientnet_micro", 3, name="encoder", remat=True)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jmod.init(jax.random.key(0), x, train=True)


def test_checkpointed_blocks_draw_no_random_numbers(monkeypatch):
    """Every block runs under remat with torch's samplers patched to fail;
    the global RNG state is left untouched."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"{name} drawn inside a checkpointed block")
        return fn

    for mod, names in ((torch, ("rand", "randn", "randint", "rand_like", "randn_like",
                                "randint_like", "bernoulli", "normal", "multinomial",
                                "randperm", "dropout")),
                       (F, ("dropout", "dropout2d", "alpha_dropout")),
                       (torch.Tensor, ("bernoulli_", "normal_", "uniform_", "random_",
                                       "exponential_", "geometric_", "cauchy_",
                                       "log_normal_"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse(n))
    calls = []
    for mod in (swin, convnext, efficientnet):
        monkeypatch.setattr(mod, "remat", lambda b, x: calls.append(type(b).__name__)
                            or layers.remat(b, x))
    for name in ENCODERS:
        enc = tmt.make_encoder(name, 3, remat=True).train()
        # parameters set by hand: init draws, and only the blocks are checked
        with torch.no_grad():
            for i, p in enumerate(enc.parameters()):
                p.copy_(torch.linspace(-0.1, 0.1, p.numel()).reshape(p.shape) * (1 + i % 3))
        state = torch.get_rng_state()
        sum(f.sum() for f in enc(torch.from_numpy(_input())) if f.numel()).backward()
        assert torch.equal(torch.get_rng_state(), state)
    for block in ("SwinBlock", "ConvNeXtBlock", "DsBlock", "IrBlock"):
        assert block in calls, (block, sorted(set(calls)))


def _model_config(arch: str, remat_flag: bool | None) -> dict:
    cfg = make_config(arch=arch, tasks=(("T", 5),))
    if remat_flag is not None:
        cfg["models"]["monotemp_model"]["remat"] = remat_flag
    return cfg


@pytest.mark.parametrize("arch,flag", [
    ("swin_micro_patch4_window12_384-upernet", True),
    ("convnext_micro-unet", True),
    ("efficientnet_micro-unet", True),
    ("efficientnet_micro-unet", None),
    ("resnet18-unet", True),
])
def test_config_key_reaches_the_blocks(arch, flag):
    model = FlairHubModel(_model_config(arch, flag))
    inner = model.encoders["AERIAL_RGBI"].seg_model
    if arch.startswith("resnet"):
        assert not hasattr(inner, "remat") and not hasattr(getattr(inner, "model", None),
                                                           "remat")
        return
    assert inner.model.remat is bool(flag)
    enc = inner.model
    enc.train()
    assert layers.remat_active(enc, enc.remat) is bool(flag)
    with torch.no_grad():
        assert not layers.remat_active(enc, enc.remat)
    enc.eval()
    assert not layers.remat_active(enc, enc.remat)


def _toy_batch(seed: int, n: int = 2, classes: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    lab = np.kron(rng.integers(0, classes, (n, PX // 8, PX // 8)),
                  np.ones((1, 8, 8))).astype(int)
    img = rng.normal(size=(n, 3, PX, PX)).astype(np.float32) + lab[:, None] * 0.3
    onehot = (lab[:, None] == np.arange(classes)[None, :, None, None]).astype(np.float32)
    return {"AERIAL_RGBI": img, "T": onehot}


@pytest.mark.parametrize("arch", ["swin_micro_patch4_window12_384-upernet",
                                  "efficientnet_micro-unet"])
def test_train_step_with_remat_equals_the_step_without(arch):
    batch = _toy_batch(3)
    base = build_model(_model_config(arch, False)).state_dict()
    out = {}
    for flag in (False, True):
        cfg = _model_config(arch, flag)
        cfg["hyperparams"].update(learning_rate=1e-3, batch_size=2)
        model = FlairHubModel(cfg)
        model.load_state_dict(copy.deepcopy(base), strict=True)
        opt = optim.make_optimizer(cfg["hyperparams"], list(model.parameters()))
        steps = make_steps(model, cfg, opt, "cpu")
        m = steps.train_step(batch, 1e-3)
        out[flag] = (float(m["loss"]), m["confmats"]["T"].numpy(),
                     {k: v.clone() for k, v in model.state_dict().items()})
    (l0, c0, s0), (l1, c1, s1) = out[False], out[True]
    assert np.isfinite(l0) and l0 == l1
    np.testing.assert_array_equal(c0, c1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert any(k.endswith("running_var") and not torch.equal(s0[k], base[k]) for k in s0)


def test_two_ranks_with_remat_match_one_process(tmp_path):
    """Under a process group the recompute replays the forward's BatchNorm
    sums: two ranks with remat equal two ranks without, bit for bit, and
    both equal one process (with remat) as the data-parallel tests hold
    the port. The gradients are held to the JAX comparison's 1e-3 of each
    tensor's largest magnitude, not to 1e-6: through EfficientNet-U-Net's
    training-mode BatchNorms float32 itself sits ~2e-3 of the largest stem
    gradient off float64, and one process differs from itself by ~4e-4 of
    it when the batch is merely permuted."""
    ranks = {}
    for flag in (False, True):
        cfg = _model_config("efficientnet_micro-unet", flag)
        cfg["hyperparams"].update(learning_rate=1e-3, batch_size=4)
        spec = {"config": cfg, "batch": _toy_batch(5, n=4),
                "state_dict": build_model(_model_config("efficientnet_micro-unet",
                                                        False)).state_dict(),
                "lr": 1e-3, "step": 0}
        d = tmp_path / str(flag)
        d.mkdir()
        torch.save(spec, d / "spec.pt")
        _torch_dp.run("train_step", str(d / "spec.pt"), str(d))
        ranks[flag] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ref = _torch_dp.one_step(spec, 0, 1)
    for k in ref["state"]:
        assert torch.equal(ranks[True][0]["state"][k], ranks[False][0]["state"][k]), k
        assert torch.equal(ranks[True][0]["state"][k], ranks[True][1]["state"][k]), k
    for k, g in ranks[False][0]["grads"].items():
        assert torch.equal(ranks[True][0]["grads"][k], g), k
    got = ranks[True][0]
    assert abs(got["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    np.testing.assert_array_equal(got["confmats"]["T"], ref["confmats"]["T"])
    gmax = max(g.abs().max().item() for g in ref["grads"].values() if g is not None)
    for k, g in ref["grads"].items():
        err = (got["grads"][k].double() - g.double()).abs().max().item()
        assert err <= 1e-3 * g.abs().max().item() + 1e-6 * gmax, (k, err)
    # the statistics within 1e-6 of each tensor's largest magnitude plus 1e-6
    # of the largest of its kind in the model (a running mean can be
    # rounding noise around 0, as a gradient can)
    stats = {kind: [k for k in ref["state"] if k.endswith(kind) and "encoders" in k]
             for kind in ("running_mean", "running_var")}
    for keys in stats.values():
        assert keys
        floor = 1e-6 * max(ref["state"][k].abs().max().item() for k in keys)
        for k in keys:
            v = ref["state"][k]
            err = (got["state"][k].double() - v.double()).abs().max().item()
            assert err <= 1e-6 * v.abs().max().item() + floor, (k, err)
