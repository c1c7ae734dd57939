"""K7 plain version (``flair_for_aigle_tpu_torch.ops.ffn``
``fused_ln_mlp_residual_backward``) vs the Pallas ffn backward
(``_kernel_bwd``: the fused kernel in interpret mode plus its LayerNorm
epilogue), on the same numpy inputs; the op's backward under
``FLAIR_FFN_BWD=kernel`` vs ``jax.vjp`` of the JAX op under the same
variable; and one swin_micro-upernet training step with the switch set vs
the JAX package's ``make_steps``.

Tolerances: float32 rtol = atol = 1e-4 per gradient; bfloat16 (a geometry
of two hidden chunks and two token blocks in the Pallas grid) a median
relative error < 0.04 per gradient, the bound tests/test_ffn_kernel.py
holds the Pallas backward to; the training step as
tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.ops.pallas import ffn as jffn
from flair_for_aigle_tpu.train import optim as joptim
from flair_for_aigle_tpu.train.task import TrainState, make_steps as jmake_steps
from flair_for_aigle_tpu.train.task import set_learning_rate
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.ops import ffn
from flair_for_aigle_tpu_torch.train import optim
from flair_for_aigle_tpu_torch.train.task import make_steps
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import TASK, _batch, _close, _config, _sd

NAMES = ["dx", "dattn", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"]


def _inputs(seed, n, c, hidden):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(n, c)).astype(f), rng.normal(size=(n, c)).astype(f),
            (rng.normal(size=c) * 0.1 + 1).astype(f), (rng.normal(size=c) * 0.1).astype(f),
            (rng.normal(size=(c, hidden)) * c ** -0.5).astype(f),
            (rng.normal(size=hidden) * 0.05).astype(f),
            (rng.normal(size=(hidden, c)) * hidden ** -0.5).astype(f),
            (rng.normal(size=c) * 0.05).astype(f)], rng.normal(size=(n, c)).astype(f)


@pytest.mark.parametrize("dtype,n,c,hidden", [("float32", 64, 128, 512),
                                              ("bfloat16", 128, 512, 2048)])
def test_ffn_backward_plain_matches_pallas(dtype, n, c, hidden):
    vals, g = _inputs(0, n, c, hidden)
    tb, hc = jffn._pick_bwd(n, c, hidden, jnp.dtype(dtype).itemsize)
    if dtype == "bfloat16":
        assert hidden // hc > 1 and n // tb > 1  # a multi-chunk Pallas grid
    res = [jnp.asarray(v.copy()).astype(dtype) if i < 2 else jnp.asarray(v.copy())
           for i, v in enumerate(vals)]
    want = jffn._kernel_bwd(res, jnp.asarray(g.copy()).astype(dtype), eps=1e-5, interpret=True)
    assert want is not None
    want = [np.asarray(v.astype(jnp.float32)) for v in want]
    want[4], want[6] = want[4].T, want[6].T  # nn.Linear layout
    tdt = getattr(torch, dtype)
    x, a, s, b, w1, b1, w2, _ = (torch.from_numpy(v.copy()) for v in vals)
    got = ffn.fused_ln_mlp_residual_backward_reference(
        x.to(tdt), a.to(tdt), s, b, w1.t(), b1, w2.t(), torch.from_numpy(g).to(tdt))
    assert [t.dtype for t in got[:2]] == [tdt, tdt]
    for name, t, e in zip(NAMES, got, want):
        t = t.float().numpy()
        assert t.shape == e.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(t, e, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            med = np.median(np.abs(t - e) / np.maximum(np.abs(e), 1e-2))
            assert med < 0.04, (name, med)


def test_ffn_backward_under_the_switch_matches_jax_vjp(monkeypatch):
    """``FLAIR_FFN_BWD=kernel`` on both sides: the JAX op's custom VJP takes
    its Pallas backward (read at trace time, so its cache is cleared around
    the call), the port's op takes K7 (its plain version on the CPU)."""
    monkeypatch.setenv("FLAIR_FFN_BWD", "kernel")
    vals, g = _inputs(1, 64, 128, 512)
    vals = [v.reshape(2, 4, 8, -1) if i < 2 else v for i, v in enumerate(vals)]
    g = g.reshape(2, 4, 8, -1)
    taken = {"jax": 0, "torch": 0}
    jbwd, tbwd = jffn._kernel_bwd, ffn.fused_ln_mlp_residual_backward

    def jspy(*a, **k):
        taken["jax"] += 1
        return jbwd(*a, **k)

    def tspy(*a, **k):
        taken["torch"] += 1
        return tbwd(*a, **k)

    monkeypatch.setattr(jffn, "_kernel_bwd", jspy)
    monkeypatch.setattr(ffn, "fused_ln_mlp_residual_backward", tspy)
    jffn._vjp_fn.cache_clear()
    try:
        _, pullback = jax.vjp(lambda *a: jffn.fused_ln_mlp_residual(*a, interpret=True),
                              *(jnp.asarray(v.copy()) for v in vals))
        want = [np.asarray(v) for v in pullback(jnp.asarray(g.copy()))]
    finally:
        jffn._vjp_fn.cache_clear()
    want[4], want[6] = want[4].T, want[6].T
    leaves = [torch.from_numpy((v.T if i in (4, 6) else v).copy()).requires_grad_()
              for i, v in enumerate(vals)]
    ffn.fused_ln_mlp_residual(*leaves).backward(torch.from_numpy(g))
    assert taken == {"jax": 1, "torch": 1}
    for name, t, e in zip(NAMES, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4, atol=1e-4, err_msg=name)


def test_training_step_with_the_ffn_backward_matches_jax(monkeypatch):
    """One AdamW step of swin_micro-upernet at 64 px, batch 2, float32, with
    ``FLAIR_FFN_BWD=kernel`` in the port (K7 in every swin block's backward)
    vs the JAX package's ``make_steps`` on the same weights and batch: loss,
    gradients, parameters and BatchNorm statistics after the step."""
    monkeypatch.setenv("FLAIR_FFN_BWD", "kernel")
    cfg = _config()
    batch = _batch(0)
    jmodel = JaxModel(config=cfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    hp = cfg["hyperparams"]
    lr = optim.make_scheduler(hp, 1).lr_for_step(0)
    jopt = joptim.make_optimizer(hp)
    jstate = TrainState(variables["params"], variables["batch_stats"],
                        jopt.init(variables["params"]), jnp.zeros((), jnp.int32))
    jtrain, _, _ = jmake_steps(jmodel, cfg, jopt)
    jstate = jstate._replace(opt_state=set_learning_rate(jstate.opt_state, lr))
    jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    want_sd = _sd(jstate.params, jstate.batch_stats)

    def jloss(params):
        (lt, _), _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
                                  mutable=["batch_stats"])
        from flair_for_aigle_tpu.train import losses as jlosses

        targets = jnp.argmax(jnp.asarray(batch[TASK]), axis=1).astype(jnp.int32)
        return jlosses.weighted_cross_entropy(
            lt[TASK], targets, jnp.asarray(jlosses.build_loss_weights(cfg)[TASK]))

    jgrads = _sd(jax.jit(jax.grad(jloss))(variables["params"]), {})

    calls = []
    tbwd = ffn.fused_ln_mlp_residual_backward
    monkeypatch.setattr(ffn, "fused_ln_mlp_residual_backward",
                        lambda *a, **k: calls.append(1) or tbwd(*a, **k))
    model = FlairHubModel(cfg)
    model.load_state_dict(_sd(variables["params"], variables["batch_stats"]), strict=True)
    opt = optim.make_optimizer(hp, list(model.parameters()))
    steps = make_steps(model, cfg, opt, "cpu")
    loss, grads, _, _ = steps.loss_and_grads(batch)
    opt.step(grads, lr)
    assert len(calls) == 4  # one K7 backward per swin block (depths 1, 1, 1, 1)
    assert abs(loss.item() - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    tgrads = dict(zip([n for n, _ in model.named_parameters()], grads))
    assert tgrads.keys() == jgrads.keys()
    gmax = max(g.abs().max().item() for g in jgrads.values())
    for name, g in tgrads.items():
        _close(g, jgrads[name].numpy(), 1e-3, name, floor=1e-6 * gmax)
    n = n_far = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, want_sd[k].numpy(), 1e-3, k)
            continue
        d = (v.double() - want_sd[k].double()).abs()
        assert d.max().item() <= 3 * lr, (k, d.max().item())
        n += d.numel()
        n_far += int((d > 1e-2 * lr).sum())
    assert n_far <= 1e-3 * n, (n_far, n)
