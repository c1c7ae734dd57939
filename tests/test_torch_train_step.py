"""The port's training step against the JAX package's ``make_steps``, on the
CPU: swin_micro-upernet at 64 px, batch 2, float32, weights carried across
by ``export_torch_state_dict``. Three AdamW steps under one_cycle_lr;
compared after each: the loss, the BatchNorm running statistics, the
parameters and the confusion matrices; the gradients at the first step;
then an eval step. Also the schedules and the weighted cross-entropy with
out-of-range targets against the JAX functions.

Tolerances (float32, the two frameworks sum in other orders): loss 1e-4
relative; gradients 1e-3 of each tensor's largest magnitude plus 1e-6 of
the largest gradient of the model (some gradients are zero in exact
arithmetic: a bias in front of a training-mode BatchNorm, and both sides
return rounding noise there); BatchNorm statistics 1e-3 of each tensor's
largest magnitude; parameters: at most 0.1 % of them may move further
apart than 1 % of the learning rates summed over the steps taken, and none
further than 3 times that sum (AdamW normalises each update to about the
learning rate, so where a gradient is rounding noise its sign, and the
update's, is arbitrary); confusion matrices: at most 0.2 % of the pixels
may change class (argmax near-ties under random weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.train import losses as jlosses
from flair_for_aigle_tpu.train import optim as joptim
from flair_for_aigle_tpu.train.task import TrainState, make_steps as jmake_steps
from flair_for_aigle_tpu.train.task import set_learning_rate
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.train import losses, optim
from flair_for_aigle_tpu_torch.train.task import make_steps
from tests._fixtures import make_config
from tests._torch_threads import few_torch_threads  # noqa: F401


TASK, N_CLS, PX, B, N_STEPS = "AERIAL_LABEL-COSIA", 5, 64, 2, 3


def _config():
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, N_CLS),))
    cfg["labels_configs"][TASK]["value_weights"]["default_exceptions"] = {4: 0}
    cfg["hyperparams"].update(learning_rate=1e-3, batch_size=B)
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    lab = np.kron(rng.integers(0, N_CLS, (B, PX // 8, PX // 8)), np.ones((1, 8, 8))).astype(int)
    img = rng.normal(size=(B, 3, PX, PX)).astype(np.float32) + lab[:, None] * 0.3
    onehot = (lab[:, None] == np.arange(N_CLS)[None, :, None, None]).astype(np.float32)
    return {"AERIAL_RGBI": img.astype(np.float32), TASK: onehot}


def _sd(params, batch_stats):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_torch_state_dict(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(batch_stats)}).items()}


def _close(got: torch.Tensor, want, rel: float, name: str, floor: float = 0.0):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


@pytest.fixture(scope="module")
def runs():
    """Both trajectories, computed once (the JAX step is compiled once)."""
    cfg = _config()
    jmodel = JaxModel(config=cfg)
    batches = [_batch(s) for s in range(N_STEPS + 1)]
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batches[0].items()}))
    hp = cfg["hyperparams"]
    jopt = joptim.make_optimizer(hp)
    jstate = TrainState(variables["params"], variables["batch_stats"],
                        jopt.init(variables["params"]), jnp.zeros((), jnp.int32))
    jtrain, jeval, _ = jmake_steps(jmodel, cfg, jopt)
    sched = joptim.make_scheduler(hp, N_STEPS)
    weights = jnp.asarray(jlosses.build_loss_weights(cfg)[TASK])

    def jloss(params, bs, batch):
        (lt, _), _ = jmodel.apply({"params": params, "batch_stats": bs}, batch, train=True,
                                  mutable=["batch_stats"])
        targets = jnp.argmax(batch[TASK], axis=1).astype(jnp.int32)
        return jlosses.weighted_cross_entropy(lt[TASK], targets, weights)

    jgrads = jax.device_get(jax.jit(jax.grad(jloss))(
        jstate.params, jstate.batch_stats, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    jax_out = []
    for step in range(N_STEPS):
        lr = sched.lr_for_step(step)
        jstate = jstate._replace(opt_state=set_learning_rate(jstate.opt_state, lr))
        jstate, m = jtrain(jstate, {k: jnp.asarray(v) for k, v in batches[step].items()},
                           jax.random.key(step))
        jax_out.append({"loss": float(m["loss"]), "confmat": np.asarray(m["confmats"][TASK]),
                        "sd": _sd(jstate.params, jstate.batch_stats)})
    jev = jeval(jstate, {k: jnp.asarray(v) for k, v in batches[N_STEPS].items()})

    model = FlairHubModel(cfg)
    model.load_state_dict(_sd(variables["params"], variables["batch_stats"]), strict=True)
    opt = optim.make_optimizer(hp, list(model.parameters()))
    steps = make_steps(model, cfg, opt, "cpu")
    tsched = optim.make_scheduler(hp, N_STEPS)
    torch_out = []
    for step in range(N_STEPS):
        lr = tsched.lr_for_step(step)
        if step == 0:  # the step taken by hand, to read its gradients
            loss, grads, preds, targets = steps.loss_and_grads(batches[0])
            opt.step(grads, lr)
            from flair_for_aigle_tpu_torch.train.metrics import confusion_matrix

            m = {"loss": loss, "confmats": {TASK: confusion_matrix(preds[TASK], targets[TASK],
                                                                   N_CLS)}}
            tgrads = dict(zip([n for n, _ in model.named_parameters()], grads))
        else:
            m = steps.train_step(batches[step], lr)
        torch_out.append({"loss": float(m["loss"]), "confmat": m["confmats"][TASK].numpy(),
                          "sd": {k: v.clone() for k, v in model.state_dict().items()}})
    tev = steps.eval_step(batches[N_STEPS])
    return dict(jgrads=_sd(jgrads, {}), tgrads=tgrads, jax=jax_out, torch=torch_out,
                jev=jev, tev=tev, lrs=[sched.lr_for_step(s) for s in range(N_STEPS)])


def test_losses_agree(runs):
    for j, t in zip(runs["jax"], runs["torch"]):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t["loss"], j["loss"])


def test_first_step_gradients_agree(runs):
    assert runs["tgrads"].keys() == runs["jgrads"].keys()
    gmax = max(g.abs().max().item() for g in runs["jgrads"].values())
    for name, g in runs["tgrads"].items():
        _close(g, runs["jgrads"][name].numpy(), 1e-3, name, floor=1e-6 * gmax)


def test_batchnorm_running_stats_agree(runs):
    for j, t in zip(runs["jax"], runs["torch"]):
        for k in t["sd"]:
            if k.endswith(("running_mean", "running_var")):
                _close(t["sd"][k], j["sd"][k].numpy(), 1e-3, k)


def test_parameters_after_adamw_agree(runs):
    for step, (j, t) in enumerate(zip(runs["jax"], runs["torch"])):
        lr_sum = sum(runs["lrs"][:step + 1])
        n = n_far = 0
        for k, v in t["sd"].items():
            d = (v.double() - j["sd"][k].double()).abs()
            assert d.max().item() <= 3 * lr_sum, (step, k, d.max().item())
            n += d.numel()
            n_far += int((d > 1e-2 * lr_sum).sum())
        assert n_far <= 1e-3 * n, (step, n_far, n)


def test_confusion_matrices_agree(runs):
    for j, t in zip(runs["jax"], runs["torch"]):
        assert t["confmat"].sum() == j["confmat"].sum() == B * PX * PX
        assert np.abs(t["confmat"] - j["confmat"]).sum() <= 2 * 0.002 * B * PX * PX


def test_eval_step_agrees(runs):
    jev, tev = runs["jev"], runs["tev"]
    assert abs(float(tev["loss"]) - float(jev["loss"])) <= 1e-4 * abs(float(jev["loss"]))
    _close(tev["per_class_loss"][TASK], np.asarray(jev["per_class_loss"][TASK]), 1e-4,
           "per_class_loss")
    diff = np.abs(tev["confmats"][TASK].numpy() - np.asarray(jev["confmats"][TASK])).sum()
    assert diff <= 2 * 0.002 * B * PX * PX


@pytest.mark.parametrize("total,pct", [(100, 0.2), (7, 0.3), (3, 0.2)])
def test_one_cycle_lr_matches_jax(total, pct):
    want = joptim.one_cycle_lr(5e-5, total, pct_start=pct)
    got = optim.one_cycle_lr(5e-5, total, pct_start=pct)
    for s in range(total + 2):
        assert abs(got(s) - float(want(s))) <= 1e-6 * 5e-5, s


@pytest.mark.parametrize("kind", ["reduce_on_plateau", "cycle_then_plateau"])
def test_plateau_schedules_match_jax(kind):
    hp = {"scheduler": kind, "learning_rate": 1e-3, "warmup_fraction": 0.2,
          "plateau_patience": 2}
    want, got = joptim.make_scheduler(hp, 50), optim.make_scheduler(hp, 50)
    val_losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9] * 2
    for epoch, vl in enumerate(val_losses):
        for s in range(epoch * 2, epoch * 2 + 2):
            assert abs(got.lr_for_step(s) - want.lr_for_step(s)) <= 1e-6 * 1e-3, (epoch, s)
        got.epoch_end(vl)
        want.epoch_end(vl)


def test_weighted_cross_entropy_out_of_range_targets_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 8, 8)).astype(np.float32)
    targets = rng.integers(0, 8, (2, 8, 8))          # 5..7 are out of range
    w = np.array([1, 1, 0, 2, 0.5], np.float32)
    want = float(jlosses.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                                jnp.asarray(w)))
    got = float(losses.weighted_cross_entropy(torch.from_numpy(logits),
                                              torch.from_numpy(targets), torch.from_numpy(w)))
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
    inside = targets.clip(0, 4)
    want_torch = torch.nn.CrossEntropyLoss(weight=torch.from_numpy(w))(
        torch.from_numpy(logits), torch.from_numpy(inside)).item()
    assert abs(got - want_torch) <= 1e-5 * abs(want_torch)


def test_batchnorm_training_mode_matches_jax():
    """TorchBatchNorm in training mode: batch statistics with the biased
    variance, running statistics updated with momentum 0.1 and the unbiased
    variance (``models/layers.py:257-270``); float32, 1e-5."""
    from flair_for_aigle_tpu.models.layers import TorchBatchNorm as JBatchNorm
    from flair_for_aigle_tpu_torch.models.checkpoint import state_dict_from_flax
    from flair_for_aigle_tpu_torch.models.layers import TorchBatchNorm

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 5, 6, 8)) * 3 + 1).astype(np.float32)
    jbn = JBatchNorm()
    variables = jbn.init(jax.random.key(0), jnp.asarray(x), use_running_average=True)
    variables = {"params": {"scale": jnp.asarray(rng.normal(size=8) + 1, jnp.float32),
                            "bias": jnp.asarray(rng.normal(size=8), jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
                                 "var": jnp.asarray(rng.uniform(0.5, 2, size=8), jnp.float32)}}
    want, mut = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    bn = TorchBatchNorm(8)
    bn.load_state_dict(state_dict_from_flax(jax.device_get(variables["params"]),
                                            jax.device_get(variables["batch_stats"])))
    got = bn.train()(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-5)
    # eval mode normalises with the (updated) running statistics
    ev = bn.eval()(torch.from_numpy(x.copy()))
    wev = jbn.apply({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                    jnp.asarray(x), use_running_average=True)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(wev), rtol=1e-5, atol=1e-5)
