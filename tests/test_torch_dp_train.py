"""Data-parallel training in the port, on the CPU: two gloo ranks
(``tests/_torch_dp.py``, one thread each) against one process, and against
the JAX package's step on a 2-device mesh.

Two ranks take one AdamW step on their halves of a global batch of 4
(64 px, float32) and are held against the one-process port on the whole
batch, from the same weights and generator seed:
* swin_micro-UPerNet (BatchNorm in the decoder) with class weights under
  which the two halves hold different weight sums (class 0 weighs 0,
  class 3 2.5; the first half's labels are 0-2, the second's 2-4);
* swin_micro-FPN fused with a SENTINEL2_TS UTAE (BatchNorm in its up
  blocks), modality dropout on both modalities, the UTAE's and the FPN's
  dropout: the masks and the modality noise are the global batch's.

Tolerances (the ranks sum in another order than one process): the loss
1e-6 relative; every gradient within 1e-6 of its tensor's largest magnitude
plus 1e-6 of the model's largest gradient (some gradients are zero in exact
arithmetic, and both sides return rounding noise there); the BatchNorm
running statistics within 1e-6 of each tensor's largest magnitude; the
confusion matrices equal. The parameters after AdamW: within 1e-6 of each
tensor's largest magnitude wherever the one-process gradient exceeds 100
times that gradient bound (AdamW normalises each update to about the
learning rate, so where a gradient is rounding noise its sign, and the
update's, is arbitrary): elsewhere within 2 learning rates, on at most 0.1 %
of the elements. Both ranks end with bit-identical states.

Against the JAX ``train_step`` on two of the conftest's virtual CPU devices
(``make_mesh(n_devices=2)``, the batch sharded over ``dp``): the tolerances
of ``tests/test_torch_train_step.py`` for the loss, the gradients, the
BatchNorm statistics, the parameters after AdamW and the confusion matrix.

The trainer: ``batch_size`` not divisible by the ranks raises; ``python -m
flair_for_aigle_tpu_torch.train_main`` on two ranks trains, checkpoints and
predicts on a toy split, with one TensorBoard writer, and ends near the
one-process run.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from flair_for_aigle_tpu.train import losses as jlosses
from flair_for_aigle_tpu.train import optim as joptim
from flair_for_aigle_tpu.train.task import TrainState, make_steps as jmake_steps
from flair_for_aigle_tpu.train.task import set_learning_rate
from flair_for_aigle_tpu_torch.models import flair_model
from flair_for_aigle_tpu_torch.parallel import dist
from flair_for_aigle_tpu_torch.train.stages import build_model
from flair_for_aigle_tpu_torch.train.trainer import train
from flair_for_aigle_tpu_torch.tools.dryrun_multichip import run_ranks
from tests import _torch_dp
from tests._fixtures import make_batch, make_config
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_train_main import N_CLS, NAME, PX, TASK, make_toy_split, toy_config

B, LR = 4, 1e-3
REPO = _torch_dp.REPO


def _onehot(lab):
    return (lab[:, None] == np.arange(N_CLS)[None, :, None, None]).astype(np.float32)


def _upernet_case():
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, N_CLS),))
    cfg["labels_configs"][TASK]["value_weights"]["default_exceptions"] = {0: 0.0, 3: 2.5}
    rng = np.random.default_rng(0)
    lab = np.concatenate([rng.integers(0, 3, (2, 8, 8)), rng.integers(2, 5, (2, 8, 8))])
    lab = np.kron(lab, np.ones((1, 8, 8))).astype(int)
    img = rng.normal(size=(B, 3, PX, PX)).astype(np.float32) + lab[:, None] * 0.3
    return cfg, {"AERIAL_RGBI": img, TASK: _onehot(lab)}


def _dropout_case():
    cfg = make_config(arch="swin_micro_patch4_window12_384-fpn", mono=("AERIAL_RGBI",),
                      multi=("SENTINEL2_TS",), tasks=((TASK, N_CLS),))
    cfg["modalities"]["modality_dropout"].update(AERIAL_RGBI=0.5, SENTINEL2_TS=0.5)
    return cfg, make_batch(cfg, batch=B, size=PX, t_steps=3)


def _spec(cfg, batch, state_dict) -> dict:
    cfg["hyperparams"].update(learning_rate=LR, batch_size=B)
    return {"config": cfg, "batch": batch, "state_dict": state_dict, "lr": LR, "step": 0}


def _two_ranks(spec, d: Path) -> list:
    torch.save(spec, d / "spec.pt")
    _torch_dp.run("train_step", str(d / "spec.pt"), str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module", params=["upernet", "dropout"])
def dp(request, tmp_path_factory):
    cfg, batch = _upernet_case() if request.param == "upernet" else _dropout_case()
    spec = _spec(cfg, batch, build_model(cfg).state_dict())
    ranks = _two_ranks(spec, tmp_path_factory.mktemp(request.param))
    noise = []
    original = flair_model.xavier_uniform_like
    flair_model.xavier_uniform_like = lambda x, g: noise.append(x.shape) or original(x, g)
    try:
        ref = _torch_dp.one_step(spec, 0, 1)
    finally:
        flair_model.xavier_uniform_like = original
    return {"case": request.param, "ranks": ranks, "ref": ref, "batch": batch, "cfg": cfg,
            "noise": noise}


def _grad_bound(ref):
    gmax = max(g.abs().max().item() for g in ref["grads"].values() if g is not None)
    return {k: 1e-6 * g.abs().max().item() + 1e-6 * gmax
            for k, g in ref["grads"].items() if g is not None}


def test_the_case_exercises_what_it_claims(dp):
    if dp["case"] == "upernet":
        w = np.array([0.0, 1, 1, 2.5, 1], np.float32)
        lab = dp["batch"][TASK].argmax(1)
        sums = [w[lab[:2]].sum(), w[lab[2:]].sum()]
        assert abs(sums[0] - sums[1]) > 0.2 * max(sums), sums
        assert any(k.endswith("running_var") and "decoder" in k for k in dp["ref"]["state"])
    else:
        assert dp["noise"], "no modality was dropped: the noise path did not run"
        assert any(k.startswith("encoders.SENTINEL2_TS.up_blocks") and k.endswith("running_var")
                   for k in dp["ref"]["state"])


def test_ranks_end_with_identical_states(dp):
    r0, r1 = dp["ranks"]
    assert r0["loss"] == r1["loss"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


def test_loss_and_confusion_matrix_match_one_process(dp):
    got, want = dp["ranks"][0], dp["ref"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    np.testing.assert_array_equal(got["confmats"][TASK], want["confmats"][TASK])
    assert want["confmats"][TASK].sum() == B * PX * PX


def test_gradients_match_one_process(dp):
    got, want = dp["ranks"][0]["grads"], dp["ref"]["grads"]
    bound = _grad_bound(dp["ref"])
    assert got.keys() == want.keys()
    for k, g in want.items():
        if g is None:
            assert got[k] is None, k
            continue
        err = (got[k].double() - g.double()).abs().max().item()
        assert err <= bound[k], (k, err, bound[k])


def test_batchnorm_statistics_match_one_process(dp):
    got, want = dp["ranks"][0]["state"], dp["ref"]["state"]
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            n += 1
            err = (got[k].double() - v.double()).abs().max().item()
            assert err <= 1e-6 * v.abs().max().item(), (k, err)
    assert n > 0


def test_parameters_after_adamw_match_one_process(dp):
    got, want, grads = dp["ranks"][0]["state"], dp["ref"]["state"], dp["ref"]["grads"]
    bound = _grad_bound(dp["ref"])
    n = n_noise = 0
    for k, g in grads.items():
        if g is None:
            continue
        d = (got[k].double() - want[k].double()).abs()
        tol = 1e-6 * want[k].abs().max().item()
        resolved = g.abs() > 100 * bound[k]
        assert (d[resolved] <= tol).all(), (k, d[resolved].max().item(), tol)
        assert (d <= 2 * LR + tol).all(), (k, d.max().item())
        n += d.numel()
        n_noise += int((d[~resolved] > tol).sum())
    assert n_noise <= 1e-3 * n, (n_noise, n)


# --- against the JAX step on a 2-device mesh -------------------------------

def _jax_batch():
    rng = np.random.default_rng(3)
    lab = np.kron(rng.integers(0, N_CLS, (B, PX // 8, PX // 8)), np.ones((1, 8, 8))).astype(int)
    img = rng.normal(size=(B, 3, PX, PX)).astype(np.float32) + lab[:, None] * 0.3
    return {"AERIAL_RGBI": img, TASK: _onehot(lab)}


def _sd(params, batch_stats):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_torch_state_dict(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(batch_stats)}).items()}


@pytest.fixture(scope="module")
def vs_jax(tmp_path_factory):
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, N_CLS),))
    cfg["labels_configs"][TASK]["value_weights"]["default_exceptions"] = {4: 0}
    cfg["hyperparams"].update(learning_rate=LR, batch_size=B)
    batch = _jax_batch()
    jmodel = JaxModel(config=cfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()}))
    mesh = make_mesh(n_devices=2)
    opt = joptim.make_optimizer(cfg["hyperparams"])
    state = TrainState(replicate_tree(mesh, variables["params"]),
                       replicate_tree(mesh, variables["batch_stats"]),
                       replicate_tree(mesh, opt.init(variables["params"])),
                       jnp.zeros((), jnp.int32))
    state = state._replace(opt_state=set_learning_rate(state.opt_state, LR))
    sharded = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    weights = jnp.asarray(jlosses.build_loss_weights(cfg)[TASK])

    def jloss(params, bs, b):
        (lt, _), _ = jmodel.apply({"params": params, "batch_stats": bs}, b, train=True,
                                  mutable=["batch_stats"])
        targets = jnp.argmax(b[TASK], axis=1).astype(jnp.int32)
        return jlosses.weighted_cross_entropy(lt[TASK], targets, weights)

    jgrads = jax.jit(jax.grad(jloss))(state.params, state.batch_stats, sharded)
    jtrain, _, _ = jmake_steps(jmodel, cfg, opt)
    jstate, m = jtrain(state, sharded, jax.random.key(0))
    spec = _spec(cfg, batch, _sd(variables["params"], variables["batch_stats"]))
    ranks = _two_ranks(spec, tmp_path_factory.mktemp("vs_jax"))
    return {"port": ranks[0], "loss": float(m["loss"]),
            "confmat": np.asarray(m["confmats"][TASK]), "grads": _sd(jgrads, {}),
            "state": _sd(jstate.params, jstate.batch_stats)}


def _close(got, want, rel, name, floor=0.0):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.abs().max().item() + floor, (name, err)


def test_two_ranks_match_the_jax_mesh_loss_and_confusion_matrix(vs_jax):
    assert abs(vs_jax["port"]["loss"] - vs_jax["loss"]) <= 1e-4 * abs(vs_jax["loss"])
    got, want = vs_jax["port"]["confmats"][TASK], vs_jax["confmat"]
    assert got.sum() == want.sum() == B * PX * PX
    assert np.abs(got - want).sum() <= 2 * 0.002 * B * PX * PX


def test_two_ranks_match_the_jax_mesh_gradients(vs_jax):
    got, want = vs_jax["port"]["grads"], vs_jax["grads"]
    assert got.keys() == want.keys()
    gmax = max(g.abs().max().item() for g in want.values())
    for k, g in got.items():
        _close(g, want[k], 1e-3, k, floor=1e-6 * gmax)


def test_two_ranks_match_the_jax_mesh_batchnorm_statistics(vs_jax):
    n = 0
    for k, v in vs_jax["port"]["state"].items():
        if k.endswith(("running_mean", "running_var")):
            n += 1
            _close(v, vs_jax["state"][k], 1e-3, k)
    assert n > 0


def test_two_ranks_match_the_jax_mesh_parameters_after_adamw(vs_jax):
    n = n_far = 0
    for k, v in vs_jax["port"]["state"].items():
        d = (v.double() - vs_jax["state"][k].double()).abs()
        assert d.max().item() <= 3 * LR, (k, d.max().item())
        n += d.numel()
        n_far += int((d > 1e-2 * LR).sum())
    assert n_far <= 1e-3 * n, (n_far, n)


# --- the trainer ------------------------------------------------------------

def test_batch_size_not_divisible_by_the_ranks_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(dist, "world_size", lambda: 3)
    cfg = toy_config(tmp_path, {"train": "a", "val": "b", "test": "c"})
    cfg["hyperparams"]["batch_size"] = 4
    with pytest.raises(ValueError, match="batch_size 4 must be divisible by the 3"):
        train(cfg, None, None, str(tmp_path), "cpu")


def _train_main(root: Path, world: int) -> Path:
    cfg = toy_config(root, make_toy_split(root, {"train": 4, "val": 2, "test": 2}))
    cfg["hyperparams"]["num_epochs"] = 1
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    run_ranks(lambda r: [sys.executable, "-m", "flair_for_aigle_tpu_torch.train_main",
                         "--config", str(root / "cfg.yaml"), "--device", "cpu"],
              world, 600, env)
    return Path(cfg["paths"]["out_folder"], NAME)


def test_train_main_on_two_ranks(tmp_path):
    from safetensors.torch import load_file

    outs = {w: _train_main(tmp_path / f"w{w}", w) for w in (1, 2)}
    for out in outs.values():
        assert len(list(out.glob("tensorboard_logs_*/events.out.tfevents.*"))) <= 1
        preds = sorted((out / f"results_{NAME}" / f"predictions_{NAME}" / TASK).glob("PRED_*"))
        assert len(preds) == 2
        assert (out / f"results_{NAME}" / f"metrics_{NAME}" / TASK / "metrics.json").exists()
    one, two = (load_file(str(outs[w] / "checkpoints" / f"last_{NAME}.safetensors"))
                for w in (1, 2))
    assert one.keys() == two.keys()
    n = n_far = 0
    for k, v in one.items():
        d = (two[k].double() - v.double()).abs()
        assert d.max().item() <= 3 * 2 * LR, (k, d.max().item())  # two steps of AdamW
        n += d.numel()
        n_far += int((d > 1e-2 * LR).sum())
    assert n_far <= 1e-3 * n, (n_far, n)
