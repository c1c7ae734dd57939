"""Full-state resume and TensorBoard scalars of the port's trainer, on the
CPU.

* A run killed after its first epoch (``saving.save_full_state_orbax``)
  and resumed from its full state for the remaining epoch
  (``tasks.train_tasks.resume_full_state_from_orbax``) equals the
  uninterrupted 2-epoch run bit for bit: every epoch's losses, the final
  parameters and BatchNorm statistics, the optimizer's count and moments,
  and the scheduler's state, with ``one_cycle_lr`` and with
  ``reduce_on_plateau``. The model is resnet18-fpn, so FPN's training-time
  channel dropout draws from the step-keyed generator, over the toy
  GeoTIFF split of ``tests/test_torch_train_main.py`` (the loader shuffles).
* The ReduceLROnPlateau tracker is part of the state (a deliberate
  divergence from the JAX package, whose orbax state lacks it): a 4-epoch
  run whose tracker halved the learning rate before the kill after epoch 2
  resumes at the halved rate and retraces the uninterrupted run; with the
  tracker dropped from the state, it does not.
* The per-step generator is keyed by (seed, step), not drawn in sequence.
* TensorBoard: the scalar names and steps, through a recording stand-in
  for the writer, equal the JAX ``_TBWriter``'s on the same toy batches.
"""

from pathlib import Path

import pytest
import torch

from flair_for_aigle_tpu_torch.train import trainer as ttr
from flair_for_aigle_tpu_torch.train.stages import build_data_module, build_model, get_datasets
from tests._fixtures import make_batch, make_config
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_train_main import make_toy_split, toy_config


class Killed(Exception):
    pass


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    return root, make_toy_split(root, {"train": 4, "val": 2, "test": 2})


def resume_config(split, out: Path, scheduler: str, epochs: int) -> dict:
    root, csvs = split
    cfg = toy_config(root, csvs)
    cfg["models"]["monotemp_model"]["arch"] = "resnet18-fpn"
    cfg["paths"]["out_folder"] = str(out)
    cfg["hyperparams"].update(num_epochs=epochs, scheduler=scheduler, plateau_patience=0,
                              learning_rate=0.02, optimizer="adamw")
    cfg["saving"].update(save_full_state_orbax=True, ckpt_save_also_last=False)
    return cfg


def run(cfg: dict, kill_after: int | None = None, resume: str | None = None):
    """Train in-process on the CPU; returns ({epoch: (train_loss, val_loss)},
    the final full state, the callback)."""
    if resume:
        cfg = {**cfg, "tasks": {**cfg["tasks"], "train_tasks": {
            **cfg["tasks"]["train_tasks"], "resume_full_state_from_orbax": resume}}}
    torch.manual_seed(0)
    dm = build_data_module(cfg, *get_datasets(cfg))
    model = build_model(cfg)
    losses = {}

    def hook(epoch, metrics):
        losses[epoch] = (metrics["train_loss"], metrics["val_loss"])
        if kill_after is not None and epoch == kill_after:
            raise Killed

    out = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"])
    out.mkdir(parents=True, exist_ok=True)
    cb = None
    try:
        cb = ttr.train(cfg, dm, model, str(out), "cpu", epoch_hook=hook)
    except Killed:
        pass
    path = out / "checkpoints" / f"full_state_last_{cfg['paths']['out_model_name']}.pt"
    return losses, ttr.load_full_state(str(path)), str(path), cb


def assert_same_state(a: dict, b: dict):
    assert a["step"] == b["step"] and a["steps_per_epoch"] == b["steps_per_epoch"]
    assert a["scheduler"] == b["scheduler"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["kind"] == ob["kind"] == "adamw" and oa["count"] == ob["count"]
    for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("scheduler", ["one_cycle_lr", "reduce_on_plateau"])
def test_killed_and_resumed_run_equals_the_uninterrupted_one(split, tmp_path, scheduler):
    full_losses, full_state, _, _ = run(resume_config(split, tmp_path / "full", scheduler, 2))
    cfg = resume_config(split, tmp_path / "cut", scheduler, 2)
    first, saved, path, _ = run(cfg, kill_after=0)
    assert saved["step"] == 2 and list(first) == [0]
    second, resumed, _, _ = run({**cfg, "hyperparams": {**cfg["hyperparams"], "num_epochs": 1}},
                                resume=path)
    assert list(second) == [1]  # the epoch labels continue from step // steps_per_epoch
    assert {**first, **second} == full_losses
    assert_same_state(resumed, full_state)
    assert resumed["step"] == 4 and resumed["optimizer"]["count"] == 4


def test_plateau_tracker_is_restored(split, tmp_path):
    def cfg_at(out, epochs):
        cfg = resume_config(split, out, "reduce_on_plateau", epochs)
        cfg["hyperparams"]["learning_rate"] = 1.0  # the validation loss rises once
        return cfg

    full_losses, full_state, _, _ = run(cfg_at(tmp_path / "full", 4))
    cfg = cfg_at(tmp_path / "cut", 4)
    first, saved, path, _ = run(cfg, kill_after=2)
    # the tracker halved the rate before the kill: the state must carry it
    assert saved["scheduler"]["plateau"]["scale"] == 0.5
    one_more = {**cfg, "hyperparams": {**cfg["hyperparams"], "num_epochs": 1}}
    second, resumed, _, _ = run(one_more, resume=path)
    assert list(second) == [3] and {**first, **second} == full_losses
    assert_same_state(resumed, full_state)
    # without the tracker the resumed epoch runs at the full rate and drifts
    saved["scheduler"]["plateau"] = None
    torch.save(saved, path)
    third, drifted, _, _ = run(one_more, resume=path)
    assert third[3] != full_losses[3]
    assert not torch.equal(drifted["optimizer"]["mu"][0], full_state["optimizer"]["mu"][0])


def test_step_generator_is_keyed_by_seed_and_step():
    seeds = {(s, t): ttr.step_seed(s, t) for s in (0, 2025) for t in (0, 1, 7, 10 ** 6)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(0 <= v < 2 ** 63 for v in seeds.values())
    assert ttr.step_seed(2025, 7) == seeds[(2025, 7)]  # a function of (seed, step) only
    draws = [torch.rand(3, generator=torch.Generator().manual_seed(ttr.step_seed(1, 5)))
             for _ in range(2)]
    assert torch.equal(*draws)


class _Recorder:
    calls: list = []

    def __init__(self, logdir):
        type(self).calls = []

    def scalar(self, name, value, step):
        type(self).calls.append((name, int(step)))

    def flush(self):
        pass


def test_tensorboard_scalars_match_the_jax_writer(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
    from flair_for_aigle_tpu.train import trainer as jtr

    cfg = make_config(arch="resnet18-unet", tasks=(("AERIAL_LABEL-COSIA", 3),))
    cfg["hyperparams"].update(batch_size=2, num_epochs=2)
    cfg["saving"] = {"ckpt_monitor": "val_miou", "ckpt_monitor_mode": "max",
                     "ckpt_earlystopping_patience": 20}
    cfg["paths"] = {"out_model_name": "tb-toy"}
    cfg["tasks"] = {"train": True, "train_tasks": {}}

    class _DM:
        def setup(self, stage):
            pass

        def _loader(self):
            return [make_batch(cfg, 2, 32, seed=s) for s in range(2)]

        train_dataloader = val_dataloader = _loader

    calls = {}
    monkeypatch.setattr(jtr, "_TBWriter", _Recorder)
    jmodel = JaxModel(config=cfg)
    variables = dict(jmodel.init(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in make_batch(cfg, 2, 32).items()}))
    jtr.train(cfg, _DM(), jmodel, variables, str(tmp_path / "jax"))
    calls["jax"] = list(_Recorder.calls)
    monkeypatch.setattr(ttr, "_TBWriter", _Recorder)
    ttr.train(cfg, _DM(), build_model(cfg), str(tmp_path / "torch"), "cpu")
    calls["torch"] = list(_Recorder.calls)
    assert calls["torch"] == calls["jax"]
    names = {n for n, _ in calls["torch"]}
    assert {"train_loss", "train_miou", "lr", "val_loss", "val_miou",
            "val_miou_COSIA"} == names
    assert sorted({s for _, s in calls["torch"]}) == [0, 1]


def test_tensorboard_writer_writes_event_files(tmp_path):
    pytest.importorskip("tensorboard")
    w = ttr._TBWriter(str(tmp_path / "tb"))
    w.scalar("train_loss", 0.5, 0)
    w.flush()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
