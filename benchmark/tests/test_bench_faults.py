"""A run with its timed path broken underneath comes out not correct, and
so does the control: a precision one step below the configuration's in
the system's place. On the CPU at a small size: the harness's whole run
but its look for a card, the port's plain versions, the cells' own
limits."""

import pytest

from benchmark import control, registry
from benchmark.tests import small


def zonal_fault(monkeypatch, alter):
    from flair_for_aigle_tpu_torch.zonal import inference as zi

    forward = zi.ZonalStep.forward_convert

    def broken(self, batch):
        return {t: alter(p.clone()) for t, p in forward(self, batch).items()}

    monkeypatch.setattr(zi.ZonalStep, "forward_convert", broken)


def half_left_out(p):
    p[p.shape[0] // 2:] = 0
    return p


def one_answer_altered(p):
    p[0] = (p[0] + 1) % 19
    return p


@pytest.mark.parametrize("alter", [half_left_out, one_answer_altered])
@pytest.mark.parametrize("workload", ["zonal-swinb-dalle-b16", "zonal-convnextb-dalle-b16"])
def test_broken_zonal_runs_are_not_correct(monkeypatch, workload, alter):
    zonal_fault(monkeypatch, alter)
    out = small.run(workload, 21)
    assert out["correct"] is False
    assert out["checks"]["label_gap"]["value"] > out["checks"]["label_gap"]["limit"]


def test_a_codec_off_its_mode_is_not_correct(monkeypatch):
    """Dalles whose labels went through the 5-bit fallback where the
    traffic's label structure calls for run-length coding."""
    from flair_for_aigle_tpu_torch.zonal import stripes

    monkeypatch.setattr(stripes.StripeCodec, "MAX_PROBES", 0)
    out = small.run("zonal-swinb-dalle-b16", 24, traffic=small.FLAT)
    assert out["correct"] is False
    assert out["attempted"] > 0 and out["checks"]["codec_off_share"]["value"] == 1.0
    assert out["checks"]["label_gap"]["value"] <= out["checks"]["label_gap"]["limit"]


def test_a_sound_small_zonal_run_is_correct():
    out = small.run("zonal-swinb-dalle-b16", 22, traffic=small.FLAT)
    assert out["correct"] is True and out["info"]["codec_modes"] == {"rle": out["attempted"]}
    assert small.run("zonal-convnextb-dalle-b16", 22)["correct"] is True


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from flair_for_aigle_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, grads, lr: None)
    out = small.run("train-swinb-f32-b16", 23)
    assert out["correct"] is False
    assert out["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(monkeypatch):
    from flair_for_aigle_tpu_torch.train import task

    loss = task.weighted_cross_entropy

    def half(logits, targets, weights):
        n = logits.shape[0] // 2
        return loss(logits[:n], targets[:n], weights)

    monkeypatch.setattr(task, "weighted_cross_entropy", half)
    out = small.run("train-swinb-f32-b16", 24)
    assert out["correct"] is False


def test_a_sound_small_training_run_is_correct():
    assert small.run("train-swinb-f32-b16", 25)["correct"] is True


# the control runs the reference alone, so it can take deeper encoders
# than the port's small test models: the error of float8 grows with depth
DEEPER = {"zonal-swinb-dalle-b16": {"depths": [2, 2, 6, 2]},
          "zonal-convnextb-dalle-b16": {"depths": [3, 3, 9, 3], "dims": [32, 64, 128, 256]}}


@pytest.mark.parametrize("workload", sorted(DEEPER))
def test_fp8_control_is_not_correct(workload):
    ctx = small.context_for(workload, 26)
    ctx.config["encoder"].update(DEEPER[workload])
    got = control.zonal_control(ctx, dalles=1)["fp8"]
    assert got["label_gap"] > ctx.limits["label_gap"]


def test_tf32_control_is_not_correct():
    ctx = small.context_for("train-swinb-f32-b16", 27)
    got = control.train_control(ctx, emulate_tf32=True)
    for name in ("tf32", "half_batch"):
        assert any(got[name][k] > ctx.limits[k] for k in got[name]), (name, got[name])
    assert registry.limits("train-swinb-f32-b16") == ctx.limits
