"""The port's multimodal training path on the CPU, on the toy split of
``tests/test_training_multimodal.py`` (32 px aerial patches, 8 px
Sentinel-2 time series of 5 dates with a cloudy date and a
GLOBAL_SENTINEL2_MTD_DATES metadata file, variable-T collate), with a
swin_micro-upernet fused with a UTAE and modality dropout on:

* ``training_stage`` (one epoch) and ``predict_stage`` run, the losses
  are finite, the best checkpoint holds the UTAE and fusion weights and
  the prediction rasters are written;
* one training step's modality dropout and UTAE dropout draw from the
  steps' generator: two steps from equal seeds give equal losses and
  gradients, and with the aux losses on (``aux_loss_fix``: the UTAE logits
  reach the loss only through their aux head) every UTAE and fusion
  parameter gets a finite gradient.
"""

import math
from pathlib import Path

import numpy as np
import torch
from safetensors.numpy import load_file

from flair_for_aigle_tpu_torch.train import stages
from flair_for_aigle_tpu_torch.train.task import make_steps
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_training_multimodal import make_cfg, mm_toy  # noqa: F401 (a fixture)

ARCH = "swin_micro_patch4_window12_384-upernet"


def _config(root, csvs):
    cfg = make_cfg(root, csvs)
    cfg["models"]["monotemp_model"]["arch"] = ARCH
    cfg["modalities"]["modality_dropout"]["SENTINEL2_TS"] = 0.5
    cfg["modalities"]["aux_loss"]["SENTINEL2_TS"] = True
    return cfg


def test_multimodal_training_epoch_and_predict(mm_toy):  # noqa: F811
    root, csvs = mm_toy
    cfg = _config(root, csvs)
    dm = stages.build_data_module(cfg, *stages.get_datasets(cfg))
    out_dir = Path(cfg["paths"]["out_folder"]) / "mm-toy-port"
    out_dir.mkdir(parents=True, exist_ok=True)
    history = []
    model = stages.training_stage(cfg, dm, out_dir, device="cpu",
                                  epoch_hook=lambda e, m: history.append(m))
    assert len(history) == 1
    assert all(math.isfinite(history[0][k]) for k in ("train_loss", "val_loss"))
    ckpts = list((out_dir / "checkpoints").glob("*.safetensors"))
    assert ckpts
    keys = set(load_file(str(ckpts[0])))
    assert "encoders.SENTINEL2_TS.temporal_encoder.attention_heads.Q" in keys
    assert "fusion_handler.conv_f.0.weight" in keys
    out_pred = out_dir / "results_mm-toy"
    out_pred.mkdir(parents=True, exist_ok=True)
    stages.predict_stage(cfg, dm, out_pred, model, device="cpu")
    preds = list((out_pred / "predictions_mm-toy" / "AERIAL_LABEL-COSIA").glob("PRED_*.tif"))
    assert len(preds) == 2


def test_training_step_draws_from_its_generator(mm_toy):  # noqa: F811
    root, csvs = mm_toy
    cfg = _config(root, csvs)
    dm = stages.build_data_module(cfg, *stages.get_datasets(cfg))
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))
    assert batch["SENTINEL2_TS"].ndim == 5 and batch["SENTINEL2_DATES"].dtype == np.float32
    model = stages.build_model(cfg)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for seed in (7, 7, 8):
        model.load_state_dict(state)
        steps = make_steps(model, cfg, None, "cpu", aux_loss_fix=True,
                           generator=torch.Generator().manual_seed(seed))
        assert steps.mod_dropout
        loss, grads, _, _ = steps.loss_and_grads(batch)
        results.append((float(loss), [g.clone() if g is not None else None for g in grads]))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    (l0, g0), (l1, g1), (l2, _) = results
    assert l0 == l1 and math.isfinite(l0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1) if a is not None)
    assert l2 != l0  # another seed, other dropout draws
    for name, g in zip(names, g0):
        if name.startswith(("encoders.SENTINEL2_TS.", "fusion_handler.")):
            assert g is not None and torch.isfinite(g).all(), name
