"""Training / prediction stages (port of ``flair_for_aigle_tpu/train/
stages.py``).

``training_stage``: seed, probe input sizes from one batch ("monkeybatch"),
build the model with seeded random weights, optionally initialise it from a
checkpoint, train, reload the best checkpoint. ``predict_stage``:
metrics-only, or predict with the PredictionWriter. The data module is the
JAX package's framework-free ``FlairDataModule``.
"""

from __future__ import annotations

import datetime
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from flair_for_aigle_tpu.data.dataset import FlairDataModule
from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.models.layers import init_weights
from flair_for_aigle_tpu_torch.train.trainer import (
    load_state_safetensors,
    predict,
    train,
)
from flair_for_aigle_tpu_torch.writer.prediction_writer import PredictionWriter

logger = logging.getLogger(__name__)


def get_datasets(config: Dict[str, Any]):
    """(train, val, test) split dicts from the config's CSVs
    (``flair_for_aigle_tpu/data/paths.py:53``, which needs pandas)."""
    from flair_for_aigle_tpu.data.paths import get_datasets as from_csvs

    return from_csvs(config)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def build_data_module(config: Dict[str, Any], dict_train=None, dict_val=None,
                      dict_test=None) -> FlairDataModule:
    use_aug = config["modalities"]["pre_processings"]["use_augmentation"]
    if not isinstance(use_aug, bool):
        raise ValueError("modalities.pre_processings.use_augmentation must be a bool")
    return FlairDataModule(
        config=config, dict_train=dict_train, dict_val=dict_val,
        dict_test=dict_test, batch_size=config["hyperparams"]["batch_size"],
        num_workers=config["hardware"]["num_workers"], drop_last=True,
        use_augmentations=use_aug)


def get_input_img_sizes(config: Dict[str, Any], dm) -> Dict[str, int]:
    """Pull one training batch through the loader ("monkeybatch") to
    measure the per-modality input sizes."""
    dm.setup("fit")
    monkeybatch = next(iter(dm.train_dataloader()))
    return {mod: monkeybatch[mod][0].shape[-1]
            for mod, active in config["modalities"]["inputs"].items()
            if active and mod in monkeybatch}


def build_model(config: Dict[str, Any]) -> FlairHubModel:
    """The model with random weights from ``hyperparams.seed``."""
    gen = torch.Generator().manual_seed(int(config["hyperparams"].get("seed", 0)))
    return init_weights(FlairHubModel(config), gen)


def training_stage(config: Dict, data_module, out_dir: Path, device=None,
                   aux_loss_fix: bool = False, epoch_hook=None) -> FlairHubModel:
    """Train; returns the model holding the best checkpoint's weights.
    ``epoch_hook(epoch, metrics)`` is passed on to ``train``."""
    device = device or default_device()
    start = datetime.datetime.now()
    np.random.seed(config["hyperparams"]["seed"])
    logger.info("input sizes from one training batch: %s",
                get_input_img_sizes(config, data_module))
    model = build_model(config)
    if config["tasks"]["train_tasks"]["init_weights_only_from_ckpt"]:
        load_checkpoint(model, config["paths"]["ckpt_model_path"])
    ckpt_cb = train(config, data_module, model, str(out_dir), device,
                    aux_loss_fix=aux_loss_fix, epoch_hook=epoch_hook)
    if ckpt_cb.best_model_path:  # reload the best weights (stages.py:112-121)
        load_state_safetensors(model, ckpt_cb.best_model_path)
    logger.info("[Training finished in %s on %s]",
                datetime.timedelta(seconds=(datetime.datetime.now() - start).total_seconds()),
                device)
    return model


def predict_stage(config: Dict, data_module, out_dir_predict: Path,
                  trained: Optional[FlairHubModel] = None, device=None) -> None:
    device = device or default_device()
    out_dir_predict = Path(out_dir_predict)
    if config["tasks"].get("metrics_only", False) and not config["tasks"].get("predict", False):
        logger.info("[ ] Metrics-only mode: loading predictions from disk ...")
        PredictionWriter(config, str(out_dir_predict)).load_predictions_and_compute_metrics()
        return
    if config["tasks"].get("predict", False):
        model = trained
        if model is None:
            model = build_model(config)
            load_checkpoint(model, config["paths"]["ckpt_model_path"])
        logger.info("[ ] Running inference and metrics calculation ...")
        predict(config, data_module, model, str(out_dir_predict), device)
        return
    logger.info("[ ] Neither 'predict' nor 'metrics_only' is enabled.")
