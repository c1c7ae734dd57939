"""Training / prediction drivers (port of ``flair_for_aigle_tpu/train/
trainer.py``; the reference replaced Lightning's Trainer by an explicit
loop, and so does this module, on one device).

Ported: ModelCheckpoint (monitor, top-1 + optional last), EarlyStopping,
the BatchNorm batch-size-1 abort, weights-only resume from a checkpoint, the
final validate pass, and checkpoints written as torch-layout safetensors
with the keys of the JAX package's ``export_torch_state_dict``. Not yet:
full-state (optimizer + step) resume (the reference's orbax flags raise),
TensorBoard scalars, and data parallelism over several GPUs (ROADMAP Queue
A 9 and 11).
"""

from __future__ import annotations

import logging
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.parallel.dist import is_rank_zero
from flair_for_aigle_tpu_torch.train.metrics import iou_from_confmat
from flair_for_aigle_tpu_torch.train.optim import make_optimizer, make_scheduler
from flair_for_aigle_tpu_torch.train.task import array_batch, make_steps

logger = logging.getLogger(__name__)

_NO_FULL_STATE = ("full-state (optimizer + step) resume is not ported to "
                  "flair_for_aigle_tpu_torch yet (ROADMAP Queue A 9: "
                  "full-state torch resume)")


def check_batchnorm_and_batch_size(config: Dict[str, Any]) -> None:
    """Abort on batch_size 1 (the decoders carry BatchNorm)."""
    if config["hyperparams"]["batch_size"] == 1 and config["tasks"].get("train"):
        logger.info("Warning: BatchNorm layers with batch size 1.")
        logger.info("Aborting training to avoid potential issues.")
        sys.exit(1)


def check_full_state_flags(config: Dict[str, Any]) -> None:
    if (config.get("saving", {}).get("save_full_state_orbax")
            or config["tasks"].get("train_tasks", {}).get("resume_full_state_from_orbax")):
        raise NotImplementedError(_NO_FULL_STATE)


def save_state_safetensors(model: torch.nn.Module, path: str) -> None:
    """The model's weights and BatchNorm statistics as a torch-layout
    safetensors file: the keys and layouts of ``export_torch_state_dict(...,
    transpose_conv_prefixes=(".up.0",))`` (the ported families hold no
    transposed convolution)."""
    from safetensors.torch import save_file

    save_file({k: v.detach().cpu().contiguous()
               for k, v in model.state_dict().items()}, path)


def load_state_safetensors(model: torch.nn.Module, path: str) -> None:
    from safetensors.torch import load_file

    model.load_state_dict(load_file(path), strict=True)


class CheckpointCallback:
    """ModelCheckpoint + EarlyStopping equivalent."""

    def __init__(self, config, out_dir):
        saving = config["saving"]
        self.monitor = saving.get("ckpt_monitor", "val_miou")
        self.mode = saving.get("ckpt_monitor_mode", "max")
        self.save_last = saving.get("ckpt_save_also_last", False)
        self.patience = saving.get("ckpt_earlystopping_patience", 20)
        self.dirpath = Path(out_dir, "checkpoints")
        self.dirpath.mkdir(parents=True, exist_ok=True)
        self.out_model_name = config["paths"]["out_model_name"]
        self.best = -math.inf if self.mode == "max" else math.inf
        self.best_model_path: str | None = None
        self.bad_epochs = 0
        self.should_stop = False

    def _is_better(self, value):
        return value > self.best if self.mode == "max" else value < self.best

    def on_epoch_end(self, epoch, metrics, model) -> None:
        value = metrics.get(self.monitor)
        if value is None:
            return
        if self._is_better(value):
            self.best = value
            self.bad_epochs = 0
            path = self.dirpath / (f"ckpt-epoch{epoch:02d}-{self.monitor}{value:.4f}_"
                                   f"{self.out_model_name}.safetensors")
            if is_rank_zero():
                save_state_safetensors(model, str(path))
                if self.best_model_path and os.path.exists(self.best_model_path):
                    os.remove(self.best_model_path)
            self.best_model_path = str(path)
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.should_stop = True
        if self.save_last and is_rank_zero():
            save_state_safetensors(
                model, str(self.dirpath / f"last_{self.out_model_name}.safetensors"))


def pad_batch_to(batch: dict, size: int) -> dict:
    """Pad the leading axis of every array to ``size`` by repeating the last
    row (``parallel/mesh.py:58``), so a ragged final batch gets the
    reference's treatment."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] < size:
            v = np.concatenate([v] + [v[-1:]] * (size - v.shape[0]), axis=0)
        out[k] = v
    return out


def _epoch_metrics(confmats: Dict[str, np.ndarray], loss_sum, n_batches,
                   prefix: str) -> Dict[str, float]:
    out = {f"{prefix}_loss": float(loss_sum / max(n_batches, 1))}
    mious = []
    for task, cm in confmats.items():
        per_class, weighted = iou_from_confmat(cm)
        out[f"{prefix}_miou_{task.split('-')[-1]}"] = weighted
        for i, v in enumerate(per_class):
            out[f"{prefix}_iou_{task.split('-')[-1]}_{i}"] = float(v)
        mious.append(weighted)
    out[f"{prefix}_miou"] = float(np.mean(mious)) if mious else 0.0
    return out


def _accumulate(acc: Dict[str, Any], m: Dict[str, Any]) -> None:
    """Sum a step's loss and confusion matrices on the device (one host
    sync per epoch, as the reference)."""
    acc["loss"] = m["loss"] if "loss" not in acc else acc["loss"] + m["loss"]
    acc["nonfinite"] = acc.get("nonfinite", 0) + (~torch.isfinite(m["loss"])).int()
    cms = acc.setdefault("confmats", {})
    for t, cm in m["confmats"].items():
        cms[t] = cm if t not in cms else cms[t] + cm
    acc["n"] = acc.get("n", 0) + 1


def _host(acc: Dict[str, Any]):
    n = acc.get("n", 0)
    loss_sum = float(acc["loss"]) if n else 0.0
    nonfinite = int(acc["nonfinite"]) if n else 0
    confmats = {t: cm.cpu().numpy() for t, cm in acc.get("confmats", {}).items()}
    return loss_sum, nonfinite, confmats, n


def train(config: Dict[str, Any], data_module, model, out_dir: str, device,
          aux_loss_fix: bool = False, epoch_hook=None):
    """Fit loop; the model ends holding the last epoch's weights. Returns
    the CheckpointCallback (best checkpoint path). ``epoch_hook(epoch,
    metrics)``, if given, runs after each epoch's checkpointing."""
    check_batchnorm_and_batch_size(config)
    check_full_state_flags(config)
    hp = config["hyperparams"]
    batch_size = hp["batch_size"]
    num_epochs = hp["num_epochs"]

    data_module.setup("fit")
    train_loader = data_module.train_dataloader()
    val_loader = data_module.val_dataloader()
    steps_per_epoch = max(1, len(train_loader))

    if config["tasks"]["train_tasks"].get("resume_training_from_ckpt"):
        # weights-only resume (reference trainers.py:94-104)
        from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint

        path = config["paths"].get("ckpt_model_path")
        if path and os.path.isfile(path):
            load_checkpoint(model, path)
        else:
            logger.info("Invalid checkpoint path.")
    model.to(device)
    optimizer = make_optimizer(hp, [p for p in model.parameters() if p.requires_grad])
    scheduler = make_scheduler(hp, hp.get("scheduler_total_steps")
                               or steps_per_epoch * num_epochs)
    steps = make_steps(model, config, optimizer, device, aux_loss_fix=aux_loss_fix)
    ckpt_cb = CheckpointCallback(config, out_dir)
    global_step = 0
    for epoch in range(num_epochs):
        acc: Dict[str, Any] = {}
        for batch in train_loader:
            batch = pad_batch_to(array_batch(batch), batch_size)
            m = steps.train_step(batch, scheduler.lr_for_step(global_step))
            _accumulate(acc, m)
            global_step += 1
        loss_sum, n_nonfinite, confmats, n_batches = _host(acc)
        if n_nonfinite:
            logger.info("NaN or Inf detected in loss at %d step(s) of epoch %d",
                        n_nonfinite, epoch)
        train_metrics = _epoch_metrics(confmats, loss_sum, n_batches, "train")
        val_metrics = validate(val_loader, steps, batch_size)
        scheduler.epoch_end(val_metrics["val_loss"])
        logger.info("epoch %d: train_loss %.4f train_miou %.4f | val_loss %.4f "
                    "val_miou %.4f | lr %.3e", epoch, train_metrics["train_loss"],
                    train_metrics["train_miou"], val_metrics["val_loss"],
                    val_metrics["val_miou"], scheduler.lr_for_step(max(global_step - 1, 0)))
        ckpt_cb.on_epoch_end(epoch, {**train_metrics, **val_metrics}, model)
        if epoch_hook is not None:
            epoch_hook(epoch, {**train_metrics, **val_metrics})
        if ckpt_cb.should_stop:
            logger.info("Early stopping at epoch %d", epoch)
            break
    validate(val_loader, steps, batch_size)  # final validate (trainers.py:431)
    return ckpt_cb


def validate(val_loader, steps, batch_size) -> Dict[str, float]:
    acc: Dict[str, Any] = {}
    for batch in val_loader:
        _accumulate(acc, steps.eval_step(pad_batch_to(array_batch(batch), batch_size)))
    loss_sum, _, confmats, n_batches = _host(acc)
    return _epoch_metrics(confmats, loss_sum, n_batches, "val")


def predict(config: Dict[str, Any], data_module, model, out_dir: str, device) -> None:
    """Prediction driver with the PredictionWriter (trainers.py:436-461)."""
    from flair_for_aigle_tpu_torch.writer.prediction_writer import PredictionWriter

    data_module.setup("predict")
    loader = data_module.predict_dataloader()
    steps = make_steps(model.to(device), config, None, device)
    writer = PredictionWriter(config, output_dir=out_dir)
    for batch in loader:
        preds = {k: v.cpu().numpy() for k, v in steps.predict_step(batch).items()}
        writer.write_on_batch_end(preds, batch)
    writer.on_predict_epoch_end()
