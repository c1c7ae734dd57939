"""Training / prediction drivers (port of ``flair_for_aigle_tpu/train/
trainer.py``; the reference replaced Lightning's Trainer by an explicit
loop, and so does this module).

Ported: ModelCheckpoint (monitor, top-1 + optional last), EarlyStopping,
the BatchNorm batch-size-1 abort, weights-only resume from a checkpoint,
full-state resume, TensorBoard scalars, the final validate pass, and
checkpoints written as torch-layout safetensors with the keys of the JAX
package's ``export_torch_state_dict``.

Data parallelism: inside a ``torch.distributed`` group of W ranks
(``parallel/dist.py initialize``, e.g. under ``torchrun``), every rank
reads the same global batch in the loader's deterministic order, pads it
to the batch size and keeps its contiguous shard (``parallel/mesh.py``);
the steps sum what GSPMD sums for the JAX package (``train/task.py``), so
a step equals the one-device step on the global batch. Rank 0's weights
are broadcast after the build and any resume; checkpoints, the full state
and TensorBoard are written by rank 0 only. ``batch_size`` must divide by
W: a ``ValueError`` otherwise, where the JAX trainer takes gcd(batch,
devices) devices and leaves the rest idle. ``predict`` splits the batches
between the ranks, the PredictionWriter sums the confusion matrices.

Full-state resume keeps the reference's config keys and semantics
(``trainer.py:121-125, 213-258``) in torch's file format:
``saving.save_full_state_orbax`` writes ``checkpoints/full_state_last_<name>.pt``
after every epoch (``torch.save``: the model with its BatchNorm buffers, the
optimizer's count and moments, the step), and
``tasks.train_tasks.resume_full_state_from_orbax: <that file>`` restores it.
The scheduler's horizon is set after the restore, every step's random draws
(modality dropout, UTAE's and the decoders' dropout) come from a generator
seeded by (seed, step), and the epoch labels continue from step //
steps_per_epoch. Three deliberate divergences make a killed-and-resumed run
retrace an uninterrupted one, as the reference's comment promises
(``trainer.py:251-255``) but its orbax state does not deliver: the state
also holds the ReduceLROnPlateau tracker (and cycle_then_plateau's switch),
the training loader's shuffle continues at the resumed epoch, and the state
holds steps_per_epoch, so a resume with another value raises instead of
shifting the epoch labels.
"""

from __future__ import annotations

import logging
import math
import os
import sys
import types
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.parallel import dist
from flair_for_aigle_tpu_torch.parallel.dist import is_rank_zero
from flair_for_aigle_tpu_torch.parallel.mesh import ShardedGenerator, pad_batch_to, shard_batch
from flair_for_aigle_tpu_torch.train.metrics import iou_from_confmat
from flair_for_aigle_tpu_torch.train.optim import make_optimizer, make_scheduler
from flair_for_aigle_tpu_torch.train.task import array_batch, make_steps

logger = logging.getLogger(__name__)


def check_batchnorm_and_batch_size(config: Dict[str, Any]) -> None:
    """Abort on batch_size 1 (the decoders carry BatchNorm)."""
    if config["hyperparams"]["batch_size"] == 1 and config["tasks"].get("train"):
        logger.info("Warning: BatchNorm layers with batch size 1.")
        logger.info("Aborting training to avoid potential issues.")
        sys.exit(1)


def step_seed(seed: int, step: int) -> int:
    """The seed of one training step's generator: keyed by (seed, step),
    not drawn in sequence, so a resumed run draws what an uninterrupted one
    draws at that step (the reference's ``fold_in(rng, step)``)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class _TBWriter:
    """TensorBoard scalars through ``torch.utils.tensorboard``; a no-op
    when it does not import (no ``tensorboard`` package) and when
    ``logdir`` is None (ranks other than 0). The writer takes TensorBoard's
    TensorFlow-free path (its ``tensorboard.compat.notf`` marker), so it
    never imports tensorflow, which imports jax where both are
    installed."""

    def __init__(self, logdir: str | None):
        self._writer = None
        if logdir is None:
            return
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._writer = SummaryWriter(logdir)

    def scalar(self, name: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(name, float(value), step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


def save_full_state(path: str, state: Dict[str, Any]) -> None:
    """Write a full training state (``train``'s ``full_state``) atomically."""
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_full_state(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_safetensors(model: torch.nn.Module, path: str) -> None:
    """The model's weights and BatchNorm statistics as a torch-layout
    safetensors file: the keys and layouts of the JAX package's
    ``export_torch_state_dict``, transposed convolutions (UTAE's, LinkNet's)
    in torch's (in, out, kH, kW)."""
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
        self.save_full = saving.get("save_full_state_orbax", False)
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

    def on_epoch_end(self, epoch, metrics, model,
                     full_state: Callable[[], Dict[str, Any]] | None = None) -> None:
        """``full_state()`` gives the training state to write when
        ``saving.save_full_state_orbax`` is on."""
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
        if self.save_full and full_state is not None and is_rank_zero():
            save_full_state(str(self.dirpath / f"full_state_last_{self.out_model_name}.pt"),
                            full_state())


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


def restore_full_state(path: str, model, optimizer, steps_per_epoch: int):
    """Load a full training state into ``model`` and ``optimizer``; returns
    (step, scheduler state). Raises when the state was written with another
    steps_per_epoch: its step would fall on other epoch labels."""
    state = load_full_state(path)
    if int(state["steps_per_epoch"]) != steps_per_epoch:
        raise ValueError(
            f"{path} was saved at {state['steps_per_epoch']} steps per epoch and "
            f"this run has {steps_per_epoch}: the resumed epochs would be labelled "
            f"{int(state['step']) // steps_per_epoch} onwards instead of "
            f"{int(state['step']) // int(state['steps_per_epoch'])}; resume with the "
            f"same training split and batch size")
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"]), state["scheduler"]


def train(config: Dict[str, Any], data_module, model, out_dir: str, device,
          aux_loss_fix: bool = False, epoch_hook=None):
    """Fit loop; the model ends holding the last epoch's weights. Returns
    the CheckpointCallback (best checkpoint path). ``epoch_hook(epoch,
    metrics)``, if given, runs after each epoch's checkpointing."""
    check_batchnorm_and_batch_size(config)
    hp = config["hyperparams"]
    batch_size = hp["batch_size"]
    num_epochs = hp["num_epochs"]
    seed = int(hp.get("seed", 0))
    rank, world = dist.process_index(), dist.world_size()
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must be divisible by the {world} "
                         "data-parallel ranks (each takes an equal shard of every batch)")

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
    global_step, sched_state = 0, None
    resume = config["tasks"]["train_tasks"].get("resume_full_state_from_orbax")
    if resume:
        global_step, sched_state = restore_full_state(resume, model, optimizer,
                                                      steps_per_epoch)
        logger.info("Resumed full training state from %s (step %d)", resume, global_step)
    dist.broadcast_module(model)  # every rank starts from rank 0's weights
    # the horizon AFTER the restore: hyperparams.scheduler_total_steps pins
    # the original run's total, else restored step + the epochs to run now
    total_steps = hp.get("scheduler_total_steps") or global_step + steps_per_epoch * num_epochs
    scheduler = make_scheduler(hp, total_steps)
    if sched_state is not None:
        scheduler.load_state_dict(sched_state)
    if global_step and not hp.get("scheduler_total_steps"):
        logger.info("scheduler horizon defaulted to resumed step + %d epochs = %d "
                    "steps; set hyperparams.scheduler_total_steps to pin the "
                    "original run's schedule instead", num_epochs, total_steps)
    # every step's random draws (modality, UTAE and decoder dropout) come
    # from this generator, reseeded by (seed, step) before the step; each
    # rank draws the global batch's and keeps its shard's
    gen = ShardedGenerator(device, rank, world)
    steps = make_steps(model, config, optimizer, device, aux_loss_fix=aux_loss_fix,
                       generator=gen)
    ckpt_cb = CheckpointCallback(config, out_dir)
    tb = _TBWriter(os.path.join(out_dir, "tensorboard_logs_" + config["paths"]["out_model_name"])
                   if is_rank_zero() else None)
    epoch_offset = global_step // steps_per_epoch
    if hasattr(train_loader, "_epoch"):
        train_loader._epoch = epoch_offset  # the shuffle continues at the resumed epoch

    def full_state() -> Dict[str, Any]:
        return {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(), "step": global_step,
                "steps_per_epoch": steps_per_epoch, "scheduler": scheduler.state_dict()}

    for epoch in range(epoch_offset, epoch_offset + num_epochs):
        acc: Dict[str, Any] = {}
        for batch in train_loader:
            batch = shard_batch(pad_batch_to(array_batch(batch), batch_size), rank, world)
            gen.manual_seed(step_seed(seed, global_step))
            m = steps.train_step(batch, scheduler.lr_for_step(global_step))
            _accumulate(acc, m)
            global_step += 1
        loss_sum, n_nonfinite, confmats, n_batches = _host(acc)
        if n_nonfinite:
            logger.info("NaN or Inf detected in loss at %d step(s) of epoch %d",
                        n_nonfinite, epoch)
        train_metrics = _epoch_metrics(confmats, loss_sum, n_batches, "train")
        tb.scalar("train_loss", train_metrics["train_loss"], epoch)
        tb.scalar("train_miou", train_metrics["train_miou"], epoch)
        tb.scalar("lr", scheduler.lr_for_step(max(global_step - 1, 0)), epoch)
        val_metrics = validate(val_loader, steps, batch_size)
        for k, v in val_metrics.items():
            if k.count("_") <= 2:
                tb.scalar(k, v, epoch)
        scheduler.epoch_end(val_metrics["val_loss"])
        logger.info("epoch %d: train_loss %.4f train_miou %.4f | val_loss %.4f "
                    "val_miou %.4f | lr %.3e", epoch, train_metrics["train_loss"],
                    train_metrics["train_miou"], val_metrics["val_loss"],
                    val_metrics["val_miou"], scheduler.lr_for_step(max(global_step - 1, 0)))
        ckpt_cb.on_epoch_end(epoch, {**train_metrics, **val_metrics}, model, full_state)
        if epoch_hook is not None:
            epoch_hook(epoch, {**train_metrics, **val_metrics})
        if ckpt_cb.should_stop:
            logger.info("Early stopping at epoch %d", epoch)
            break
    validate(val_loader, steps, batch_size)  # final validate (trainers.py:431)
    tb.flush()
    dist.barrier()  # rank 0's checkpoints are on disk before any rank reloads one
    return ckpt_cb


def validate(val_loader, steps, batch_size) -> Dict[str, float]:
    """The validation metrics over the global batches (each rank evaluates
    its shard; the steps sum the loss and the confusion matrices)."""
    rank, world = dist.process_index(), dist.world_size()
    acc: Dict[str, Any] = {}
    for batch in val_loader:
        batch = shard_batch(pad_batch_to(array_batch(batch), batch_size), rank, world)
        _accumulate(acc, steps.eval_step(batch))
    loss_sum, _, confmats, n_batches = _host(acc)
    return _epoch_metrics(confmats, loss_sum, n_batches, "val")


def predict(config: Dict[str, Any], data_module, model, out_dir: str, device) -> None:
    """Prediction driver with the PredictionWriter (trainers.py:436-461).
    Under data parallelism rank r predicts the batches r, r + W, ... and
    writes their files; the writer sums the confusion matrices over the
    ranks (``all_sum_host``) and rank 0 writes the metrics, as the
    reference's DDP ranks do."""
    from flair_for_aigle_tpu_torch.writer.prediction_writer import PredictionWriter

    data_module.setup("predict")
    loader = data_module.predict_dataloader()
    steps = make_steps(model.to(device), config, None, device)
    writer = PredictionWriter(config, output_dir=out_dir)
    rank, world = dist.process_index(), dist.world_size()
    for i, batch in enumerate(loader):
        if i % world != rank:
            continue
        preds = {k: v.cpu().numpy() for k, v in steps.predict_step(batch).items()}
        writer.write_on_batch_end(preds, batch)
    writer.on_predict_epoch_end()
