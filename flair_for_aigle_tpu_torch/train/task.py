"""Segmentation task steps (port of ``flair_for_aigle_tpu/train/task.py``).

``make_steps`` returns the train, eval and predict steps over a model that
holds its own parameters and BatchNorm statistics and an optimizer that
holds its moments; the JAX ``TrainState`` is those two objects here.

Quirk compatibility: the reference's auxiliary loss is dead code (keys
``aux_{mod}_{task}`` never match its ``task in dict_logits_aux`` check).
``aux_loss_fix=False`` reproduces that (no aux gradient); ``True`` enables
the intended aux loss with ``aux_loss_weight`` scaling. Modality dropout
is on when any ``modality_dropout`` value is positive (the values only
switch it on, as in ``task.py:57-59``); it acts with more than one
modality, and draws, like UTAE's dropout, from the steps' generator.

Under data parallelism (a ``torch.distributed`` group of more than one
rank, each holding an equal shard of the global batch) the steps compute
what one device computes on the global batch, as GSPMD does for the JAX
package: each rank's loss is its share of the global loss
(``train/losses.py``), the gradients are summed over the ranks before the
optimizer step, and the reported loss and confusion matrices are the
global ones; the generator is then a ``parallel/mesh.py ShardedGenerator``
that draws the global batch's masks and noise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.parallel.dist import all_reduce_grads, sum_over_group
from flair_for_aigle_tpu_torch.train.losses import (
    build_loss_weights,
    weighted_cross_entropy,
)
from flair_for_aigle_tpu_torch.train.metrics import (
    confusion_matrix,
    per_class_mean_loss,
)
from flair_for_aigle_tpu_torch.utils import profiling


def array_batch(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Drop non-array entries (ID strings, python lists)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in array_batch(batch).items()}


class Steps:
    """train / eval / predict steps of one model (``make_steps``)."""

    def __init__(self, model, config: Dict[str, Any], optimizer,
                 device, aux_loss_fix: bool = False,
                 generator: torch.Generator | None = None):
        self.model = model
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.labels = list(config["labels"])
        self.nclasses = {t: len(config["labels_configs"][t]["value_name"])
                         for t in self.labels}
        self.weights = {k: torch.as_tensor(v, device=self.device)
                        for k, v in build_loss_weights(config).items()}
        self.task_weights = {
            t: float(config["labels_configs"][t].get("task_weight", 1.0))
            for t in self.labels}
        self.aux_weight = config["modalities"].get("aux_loss_weight", 1.0)
        self.aux_mods = [
            m for m, a in config["modalities"].get("aux_loss", {}).items()
            if a and config["modalities"]["inputs"].get(m, False)]
        self.aux_loss_fix = aux_loss_fix
        self.mod_dropout = any(
            v > 0 for v in config["modalities"].get("modality_dropout", {}).values())
        self.generator = generator
        self.compute_dtype = (torch.bfloat16 if config["hyperparams"].get(
            "compute_dtype") == "bfloat16" else None)
        self.params = [p for p in model.parameters() if p.requires_grad]

    def cast_inputs(self, batch):
        """``compute_dtype: bfloat16``: float32 inputs (not dates, not
        labels) to bf16, as ``task.py:66-75``."""
        if self.compute_dtype is None:
            return batch
        return {k: (v.to(self.compute_dtype)
                    if v.dtype == torch.float32 and not k.endswith("_DATES")
                    and k not in self.labels else v)
                for k, v in batch.items()}

    def targets(self, batch, task) -> torch.Tensor:
        t = batch[task]
        if t.ndim == 4:
            t = torch.argmax(t, dim=1)
        return t.to(torch.int32)

    def compute_loss(self, logits_tasks, logits_aux, batch):
        loss_sum = torch.zeros((), device=self.device)
        preds, targets_out = {}, {}
        for task in self.labels:
            targets = self.targets(batch, task)
            main = weighted_cross_entropy(logits_tasks[task], targets,
                                          self.weights[task])
            aux = 0.0
            if self.aux_loss_fix and self.aux_mods:
                terms = []
                for mod in self.aux_mods:
                    key = f"aux_{mod}_{task}"
                    if key in logits_aux:
                        w = (self.aux_weight if not isinstance(self.aux_weight, dict)
                             else self.aux_weight.get(mod, 1.0))
                        terms.append(w * weighted_cross_entropy(
                            logits_aux[key], targets, self.weights[key]))
                if terms:
                    aux = torch.stack(terms).mean()
            loss_sum = loss_sum + self.task_weights[task] * (main + aux)
            preds[task] = torch.argmax(logits_tasks[task], dim=1)
            targets_out[task] = targets
        return loss_sum, preds, targets_out

    def loss_and_grads(self, batch):
        """Training-mode forward + backward: (loss, grads in ``self.params``
        order, preds, targets); the loss and the gradients are the global
        batch's under data parallelism, the preds and targets this rank's.
        Updates the BatchNorm running statistics, touches no parameter.
        Spans ``train.h2d``, ``train.forward`` (model and loss) and
        ``train.backward`` (gradients and their sum over the group), the
        last two timed on the device too while a profiler session is on."""
        self.model.train()
        with profiling.span("train.h2d"):
            b = to_device(batch, self.device)
        with profiling.span("train.forward", device=self.device):
            logits_tasks, logits_aux = self.model(self.cast_inputs(b),
                                                  apply_mod_dropout=self.mod_dropout,
                                                  generator=self.generator)
            loss, preds, targets = self.compute_loss(logits_tasks, logits_aux, b)
        with profiling.span("train.backward", device=self.device):
            grads = all_reduce_grads(torch.autograd.grad(loss, self.params, allow_unused=True))
            loss = sum_over_group(loss.detach())
        return loss, grads, preds, targets

    @profiling.span("train.step")
    def train_step(self, batch, lr: float) -> Dict[str, Any]:
        loss, grads, preds, targets = self.loss_and_grads(batch)
        with profiling.span("train.optimizer"):
            self.optimizer.step(grads, lr)
        with profiling.span("train.confmat"):
            confmats = self.confmats(preds, targets)
        return {"loss": loss, "confmats": confmats}

    def confmats(self, preds, targets) -> Dict[str, torch.Tensor]:
        """Each task's confusion matrix, summed over the group."""
        return {t: sum_over_group(confusion_matrix(preds[t], targets[t], self.nclasses[t]))
                for t in self.labels}

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, Any]:
        self.model.eval()
        b = to_device(batch, self.device)
        logits_tasks, logits_aux = self.model(self.cast_inputs(b))
        loss, preds, targets = self.compute_loss(logits_tasks, logits_aux, b)
        return {"loss": sum_over_group(loss), "confmats": self.confmats(preds, targets),
                "per_class_loss": {t: per_class_mean_loss(logits_tasks[t],
                                                          targets[t])
                                   for t in self.labels}}

    @torch.no_grad()
    def predict_step(self, batch) -> Dict[str, torch.Tensor]:
        """argmax of the softmax per task; inputs are not cast to the
        compute dtype (``task.py:151-160``)."""
        self.model.eval()
        logits_tasks, _ = self.model(to_device(batch, self.device))
        return {f"preds_{t}": torch.argmax(torch.softmax(logits_tasks[t], dim=1), dim=1)
                for t in self.labels}


def make_steps(model, config: Dict[str, Any], optimizer, device,
               aux_loss_fix: bool = False,
               generator: torch.Generator | None = None) -> Steps:
    """``generator``: the draws of the training step's modality dropout
    and UTAE dropout (on ``device``); None uses torch's default one."""
    return Steps(model, config, optimizer, device, aux_loss_fix=aux_loss_fix,
                 generator=generator)
