"""Metrics report: compute + persist (reference writer/metrics_utils.py:17-135).

Drops zero-weighted classes from the confusion matrix, computes
OA/IoU/F1/precision/recall, writes metrics.json + confmat_<mode>.npy, and
logs the formatted per-class table with task/modality weights.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict

import numpy as np

from flair_for_aigle_tpu_torch.writer.metrics_core import (
    class_IoU,
    class_fscore,
    class_precision,
    class_recall,
    overall_accuracy,
)

logger = logging.getLogger(__name__)


def compute_and_save_metrics(confmat: np.ndarray, config: Dict,
                             output_dir: str, task: str,
                             mode: str = "predict") -> dict:
    label_config = config["labels_configs"][task]
    class_names = label_config["value_name"]
    num_classes = len(class_names)

    value_weights = label_config.get("value_weights", {})
    default_weight = value_weights.get("default", 1)
    default_exceptions = value_weights.get("default_exceptions", {}) or {}
    default_weights = [default_weight] * num_classes
    for i, weight in default_exceptions.items():
        default_weights[int(i)] = weight

    active_modalities = [
        mod for mod, a in config["modalities"]["inputs"].items() if a
    ]
    per_modality_exceptions = value_weights.get("per_modality_exceptions", {}) or {}
    modality_weights = {}
    for mod in active_modalities:
        modality_weights[mod] = default_weights.copy()
        mod_exc = per_modality_exceptions.get(mod)
        if mod_exc:
            for i, weight in mod_exc.items():
                modality_weights[mod][int(i)] = weight

    weights_array = np.array(default_weights)
    used = np.where(weights_array != 0)[0]

    cm = confmat[np.ix_(used, used)]
    names = [class_names[i] if not isinstance(class_names, dict)
             else class_names[i] for i in used]
    dw = [default_weights[i] for i in used]
    mw = {mod: [modality_weights[mod][i] for i in used]
          for mod in active_modalities}

    per_c_ious, avg_ious = class_IoU(cm, len(used))
    ovr_acc = overall_accuracy(cm)
    per_c_precision, avg_precision = class_precision(cm)
    per_c_recall, avg_recall = class_recall(cm)
    per_c_fscore, avg_fscore = class_fscore(per_c_precision, per_c_recall)

    metrics = {
        "Avg_metrics_name": ["mIoU", "Overall Accuracy", "F-score",
                             "Precision", "Recall"],
        "Avg_metrics": [avg_ious, ovr_acc, avg_fscore, avg_precision,
                        avg_recall],
        "classes": names,
        "per_class_iou": list(per_c_ious),
        "per_class_fscore": list(per_c_fscore),
        "per_class_precision": list(per_c_precision),
        "per_class_recall": list(per_c_recall),
        "per_class_default_weight": dw,
        "per_class_modality_weights": mw,
    }

    out_folder = Path(output_dir,
                      f"metrics_{config['paths']['out_model_name']}", task)
    out_folder.mkdir(exist_ok=True, parents=True)
    np.save(out_folder / f"confmat_{mode}.npy", confmat)
    with open(out_folder / "metrics.json", "w") as f:
        json.dump(metrics, f, indent=2, default=float)

    logger.info("Task: %s - Global Metrics:", task)
    for name, value in zip(metrics["Avg_metrics_name"], metrics["Avg_metrics"]):
        logger.info("%-20s %.4f", name, value)
    for i, cname in enumerate(names):
        logger.info("%-6d %-25s IoU %.4f F1 %.4f P %.4f R %.4f",
                    i, str(cname), per_c_ious[i], per_c_fscore[i],
                    per_c_precision[i], per_c_recall[i])
    unused = np.where(weights_array == 0)[0]
    if len(unused):
        logger.info("0-weighted classes for task: %s", list(unused))
    return metrics
