"""Prediction writer (port of ``flair_for_aigle_tpu/writer/
prediction_writer.py``).

Per predict batch: writes ``PRED_<name>.tif`` per task (georeferenced from
the source label raster, or a plain TIFF via PIL) and accumulates a
confusion matrix against the label raster named in the batch ID. At the end
the confusion matrices are summed over processes and the metrics persisted
on rank zero (``flair_for_aigle_tpu.writer.metrics_utils``, framework-free).
Metrics-only mode recomputes everything from rasters on disk.

Rasters are read and written through the ``geotiff`` module's attributes at
call time, so the in-memory stand-ins of ``zonal/memory_io.py`` apply.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np

from flair_for_aigle_tpu.geo import geotiff
from flair_for_aigle_tpu.writer.metrics_utils import compute_and_save_metrics
from flair_for_aigle_tpu_torch.parallel.dist import (
    all_sum_host,
    is_rank_zero,
    rank_zero_only,
)

logger = logging.getLogger(__name__)


def _sklearn_confmat(target: np.ndarray, pred: np.ndarray, n: int) -> np.ndarray:
    t, p = target.astype(np.int64).ravel(), pred.astype(np.int64).ravel()
    keep = (t >= 0) & (t < n) & (p >= 0) & (p < n)
    return np.bincount(t[keep] * n + p[keep], minlength=n * n).reshape(n, n)


class PredictionWriter:
    def __init__(self, config: dict, output_dir: str):
        self.config = config
        self.output_dir = output_dir
        self.accumulated_confmats: Dict[str, np.ndarray | None] = {
            task: None for task in config["labels"]}

    def _n(self, task: str) -> int:
        return len(self.config["labels_configs"][task]["value_name"])

    def _channel(self, task: str) -> int:
        return self.config["labels_configs"][task].get("label_channel_nomenclature", 1)

    def write_on_batch_end(self, prediction: Dict[str, np.ndarray], batch: Dict) -> None:
        for task in self.config["labels"]:
            n = self._n(task)
            if self.accumulated_confmats[task] is None:
                self.accumulated_confmats[task] = np.zeros((n, n), dtype=int)
            out_dir = Path(self.output_dir,
                           f"predictions_{self.config['paths']['out_model_name']}", task)
            out_dir.mkdir(exist_ok=True, parents=True)
            preds = np.asarray(prediction[f"preds_{task}"]).astype("uint8")
            id_in_file = batch[f"ID_{task}"]
            src_path = id_in_file[0] if isinstance(id_in_file, list) else id_in_file
            with geotiff.open_raster(src_path) as src:
                target = np.squeeze(src.read(self._channel(task)))
                transform, crs = src.transform, src.crs
            if self.config["tasks"].get("write_files", True):
                out_file = str(out_dir / f"PRED_{str(src_path).split('/')[-1]}")
                if self.config["tasks"].get("georeferencing_output", True):
                    geotiff.write_geotiff(out_file, preds[0][None], transform, crs,
                                          compress="lzw")
                else:
                    from PIL import Image

                    Image.fromarray(preds[0]).save(out_file, compression="tiff_lzw")
            self.accumulated_confmats[task] += _sklearn_confmat(target, preds[0], n)

    def on_predict_epoch_end(self) -> None:
        for task, confmat in self.accumulated_confmats.items():
            if confmat is None:
                confmat = np.zeros((self._n(task),) * 2, dtype=int)
            confmat = all_sum_host(confmat)
            self.accumulated_confmats[task] = confmat
            if is_rank_zero():
                compute_and_save_metrics(confmat, self.config, self.output_dir,
                                         task, mode="predict")

    @rank_zero_only
    def load_predictions_and_compute_metrics(self) -> None:
        """Metrics-only mode: confusion matrices from the prediction and
        label rasters on disk (the test CSV lists the labels)."""
        import pandas as pd

        any_found = False
        for task in self.config["labels"]:
            n = self._n(task)
            accum = np.zeros((n, n), dtype=int)
            gt_paths = pd.read_csv(Path(self.config["paths"]["test_csv"]))[task].tolist()
            pred_dir = Path(self.output_dir) / (
                f"predictions_{self.config['paths']['out_model_name']}") / task
            valid = 0
            for gt_path in map(Path, gt_paths):
                pred_path = pred_dir / f"PRED_{gt_path.name}"
                if not pred_path.exists():
                    continue
                try:
                    with geotiff.open_raster(str(gt_path)) as src:
                        gt = np.squeeze(src.read(self._channel(task)))
                    with geotiff.open_raster(str(pred_path)) as src:
                        pred = np.squeeze(src.read(1))
                    if gt.shape != pred.shape:
                        raise ValueError(f"shapes differ: {gt.shape} vs {pred.shape}")
                    accum += _sklearn_confmat(gt, pred, n)
                    valid += 1
                except (OSError, ValueError) as e:
                    logger.info("[ERROR] Failed to process %s: %s", gt_path.name, e)
            logger.info("Confmat sum: %d; processed %d/%d", accum.sum(), valid,
                        len(gt_paths))
            if valid > 0:
                self.accumulated_confmats[task] = accum
                compute_and_save_metrics(accum, self.config, self.output_dir, task,
                                         mode="metrics_only")
                any_found = True
        if not any_found:
            logger.info("[ERROR] No predictions found at all. "
                        "Metrics will not be calculated.")
