"""Confusion-matrix metric primitives (reference writer/metrics_core.py)."""

from __future__ import annotations

import numpy as np


def overall_accuracy(npcm: np.ndarray) -> float:
    return 100 * np.trace(npcm) / npcm.sum()


def class_IoU(npcm: np.ndarray, n_class: int):
    ious = 100 * np.diag(npcm) / (
        np.sum(npcm, axis=1) + np.sum(npcm, axis=0) - np.diag(npcm)
    )
    ious[np.isnan(ious)] = 0
    return ious, np.mean(ious)


def class_precision(npcm: np.ndarray):
    precision = 100 * np.diag(npcm) / np.sum(npcm, axis=0)
    precision[np.isnan(precision)] = 0
    return precision, np.mean(precision)


def class_recall(npcm: np.ndarray):
    recall = 100 * np.diag(npcm) / np.sum(npcm, axis=1)
    recall[np.isnan(recall)] = 0
    return recall, np.mean(recall)


def class_fscore(precision: np.ndarray, recall: np.ndarray):
    fscore = 2 * (precision * recall) / (precision + recall)
    fscore[np.isnan(fscore)] = 0
    return fscore, np.mean(fscore)
