"""CSV-driven data path resolution (reference utils_data/paths.py)."""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Set, Tuple

import pandas as pd

from flair_for_aigle_tpu_torch.data.sentinel_dates import get_sentinel_dates_mtd

logger = logging.getLogger(__name__)


def extract_sentinel_patch_ids(dicts: List[Optional[Dict]]) -> Set[str]:
    patch_ids: Set[str] = set()
    for d in dicts:
        if d is None:
            continue
        for key in ["SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS"]:
            for path in d.get(key, []):
                fname = str(path).split("/")[-1]
                patch_id = fname.replace(f"_{key}", "").replace(".tif", "")
                patch_ids.add(patch_id)
    return patch_ids


def get_paths(config: Dict[str, Any], split: str = "train") -> Dict:
    csv_key = {"train": "train_csv", "val": "val_csv", "test": "test_csv"}
    if split not in csv_key:
        raise SystemExit("Invalid split specified.")
    csv_path = config["paths"][csv_key[split]]
    if not (csv_path and os.path.isfile(csv_path) and csv_path.endswith(".csv")):
        raise SystemExit(f"Invalid .csv file path for {split} split.")
    paths = pd.read_csv(csv_path)

    dict_paths: Dict[str, list] = {
        m: [] for m in config["modalities"]["inputs"].keys()
    }
    for modality, active in config["modalities"]["inputs"].items():
        if active and modality in paths.columns:
            dict_paths[modality] = paths[modality].tolist()
    for label_mod in config["labels"]:
        dict_paths[label_mod] = paths[label_mod].tolist()
    if config["modalities"]["inputs"].get("SENTINEL2_TS"):
        dict_paths["SENTINEL2_MSK-SC"] = paths["SENTINEL2_MSK-SC"].tolist()
    else:
        dict_paths["SENTINEL2_MSK-SC"] = []
    return dict_paths


def get_datasets(config: Dict[str, Any]) -> Tuple[Optional[Dict], Optional[Dict], Optional[Dict]]:
    dict_train, dict_val, dict_test = None, None, None
    if config["tasks"]["train"]:
        dict_train = get_paths(config, "train")
        dict_val = get_paths(config, "val")
    if config["tasks"]["predict"]:
        dict_test = get_paths(config, "test")

    used = extract_sentinel_patch_ids([dict_train, dict_val, dict_test])
    dates_s2, dates_s1asc, dates_s1desc = get_sentinel_dates_mtd(config, used)
    for d in (dict_train, dict_val, dict_test):
        if d is not None:
            d["DATES_S2"] = dates_s2
            d["DATES_S1_ASC"] = dates_s1asc
            d["DATES_S1_DESC"] = dates_s1desc
    return dict_train, dict_val, dict_test
