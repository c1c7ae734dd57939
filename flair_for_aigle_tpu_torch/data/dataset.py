"""Training dataset + data module (reference flair_hub/data/dataloader.py +
datamodule.py), torch-free.

``FlairDataset`` reproduces the reference per-sample pipeline: per-modality
raster reads, normalization, DEM elevation handling, Sentinel reshape /
cloud filter / temporal averaging, label one-hot, joint augmentations.
``FlairDataModule`` builds train/val/predict ``BatchedLoader``s with the
pad-collate; predict uses batch_size=1 like the reference (:379).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from flair_for_aigle_tpu_torch.data.padding import pad_collate
from flair_for_aigle_tpu_torch.data.sentinel import (
    filter_time_series,
    reshape_sentinel,
    temporal_average,
)
from flair_for_aigle_tpu_torch.data.transforms import (
    apply_numpy_augmentations,
    calc_elevation,
    norm,
    reshape_label_ohe,
)
from flair_for_aigle_tpu_torch.geo.geotiff import read_patch

logger = logging.getLogger(__name__)


class FlairDataset:
    def __init__(self, config: Dict, dict_paths: Dict,
                 use_augmentations: Any = None,
                 rng: np.random.Generator | None = None) -> None:
        self.config = config
        self.rng = rng or np.random.default_rng()
        if use_augmentations is True:
            self.use_augmentations = apply_numpy_augmentations
        else:
            self.use_augmentations = use_augmentations
        self._init_data_paths(dict_paths)
        self._init_label_info(dict_paths)
        self._init_normalization()
        self.ref_date = config["models"]["multitemp_model"]["ref_date"]

    def _init_data_paths(self, dict_paths):
        self.list_patch = {}
        enabled = self.config["modalities"]["inputs"]
        for mod, flag in enabled.items():
            if flag and mod in dict_paths:
                self.list_patch[mod] = np.array(dict_paths[mod])
                if mod == "SENTINEL2_TS":
                    self.list_patch["SENTINEL2_MSK-SC"] = np.array(
                        dict_paths["SENTINEL2_MSK-SC"]
                    )
        self.dict_dates = {}
        if "SENTINEL2_TS" in enabled:
            self.dict_dates["SENTINEL2_TS"] = dict_paths.get("DATES_S2", {})
        if "SENTINEL1-ASC_TS" in enabled:
            self.dict_dates["SENTINEL1-ASC_TS"] = dict_paths.get("DATES_S1_ASC", {})
        if "SENTINEL1-DESC_TS" in enabled:
            self.dict_dates["SENTINEL1-DESC_TS"] = dict_paths.get("DATES_S1_DESC", {})

    def _init_label_info(self, dict_paths):
        self.tasks = {}
        for task in self.config["labels"]:
            label_conf = self.config["labels_configs"][task]
            self.tasks[task] = {
                "data_paths": np.array(dict_paths[task]),
                "num_classes": len(label_conf["value_name"]),
                "channels": [label_conf.get("label_channel_nomenclature", 1)],
            }

    def _init_normalization(self):
        self.norm_type = self.config["modalities"]["normalization"]["norm_type"]
        enabled = self.config["modalities"]["inputs"]
        self.channels = {
            mod: self.config["modalities"]["inputs_channels"].get(mod, [])
            for mod, a in enabled.items() if a
        }
        self.normalization = {
            mod: {
                "mean": self.config["modalities"]["normalization"].get(
                    f"{mod}_means", []),
                "std": self.config["modalities"]["normalization"].get(
                    f"{mod}_stds", []),
            }
            for mod, a in enabled.items() if a
        }

    def __len__(self):
        for task in self.tasks.values():
            if len(task["data_paths"]) > 0:
                return len(task["data_paths"])
        return 0

    def _area_elem(self, path: str) -> str:
        parts = str(path).split("/")[-1].split("_")
        return "_".join([parts[0], parts[-2], parts[-1].split(".")[0]])

    def _mono(self, batch, key, index):
        data = read_patch(self.list_patch[key][index], self.channels[key])
        batch[key] = norm(data, self.norm_type,
                          self.normalization[key]["mean"],
                          self.normalization[key]["std"])

    def _sentinel(self, batch, key, index, area_elem, chunk):
        pp = self.config["modalities"]["pre_processings"]
        data = read_patch(self.list_patch[key][index])
        data = reshape_sentinel(data, chunk_size=chunk)[
            :, [c - 1 for c in self.channels[key]], :, :
        ]
        dd = self.dict_dates[key][area_elem]
        dates, diffs = dd["dates"], dd["diff_dates"]

        if key == "SENTINEL2_TS" and pp["filter_sentinel2"]:
            msk = read_patch(self.list_patch["SENTINEL2_MSK-SC"][index])
            msk = reshape_sentinel(msk, chunk_size=2)
            valid = filter_time_series(
                msk,
                max_cloud_value=pp["filter_sentinel2_max_cloud"],
                max_snow_value=pp["filter_sentinel2_max_snow"],
                max_fraction_covered=pp["filter_sentinel2_max_frac_cover"],
            )
            sel = np.where(valid)[0]
            data, dates, diffs = data[sel], dates[sel], diffs[sel]

        avg_key = ("temporal_average_sentinel2" if key == "SENTINEL2_TS"
                   else "temporal_average_sentinel1")
        if pp[avg_key]:
            data, diffs = temporal_average(
                data, list(dates), period=pp[avg_key], ref_date=self.ref_date
            )
        batch[key] = data
        batch[key.replace("_TS", "_DATES")] = np.asarray(diffs)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        area_elem = None
        for task, info in self.tasks.items():
            batch[f"ID_{task}"] = str(info["data_paths"][index])
            area_elem = self._area_elem(info["data_paths"][index])

        for key in ("AERIAL_RGBI", "AERIAL-RLT_PAN", "SPOT_RGBI"):
            if key in self.list_patch:
                self._mono(batch, key, index)

        key = "DEM_ELEV"
        if key in self.list_patch and self.list_patch[key][index] is not None:
            zdata = read_patch(self.list_patch[key][index])
            pp = self.config["modalities"]["pre_processings"]
            if pp["calc_elevation"]:
                elev = calc_elevation(zdata)
                if pp["calc_elevation_stack_dsm"]:
                    elev = np.stack((zdata[0, :, :], elev[0]), axis=0)
                batch[key] = elev
            else:
                batch[key] = zdata
            batch[key] = norm(batch[key], self.norm_type,
                              self.normalization[key]["mean"],
                              self.normalization[key]["std"])

        if "SENTINEL2_TS" in self.list_patch:
            self._sentinel(batch, "SENTINEL2_TS", index, area_elem, chunk=10)
        for key in ("SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS"):
            if key in self.list_patch and self.list_patch[key][index] is not None:
                self._sentinel(batch, key, index, area_elem, chunk=2)

        for task, info in self.tasks.items():
            label = read_patch(info["data_paths"][index], info["channels"])
            batch[task] = reshape_label_ohe(label, info["num_classes"])

        if callable(self.use_augmentations):
            input_keys = [k for k, v in
                          self.config["modalities"]["inputs"].items() if v]
            label_keys = list(self.config["labels"])
            batch = self.use_augmentations(batch, input_keys, label_keys,
                                           rng=self.rng)

        return {
            k: (np.asarray(v, np.float32)
                if isinstance(v, (np.ndarray, list)) and "ID_" not in k else v)
            for k, v in batch.items()
        }


class _Loader:
    """Shuffling/drop-last batched iterator with pad-collate."""

    def __init__(self, dataset, batch_size, shuffle, drop_last,
                 seed=0, fixed_t=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.fixed_t = fixed_t
        self._epoch = 0
        self._seed = seed

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        stop = n - (n % self.batch_size) if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            samples = [self.dataset[int(j)] for j in idx]
            yield pad_collate(samples, fixed_t=self.fixed_t)


class FlairDataModule:
    def __init__(self, config, dict_train=None, dict_val=None, dict_test=None,
                 num_workers: int = 1, batch_size: int = 2,
                 drop_last: bool = True, use_augmentations: bool = True):
        self.config = config
        self.dict_train, self.dict_val, self.dict_test = (
            dict_train, dict_val, dict_test
        )
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.use_augmentations = use_augmentations
        self.train_dataset = self.val_dataset = self.pred_dataset = None

    def setup(self, stage: Optional[str] = None):
        if stage in ("fit", "validate"):
            # seeded augmentation rng: the reference's seed_everything seeds
            # numpy globally, which its np.random-based augs consume
            # (tasks/stages.py:36, utils_data/augmentations.py)
            self.train_dataset = FlairDataset(
                self.config, self.dict_train,
                use_augmentations=self.use_augmentations or None,
                rng=np.random.default_rng(
                    self.config["hyperparams"].get("seed", 0)
                ),
            )
            self.val_dataset = FlairDataset(self.config, self.dict_val, None)
        elif stage == "predict":
            self.pred_dataset = FlairDataset(self.config, self.dict_test, None)

    def train_dataloader(self):
        return _Loader(self.train_dataset, self.batch_size, True,
                       self.drop_last,
                       seed=self.config["hyperparams"].get("seed", 0))

    def val_dataloader(self):
        return _Loader(self.val_dataset, self.batch_size, False, self.drop_last)

    def predict_dataloader(self):
        return _Loader(self.pred_dataset, 1, False, False)
