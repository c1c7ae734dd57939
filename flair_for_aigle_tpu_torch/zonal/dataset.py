"""Multimodal windowed dataset for zonal inference.

Behavioral port of MultiModalSlicedDataset
(flair-for-aigle: flair_zonal_detection/dataset.py:24-217): per tile and per
modality, a windowed boundless read resampled to the per-modality patch
size, per-channel normalization, Sentinel reshape/(cloud+snow filtering
against a separate mask raster)/optional temporal averaging, day-offset
metadata from ``dates_txt`` files. Emits numpy dicts
``{MOD, MOD_RAW, MOD_DATES, index, <task zero labels>}``.

TPU adaptations:
* samples are numpy (no torch); a thread-prefetched batcher
  (``BatchedLoader``) feeds fixed-size batches (last batch padded) so the
  jit'd step never retraces.
* time series are padded/truncated to a fixed T bucket per run.

A tile's time-series work (read, cloud and snow filter, bucket, cast) is
the span ``zonal.series`` (``series_s`` of the zonal call's record), entered
from the loader's thread. The loader counts the frames a batch's series
holds (``series_frames``, B x T) and the padding among them
(``series_frames_padded``: the collate's, to the batch's largest T, and a
fixed-T bucket's, as each tile is read).
"""

from __future__ import annotations

import logging
import os
import threading
import queue
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from flair_for_aigle_tpu_torch.data.sentinel import (
    MAX_CLOUD_VALUE,
    MAX_SNOW_VALUE,
    filter_time_series,
    pad_to_fixed_t,
    reshape_sentinel,
    temporal_average,
)
from flair_for_aigle_tpu_torch.data.transforms import norm as normalize_array
from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.geo.windows import from_bounds
from flair_for_aigle_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


def _should_preload(reader, preload) -> bool:
    """Decide whether to decode the raster fully into RAM up front.

    Overlap tiling re-decodes each compressed block up to ~4x through
    windowed reads (measured 16 ms/tile vs 0.3 ms/tile from memory on the
    bench raster); a single sequential decode is strictly less work. Auto
    mode preloads when the decoded array fits in half the available RAM.
    """
    if preload is not True and preload != "auto":
        return bool(preload)
    if preload is True:
        return True
    decoded = reader.width * reader.height * reader.count * (
        reader.dtypes[0].itemsize
    )
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        avail = 4 << 30
    return decoded <= avail // 2


class MultiModalSlicedDataset:
    def __init__(
        self,
        tiles: List[dict],
        modality_cfgs: Dict[str, Dict[str, Any]],
        patch_size_dict: Dict[str, int],
        ref_date_str: str,
        modalities_config: Dict[str, Any],
        fixed_t: int | None = None,
    ) -> None:
        self.tiles = tiles
        self.modalities = modality_cfgs
        self.modalities_config = modalities_config
        self.patch_sizes = patch_size_dict
        self.ref_date_str = ref_date_str
        self.fixed_t = fixed_t
        #: whether items carry zero label placeholders (the model reads the
        #: output size from them); ``inference_and_write`` turns them off
        self.emit_label_placeholders = (
            modalities_config.get("emit_label_placeholders") is not False)

        self.readers = {}
        preload = modalities_config.get("preload_rasters", "auto")
        for mod, cfg in modality_cfgs.items():
            reader = open_raster(cfg["input_img_path"])
            if _should_preload(reader, preload):
                from flair_for_aigle_tpu_torch.geo.geotiff import MemoryRaster

                mem = MemoryRaster(reader)
                reader.close()
                reader = mem
            self.readers[mod] = reader
        self.mask_reader = None
        self.mask_resolution_ratio = 1.0
        s2 = modality_cfgs.get("SENTINEL2_TS")
        if s2 and s2.get("filter_clouds") and "filter_clouds_img_path" in s2:
            mask = open_raster(s2["filter_clouds_img_path"])
            if _should_preload(mask, preload):
                from flair_for_aigle_tpu_torch.geo.geotiff import MemoryRaster

                mem = MemoryRaster(mask)
                mask.close()
                mask = mem
            self.mask_reader = mask
            sentinel_res = self.readers["SENTINEL2_TS"].res[0]
            self.mask_resolution_ratio = sentinel_res / self.mask_reader.res[0]

        self.diff_dates = self._init_diff_dates()

    def _init_diff_dates(self):
        diff_dates = {}
        ref_month, ref_day = map(int, self.ref_date_str.split("-"))
        for mod, cfg in self.modalities.items():
            if not mod.endswith("_TS"):
                continue
            if cfg.get("filter_clouds", False) and not cfg.get("dates_txt"):
                raise ValueError(
                    f"'filter_clouds' is enabled for '{mod}' but 'dates_txt' "
                    "is missing or empty."
                )
            if cfg.get("dates_txt"):
                with open(cfg["dates_txt"]) as f:
                    date_strs = [ln.strip() for ln in f if ln.strip()]
                if not date_strs:
                    raise ValueError(f"'dates_txt' file for '{mod}' is empty.")
                dates = [datetime.strptime(d, "%Y%m%d") for d in date_strs]
                diffs = [
                    (d - datetime(d.year, ref_month, ref_day)).days for d in dates
                ]
                diff_dates[mod] = {
                    "dates": np.array(dates),
                    "diff_dates": np.array(diffs, np.float32),
                }
        return diff_dates

    def _load_patch(self, reader, bounds, cfg, patch_size, mod_name=None):
        window = from_bounds(*bounds, transform=reader.transform)
        if mod_name and mod_name.endswith("_TS") and mod_name in self.diff_dates:
            n_dates = len(self.diff_dates[mod_name]["dates"])
            n_ch = len(cfg["channels"])
            indexes = list(range(1, n_ch * n_dates + 1))
        else:
            indexes = cfg["channels"]
        patch = reader.read(
            indexes=indexes,
            window=window,
            out_shape=(len(indexes), patch_size, patch_size),
            resampling="bilinear",
            boundless=True,
            fill_value=0,
        )
        return patch, window

    def _normalize_patch(self, patch, cfg):
        norm_cfg = cfg.get("normalization", {})
        if norm_cfg:
            return normalize_array(
                patch, norm_cfg.get("type"), norm_cfg.get("means", []),
                norm_cfg.get("stds", []),
            )
        return patch

    def _process_time_series_patch(self, mod_name, patch, window, cfg):
        """Returns (patch, diffs, coverage): coverage is the per-date
        invalid-pixel fraction from the cloud/snow masks (None when no mask
        or after temporal averaging) — it feeds the unified T-overflow
        policy (data/sentinel.py:select_keep_indices) so a fixed-T bucket
        drops the worst-covered dates first, not the newest."""
        patch = reshape_sentinel(patch, chunk_size=len(cfg["channels"]))
        dates = self.diff_dates[mod_name]["dates"]
        diffs = self.diff_dates[mod_name]["diff_dates"]
        coverage = None

        if mod_name == "SENTINEL2_TS" and self.mask_reader is not None:
            n_t = len(dates)
            n_bands = 2 * n_t
            h = int(patch.shape[2] / self.mask_resolution_ratio)
            w = int(patch.shape[3] / self.mask_resolution_ratio)
            msk = self.mask_reader.read(
                indexes=list(range(1, n_bands + 1)),
                window=window,
                out_shape=(n_bands, h, w),
                resampling="nearest",
                boundless=True,
                fill_value=0,
            )
            msk = reshape_sentinel(msk, chunk_size=2)
            valid = filter_time_series(msk)
            # per-date invalid fraction (cloud ch1 / snow ch0 above the
            # SAME thresholds filter_time_series retains dates by)
            coverage = np.mean(
                (msk[:, 1] > MAX_CLOUD_VALUE)
                | (msk[:, 0] > MAX_SNOW_VALUE), axis=(1, 2))
            if valid.sum() > 0:
                patch = patch[valid]
                dates = dates[valid]
                diffs = diffs[valid]
                coverage = coverage[valid]

        if cfg.get("temporal_average", False):
            patch, diffs = temporal_average(
                patch, list(dates), period=cfg.get("average_period", "monthly"),
                ref_date=self.ref_date_str,
            )
            coverage = None  # T axis is now periods, not the masked dates
        return patch, diffs, coverage

    def _series_patch(self, mod_name, reader, bounds, cfg, patch_size):
        """A tile's time series as the model takes it: the windowed read of
        every date's bands, the cloud and snow filter, the fixed-T bucket
        when one is set, float32 frames (T, C, H, W) and day offsets (T,)."""
        patch, window = self._load_patch(reader, bounds, cfg, patch_size, mod_name)
        patch, diffs, coverage = self._process_time_series_patch(
            mod_name, patch, window, cfg
        )
        if self.fixed_t:
            profiling.count("series_frames_padded", max(self.fixed_t - len(diffs), 0))
            # same coverage -> same kept indices for data and dates
            patch = pad_to_fixed_t(
                patch.astype(np.float32), self.fixed_t, 0.0,
                coverage=coverage, what=mod_name,
            )
            diffs = pad_to_fixed_t(
                np.asarray(diffs, np.float32), self.fixed_t, 0.0,
                coverage=coverage, what=mod_name + " dates",
            )
        return np.asarray(patch, np.float32), np.asarray(diffs, np.float32)

    def __len__(self):
        return len(self.tiles)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.tiles[idx]
        bounds = row["geometry"].bounds  # (minx, miny, maxx, maxy)
        tile_data: Dict[str, np.ndarray] = {}

        for mod_name, cfg in self.modalities.items():
            reader = self.readers[mod_name]
            patch_size = self.patch_sizes[mod_name]
            if mod_name.endswith("_TS"):
                with profiling.span("zonal.series", "series_s"):
                    patch, diffs = self._series_patch(mod_name, reader, bounds, cfg,
                                                      patch_size)
                tile_data[mod_name] = patch
                tile_data[mod_name.replace("_TS", "_DATES")] = diffs
                continue
            patch, window = self._load_patch(reader, bounds, cfg, patch_size,
                                             mod_name)
            if self.modalities_config.get("normalize_on_device"):
                # raw patch in native dtype; the jit'd step normalizes
                # on the TPU (zonal/inference.py make_infer_step) — a
                # single CPU cannot keep up with float64 host norm.
                tile_data[mod_name] = np.ascontiguousarray(patch)
            else:
                raw = patch.copy()
                patch = self._normalize_patch(patch, cfg)
                tile_data[mod_name] = np.ascontiguousarray(patch, np.float32)
                tile_data[mod_name + "_RAW"] = np.ascontiguousarray(
                    raw, np.float32
                )

        tile_data["index"] = np.array([idx], np.int64)

        if not self.emit_label_placeholders:
            # fast path: the engine substitutes device-resident zero labels;
            # stacking ~20MB/task of host zeros per tile is pure waste
            return tile_data

        for task in self.modalities_config["labels"]:
            n_cls = len(
                self.modalities_config["labels_configs"][task]["value_name"]
            )
            ref_ps = list(self.patch_sizes.values())[0]
            tile_data[task] = np.zeros((n_cls, ref_ps, ref_ps), np.float32)
        return tile_data

    def close(self):
        for r in self.readers.values():
            r.close()
        if self.mask_reader:
            self.mask_reader.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class BatchedLoader:
    """Thread-prefetched fixed-batch loader over an indexable dataset.

    Pads the final batch by repeating the last sample; ``valid`` in each
    batch dict tells the consumer how many entries are real.
    """

    def __init__(self, dataset, batch_size: int, prefetch: int = 2,
                 num_workers: int = 1, order=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.num_workers = max(1, num_workers)
        #: optional index permutation; the zonal engine sets a bottom-up
        #: row-major order so output rows finalize progressively (streamed
        #: canvas D2H) — seam winners stay reference-identical, see
        #: inference.py
        self.order = order

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, indices):
        samples = [self.dataset[i] for i in indices]
        valid = len(samples)
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        batch = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], np.ndarray):
                if key.endswith("_TS"):
                    t_max = max(v.shape[0] for v in vals)
                    profiling.count("series_frames", len(vals) * t_max)
                    profiling.count("series_frames_padded",
                                    sum(t_max - v.shape[0] for v in vals))
                # time axes may differ if no fixed_t: pad to max
                if vals[0].ndim >= 1 and any(
                    v.shape != vals[0].shape for v in vals
                ):
                    t_max = max(v.shape[0] for v in vals)
                    vals = [pad_to_fixed_t(v, t_max, 0.0) for v in vals]
                batch[key] = np.stack(vals, axis=0)
            else:
                batch[key] = vals
        batch["valid"] = valid
        return batch

    def __iter__(self):
        n = len(self.dataset)
        idx = list(self.order) if self.order is not None else list(range(n))
        assert len(idx) == n
        chunks = [
            idx[i:i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]
        if self.num_workers > 1:
            yield from self._iter_pool(chunks)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for chunk in chunks:
                    q.put(self._make_batch(chunk))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()

    def _iter_pool(self, chunks):
        """num_workers > 1: batches built concurrently by a thread pool
        (reads release the GIL in native IO), yielded strictly in order —
        the zonal canvas scatter must preserve the reference's
        last-write-wins tile ordering. In-flight batches are bounded by
        ``prefetch`` to cap host memory.

        Reference parity: DataLoader(num_workers)
        (flair_zonal_detection/inference.py:662, datamodule.py:96-103).
        """
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        in_flight = max(self.prefetch, self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = deque()
            it = iter(chunks)
            for chunk in it:
                pending.append(pool.submit(self._make_batch, chunk))
                if len(pending) >= in_flight:
                    break
            while pending:
                yield pending.popleft().result()
                for chunk in it:
                    pending.append(pool.submit(self._make_batch, chunk))
                    break
