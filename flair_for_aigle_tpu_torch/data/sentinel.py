"""Sentinel time-series transforms (pure numpy).

Behavioral ports of flair_hub/data/utils_data/sentinel.py:
* ``reshape_sentinel`` (:7-17) — (T*C, H, W) -> (T, C, H, W).
* ``filter_time_series`` (:20-43) — per-date cloud/snow validity with the
  snow-only fallback when nothing passes.
* ``temporal_average`` (:123-152) — monthly (12) / semi-monthly (24) means
  with forward fill and mid-period day offsets.
"""

from __future__ import annotations

import datetime
import logging
from typing import Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_warned: set = set()


def warn_once(key, msg: str, *args) -> None:
    """Per-process warning dedup for the T-overflow messages: a zonal run
    can overflow on thousands of tiles (two arrays each), and the 1-core
    host is the documented throughput ceiling — one line per distinct
    (what, T, bucket) carries the same signal."""
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg + " (further identical warnings suppressed)",
                       *args)


def reshape_sentinel(arr: np.ndarray, chunk_size: int = 10) -> np.ndarray:
    first = arr.shape[0] // chunk_size
    return arr.reshape((first, chunk_size, *arr.shape[1:]))


# Reference defaults (flair_hub sentinel.py): a date is "covered" at a
# pixel where cloud (ch 1) or snow (ch 0) exceeds these. Shared so the
# zonal dataset's per-date coverage ranking (T-overflow policy) uses the
# SAME notion of invalid as the validity filter below.
MAX_CLOUD_VALUE = 1
MAX_SNOW_VALUE = 1


def filter_time_series(
    data_array: np.ndarray,
    max_cloud_value: int = MAX_CLOUD_VALUE,
    max_snow_value: int = MAX_SNOW_VALUE,
    max_fraction_covered: float = 0.05,
) -> np.ndarray:
    """(T, 2, H, W) mask stack -> (T,) bool of retained dates.

    Channel 1 is cloud, channel 0 is snow (reference sentinel.py:36).
    """
    select = (data_array[:, 1, :, :] <= max_cloud_value) & (
        data_array[:, 0, :, :] <= max_snow_value
    )
    num_pix = data_array.shape[2] * data_array.shape[3]
    threshold = (1 - max_fraction_covered) * num_pix
    selected = np.sum(select, axis=(1, 2)) >= threshold
    if not np.any(selected):
        select = data_array[:, 0, :, :] <= max_snow_value
        selected = np.sum(select, axis=(1, 2)) >= threshold
    return selected


def _monthly_average(data, dates, ref_dt):
    months = np.array([d.month for d in dates])
    result, diffs = [], []
    last = None
    for month in range(1, 13):
        idx = np.nonzero(months == month)[0]
        if len(idx) > 0:
            mean = np.mean(data[idx], axis=0)
            result.append(mean)
            last = mean
            mid = datetime.datetime(ref_dt.year, month, 15)
            diffs.append((mid - ref_dt).days)
        else:
            result.append(last if last is not None else np.zeros_like(data[0]))
            diffs.append(diffs[-1] if diffs else 0)
    return np.array(result), np.array(diffs)


def _semi_monthly_average(data, dates, ref_dt):
    result, diffs = [], []
    last = None
    darr = np.array(dates)
    for month in range(1, 13):
        for half in ("first", "second"):
            if half == "first":
                start = datetime.datetime(ref_dt.year, month, 1)
                end = datetime.datetime(ref_dt.year, month, 15)
                mid = datetime.datetime(ref_dt.year, month, 8)
            else:
                start = datetime.datetime(ref_dt.year, month, 16)
                if month < 12:
                    end = datetime.datetime(ref_dt.year, month + 1, 1) - datetime.timedelta(days=1)
                else:
                    end = datetime.datetime(ref_dt.year + 1, 1, 1) - datetime.timedelta(days=1)
                mid = datetime.datetime(ref_dt.year, month, 23)
            idx = np.nonzero([(d >= start) and (d <= end) for d in darr])[0]
            if len(idx) > 0:
                mean = np.mean(data[idx], axis=0)
                result.append(mean)
                last = mean
                diffs.append((mid - ref_dt).days)
            else:
                result.append(last if last is not None else np.zeros_like(data[0]))
                diffs.append(diffs[-1] if diffs else 0)
    return np.array(result), np.array(diffs)


def temporal_average(
    data: np.ndarray,
    dates: Sequence[datetime.datetime],
    period: str = "monthly",
    ref_date: str = "01-01",
) -> Tuple[np.ndarray, np.ndarray]:
    ref_month, ref_day = map(int, ref_date.split("-"))
    dates = list(dates)
    ref_year = dates[0].year
    ref_dt = datetime.datetime(ref_year, ref_month, ref_day)
    if period == "monthly":
        return _monthly_average(data, dates, ref_dt)
    if period == "semi-monthly":
        return _semi_monthly_average(data, dates, ref_dt)
    raise ValueError("Period must be either 'monthly' or 'semi-monthly'.")


def select_keep_indices(
    t: int, target_t: int, coverage: np.ndarray | None = None
) -> np.ndarray:
    """Unified T-overflow policy: which ``target_t`` of ``t`` dates to KEEP.

    The reference never drops dates (it pads every batch to its max T,
    flair_hub/data/utils_data/padding.py:48-88); a fixed-T TPU bucket can
    overflow, and the single framework-wide rule for that case is:

    * ``coverage`` given (per-date invalid-pixel fraction/count from the
      cloud/snow masks, higher = worse): drop the WORST-covered dates
      first. Ties keep the earlier date (stable sort), so equally-clean
      series degrade to oldest-kept rather than an arbitrary order.
    * no ``coverage``: evenly subsample the time axis (keeps the seasonal
      spread; truncating by recency would silently discard a whole
      season).

    Returns sorted (chronological) kept indices. Callers must apply the
    SAME indices to the data and its date offsets.
    """
    if target_t >= t:
        return np.arange(t)
    if coverage is not None:
        coverage = np.asarray(coverage)
        if coverage.shape[0] != t:
            raise ValueError(
                f"coverage has {coverage.shape[0]} entries for T={t}")
        return np.sort(np.argsort(coverage, kind="stable")[:target_t])
    return np.round(np.linspace(0, t - 1, target_t)).astype(np.int64)


def pad_to_fixed_t(
    arr: np.ndarray,
    target_t: int,
    pad_value: float = 0.0,
    coverage: np.ndarray | None = None,
    what: str = "time series",
) -> np.ndarray:
    """Pad (T, ...) along axis 0 to target_t — or truncate per the unified
    overflow policy (``select_keep_indices``), warning with counts.

    TPU addition: fixing T avoids per-batch recompilation under jit; the
    U-TAE pad mask makes padded frames inert (models/utae.py).
    """
    t = arr.shape[0]
    if t == target_t:
        return arr
    if t > target_t:
        keep = select_keep_indices(t, target_t, coverage)
        warn_once(
            (what, t, target_t, coverage is not None),
            "%s has %d dates > fixed T bucket %d: dropping %d by %s "
            "(reference keeps all dates; raise fixed_time_steps to avoid)",
            what, t, target_t, t - target_t,
            "cloud-cover rank" if coverage is not None
            else "even temporal subsampling")
        return arr[keep]
    pad = np.full((target_t - t, *arr.shape[1:]), pad_value, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
