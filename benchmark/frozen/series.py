"""Synthetic Sentinel-2 series over a dalle, with its cloud and snow mask.

Over each dalle's km, at ``res_m`` metres a pixel: ``dates`` acquisitions
``revisit_days`` apart from ``first_date`` (a year at S2A + S2B's five-day
revisit: 73), each of ``bands`` bands of uint16 reflectance, and a mask of
two uint8 bands a date, snow then cloud probability (0-100), as the
Sentinel-2 ``MSK-SC`` rasters hold them. Rasters are date-major: band
``t * bands + b`` is band ``b`` of date ``t``.

Reflectance: per band a field smooth over ``field_px`` pixels around a
base drawn in ``base``, a vegetation signal (its amplitude smooth over
``field_px`` too) that follows the season, and noise of ``noise`` a pixel.
Clouds: a ``clear_share`` of the dates is clear; every other date has a
cloud cover drawn in ``cover``, laid out as blobs of about ``cloud_px``
pixels (a smooth field thresholded at its quantile), with cloud probability
20-100 under the blobs, where the reflectance turns bright, and 0-1
elsewhere; in December to February a ``snow_share`` of the dates has snow
patches of the same kind. Made on the device from the seed, a dalle at a
time, and copied to the host.

The series covers the dalle's km and no more, as the engine asks of a
user's: it refuses a modality whose bounds are not the aerial's. The tiles
along a dalle's edges reach 8 m past it, so their series windows read a
boundless row or column of zeros, whose mask reads clear.
"""

from __future__ import annotations

import math
from datetime import datetime, timedelta

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.frozen.raster import generator


def date_strings(series: dict) -> list[str]:
    first = datetime.strptime(series["first_date"], "%Y%m%d")
    return [(first + timedelta(days=series["revisit_days"] * t)).strftime("%Y%m%d")
            for t in range(series["dates"])]


def smooth(g: torch.Generator, n: int, side: int, cell: int, device) -> torch.Tensor:
    """(n, side, side) fields in [0, 1) smooth over ``cell`` pixels."""
    k = side // cell + 2
    coarse = torch.rand((n, 1, k, k), generator=g, device=device)
    return F.interpolate(coarse, size=(side, side), mode="bilinear", align_corners=False)[:, 0]


def blobs(g: torch.Generator, cover: torch.Tensor, side: int, cell: int,
          device) -> torch.Tensor:
    """(T, side, side) bool: a ``cover`` share of each date's pixels in blobs."""
    field = smooth(g, len(cover), side, cell, device).reshape(len(cover), -1)
    ranked = field.sort(dim=1).values
    at = ((1 - cover) * (ranked.shape[1] - 1)).long().clamp(0, ranked.shape[1] - 1)
    level = ranked.gather(1, at[:, None])
    return ((field > level) & (cover[:, None] > 0)).reshape(len(cover), side, side)


def dalle_series(g: torch.Generator, side: int, series: dict,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dates x bands, side, side) uint16 reflectance and (dates x 2, side,
    side) uint8 mask of one dalle."""
    t, nb, cell = series["dates"], series["bands"], series["field_px"]
    days = torch.tensor([datetime.strptime(d, "%Y%m%d").timetuple().tm_yday
                         for d in date_strings(series)], dtype=torch.float32, device=device)
    lo, hi = series["base"]
    base = lo + (hi - lo) * smooth(g, nb, side, cell, device)  # (bands, side, side)
    green = smooth(g, 1, side, cell, device)[0]
    response = torch.linspace(-0.5, 1.0, nb, device=device)  # red falls, NIR rises
    season = torch.sin(2 * math.pi * (days - 100.0) / 365.0).clamp(min=0)
    refl = (base[None] + series["vegetation"] * green[None, None] * season[:, None, None, None]
            * response[None, :, None, None])
    refl = refl + series["noise"] * torch.randn((t, nb, side, side), generator=g, device=device)
    lo_c, hi_c = series["cover"]
    cover = lo_c + (hi_c - lo_c) * torch.rand(t, generator=g, device=device)
    cover = torch.where(torch.rand(t, generator=g, device=device) < series["clear_share"],
                        torch.zeros_like(cover), cover)
    cloudy = blobs(g, cover, side, series["cloud_px"], device)
    cloud = torch.where(cloudy, torch.randint(20, 101, (t, side, side), generator=g,
                                              device=device),
                        torch.randint(0, 2, (t, side, side), generator=g, device=device))
    winter = torch.tensor([int(d[4:6]) in (12, 1, 2) for d in date_strings(series)],
                          device=device)
    snow_cover = torch.where(winter & (torch.rand(t, generator=g, device=device)
                                       < series["snow_share"]),
                             0.3 * torch.rand(t, generator=g, device=device),
                             torch.zeros(t, device=device))
    snowy = blobs(g, snow_cover, side, series["cloud_px"], device)
    snow = torch.where(snowy, torch.randint(20, 101, (t, side, side), generator=g,
                                            device=device),
                       torch.randint(0, 2, (t, side, side), generator=g, device=device))
    bright = (3000.0 + 60.0 * cloud.float())[:, None]
    refl = torch.where(cloudy[:, None], torch.maximum(refl, bright), refl)
    refl = refl.clamp(1, 10000).round().to(torch.int32).reshape(t * nb, side, side)
    mask = torch.stack([snow, cloud], dim=1).reshape(t * 2, side, side).to(torch.uint8)
    return refl, mask


def series_pool(seed: int, traffic: dict, device: torch.device) -> list[tuple]:
    """``traffic["pool"]`` pairs of host arrays (series uint16, mask uint8),
    one a pixel pool entry, over a dalle of ``side_px`` at ``res_m``."""
    s = traffic["series"]
    side = int(round(traffic["side_px"] * traffic["res_m"] / s["res_m"]))
    g = generator(seed, device, stream=3)
    out = []
    for _ in range(traffic["pool"]):
        refl, mask = dalle_series(g, side, s, device)
        out.append((refl.cpu().numpy().astype(np.uint16), mask.cpu().numpy()))
    return out
