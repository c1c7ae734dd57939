"""Synthetic 20 cm aerial dalles with the structure of land cover.

The dalle's size, bands and grid follow ``flair_for_aigle_tpu_torch/bench.py
make_raster``; its pixels do not. Uniform noise makes a noise-like label map,
on which the stripe codec commits to its 5-bit fallback, where real dalles,
made of fields, plots and buildings, give label maps of long runs and commit
to run-length coding. So each dalle is a patchwork: large fields (a jittered
Voronoi partition of cell ``fields_px``), a ``built_share`` of which are cut
into small plots (cell ``plots_px``); each parcel has its own colour,
shaded by ``shade`` levels of noise smooth over ``shade_px`` pixels, with
``texture`` levels of uniform noise on every pixel. Made on the device from
the seed, a dalle at a time, and copied to the host, where the engine reads
them as rasters.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def voronoi(g: torch.Generator, side: int, cell: int, device: torch.device) -> torch.Tensor:
    """(side, side) int64 parcel ids of a jittered Voronoi partition: one
    site placed at random in each ``cell`` x ``cell`` square of a grid that
    covers the dalle with a square to spare on each side; each pixel takes
    the nearest of the 9 sites around its own square."""
    n = side // cell + 3
    site = torch.rand((2, n, n), generator=g, device=device) * cell
    site[0] += (torch.arange(n, device=device)[:, None] - 1) * cell
    site[1] += (torch.arange(n, device=device)[None, :] - 1) * cell
    yy = torch.arange(side, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(side, device=device, dtype=torch.float32)[None, :]
    ci = (torch.arange(side, device=device) // cell + 1)[:, None]
    cj = (torch.arange(side, device=device) // cell + 1)[None, :]
    best = torch.full((side, side), float("inf"), device=device)
    ids = torch.zeros((side, side), dtype=torch.int64, device=device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i, j = (ci + di).expand(side, side), (cj + dj).expand(side, side)
            d = (site[0][i, j] - yy) ** 2 + (site[1][i, j] - xx) ** 2
            closer = d < best
            best = torch.where(closer, d, best)
            ids = torch.where(closer, i * n + j, ids)
    return ids


def dalle(g: torch.Generator, bands: int, side: int, traffic: dict,
          device: torch.device) -> torch.Tensor:
    """(bands, side, side) uint8 pixels of one dalle."""
    fields = voronoi(g, side, traffic["fields_px"], device)
    plots = voronoi(g, side, traffic["plots_px"], device)
    n_fields = int(fields.max()) + 1
    built = torch.rand(n_fields, generator=g, device=device) < traffic["built_share"]
    parcel = torch.where(built[fields], n_fields + plots, fields)
    colours = torch.randint(16, 240, (int(parcel.max()) + 1, bands), generator=g,
                            device=device, dtype=torch.int16)
    t = traffic["texture"]
    noise = torch.randint(-t, t + 1, (bands, side, side), generator=g, device=device,
                          dtype=torch.int16)
    k = side // traffic["shade_px"] + 2
    coarse = (torch.rand((1, bands, k, k), generator=g, device=device) * 2 - 1) * traffic["shade"]
    shade = torch.nn.functional.interpolate(coarse, size=(side, side), mode="bilinear",
                                            align_corners=False)[0].round().to(torch.int16)
    return (colours[parcel].permute(2, 0, 1) + shade + noise).clamp(0, 255).to(torch.uint8)


def pixel_pool(seed: int, traffic: dict, bands: int, device: torch.device) -> list[np.ndarray]:
    """``traffic["pool"]`` host arrays of (bands, side, side) uint8 pixels."""
    g = generator(seed, device, stream=1)
    side = traffic["side_px"]
    return [dalle(g, bands, side, traffic, device).cpu().numpy()
            for _ in range(traffic["pool"])]


def dalle_origin(index: int, traffic: dict) -> tuple[float, float]:
    """The Lambert-93 (west, north) corner of dalle ``index``: the km grid
    of a department, row by row."""
    west0, north0 = traffic["grid_origin_m"]
    cols = traffic["grid_columns"]
    step = traffic["side_px"] * traffic["res_m"]
    return west0 + step * (index % cols), north0 - step * (index // cols)
