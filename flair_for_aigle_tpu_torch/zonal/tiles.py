"""The zonal engine's two tile sources (PyTorch port), and the plan that
chooses between them.

``zonal/inference.py inference_and_write`` reads ``device_tiling_plan``
once: with a plan the tiles come from ``ResidentTiles``, without one from
``HostTiles``. Each source takes the call's shared set-up (``_ZonalCall``:
its mesh, batch size and shard rows, the tiles' order, output rows and
count, the canvas height and the stripe codec) and gives the engine:

* ``device_norm(config, plan)``: what its ``ZonalStep`` normalises on the
  device;
* ``fmt``, ``fmb``: the stream's frontiers by tiles consumed
  (``stripes.py future_frontiers``);
* ``batches()``: each batch in the engine's order as a callable that places
  its shards on the mesh (a gather or a put) and returns (tile indices,
  valid tiles, shards); the source's own work between batches runs inside
  the generator;
* ``in_stream()``: its work inside each batch's ``stripes.stream`` span;
* ``name``: "resident" or "host".
"""

from __future__ import annotations

import functools
import logging
from typing import Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.geo.windows import Window, from_bounds
from flair_for_aigle_tpu_torch.parallel.mesh import shard_batch
from flair_for_aigle_tpu_torch.utils import profiling
from flair_for_aigle_tpu_torch.zonal.dataset import MultiModalSlicedDataset
from flair_for_aigle_tpu_torch.zonal.stripes import future_frontiers

logger = logging.getLogger(__name__)


def device_tiling_plan(config: Dict) -> Dict | None:
    """Whether inference can run from device-resident rasters (reference
    :286): no time series, every modality at the reference resolution and
    of one size, normalisation expressible on the device ('custom' needs
    ``normalize_on_device`` in auto mode), decoded rasters within
    ``device_tiles_max_bytes`` (default 3 GiB)."""
    flag = config.get("device_resident_tiles", "auto")
    if not flag:
        return None
    active = [m for m, a in config["modalities"]["inputs"].items() if a]
    if any(m.endswith("_TS") for m in active):
        return None
    ref_res = config["reference_resolution"]
    norm_specs: Dict[str, tuple] = {}
    total_bytes = 0
    dims = None
    for mod in active:
        if abs(config["modality_resolutions"][mod] - ref_res) > 1e-9:
            return None
        mcfg = config["modalities"][mod]
        with open_raster(mcfg["input_img_path"]) as src:
            dtype = np.dtype(src.dtypes[0])
            total_bytes += src.width * src.height * src.count * dtype.itemsize
            if dims is None:
                dims = (src.width, src.height)
            elif dims != (src.width, src.height):
                return None
        spec = _norm_spec(mcfg, dtype, flag == "auto"
                          and not config.get("normalize_on_device"))
        if spec is None:
            return None
        norm_specs[mod] = spec
    if total_bytes > config.get("device_tiles_max_bytes", 3 << 30):
        return None
    return {"mods": active, "norm_specs": norm_specs, "bytes": total_bytes}


def _norm_spec(mcfg: Dict, dtype: np.dtype, host_custom: bool = False):
    """Device normalisation spec of one modality: ("custom", means, stds),
    ("scaling", max) or ("cast",); None when it must stay on the host."""
    ncfg = mcfg.get("normalization") or {}
    ntype = ncfg.get("type", "without")
    if ntype == "custom":
        return None if host_custom else ("custom", ncfg["means"], ncfg["stds"])
    if ntype == "scaling" and not np.issubdtype(dtype, np.floating):
        info = np.iinfo(dtype)
        return ("scaling", float(max(abs(info.min), info.max)))
    if ntype in ("scaling", "without"):
        return ("cast",)
    return None


def _gather_tiles(buf: torch.Tensor, offs: np.ndarray, size: int) -> torch.Tensor:
    """(B, C, size, size) tiles sliced out of a (C, H, W) device raster,
    offsets clamped in-bounds like dynamic_slice."""
    hmax, wmax = buf.shape[-2] - size, buf.shape[-1] - size
    return torch.stack([
        buf[:, min(max(int(y), 0), hmax):min(max(int(y), 0), hmax) + size,
            min(max(int(x), 0), wmax):min(max(int(x), 0), wmax) + size]
        for y, x in offs])


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint16): torch.uint16, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


class ResidentTiles:
    """Tiles gathered on the card from a margin-padded raster a modality on
    every replica's device, which the host fills in row stripes from the
    bottom up (read, then put from pageable memory). A batch is dispatched
    once the stripes it reads have landed; the codec is polled between
    stripes."""

    name = "resident"

    @staticmethod
    def device_norm(config: Dict, plan: Dict):
        return plan["norm_specs"]

    def __init__(self, call, dataloader, tiles, config: Dict, plan: Dict):
        logger.info("[ ] device-resident tiling: %d modality raster(s), %.1f MB H2D",
                    len(plan["mods"]), plan["bytes"] / 1e6)
        self.call, self.mods = call, plan["mods"]
        self.readers = readers = dataloader.dataset.readers
        self.channels = {m: config["modalities"][m].get("channels") for m in self.mods}
        self.margin = margin_px = config["margin"]
        self.tile_size = tile_size = config["img_pixels_detection"]
        self.in_offs = {}
        for mod in self.mods:
            tr = readers[mod].transform
            offs = np.zeros((call.n_total, 2), np.int64)
            for i, row in enumerate(tiles):
                win = from_bounds(*row["geometry"].bounds, transform=tr).round()
                offs[i] = (int(win.row_off) + margin_px, int(win.col_off) + margin_px)
            self.in_offs[mod] = offs
        self.extras = [{t: torch.zeros((call.shard_rows, 1, tile_size, tile_size),
                                       dtype=torch.float32, device=dev)
                        for t in config["labels"]} for dev in call.mesh.devices]
        self.fmt, self.fmb = future_frontiers(call.order, call.tile_tops, call.tile_bots,
                                              call.height)
        self.batch_starts = list(range(0, call.n_total, call.bsz))
        self.need_lo = [max(0, int(min(self.in_offs[m][call.order[s:s + call.bsz], 0].min()
                                       for m in self.mods)) - margin_px)
                        for s in self.batch_starts]
        # a margin-padded raster per modality on every replica's device
        self.bufs = [{} for _ in call.mesh.devices]
        for mod in self.mods:
            r = readers[mod]
            n_ch = len(self.channels[mod] or range(r.count))
            for i, dev in enumerate(call.mesh.devices):
                self.bufs[i][mod] = torch.zeros(
                    (n_ch, r.height + 2 * margin_px, r.width + 2 * margin_px),
                    dtype=_TORCH_DTYPES[np.dtype(r.dtypes[0])], device=dev)
        self.height = readers[self.mods[0]].height
        self.width = readers[self.mods[0]].width
        itemsize = max(np.dtype(readers[m].dtypes[0]).itemsize for m in self.mods)
        self.stripe_rows = max(64, (8 << 20) // max(1, self.width * 3 * itemsize))
        block = max((getattr(readers[m], "block_rows", 1) or 1) for m in self.mods)
        if block > 1:
            self.stripe_rows = max(block, (self.stripe_rows // block) * block)
        self.next_batch = 0

    def batches(self):
        """Each stripe from the bottom up: read and put it, yield every
        batch whose rows have landed, poll the codec; then the rest."""
        rows, m = self.stripe_rows, self.margin
        for y0, h in reversed([(y0, min(rows, self.height - y0))
                               for y0 in range(0, self.height, rows)]):
            for mod in self.mods:
                with profiling.span("zonal.read", "read_s"):
                    arr = self.readers[mod].read(indexes=self.channels[mod],
                                                 window=Window(0, y0, self.width, h))
                    if arr.ndim == 2:
                        arr = arr[None]
                # a copy from pageable memory waits for the card's queue
                with profiling.span("zonal.put", "put_s"), profiling.blocked():
                    for bufs in self.bufs:
                        bufs[mod][:, y0 + m:y0 + m + h, m:m + self.width].copy_(
                            torch.from_numpy(arr))
            yield from self._landed(y0)
        yield from self._landed(0)

    def _landed(self, read_lo: int):
        """The batches that read no row above ``read_lo`` (all of them at
        0), then a poll of the codec."""
        while self.next_batch < len(self.batch_starts) and (
                read_lo <= self.need_lo[self.next_batch] or read_lo <= 0):
            yield functools.partial(self._gather, self.batch_starts[self.next_batch])
            self.next_batch += 1
        with profiling.span("stripes.poll", "poll_s"):
            self.call.codec.poll()

    def in_stream(self) -> None:
        """Nothing: this source polls the codec between stripes."""

    def _gather(self, start: int):
        """(tile indices, valid tiles, shards) of the batch at ``start`` of
        the order, padded by its last tile, gathered on each replica."""
        call = self.call
        idxs = call.order[start:min(start + call.bsz, call.n_total)]
        valid = len(idxs)
        if valid < call.bsz:
            idxs = np.concatenate([idxs, np.full(call.bsz - valid, idxs[-1], idxs.dtype)])
        with profiling.span("zonal.gather", "gather_s"):
            shards = []
            for i in range(call.mesh.dp):
                ids = idxs[i * call.shard_rows:(i + 1) * call.shard_rows]
                shard = dict(self.extras[i])
                for mod in self.mods:
                    shard[mod] = _gather_tiles(self.bufs[i][mod], self.in_offs[mod][ids],
                                               self.tile_size)
                shards.append(shard)
        return idxs, valid, shards


class HostTiles:
    """The loader's batches of windowed reads (thread-prefetched), each
    shard put from pageable memory on its replica's device; the codec is
    polled inside each batch's stream."""

    name = "host"

    @staticmethod
    def device_norm(config: Dict, plan):
        """Each mono modality's with ``normalize_on_device``, else None."""
        if not config.get("normalize_on_device"):
            return None
        norm = {}
        for mod, active in config["modalities"]["inputs"].items():
            if not active or mod.endswith("_TS"):
                continue
            with open_raster(config["modalities"][mod]["input_img_path"]) as src:
                dtype = np.dtype(src.dtypes[0])
            norm[mod] = _norm_spec(config["modalities"][mod], dtype) or ("cast",)
        return norm

    def __init__(self, call, dataloader, tiles, config: Dict, plan):
        self.call, self.dataloader = call, dataloader
        self.labels, self.tile_size = config["labels"], config["img_pixels_detection"]
        # the dataset's *_RAW copies never reach the forward, and one-channel
        # device zeros stand in for the labels, so the loader stacks no label
        # placeholder (a float32 plane a class and tile)
        self.device_labels = None
        if isinstance(getattr(dataloader, "dataset", None), MultiModalSlicedDataset):
            dataloader.dataset.emit_label_placeholders = False
        ordered = call.n_total > 1 and hasattr(dataloader, "order")
        if ordered and dataloader.order is None:
            dataloader.order = call.order.tolist()
        if ordered and list(dataloader.order) == call.order.tolist():
            self.fmt, self.fmb = future_frontiers(call.order, call.tile_tops, call.tile_bots,
                                                  call.height)
        else:  # foreign order: every row lands at finalize
            self.fmt = np.zeros(call.n_total + 1, np.int64)
            self.fmb = np.full(call.n_total + 1, call.height, np.int64)

    def batches(self):
        batches = iter(self.dataloader)
        while True:
            with profiling.span("zonal.read", "read_s"):
                batch = next(batches, None)
            if batch is None:
                return
            yield functools.partial(self._put, batch)

    def in_stream(self) -> None:
        self.call.codec.poll()

    def _put(self, batch: Dict):
        """(tile indices, valid tiles, shards) of a loader batch, each shard
        put on its replica's device beside device zeros for the labels."""
        mesh = self.call.mesh
        valid = batch.pop("valid")
        indices = np.asarray(batch["index"]).reshape(-1)
        host = {k: v for k, v in batch.items()
                if isinstance(v, np.ndarray) and k != "index"
                and not k.endswith("_RAW") and k not in self.labels}
        if self.device_labels is None:
            self.device_labels = [{
                t: torch.zeros((len(indices) // mesh.dp, 1)
                               + (tuple(np.shape(batch[t])[-2:])
                                  if t in batch else (self.tile_size, self.tile_size)),
                               dtype=torch.float32, device=dev)
                for t in self.labels} for dev in mesh.devices]
        shards = []
        # a copy from pageable memory waits for the card's queue
        with profiling.span("zonal.put", "put_s"), profiling.blocked():
            for i, dev in enumerate(mesh.devices):
                shard = {k: torch.from_numpy(v).to(dev)
                         for k, v in shard_batch(host, i, mesh.dp).items()}
                shard.update(self.device_labels[i])
                shards.append(shard)
        return indices, int(valid), shards
