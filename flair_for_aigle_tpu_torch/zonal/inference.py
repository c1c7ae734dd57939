"""Zonal inference engine (PyTorch port): batched device inference and
on-device stitching.

Port of ``flair_for_aigle_tpu/zonal/inference.py``. Per raster:

  host: overlap tiling -> windowed reads (thread-prefetched), or row stripes
        into a device-resident, margin-padded raster (device tile gather)
  device: normalise -> compute dtype -> forward -> fused epilogue (or crop
          + argmax / class_prob) -> optional nearest rescale -> uint8 canvas
  host: streamed raw D2H of final canvas rows -> tiled GeoTIFF

Tiles are processed bottom-up row-major (reference :732-742) and stitched
one tile at a time in that order, which keeps the reference's
last-write-wins seams.

Host modules (geo, tiling, windowed dataset, config) are the port's own
copies of the JAX package's framework-free ones.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.geo.geotiff import (
    WindowedWriter,
    convert_to_cog,
    open_raster,
)
from flair_for_aigle_tpu_torch.geo.windows import Window, from_bounds, from_origin
from flair_for_aigle_tpu_torch.zonal.config import (
    config_recap_1,
    config_recap_2,
    load_config,
    validate_config,
)
from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader, MultiModalSlicedDataset
from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference
from flair_for_aigle_tpu_torch.ops import epilogue
from flair_for_aigle_tpu_torch.ops.resize import scipy_zoom0_index
from flair_for_aigle_tpu_torch.zonal.model_utils import (
    build_inference_model,
    compute_patch_sizes,
)
from flair_for_aigle_tpu_torch.zonal.stripes import (
    LAST_TIMINGS,
    RawStripeCodec,
    StripeStream,
    finalize_canvases,
    future_frontiers,
)

logger = logging.getLogger(__name__)


def initialize_geometry_and_resolutions(config: Dict) -> Dict:
    """Reference modality (finest resolution), bounds and tile geometry."""
    modalities = config["modalities"]
    active = [m for m, a in modalities["inputs"].items() if a]
    resolutions, bounds = {}, []
    for mod in active:
        with open_raster(modalities[mod]["input_img_path"]) as src:
            resolutions[mod] = round(src.res[0], 5)
            bounds.append((mod, src.bounds))
            if "image_shape_px" not in config:
                config["image_shape_px"] = {"height": src.height, "width": src.width}
    ref_mod0, ref_bounds = bounds[0]
    for mod, b in bounds[1:]:
        if not np.allclose(list(b), list(ref_bounds), atol=1e-2):
            raise ValueError(f"Bounds mismatch between '{ref_mod0}' and '{mod}': "
                             f"{list(ref_bounds)} vs {list(b)}")
    # quirk-compat: min() picks the FINEST resolution (reference :97)
    ref_mod, reference_resolution = min(resolutions.items(), key=lambda x: x[1])
    config["reference_modality"] = ref_mod
    config["reference_resolution"] = reference_resolution
    config["modality_resolutions"] = resolutions
    config["image_bounds"] = {"left": ref_bounds.left, "bottom": ref_bounds.bottom,
                              "right": ref_bounds.right, "top": ref_bounds.top}
    config["tile_size_m"] = round(config["img_pixels_detection"] * reference_resolution, 2)
    config["margin_size_m"] = round(config["margin"] * reference_resolution, 2)
    return config


def prep_config(config_path) -> Dict:
    """Load (path or dict), validate and complete the zonal config."""
    config = load_config(config_path) if isinstance(config_path, str) else config_path
    validate_config(config)
    config_recap_1(config)
    config = initialize_geometry_and_resolutions(config)
    config_recap_2(config)
    config["output_type"] = config.get("output_type", "argmax")
    return config


def _set_labels(config: Dict) -> None:
    config["labels"] = [t["name"] for t in config["tasks"] if t["active"]]
    config["labels_configs"] = {
        t["name"]: {"value_name": (list(t["class_names"].values())
                                   if isinstance(t["class_names"], dict)
                                   else list(t["class_names"]))}
        for t in config["tasks"] if t["active"]
    }


def prep_dataset(config: Dict, tiles, patch_sizes: Dict[str, int]
                 ) -> MultiModalSlicedDataset:
    active = [m for m, a in config["modalities"]["inputs"].items() if a]
    _set_labels(config)
    modalities_config = config
    if device_tiling_plan(config) is not None:
        # the resident path reads each raster once in row stripes; a
        # whole-raster preload would decode it a second time
        modalities_config = dict(config)
        modalities_config["preload_rasters"] = False
    return MultiModalSlicedDataset(
        tiles=tiles,
        modality_cfgs={m: config["modalities"][m] for m in active},
        patch_size_dict=patch_sizes,
        ref_date_str=config.get("multitemp_model_ref_date", "01-01"),
        modalities_config=modalities_config,
        fixed_t=config.get("fixed_time_steps"),
    )


def init_outputs(config: Dict, ref_img, raster_index=None):
    """One canvas-backed writer per active task (reference :168)."""
    output_files, temp_paths = {}, {}
    output_type = config["output_type"]
    ref_res = config["reference_resolution"]
    out_res = config.get("output_px_meters", ref_res)
    image_bounds = config["image_bounds"]
    needs_rescale = abs(ref_res - out_res) > 1e-6
    suffix = "argmax" if output_type == "argmax" else "class-prob"
    idx_part = f"_{raster_index}" if raster_index is not None else "_i"
    for task in config["tasks"]:
        if not task["active"]:
            continue
        out_path = os.path.join(
            config["output_path"],
            f"{config['output_name']}_{task['name']}_{suffix}{idx_part}.tif")
        if not needs_rescale:
            height, width, transform = ref_img.height, ref_img.width, ref_img.transform
        else:
            height = int(round((image_bounds["top"] - image_bounds["bottom"]) / out_res))
            width = int(round((image_bounds["right"] - image_bounds["left"]) / out_res))
            transform = from_origin(image_bounds["left"], image_bounds["top"],
                                    out_res, out_res)
        count = len(task["class_names"]) if output_type == "class_prob" else 1
        output_files[task["name"]] = WindowedWriter(
            out_path, width, height, count, np.uint8, transform, ref_img.crs,
            compress="lzw")
        temp_paths[task["name"]] = out_path
    return output_files, temp_paths


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


class ZonalStep:
    """One batch on the device: normalise -> compute dtype -> forward ->
    epilogue (or crop + argmax / class_prob) -> nearest rescale, and the
    ordered canvas stitch (reference ``make_infer_step`` :377-551)."""

    def __init__(self, model, output_type: str, margin_px: int, tile_size: int,
                 scale_num: int, scale_den: int, compute_dtype: torch.dtype,
                 device_norm: Dict | None, device: torch.device):
        self.model = model
        self.output_type = output_type
        self.margin = margin_px
        self.tile_size = tile_size
        self.compute_dtype = compute_dtype
        inner = tile_size - 2 * margin_px
        self.rescale_idx = None
        if scale_num != scale_den:
            out_size = int(round(inner * scale_num / scale_den))
            self.rescale_idx = torch.as_tensor(scipy_zoom0_index(inner, out_size),
                                               device=device)
        self.norm = {}
        for mod, spec in (device_norm or {}).items():
            if spec[0] == "custom":
                self.norm[mod] = (
                    "custom",
                    torch.tensor(spec[1], dtype=torch.float32, device=device)[None, :, None, None],
                    torch.tensor(spec[2], dtype=torch.float32, device=device)[None, :, None, None])
            elif spec[0] == "scaling":
                self.norm[mod] = ("scaling", float(np.float32(1.0 / spec[1])))
            else:
                self.norm[mod] = ("cast",)

    def _apply_norm(self, k: str, v: torch.Tensor) -> torch.Tensor:
        spec = self.norm.get(k)
        if spec is None:
            return v
        if spec[0] == "custom":
            return (v.float() - spec[1]) / spec[2]
        if spec[0] == "scaling":
            return v.float() * spec[1]
        return v.float()

    @torch.no_grad()
    def forward_convert(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{task: uint8 (B, 1 or K, th, tw)} for one batch."""
        cast = {}
        for k, v in batch.items():
            v = self._apply_norm(k, v)
            if v.dtype == torch.float32 and not k.endswith("_DATES"):
                v = v.to(self.compute_dtype)
            cast[k] = v
        logits_tasks, _ = self.model(cast)
        m, ts = self.margin, self.tile_size
        out = {}
        for task, logits in logits_tasks.items():
            if self.model.stride4:
                pred = epilogue.upsample_crop_convert(
                    logits.permute(0, 3, 1, 2).contiguous(), margin=m, scale=4,
                    output_type=self.output_type)
            else:
                lg = logits[:, :, m:ts - m, m:ts - m].float()
                if self.output_type == "argmax":
                    pred = torch.argmax(lg, dim=1).to(torch.uint8)[:, None]
                else:
                    probs = torch.softmax(lg, dim=1)
                    pred = torch.round(probs * 255).to(torch.uint8)
            if self.rescale_idx is not None:
                pred = pred.index_select(-2, self.rescale_idx).index_select(
                    -1, self.rescale_idx)
            out[task] = pred
        return out

    @staticmethod
    def stitch(preds: Dict[str, torch.Tensor], offsets: np.ndarray,
               canvases: Dict[str, torch.Tensor]) -> None:
        """Write tile i at offsets[i], one tile after the other (last write
        wins, in batch order), clamped in-bounds like dynamic_update_slice."""
        for t, canvas in canvases.items():
            tiles = preds[t]
            th, tw = tiles.shape[-2:]
            for i, (oy, ox) in enumerate(offsets):
                oy = min(max(int(oy), 0), canvas.shape[-2] - th)
                ox = min(max(int(ox), 0), canvas.shape[-1] - tw)
                canvas[:, oy:oy + th, ox:ox + tw] = tiles[i]


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


def inference_and_write(model, dataloader, tiles, config: Dict,
                        output_files: Dict[str, WindowedWriter], ref_img,
                        device: torch.device) -> None:
    """Run batched inference, stitch on the device, land each canvas once."""
    LAST_TIMINGS.clear()
    if (config.get("data_parallel_devices") or 1) > 1:
        raise NotImplementedError(
            "data_parallel_devices > 1: multi-GPU zonal inference is ROADMAP "
            "Queue A item 11")
    margin_px = config["margin"]
    tile_size = config["img_pixels_detection"]
    ref_res = config["reference_resolution"]
    out_res = config.get("output_px_meters", ref_res)
    needs_rescale = abs(ref_res - out_res) > 1e-6
    b = ref_img.bounds
    image_bounds = {"left": b.left, "bottom": b.bottom, "right": b.right, "top": b.top}
    scale_den, scale_num = 1000000, int(round(1000000 * ref_res / out_res))
    if not needs_rescale:
        scale_num = scale_den

    tasks = list(output_files.keys())
    plan = device_tiling_plan(config)
    device_norm = None
    if plan:
        device_norm = plan["norm_specs"]
    elif config.get("normalize_on_device"):
        device_norm = {}
        for mod, active in config["modalities"]["inputs"].items():
            if not active or mod.endswith("_TS"):
                continue
            with open_raster(config["modalities"][mod]["input_img_path"]) as src:
                dtype = np.dtype(src.dtypes[0])
            device_norm[mod] = _norm_spec(config["modalities"][mod], dtype) or ("cast",)
    step = ZonalStep(
        model, config["output_type"], margin_px, tile_size, scale_num, scale_den,
        torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32,
        device_norm, device)

    inner = tile_size - 2 * margin_px
    th = int(round(inner * scale_num / scale_den)) if needs_rescale else inner
    # canvases padded by one tile each side so every write is in-bounds
    canvases = {t: torch.zeros((w.count, w.height + th, w.width + th),
                               dtype=torch.uint8, device=device)
                for t, w in output_files.items()}
    img_h = {t: output_files[t].height for t in tasks}
    img_w = {t: output_files[t].width for t in tasks}
    assert all(img_h[t] == img_h[tasks[0]] and img_w[t] == img_w[tasks[0]]
               for t in tasks), "output canvases must share one geometry"

    n_total = len(tiles)
    tile_tops = np.empty(n_total, np.int64)
    tile_lefts = np.empty(n_total, np.int64)
    for i, row in enumerate(tiles):
        tile_tops[i] = int(round((image_bounds["top"] - row["top"]) / out_res))
        tile_lefts[i] = int(round((row["left"] - image_bounds["left"]) / out_res))
    tile_bots = np.minimum(tile_tops + th, img_h[tasks[0]])
    stream = StripeStream(tasks, img_h[tasks[0]], RawStripeCodec(img_w))
    # bottom-up row-major: keeps every overlap seam's winner (reference :732)
    order = np.lexsort((tile_lefts, -tile_tops))

    def out_offsets(indices, valid):
        offs = np.zeros((len(indices), 2), np.int64)
        for i, idx in enumerate(indices):
            if i >= valid:
                offs[i] = (img_h[tasks[0]], img_w[tasks[0]])  # padded area
            else:
                offs[i] = (tile_tops[int(idx)], tile_lefts[int(idx)])
        return offs

    consumed = 0
    t_start = time.perf_counter()
    if plan:
        # --- device-resident rasters: gather tiles on the device ----------
        logger.info("[ ] device-resident tiling: %d modality raster(s), %.1f MB H2D",
                    len(plan["mods"]), plan["bytes"] / 1e6)
        readers = dataloader.dataset.readers
        in_offs_all = {}
        for mod in plan["mods"]:
            tr = readers[mod].transform
            offs = np.zeros((n_total, 2), np.int64)
            for i, row in enumerate(tiles):
                win = from_bounds(*row["geometry"].bounds, transform=tr).round()
                offs[i] = (int(win.row_off) + margin_px, int(win.col_off) + margin_px)
            in_offs_all[mod] = offs
        bsz = dataloader.batch_size
        extras = {t: torch.zeros((bsz, 1, tile_size, tile_size), dtype=torch.float32,
                                 device=device) for t in config["labels"]}
        fmt, fmb = future_frontiers(order, tile_tops, tile_bots, img_h[tasks[0]])
        batch_starts = list(range(0, n_total, bsz))
        need_lo = [max(0, int(min(in_offs_all[m][order[s:s + bsz], 0].min()
                                  for m in plan["mods"])) - margin_px)
                   for s in batch_starts]
        bufs = {}
        for mod in plan["mods"]:
            r = readers[mod]
            n_ch = len(config["modalities"][mod].get("channels") or range(r.count))
            bufs[mod] = torch.zeros(
                (n_ch, r.height + 2 * margin_px, r.width + 2 * margin_px),
                dtype=_TORCH_DTYPES[np.dtype(r.dtypes[0])], device=device)
        height = readers[plan["mods"][0]].height
        width = readers[plan["mods"][0]].width
        itemsize = max(np.dtype(readers[m].dtypes[0]).itemsize for m in plan["mods"])
        stripe_rows = max(64, (8 << 20) // max(1, width * 3 * itemsize))
        block = max((getattr(readers[m], "block_rows", 1) or 1) for m in plan["mods"])
        if block > 1:
            stripe_rows = max(block, (stripe_rows // block) * block)
        bi = 0
        t_read = t_put = t_disp = 0.0

        def dispatch_ready(read_lo: int):
            nonlocal bi, consumed
            while bi < len(batch_starts) and (read_lo <= need_lo[bi] or read_lo <= 0):
                start = batch_starts[bi]
                idxs = order[start:min(start + bsz, n_total)]
                valid = len(idxs)
                if valid < bsz:
                    idxs = np.concatenate([idxs, np.full(bsz - valid, idxs[-1], idxs.dtype)])
                batch = dict(extras)
                for mod in plan["mods"]:
                    batch[mod] = _gather_tiles(bufs[mod], in_offs_all[mod][idxs], tile_size)
                step.stitch(step.forward_convert(batch), out_offsets(idxs, valid), canvases)
                consumed += valid
                c = min(consumed, n_total)
                stream.advance(canvases, fmt[c], fmb[c])
                bi += 1

        spans = [(y0, min(stripe_rows, height - y0)) for y0 in range(0, height, stripe_rows)]
        for y0, h in reversed(spans):
            for mod in plan["mods"]:
                t0 = time.perf_counter()
                arr = readers[mod].read(indexes=config["modalities"][mod].get("channels"),
                                        window=Window(0, y0, width, h))
                if arr.ndim == 2:
                    arr = arr[None]
                t1 = time.perf_counter()
                bufs[mod][:, y0 + margin_px:y0 + margin_px + h,
                          margin_px:margin_px + width].copy_(torch.from_numpy(arr))
                t_read += t1 - t0
                t_put += time.perf_counter() - t1
            t0 = time.perf_counter()
            dispatch_ready(y0)
            t_disp += time.perf_counter() - t0
        t0 = time.perf_counter()
        dispatch_ready(0)
        t_disp += time.perf_counter() - t0
        LAST_TIMINGS.update(read_s=t_read, put_s=t_put, dispatch_s=t_disp)
    else:
        # --- host windowed-read path --------------------------------------
        # the dataset's *_RAW copies and label placeholders never reach the
        # forward; one-channel device zeros stand in for the labels
        device_labels = None
        host_order = None
        if n_total > 1 and hasattr(dataloader, "order"):
            if dataloader.order is None:
                dataloader.order = order.tolist()
            if list(dataloader.order) == order.tolist():
                host_order = order
        if host_order is not None:
            fmt, fmb = future_frontiers(host_order, tile_tops, tile_bots, img_h[tasks[0]])
        else:  # foreign order: every row lands at finalize
            fmt = np.zeros(n_total + 1, np.int64)
            fmb = np.full(n_total + 1, img_h[tasks[0]], np.int64)
        for batch in dataloader:
            valid = batch.pop("valid")
            indices = np.asarray(batch["index"]).reshape(-1)
            jb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                  if isinstance(v, np.ndarray) and k != "index"
                  and not k.endswith("_RAW") and k not in config["labels"]}
            if device_labels is None:
                device_labels = {
                    t: torch.zeros((len(indices), 1) + (tuple(np.shape(batch[t])[-2:])
                                                       if t in batch else (tile_size, tile_size)),
                                   dtype=torch.float32, device=device)
                    for t in config["labels"]}
            jb.update(device_labels)
            step.stitch(step.forward_convert(jb), out_offsets(indices, valid), canvases)
            consumed += int(valid)
            c = min(consumed, n_total)
            stream.advance(canvases, fmt[c], fmb[c])

    t0 = time.perf_counter()
    finalize_canvases(canvases, stream, img_h, output_files)
    LAST_TIMINGS.update(finalize_s=time.perf_counter() - t0,
                        total_s=time.perf_counter() - t_start)
    logger.info("[ok] canvases written")


def postpro_outputs(temp_paths: Dict[str, str], config: Dict) -> None:
    if config.get("cog_conversion", False):
        for task_name, temp_path in temp_paths.items():
            cog_path = temp_path.replace(".tif", "_COG.tif")
            convert_to_cog(temp_path, cog_path)
            temp_paths[task_name] = cog_path
            logger.info("[ok] Converted to COG: %s", cog_path)


def run_inference(config_path, device="cuda") -> Dict[str, str]:
    """Standalone zonal entry point: config (YAML path or dict) -> written
    rasters {task: path}. Runs on ``device``: the CUDA card (the kernels) by
    default, raising when there is none; ``"cpu"`` runs their plain
    versions."""
    device = resolve_device(device)
    start_total = time.time()
    config = prep_config(config_path)
    tiles = generate_patches_from_reference(config)
    logger.info("[ok] Sliced into %d tiles", len(tiles))
    patch_sizes = compute_patch_sizes(config)
    _set_labels(config)
    model, _ = build_inference_model(config, device=device)
    dataset = prep_dataset(config, tiles, patch_sizes)
    dataloader = BatchedLoader(dataset, batch_size=config.get("batch_size", 8),
                               num_workers=config.get("num_worker", 1))
    ref_img = open_raster(
        config["modalities"][config["reference_modality"]]["input_img_path"])
    output_files, temp_paths = init_outputs(config, ref_img)
    inference_and_write(model, dataloader, tiles, config, output_files, ref_img,
                        device)
    postpro_outputs(temp_paths, config)
    logger.info("[ok] Total time: %.2fs; rasters: %s", time.time() - start_total,
                list(temp_paths.values()))
    ref_img.close()
    dataset.close()
    return temp_paths
