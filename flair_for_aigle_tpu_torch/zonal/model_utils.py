"""Model construction for zonal inference (PyTorch port).

Port of ``flair_for_aigle_tpu/zonal/model_utils.py``: per-modality patch
sizes from the raster resolutions, the flat zonal YAML expanded into the
model config, and the model build + checkpoint load.

Epilogue gate (reference :151-167, with CUDA in place of the TPU):
``fused_epilogue`` auto|True|False. ``auto`` takes the stride-4 head + fused
epilogue kernel on CUDA and the full-resolution head on the CPU; ``True``
takes the stride-4 route everywhere (the epilogue's plain version on the
CPU). On CUDA the four kernels always carry the path, so ``fused_epilogue:
false`` and ``attn_kernel: off`` raise there (not ported; ROADMAP).
"""

from __future__ import annotations

import logging
from copy import deepcopy
from typing import Any, Dict

import torch

from flair_for_aigle_tpu.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.models.layers import init_weights
from flair_for_aigle_tpu_torch.ops.epilogue import MAX_CLASSES

logger = logging.getLogger(__name__)

_UNPORTED_ON_CUDA = ("is not available on CUDA in flair_for_aigle_tpu_torch: "
                     "the main path always runs the hand-written kernels "
                     "(the plain-XLA-path equivalents are ROADMAP items)")


def get_resolution(path: str) -> float:
    with open_raster(path) as src:
        return abs(src.res[0])


def compute_patch_sizes(config: Dict[str, Any]) -> Dict[str, int]:
    """patch_px(mod) = round(img_pixels_detection / (mod_res / ref_res))."""
    patch_sizes = {}
    target_res = config["reference_resolution"]
    for mod, active in config["modalities"]["inputs"].items():
        if not active:
            continue
        scale = get_resolution(config["modalities"][mod]["input_img_path"]) / target_res
        patch_sizes[mod] = int(round(config["img_pixels_detection"] / scale))
    logger.info("PATCH SIZES ---> %s", patch_sizes)
    return patch_sizes


def prepare_model_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Expand the flat zonal YAML into the full model config."""
    cfg = deepcopy(config)
    cfg.setdefault("models", {})
    if "monotemp_arch" in config:
        cfg["models"]["monotemp_model"] = {
            "arch": config["monotemp_arch"],
            "new_channels_init_mode": "random",
            "attn_f32": config.get("attn_f32", True),
            "attn_kernel": config.get("attn_kernel", "auto"),
        }
    cfg.setdefault("labels", [t["name"] for t in cfg["tasks"] if t.get("active")])
    cfg.setdefault("labels_configs", {
        t["name"]: {"value_name": (list(t["class_names"].values())
                                   if isinstance(t["class_names"], dict)
                                   else list(t["class_names"]))}
        for t in cfg["tasks"] if t.get("active", False)
    })
    cfg["modalities"].setdefault("inputs_channels", {
        mod: cfg["modalities"].get(mod, {}).get("channels", [])
        for mod in cfg["modalities"]["inputs"]
    })
    cfg["modalities"].setdefault("aux_loss", {
        mod: False for mod in cfg["modalities"]["inputs"]})
    dem_cfg = cfg["modalities"].get("DEM_ELEV", {})
    cfg["modalities"].setdefault("pre_processings", {
        "calc_elevation": dem_cfg.get("calc_elevation", False),
        "calc_elevation_stack_dsm": dem_cfg.get("calc_elevation_stack_dsm", False),
    })
    cfg.setdefault("paths", {})["ckpt_model_path"] = config["model_weights"]
    return cfg


def use_stride4_epilogue(config: Dict[str, Any], device: torch.device) -> bool:
    """The epilogue gate; raises on CUDA for the routes not ported there."""
    flag = config.get("fused_epilogue", "auto")
    on_cuda = device.type == "cuda"
    attn_kernel = config.get("attn_kernel", "auto")  # YAML reads `off` as False
    if on_cuda and (attn_kernel is False or str(attn_kernel).lower() == "off"):
        raise NotImplementedError(f"attn_kernel: off {_UNPORTED_ON_CUDA}")
    if on_cuda and flag is False:
        raise NotImplementedError(f"fused_epilogue: false {_UNPORTED_ON_CUDA}")
    if not flag:
        return False
    arch_ok = str(config.get("monotemp_arch", "")).endswith("-upernet")
    tile = int(config.get("img_pixels_detection", 512))
    margin = int(config.get("margin", 0))
    n_cls = max((len(t["class_names"]) for t in config.get("tasks", [])
                 if t.get("active")), default=0)
    fit = n_cls <= MAX_CLASSES and tile % 4 == 0 and tile - 2 * margin > 0
    if arch_ok and fit and (flag is True or on_cuda):
        return True
    if on_cuda:
        raise NotImplementedError(
            f"the full-resolution head route (arch upernet: {arch_ok}, "
            f"epilogue shape fits: {fit}) {_UNPORTED_ON_CUDA}")
    return False


def build_inference_model(config: Dict[str, Any],
                          device: torch.device | str = "cpu", seed: int = 0):
    """Build FlairHubModel on ``device`` in eval mode. Weights come from
    ``model_weights`` when it names a file, else from a ``torch.Generator``
    seeded with ``seed``. Returns (model, model_cfg)."""
    device = torch.device(device)
    model_cfg = prepare_model_config(config)
    if use_stride4_epilogue(config, device):
        model_cfg["zonal_stride4_logits"] = True
    model = FlairHubModel(model_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    path = model_cfg["paths"].get("ckpt_model_path")
    if path:
        load_checkpoint(model, path)
    return model.to(device).eval(), model_cfg
