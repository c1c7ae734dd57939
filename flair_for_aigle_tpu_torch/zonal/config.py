"""Zonal config load/validate/recap (reference flair_zonal_detection/config.py)."""

from __future__ import annotations

import logging
import os

import yaml

logger = logging.getLogger(__name__)

REQUIRED_KEYS = [
    "output_path", "output_name", "model_weights", "img_pixels_detection",
    "margin", "modalities", "tasks", "output_px_meters",
]


def load_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def validate_config(config: dict) -> None:
    for key in REQUIRED_KEYS:
        if key not in config:
            raise ValueError(f"Missing required config key: {key}")
    if not os.path.isfile(config["model_weights"]):
        raise FileNotFoundError(
            f"Model weights not found at: {config['model_weights']}"
        )
    os.makedirs(config["output_path"], exist_ok=True)


def config_recap_1(config: dict) -> None:
    used = ", ".join(
        m for m, a in config["modalities"]["inputs"].items() if a
    )
    active_tasks = ", ".join(t["name"] for t in config["tasks"] if t["active"])
    logger.info(
        "\n##############################################\n"
        "FLAIR-HUB ZONE DETECTION (TPU)\n"
        "##############################################\n"
        "|-> Output path            : %s\n"
        "|-> Output file name       : %s.tif\n"
        "|-> Modalities used        : %s\n"
        "|-> Tasks active           : %s\n"
        "|-> Output type            : %s\n"
        "|-> Checkpoint path        : %s\n"
        "|-> Batch size             : %s\n",
        config["output_path"], config["output_name"], used, active_tasks,
        config.get("output_type"), config["model_weights"],
        config.get("batch_size"),
    )


def config_recap_2(config: dict) -> None:
    res = config["reference_resolution"]
    shape = config.get("image_shape_px", {})
    if shape:
        logger.info("|-> Image size (px): %s (H) x %s (W)",
                    shape["height"], shape["width"])
    logger.info("|-> Reference resolution: %s m/px", res)
    logger.info("|-> Output resolution: %s m/px", config["output_px_meters"])
    logger.info("|-> Patch %s px / margin %s px", config["img_pixels_detection"],
                config["margin"])
    for mod, r in config.get("modality_resolutions", {}).items():
        logger.info("   - %-15s: %s m/px", mod, r)
