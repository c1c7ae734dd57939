"""Config recap tree + data split counts (reference utils/config_display.py)."""

from __future__ import annotations

import logging
from typing import Optional

from flair_for_aigle_tpu_torch.parallel.dist import rank_zero_only

logger = logging.getLogger(__name__)

MODALITY_KEYS = [
    "AERIAL_RGBI", "AERIAL-RLT_PAN", "DEM_ELEV", "SPOT_RGBI",
    "SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS",
]


@rank_zero_only
def print_recap(config: dict, dict_train: Optional[dict] = None,
                dict_val: Optional[dict] = None,
                dict_test: Optional[dict] = None) -> None:
    def walk(d, prefix="", filter_section=False, active_inputs=None,
             parent_key=None):
        for k, v in d.items():
            if active_inputs is not None:
                if parent_key in {"inputs_channels", "aux_loss",
                                  "modality_dropout"}:
                    if k not in active_inputs:
                        continue
                elif parent_key == "normalization":
                    if k.endswith("_means") or k.endswith("_stds"):
                        base = k.replace("_means", "").replace("_stds", "")
                        if base not in active_inputs:
                            continue
            if isinstance(v, dict):
                if filter_section and all(
                    x in [False, 0, None, "", [], {}] for x in v.values()
                ):
                    continue
                logger.info("%s|- %s:", prefix, k)
                walk(v, prefix + "|   ", filter_section, active_inputs, k)
            elif isinstance(v, list):
                if not filter_section or v:
                    logger.info("%s|- %s: %s", prefix, k, v)
            else:
                if not filter_section or v not in [False, 0, None, "", [], {}]:
                    logger.info("%s|- %s: %s", prefix, k, v)

    verbose = config.get("saving", {}).get("verbose_config", True)
    inputs = config.get("modalities", {}).get("inputs", {})
    active = {k for k, v in inputs.items() if v}

    logger.info("Configuration Tree:")
    for key, val in config.items():
        if isinstance(val, dict):
            logger.info("|- %s:", key)
            walk(val, "|   ", not verbose,
                 active if key == "modalities" else None)
        else:
            logger.info("|- %s: %s", key, val)

    keys = MODALITY_KEYS + list(config.get("labels", []))
    logger.info("[---DATA SPLIT---]")
    if config["tasks"].get("train", False):
        for name, d in (("TRAIN", dict_train), ("VAL", dict_val)):
            logger.info("[%s]", name)
            for key in keys:
                if d and d.get(key) is not None and len(d.get(key, [])) > 0:
                    logger.info("- %-20s: %d samples", key, len(d[key]))
    if config["tasks"].get("predict", False):
        logger.info("[TEST]")
        for key in keys:
            if dict_test and dict_test.get(key) is not None and len(
                dict_test.get(key, [])
            ) > 0:
                logger.info("- %-20s: %d samples", key, len(dict_test[key]))
