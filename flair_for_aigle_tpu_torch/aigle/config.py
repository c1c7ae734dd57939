"""JSON config loader + CLI merge (reference utils/config.py)."""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger(__name__)


def load_config(config_path: str) -> dict:
    if "s3://" in config_path:
        from flair_for_aigle_tpu_torch.aigle.s3 import download_s3_config

        config_path = download_s3_config(
            config_path, os.getenv("RUN_FOLDER", ".")
        )
    with open(config_path) as f:
        return json.load(f)


def combine_args_with_priority(args, config: dict) -> argparse.Namespace:
    """Config values win over argparse defaults (reference behavior:
    utils/config.py:47-52)."""
    combined = vars(args).copy()
    combined.update({k: v for k, v in config.items()})
    return argparse.Namespace(**combined)


class ArgsObject:
    def __init__(self, **entries):
        self.__dict__.update(entries)
