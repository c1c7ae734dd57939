"""Misc Aigle utilities (reference utils/utils.py)."""

from __future__ import annotations

import logging
import os
import re
from datetime import datetime

import pandas as pd

logger = logging.getLogger(__name__)


def concat_df_parquet_files(folder_path: str,
                            pattern: str = r"df_set_results_tmp_raster_"):
    parquet_files = [
        os.path.join(folder_path, f) for f in os.listdir(folder_path)
        if pattern in f
    ]
    if not parquet_files:
        raise FileNotFoundError("No matching Parquet files found.")
    return pd.concat([pd.read_parquet(f) for f in parquet_files],
                     ignore_index=True)


def find_first_four_digits(text: str):
    match = re.search(r"\d{4}", text)
    return match.group() if match else None


def correct_string(s: str) -> str:
    return re.sub(r"(\d+)-(\d+)-(\d+)-(\d+)_", r"\1.\2-\3.\4.", s)


def remove_files_except_with_substrings(folder_path, substring1, substring2):
    try:
        files = os.listdir(folder_path)
    except FileNotFoundError:
        logger.info("The folder %s does not exist.", folder_path)
        return
    for file_name in files:
        file_path = os.path.join(folder_path, file_name)
        if os.path.isfile(file_path):
            if substring1 in file_name and substring2 in file_name:
                logger.debug("Keeping file: %s", file_name)
            else:
                logger.info("Removing old ckpt file : %s", file_name)
                os.remove(file_path)


def generate_timestamp() -> str:
    return datetime.now().strftime("%y%m%d%H%M")
