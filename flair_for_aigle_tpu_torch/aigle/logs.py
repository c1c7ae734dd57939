"""Run logging + Airflow progression file (reference utils/logs.py).

``update_progress`` appends status JSON lines locally and re-uploads to S3
when configured (consumed by the Airflow DAGs driving production runs).
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime
from typing import Union

from flair_for_aigle_tpu_torch.aigle.s3 import load_s3_json_file

S3_PROGRESSION_FILE_PATH = None
TMP_PROGRESSION_FILE_PATH = None


def clear_logger_handlers(logger_name):
    lg = logging.getLogger(logger_name)
    lg.handlers.clear()
    lg.propagate = False


def configure_logging(log_file_path, progression_file_path,
                      level=logging.INFO):
    global S3_PROGRESSION_FILE_PATH, TMP_PROGRESSION_FILE_PATH
    S3_PROGRESSION_FILE_PATH = progression_file_path
    tmp_local = os.path.join(log_file_path.rsplit("/", 1)[0],
                             "tmp_progression.json")
    TMP_PROGRESSION_FILE_PATH = tmp_local

    logger = logging.getLogger()
    logger.setLevel(level)
    # replace any pre-existing handlers (e.g. basicConfig's) so records
    # aren't emitted twice
    logger.handlers.clear()
    file_handler = logging.FileHandler(log_file_path)
    stream_handler = logging.StreamHandler()
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )
    for h in (file_handler, stream_handler):
        h.setLevel(level)
        h.setFormatter(fmt)
        logger.addHandler(h)
    logging.info("Logging system configured.")

    for module in ("boto3", "botocore", "jax", "flax"):
        clear_logger_handlers(module)
        mlg = logging.getLogger(module)
        mlg.setLevel(level)
        mlg.propagate = True

    if progression_file_path:
        logging.info("Airflow run progression config detected: %s",
                     progression_file_path)
        data = {"timestamp": str(datetime.now()), "status": "initializing",
                "progress": 0}
        with open(tmp_local, "w", encoding="utf-8") as pf:
            pf.write(json.dumps(data) + "\n")
        load_s3_json_file(tmp_local, progression_file_path)


def update_progress(progress: Union[int, float], status: str):
    if S3_PROGRESSION_FILE_PATH:
        data = {"timestamp": str(datetime.now()), "status": status,
                "progress": progress}
        with open(TMP_PROGRESSION_FILE_PATH, "a", encoding="utf-8") as pf:
            pf.write(json.dumps(data) + "\n")
        load_s3_json_file(TMP_PROGRESSION_FILE_PATH, S3_PROGRESSION_FILE_PATH)
    else:
        logging.debug("Progression file path not set. Skipping update.")
