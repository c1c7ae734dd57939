"""S3 data plumbing (reference utils/s3.py), driver-gated.

The reference pulls aerial archives / BD-TOPO / model folders from Scaleway
S3 with boto3 + py7zr and syncs run traces back. Neither boto3 nor py7zr is
available in this image, so every function degrades gracefully:

* ``s3://`` paths raise a clear RuntimeError unless boto3 is importable;
* local paths (or paths already present in the data folder) pass through,
  which keeps the whole aigle pipeline runnable on pre-staged data — the
  same behavior the reference's download-once cache gives on a warm run
  (reference utils/s3.py:163-181).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import Optional, Tuple

logger = logging.getLogger(__name__)


def _boto3():
    try:
        import boto3  # noqa: PLC0415

        return boto3
    except ImportError:
        return None


def _require_s3(what: str):
    b3 = _boto3()
    if b3 is None:
        raise RuntimeError(
            f"S3 operation '{what}' requires boto3, which is not installed. "
            "Pre-stage the data locally or install boto3."
        )
    return b3


def prepare_run_folder(experiment_run_folder: str,
                       progression_file_path: Optional[str]):
    """Create log/result folders and wire logging (reference s3.py:101-131)."""
    from flair_for_aigle_tpu_torch.aigle.logs import configure_logging

    log_folder = os.path.join(experiment_run_folder, "logs")
    result_folder = os.path.join(experiment_run_folder, "results")
    os.makedirs(log_folder, exist_ok=True)
    os.makedirs(result_folder, exist_ok=True)
    configure_logging(os.path.join(log_folder, "run.log"),
                      progression_file_path)
    return log_folder, result_folder


def prepare_local_data_folder(s3_bucket_name, s3_aerial_src, s3_db_topo_src,
                              experiment_data_folder, force_download=False,
                              extract_pleiades=False) -> Tuple[str, str, str, str]:
    """Aerial + BD-TOPO staging. Local-first: if the target folder already
    holds rasters, skip any download (reference caches the same way)."""
    images_folder = os.path.join(experiment_data_folder, "raw-img")
    os.makedirs(images_folder, exist_ok=True)
    have_local = any(
        f.lower().endswith((".tif", ".tiff", ".jp2"))
        for f in os.listdir(images_folder)
    )
    if have_local and not force_download:
        logger.info("Local imagery found in %s; skipping S3 pull",
                    images_folder)
        return images_folder, experiment_data_folder, "", ""
    if s3_bucket_name:
        b3 = _require_s3("download aerial archives")
        s3 = b3.resource("s3")
        bucket = s3.Bucket(s3_bucket_name)
        for obj in bucket.objects.filter(Prefix=s3_aerial_src):
            dest = os.path.join(images_folder, os.path.basename(obj.key))
            if not os.path.exists(dest):
                bucket.download_file(obj.key, dest)
        logger.info("Downloaded aerial data from s3://%s/%s", s3_bucket_name,
                    s3_aerial_src)
    return images_folder, experiment_data_folder, "", ""


def prepare_local_model_folder(run_folder: str, model_id,
                               db=None) -> Tuple[str, str]:
    """Model registry lookup (reference s3.py:26-98): resolve the model row
    in Postgres ``detections.model`` and pull ``model_path`` from S3 via
    ``aws s3 cp --recursive``; fall back to a pre-staged local layout
    ``<run_folder>/models/<model_id>/`` when no DB is reachable."""
    model_dir = os.path.join(run_folder, "models", str(model_id))
    if not os.path.isdir(model_dir):
        from flair_for_aigle_tpu_torch.aigle.db import (
            DatabaseError,
            connect_from_env,
            lookup_model_row,
        )

        try:
            db = db or connect_from_env()
            if db is None:
                raise DatabaseError("DB_STRING_PROD not set")
            logger.info("Initializing ml model configuration from id: %s",
                        model_id)
            row = lookup_model_row(db, model_id)
            model_s3_path = row["model_path"]
            os.makedirs(model_dir, exist_ok=True)
            if shutil.which("aws") is None:
                raise FileNotFoundError(
                    f"aws CLI unavailable to fetch {model_s3_path}"
                )
            logger.info("Downloading model from %s to %s ...",
                        model_s3_path, model_dir)
            proc = subprocess.run(
                ["aws", "s3", "cp", model_s3_path, model_dir, "--recursive"],
                check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for line in (proc.stdout or "").splitlines():
                logger.info("S3 SYNC : %s", line)
        except DatabaseError as e:
            raise FileNotFoundError(
                f"Model folder not found: {model_dir} and the registry "
                f"lookup is unavailable ({e}). Stage "
                "<run_folder>/models/<model_id>/ with the checkpoint."
            ) from e
    ckpt = None
    thresholds = ""
    for f in sorted(os.listdir(model_dir)):
        if f.endswith((".safetensors", ".ckpt", ".pt", ".pth")):
            ckpt = os.path.join(model_dir, f)
        if f == "best_thresholds.yaml":
            thresholds = os.path.join(model_dir, f)
    if ckpt is None:
        raise FileNotFoundError(f"No checkpoint found in {model_dir}")
    return ckpt, thresholds


def upload_run_traces_to_s3(s3_runs_path: str, experiment_run_folder: str,
                            image_set_name: str) -> None:
    """aws s3 sync of run traces (reference s3.py:233-250); no-op with a
    warning when the aws CLI is unavailable."""
    if shutil.which("aws") is None:
        logger.warning("aws CLI not available; skipping trace upload to %s",
                       s3_runs_path)
        return
    subprocess.run(
        ["aws", "s3", "sync", experiment_run_folder,
         f"{s3_runs_path}/{image_set_name}"],
        check=False,
    )


def load_s3_json_file(local_path: str, s3_path: str) -> None:
    """Upload a progression JSON to S3 (reference utils/s3.py)."""
    b3 = _boto3()
    if b3 is None or not str(s3_path).startswith("s3://"):
        logger.debug("progress upload skipped (no boto3 or local path)")
        return
    bucket_name, key = s3_path.replace("s3://", "").split("/", 1)
    b3.resource("s3").Bucket(bucket_name).upload_file(local_path, key)


def download_s3_config(config_path: str, run_folder: str) -> str:
    """Fetch an s3:// config locally (reference utils/config.py:13-45)."""
    if "s3://" not in config_path:
        return config_path
    b3 = _require_s3("download config")
    local_dir = os.path.join(run_folder, "logs", "configs")
    os.makedirs(local_dir, exist_ok=True)
    bucket_name, key = config_path.replace("s3://", "").split("/", 1)
    filename = key.rsplit("/", 1)[-1]
    local = os.path.join(local_dir, filename)
    b3.resource("s3").Bucket(bucket_name).download_file(key, local)
    return local


def _py7zr():
    try:
        import py7zr  # noqa: PLC0415

        return py7zr
    except ImportError:
        return None


def download_batch_archives(bucket, prefix: str, dest_folder: str) -> list:
    """Download multi-part 7z archive pieces (reference s3.py:284-300)."""
    os.makedirs(dest_folder, exist_ok=True)
    parts = []
    for obj in bucket.objects.filter(Prefix=prefix):
        dest = os.path.join(dest_folder, os.path.basename(obj.key))
        if not os.path.exists(dest):
            bucket.download_file(obj.key, dest)
        parts.append(dest)
    return sorted(parts)


def concatenate_and_extract(parts: list, dest_folder: str) -> None:
    """Concatenate .7z.001... pieces and extract (reference s3.py:302-312)."""
    if not parts:
        return
    archive = parts[0]
    if len(parts) > 1:
        archive = parts[0].rsplit(".", 1)[0]
        with open(archive, "wb") as out:
            for p in parts:
                with open(p, "rb") as f:
                    shutil.copyfileobj(f, out)
    p7 = _py7zr()
    if p7 is None:
        raise RuntimeError(
            "py7zr is not installed; extract the archive manually: " + archive
        )
    with p7.SevenZipFile(archive, mode="r") as z:
        z.extractall(path=dest_folder)


def download_extract_aerials(s3_bucket_name: str, prefix: str,
                             dest_folder: str) -> str:
    """Aerial archive staging (reference s3.py:314-326)."""
    b3 = _require_s3("download aerial archives")
    bucket = b3.resource("s3").Bucket(s3_bucket_name)
    parts = download_batch_archives(bucket, prefix, dest_folder)
    concatenate_and_extract(parts, dest_folder)
    return dest_folder


def download_extract_pleiades(s3_bucket_name: str, key: str,
                              dest_folder: str) -> str:
    """Pleiades zip staging (reference s3.py:328-337)."""
    import zipfile

    b3 = _require_s3("download pleiades zip")
    os.makedirs(dest_folder, exist_ok=True)
    local = os.path.join(dest_folder, os.path.basename(key))
    if not os.path.exists(local):
        b3.resource("s3").Bucket(s3_bucket_name).download_file(key, local)
    with zipfile.ZipFile(local) as z:
        z.extractall(dest_folder)
    return dest_folder


def upload_file(s3_bucket_name: str, local_path: str, key: str) -> None:
    """Single-file upload (reference s3.py:339-356)."""
    b3 = _require_s3("upload file")
    b3.resource("s3").Bucket(s3_bucket_name).upload_file(local_path, key)
