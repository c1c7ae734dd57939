"""YAML config system (reference flair_hub/utils/config_io.py).

``read_config`` merges a single file or every .yaml in a directory;
``setup_environment`` creates the output dir; ``copy_csv_and_config``
snapshots CSVs + config for reproducibility (rank-zero only).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict

import yaml

from flair_for_aigle_tpu_torch.parallel.dist import rank_zero_only


def read_config(path: str) -> Dict[str, dict]:
    combined: dict = {}
    if os.path.isfile(path) and path.endswith(".yaml"):
        with open(path) as f:
            config = yaml.safe_load(f)
            if isinstance(config, dict):
                combined.update(config)
    elif os.path.isdir(path):
        for file_name in sorted(os.listdir(path)):
            if file_name.endswith(".yaml"):
                with open(os.path.join(path, file_name)) as f:
                    config = yaml.safe_load(f)
                    if isinstance(config, dict):
                        combined.update(config)
    else:
        raise ValueError(
            f"Invalid path: {path}. Must be a .yaml file or a directory "
            "containing .yaml files."
        )
    return combined


def setup_environment(args) -> tuple:
    config = read_config(args.config)
    out_dir = Path(config["paths"]["out_folder"],
                   config["paths"]["out_model_name"])
    out_dir.mkdir(parents=True, exist_ok=True)
    return config, out_dir


@rank_zero_only
def copy_csv_and_config(config: dict, out_dir: Path, args) -> None:
    csv_copy_dir = Path(out_dir, "used_csv_and_config")
    csv_copy_dir.mkdir(parents=True, exist_ok=True)
    if config["tasks"]["train"]:
        shutil.copy(config["paths"]["train_csv"], csv_copy_dir)
        shutil.copy(config["paths"]["val_csv"], csv_copy_dir)
    if config["tasks"]["predict"]:
        shutil.copy(config["paths"]["test_csv"], csv_copy_dir)
    if os.path.isdir(args.config):
        shutil.copytree(args.config, csv_copy_dir, dirs_exist_ok=True)
    elif os.path.isfile(args.config):
        shutil.copy(args.config, csv_copy_dir / Path(args.config).name)
