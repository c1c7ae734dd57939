"""FLAIR-HUB training / predict CLI of the PyTorch port (port of the
repository's ``train_main.py``).

    python -m flair_for_aigle_tpu_torch.train_main --config <yaml file or dir of yamls>

Same YAML schema as ``train_main.py``; runs on the CUDA card when one is
present (the kernels), else on the CPU (their plain versions). The host
helpers are the JAX package's framework-free modules; their rank-zero
wrappers would import jax, so this entry point calls the wrapped functions
behind the port's own rank check.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from flair_for_aigle_tpu.utils import config_display, config_io, messaging
from flair_for_aigle_tpu_torch.parallel.dist import is_rank_zero
from flair_for_aigle_tpu_torch.train.stages import (
    build_data_module,
    get_datasets,
    predict_stage,
    training_stage,
)

logger = logging.getLogger(__name__)


def _rank_zero(fn, *args) -> None:
    if is_rank_zero():
        getattr(fn, "__wrapped__", fn)(*args)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="Path to the .yaml config file or a directory of them")
    parser.add_argument("--aux-loss-fix", action="store_true",
                        help="Enable the (reference-dead) auxiliary loss path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(name)s - %(message)s")
    config, out_dir = config_io.setup_environment(args)
    paths = config["paths"]
    sys.stdout = messaging.Logger(Path(
        paths["out_folder"], paths["out_model_name"],
        f"flair-compute{paths['out_model_name']}.log").as_posix())
    try:
        _rank_zero(messaging.start_msg)
        dict_train, dict_val, dict_test = get_datasets(config)
        _rank_zero(config_display.print_recap, config, dict_train, dict_val, dict_test)
        if config["saving"]["cp_csv_and_conf_to_output"]:
            _rank_zero(config_io.copy_csv_and_config, config, out_dir, args)
        dm = build_data_module(config, dict_train, dict_val, dict_test)
        trained = None
        if config["tasks"]["train"]:
            trained = training_stage(config, dm, out_dir, aux_loss_fix=args.aux_loss_fix)
        if config["tasks"].get("predict") or config["tasks"].get("metrics_only"):
            out_dir_predict = Path(out_dir, "results_" + paths["out_model_name"])
            out_dir_predict.mkdir(parents=True, exist_ok=True)
            predict_stage(config, dm, out_dir_predict, trained)
        else:
            logger.info("[WARNING] Neither prediction nor metrics_only enabled.")
        _rank_zero(messaging.end_msg)
    finally:
        log, sys.stdout = sys.stdout, sys.stdout.terminal
        log.close()


if __name__ == "__main__":
    main()
