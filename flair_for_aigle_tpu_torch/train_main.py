"""FLAIR-HUB training / predict CLI of the PyTorch port (port of the
repository's ``train_main.py``).

    python -m flair_for_aigle_tpu_torch.train_main --config <yaml file or dir of yamls> \
        [--device cuda|cpu]

Same YAML schema as ``train_main.py``; runs on the CUDA card (the kernels)
unless ``--device cpu`` asks for the CPU (their plain versions), and stops
with an error when ``cuda`` is asked for and there is no card.

Data-parallel training over N cards of one host:

    torchrun --nproc_per_node N -m flair_for_aigle_tpu_torch.train_main --config <yaml>

Each process joins the group before the model is built (``cuda`` means
``cuda:LOCAL_RANK`` over NCCL, ``--device cpu`` runs the ranks over gloo)
and takes an equal shard of every batch; ``hyperparams.batch_size`` is the
global batch and must divide by N.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from flair_for_aigle_tpu_torch.parallel.dist import initialize, is_rank_zero
from flair_for_aigle_tpu_torch.train.stages import (
    build_data_module,
    get_datasets,
    predict_stage,
    training_stage,
)
from flair_for_aigle_tpu_torch.utils import config_display, config_io, messaging

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="Path to the .yaml config file or a directory of them")
    parser.add_argument("--aux-loss-fix", action="store_true",
                        help="Enable the (reference-dead) auxiliary loss path")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Run on the CUDA card (default) or on the CPU")
    args = parser.parse_args(argv)
    device = initialize(device=args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(name)s - %(message)s")
    config, out_dir = config_io.setup_environment(args)
    paths = config["paths"]
    sys.stdout = messaging.Logger(Path(
        paths["out_folder"], paths["out_model_name"],
        f"flair-compute{paths['out_model_name']}.log").as_posix())
    try:
        messaging.start_msg()
        dict_train, dict_val, dict_test = get_datasets(config)
        config_display.print_recap(config, dict_train, dict_val, dict_test)
        if config["saving"]["cp_csv_and_conf_to_output"] and is_rank_zero():
            config_io.copy_csv_and_config(config, out_dir, args)
        dm = build_data_module(config, dict_train, dict_val, dict_test)
        trained = None
        if config["tasks"]["train"]:
            trained = training_stage(config, dm, out_dir, device=device,
                                     aux_loss_fix=args.aux_loss_fix)
        if config["tasks"].get("predict") or config["tasks"].get("metrics_only"):
            out_dir_predict = Path(out_dir, "results_" + paths["out_model_name"])
            out_dir_predict.mkdir(parents=True, exist_ok=True)
            predict_stage(config, dm, out_dir_predict, trained, device=device)
        else:
            logger.info("[WARNING] Neither prediction nor metrics_only enabled.")
        messaging.end_msg()
    finally:
        log, sys.stdout = sys.stdout, sys.stdout.terminal
        log.close()


if __name__ == "__main__":
    main()
