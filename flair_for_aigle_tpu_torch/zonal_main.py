"""Standalone zonal detection CLI of the PyTorch port.

    python -m flair_for_aigle_tpu_torch.zonal_main --config <zonal yaml> [--device cuda|cpu]

Takes the same YAML schema as the JAX package's ``zonal_main.py``; runs on
the CUDA card unless ``--device cpu`` asks for the CPU, and stops with an
error when ``cuda`` is asked for and there is no card.
"""

from __future__ import annotations

import argparse
import logging

from flair_for_aigle_tpu_torch.zonal.inference import run_inference


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s")
    parser = argparse.ArgumentParser(description="Run zonal detection inference.")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the detection config file")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Run on the CUDA card (default) or on the CPU")
    args = parser.parse_args(argv)
    run_inference(args.config, device=args.device)


if __name__ == "__main__":
    main()
