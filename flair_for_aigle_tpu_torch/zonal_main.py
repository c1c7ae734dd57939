"""Standalone zonal detection CLI of the PyTorch port.

    python -m flair_for_aigle_tpu_torch.zonal_main --config <zonal yaml>

Takes the same YAML schema as the JAX package's ``zonal_main.py``; runs on
the CUDA card when one is present, else on the CPU.
"""

from __future__ import annotations

import argparse
import logging

from flair_for_aigle_tpu_torch.zonal.inference import run_inference


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s")
    parser = argparse.ArgumentParser(description="Run zonal detection inference.")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the detection config file")
    args = parser.parse_args()
    run_inference(args.config)


if __name__ == "__main__":
    main()
