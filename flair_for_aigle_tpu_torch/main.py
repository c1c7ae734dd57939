"""Aigle - Construction Detection CLI of the PyTorch port.

    python -m flair_for_aigle_tpu_torch.main --config <run json> [--device cuda|cpu]

The JAX package's ``main.py`` surface (the reference's main.py): the same
options, ``process=run_fast_best_segmentations``, JSON config values win
over argparse defaults. Runs on the CUDA card unless ``--device cpu`` asks
for the CPU, and stops with an error when ``cuda`` is asked for and there
is no card.
"""

from __future__ import annotations

import argparse
import logging
import sys

from flair_for_aigle_tpu_torch.aigle.config import combine_args_with_priority, load_config
from flair_for_aigle_tpu_torch.aigle.run_fast_aigle_segmentation import (
    run_fast_aigle_segmentation,
)
from flair_for_aigle_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Aigle - Construction Detection on PHR Images"
    )
    add = parser.add_argument
    add("-config", "--config", required=False,
        help="Path to the JSON configuration file")
    add("-process", "--process", required=False,
        choices=["prepare_training", "prepare_test", "evaluate", "predict",
                 "run_best_detections", "run_fast_best_segmentations",
                 "convert_dataset"])
    add("--run_id", required=False, default="local")
    add("--run_progression_filepath", required=False)
    add("-debug_mode", "--debug_mode", action="store_true")
    add("-images_type", "--images_type",
        choices=["pleiade", "aerial", "siatiles"], required=False)
    add("-annotation_source_type", "--annotation_source_type", required=False)
    add("-model_type", "--model_type", required=False)
    add("-model_ckpt", "--model_ckpt", required=False)
    add("-model_config", "--model_config", required=False)
    add("-model_id", "--model_id", required=False)
    add("-images_folders", "--images_folders", required=False)
    add("-inference_folder", "--inference_folder", default=None)
    add("-datasets_folder", "--datasets_folder", required=False)
    add("-db_sources", "--db_sources", required=False, default="./db_cache")
    add("-dataset_rootname", "--dataset_rootname", required=False)
    add("-testset_name", "--testset_name", required=False)
    add("-set_annotations_file", "--set_annotations_file", default=None)
    add("-set_images_file", "--set_images_file", default=None)
    add("-target_pixel_size_m", "--target_pixel_size_m", default=None)
    add("-target_tile_size_px", "--target_tile_size_px", default=256)
    add("-input_pixel_size_m", "--input_pixel_size_m", default=None)
    add("-input_tile_size_px", "--input_tile_size_px", default=256)
    add("-tile_size_px", "--tile_size_px", default=256)
    add("-input_crs", "--input_crs", default="EPSG:2154")
    add("-target_crs", "--target_crs", default="EPSG:4326")
    add("-geozones_codes", "--geozones_codes", default="all")
    add("-export_geozones_codes", "--export_geozones_codes", default="all")
    add("-version", "--version", required=False)
    add("-dataset_type", "--dataset_type", choices=["coco", "yolo"],
        required=False)
    add("-classes_file", "--classes_file", required=False)
    add("-verified_zones", "--verified_zones", default=True, type=bool)
    add("-verify_threshold", "--verify_threshold", default=100, type=int)
    add("-remove_zones", "--remove_zones", default=False, action="store_true")
    add("-category_zones", "--category_zones", default=False,
        action="store_true")
    add("-clean_for_training", "--clean_for_training", default=False,
        action="store_true")
    add("-classes", "--classes", default=[], nargs="+", type=int)
    add("-threshold_file_path", "--threshold_file_path", required=False)
    add("-add_bd_topo", "--add_bd_topo", default=False, nargs="+", type=int)
    add("-bd_topo_file", "--bd_topo_file", default=None, type=str)
    add("-aigle_output", "--aigle_output", default=None)
    add("-export_gpkg", "--export_gpkg", default=None)
    add("-export_sql", "--export_sql", default=None)
    add("-start_raster_index", "--start_from_raster_index", default="(0,0)",
        type=str)
    add("-start_raster_index_df_results_path",
        "--start_raster_index_df_results_path", default=None, type=str)
    add("-start_raster_index_df_infos_path",
        "--start_raster_index_df_infos_path", default=None, type=str)
    add("-s3_bucket_name", "--s3_bucket_name", default=None, type=str)
    add("-s3_aerial_archive_source_folder",
        "--s3_aerial_archive_source_folder", default=None, type=str)
    add("-s3_db_topo_archive_source_file",
        "--s3_db_topo_archive_source_file", default=None, type=str)
    add("-s3_run_folder_path", "--s3_run_folder_path", default=None, type=str)
    add("-conv_dataset_input_folder", "--conv_dataset_input_folder",
        default=None)
    add("-conv_dataset_input_type", "--conv_dataset_input_type", default=None)
    add("-conv_dataset_input_annotation_file",
        "--conv_dataset_input_annotation_file", default=None)
    add("-conv_dataset_input_classes_file",
        "--conv_dataset_input_classes_file", default=None)
    add("-conv_dataset_output_folder", "--conv_dataset_output_folder",
        default=None)
    add("-conv_dataset_output_type", "--conv_dataset_output_type",
        default=None)
    add("-conv_dataset_output_annotation_file",
        "--conv_dataset_output_annotation_file", default=None)
    add("-conv_dataset_output_classes_file",
        "--conv_dataset_output_classes_file", default=None)
    add("-conv_image_overlap", "--conv_image_overlap", default=None)
    add("-conv_images_coords_path", "--conv_images_coords", default=None)
    add("--device", choices=("cuda", "cpu"), default="cuda",
        help="Run on the CUDA card (default) or on the CPU")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(message)s")
    args = build_parser().parse_args(argv)
    resolve_device(args.device)

    config = {}
    if args.config:
        config = load_config(args.config)
    combined_args = combine_args_with_priority(args, config)

    process = combined_args.process
    if process == "run_fast_best_segmentations":
        run_fast_aigle_segmentation(combined_args, device=args.device)
    else:
        print("Unknown process specified.")
        sys.exit(1)


if __name__ == "__main__":
    main()
