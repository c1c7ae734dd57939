"""Aigle production zonal run driver of the PyTorch port
(reference scripts/run_fast_aigle_segmentation.py:20-199).

End-to-end: env setup -> data/model staging -> model build (once) ->
per-raster loop with skip-if-done resume (existing .gpkg) -> slice -> infer
(on-device stitch, the CUDA kernels) -> polygonize -> aggregate ->
postprocess (geozone clip, class filter class_id==6, simplify tol=1,
area>20m², placeholder confidence) -> export SQL/GPKG -> trace upload ->
data cleanup.

The loop is the JAX package's driver's; only the engine differs: the model
is built on ``device`` before the loop and ``inference_and_write`` takes
the device. The run happens on the CUDA card unless the caller asks for
the CPU (``device="cpu"``, where every kernel wrapper runs its plain
version), and raises before any work when a card is asked for and there
is none. ``data_parallel_devices: N`` in the model configuration runs
every raster data parallel over the first N cards (``zonal/inference.py``).
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import time
from typing import List

from flair_for_aigle_tpu_torch.aigle.export import Exporter
from flair_for_aigle_tpu_torch.aigle.logs import update_progress
from flair_for_aigle_tpu_torch.aigle.map import Mapper
from flair_for_aigle_tpu_torch.aigle.s3 import (
    prepare_local_data_folder,
    prepare_local_model_folder,
    prepare_run_folder,
    upload_run_traces_to_s3,
)
from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.geo import geos
from flair_for_aigle_tpu_torch.geo.crs import transform_geometry
from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.geo.gpkg import read_gpkg, write_gpkg
from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
from flair_for_aigle_tpu_torch.zonal.inference import (
    _set_labels,
    inference_and_write,
    init_outputs,
    initialize_geometry_and_resolutions,
    load_geozone_contour,
    prep_config,
    prep_dataset,
    raster_to_polygons,
)
from flair_for_aigle_tpu_torch.zonal.model_utils import (
    build_inference_model,
    compute_patch_sizes,
)
from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

logger = logging.getLogger(__name__)


def postprocess_results(results: List[dict], target_crs: str,
                        geozone_contours, input_crs: str,
                        use_random_confidence: bool = True) -> List[dict]:
    """Reference inner postprocess_results (run_fast...py:135-167)."""
    if geozone_contours:
        contour_union = geos.unary_union(list(geozone_contours))
        kept = []
        for r in results:
            if r["geometry"].intersects(contour_union):
                r = dict(r)
                r["geometry"] = r["geometry"].intersection(contour_union)
                kept.append(r)
        results = kept

    results = [r for r in results if r["class_id"] == 6]
    for r in results:
        r["geometry"] = r["geometry"].simplify(1.0, preserve_topology=True)
    results = [r for r in results if r["geometry"].area > 20]

    for r in results:
        if use_random_confidence or "confidence" not in r:
            r["confidence"] = random.uniform(0, 1)

    for r in results:
        r["geometry"] = transform_geometry(r["geometry"], input_crs, target_crs)
    return results


def run_fast_aigle_segmentation(run_config_args, device="cuda") -> None:
    device = resolve_device(device)
    logger.info("Initializing process...")
    data_folder = os.getenv("DATA_FOLDER", "./data")
    run_folder = os.getenv("RUN_FOLDER", "./runs")

    debug_mode = getattr(run_config_args, "debug_mode", False)
    images_type = getattr(run_config_args, "images_type", "aerial")
    input_crs = getattr(run_config_args, "input_crs", "EPSG:2154")
    target_crs = getattr(run_config_args, "target_crs", "EPSG:4326")
    export_sql = getattr(run_config_args, "export_sql", False)
    dataset_type = getattr(run_config_args, "dataset_type", "yolo")
    db_sources_folder = os.path.abspath(getattr(run_config_args, "db_sources", "./db_cache"))
    model_id = getattr(run_config_args, "model_id", 0)
    model_config_path = getattr(run_config_args, "model_config")
    version = (getattr(run_config_args, "testset_name", "run") + "_" +
               str(getattr(run_config_args, "version", "v1")))
    image_set_name = f"aigle_{images_type}_{dataset_type}_{version}"

    experiment_data_folder = os.path.join(data_folder, image_set_name)
    experiment_run_folder = os.path.join(run_folder, image_set_name)
    for d in (data_folder, run_folder, db_sources_folder):
        os.makedirs(d, exist_ok=True)

    progression_file_path = getattr(run_config_args, "run_progression_filepath", None) or None

    log_folder, result_folder = prepare_run_folder(experiment_run_folder,
                                                   progression_file_path)
    images_folder, _, _, _ = prepare_local_data_folder(
        getattr(run_config_args, "s3_bucket_name", None),
        getattr(run_config_args, "s3_aerial_archive_source_folder", None),
        getattr(run_config_args, "s3_db_topo_archive_source_file", None),
        experiment_data_folder, False, False,
    )
    update_progress(25, "initializing")
    model_ckpt_path, model_threshold_filepath = prepare_local_model_folder(run_folder, model_id)
    update_progress(50, "initializing")

    logger.info("Starting segmentation process...")
    start_total = time.time()

    model_config_args = prep_config(model_config_path, model_ckpt_path,
                                    model_threshold_filepath, result_folder, log_folder,
                                    images_folder)

    # geozone contours (cache file; 'all' disables filtering)
    try:
        geozone_contours = load_geozone_contour(run_config_args)
    except FileNotFoundError:
        logger.warning("No geozone cache found; processing full rasters")
        geozone_contours = []

    patch_sizes = compute_patch_sizes(model_config_args)
    _set_labels(model_config_args)

    start_model = time.time()
    model, _ = build_inference_model(model_config_args, device=device)
    logger.info("[ok] Loaded model and checkpoint in %.2fs", time.time() - start_model)

    rasters = sorted(os.path.join(images_folder, f) for f in os.listdir(images_folder)
                     if f.lower().endswith((".tif", ".tiff", ".jp2")))
    for i, source_image_path in enumerate(rasters):
        base = os.path.basename(source_image_path)
        raster_results_filepath = os.path.join(result_folder, base.rsplit(".", 1)[0] + ".gpkg")
        if os.path.exists(raster_results_filepath):
            logger.warning("intermediate result found: %s - raster skipped: %s",
                           raster_results_filepath, base)
            continue

        start_slice = time.time()
        ref_mod = model_config_args["reference_modality"]
        model_config_args["modalities"][ref_mod]["input_img_path"] = source_image_path
        model_config_args.pop("image_shape_px", None)
        model_config_args = initialize_geometry_and_resolutions(model_config_args)

        tiles = generate_patches_from_reference(model_config_args, source_image_path,
                                                geozone_contours or None)
        logger.info("[ok] %s sliced into %d tiles in %.2fs", source_image_path,
                    len(tiles), time.time() - start_slice)
        if not tiles:
            continue

        dataset = prep_dataset(model_config_args, tiles, patch_sizes)
        dataloader = BatchedLoader(dataset, batch_size=model_config_args.get("batch_size", 8),
                                   num_workers=model_config_args.get("num_worker", 1))
        ref_img = open_raster(source_image_path)
        output_files, _ = init_outputs(model_config_args, ref_img, i)

        start_infer = time.time()
        inference_and_write(model, dataloader, tiles, model_config_args, output_files,
                            ref_img, device)
        results = raster_to_polygons(output_files, n_jobs=4)
        if results:
            write_gpkg(raster_results_filepath,
                       [{"geometry": r["geometry"], "class_id": r["class_id"]}
                        for r in results],
                       layer="detections", crs=input_crs)
        logger.info("[ok] Inference completed in %.2fs", time.time() - start_infer)
        ref_img.close()
        dataset.close()

    logger.info("[ok] Total time: %.2fs", time.time() - start_total)

    # aggregate all gpkg results
    global_results: List[dict] = []
    for f in os.listdir(result_folder):
        if f.endswith(".gpkg") and not f.startswith("batch_segmentations"):
            recs, _ = read_gpkg(os.path.join(result_folder, f))
            global_results.extend(recs)

    clean = postprocess_results(global_results, target_crs, geozone_contours, input_crs)

    description = "debug_mode" if debug_mode else image_set_name
    export_context = {
        "batch_name": image_set_name,
        "model_id": model_id,
        "export_sql": export_sql,
        "description": description,
        "add_bd_topo": False,
    }
    active_tasks = [t for t in model_config_args["tasks"] if t["active"]]
    mapper = Mapper(active_tasks[0]["class_names"], simplify=True)
    exporter = Exporter(target_crs)
    exporter.export_to_aigle(clean, target_crs, result_folder, mapper, export_context)
    logger.info("Prediction process complete.")
    update_progress(100, "exporting")

    s3_bucket = getattr(run_config_args, "s3_bucket_name", None)
    if s3_bucket:
        s3_runs_path = "s3://" + s3_bucket + "/" + getattr(
            run_config_args, "s3_run_folder_path", "aigle-runs")
        upload_run_traces_to_s3(s3_runs_path, experiment_run_folder, image_set_name)

    if not debug_mode:
        for item in os.listdir(data_folder):
            item_path = os.path.join(data_folder, item)
            if os.path.isfile(item_path) or os.path.islink(item_path):
                os.unlink(item_path)
            elif os.path.isdir(item_path):
                shutil.rmtree(item_path)
        logger.info("data folder cleaned (contents removed): %s", data_folder)
