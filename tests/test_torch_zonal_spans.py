"""The spans and counters of a zonal call and of a training step, on the
CPU (``utils/profiling.py``).

A toy ``inference_and_write`` (swin_micro-UPerNet with seeded weights, a
160 x 160 raster, 64 px tiles, batch 2, labels through the stripe codec)
runs as the Aigle loop drives it, on the resident and on the host path,
once under ``profile_trace`` and once with no profiler:

* the record counts ``batches == ceil(tiles / batch)``, the valid tiles and
  every stripe under one tier; the two runs count alike and write the same
  labels;
* the Chrome trace holds one ``zonal.batch`` span per batch, each with one
  ``zonal.forward`` inside, which holds ``model.encoder`` (its stages and
  their blocks inside), ``model.decoder`` and ``zonal.epilogue``; the host phases
  before the call (``zonal.geometry``, ``.slice``, ``.dataset``,
  ``.outputs``) are spans too;
* ``put_s`` and ``dispatch_s`` are the sums of the ``zonal.put`` and
  ``zonal.batch`` spans; the top-level spans of the call are the path's
  phases and fit in ``total_s``; every key the benchmark, ``bench.py``,
  ``chip_smoke.py`` and the README read is present, and the second call
  uploads no constant of the forward (``const_uploads`` 0).

``Steps.train_step`` under the profiler emits ``train.step`` with
``train.h2d``, ``train.forward``, ``train.backward``, ``train.optimizer``
and ``train.confmat`` inside, in that order, and leaves no device times on
the CPU.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from flair_for_aigle_tpu_torch.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu_torch.geo.windows import from_origin
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.models.layers import init_weights
from flair_for_aigle_tpu_torch.train import optim
from flair_for_aigle_tpu_torch.train.task import make_steps
from flair_for_aigle_tpu_torch.utils import profiling
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal import stripes
from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model, compute_patch_sizes
from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference
from tests._fixtures import make_config
from tests._torch_threads import few_torch_threads  # noqa: F401

RES, PATCH, MARGIN, N_CLS, SIDE, BATCH = 0.5, 64, 8, 5, 160, 2
TASK = "AERIAL_LABEL-COSIA"
#: the record's keys that the benchmark, bench.py, chip_smoke.py and the
#: README read
KEPT = {"read_s", "put_s", "dispatch_s", "finalize_s", "finalize_plan_s", "finalize_wait_s",
        "finalize_unpack_s", "finalize_tiff_write_s", "total_s", "d2h_bytes",
        "d2h_codec_mode", "rle_probes", "plan_pending", "unpack_route", "const_uploads"}
TOP_LEVEL = {"resident": {"zonal.setup", "zonal.read", "zonal.put", "zonal.batch",
                          "stripes.poll", "stripes.finalize"},
             "host": {"zonal.setup", "zonal.read", "zonal.batch", "stripes.finalize"}}
TOP_KEYS = {"resident": ("engine_setup_s", "read_s", "put_s", "dispatch_s", "poll_s",
                         "finalize_s"),
            "host": ("engine_setup_s", "read_s", "dispatch_s", "finalize_s")}


def _config(d, path: str) -> dict:
    img = str(d / "img.tif")
    if not os.path.exists(img):
        raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
        write_geotiff(img, raster, from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
    return {
        "output_path": str(d / path), "output_name": "spans",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": "", "batch_size": BATCH, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": "swin_micro_patch4_window12_384-upernet",
        "normalize_on_device": True, "pack_d2h": True, "d2h_codec": "auto",
        "device_resident_tiles": path == "resident",
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom",
                                              "means": [105.0, 111.0, 102.0],
                                              "stds": [52.0, 45.0, 44.0]}},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }


def _dalle(cfg: dict) -> tuple:
    """One raster through the engine as the Aigle loop drives it: (record,
    tiles, labels)."""
    os.makedirs(cfg["output_path"], exist_ok=True)
    cfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    patch_sizes = compute_patch_sizes(cfg)
    zi._set_labels(cfg)
    model, _ = build_inference_model(cfg, device="cpu", seed=3)
    path = cfg["modalities"]["AERIAL_RGBI"]["input_img_path"]
    tiles = generate_patches_from_reference(cfg, path, None)
    dataset = zi.prep_dataset(cfg, tiles, patch_sizes)
    loader = BatchedLoader(dataset, batch_size=cfg["batch_size"], num_workers=1)
    ref_img = open_raster(path)
    output_files, out_paths = zi.init_outputs(cfg, ref_img)
    zi.inference_and_write(model, loader, tiles, cfg, output_files, ref_img,
                           torch.device("cpu"))
    ref_img.close()
    dataset.close()
    with open_raster(out_paths[TASK]) as src:
        labels = src.read()
    return dict(stripes.LAST_TIMINGS), len(tiles), labels


def _annotations(logdir) -> list:
    files = glob.glob(os.path.join(str(logdir), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda a: (a[1], -a[2]))


def _within(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2] and child is not parent


@pytest.fixture(scope="module", params=["resident", "host"])
def runs(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    path = request.param
    logdir = d / "trace"
    with profiling.profile_trace(str(logdir)):
        traced = _dalle(_config(d, path))
    plain = _dalle({**_config(d, path), "output_path": str(d / f"{path}_off")})
    return {"path": path, "traced": traced, "plain": plain, "ann": _annotations(logdir)}


def test_batches_tiles_and_stripes_are_counted(runs):
    for rec, n_tiles, _ in (runs["traced"], runs["plain"]):
        assert n_tiles > BATCH
        assert rec["batches"] == math.ceil(n_tiles / BATCH)
        assert rec["tiles"] == n_tiles
        tiers = [rec[f"stripes_{t}"] for t in ("small", "mid", "packed", "raw")]
        assert sum(tiers) >= 1 and rec["d2h_bytes"] > 0
    assert {k: runs["traced"][0][k] for k in ("batches", "tiles", "stripes_packed")} == \
        {k: runs["plain"][0][k] for k in ("batches", "tiles", "stripes_packed")}
    np.testing.assert_array_equal(runs["traced"][2], runs["plain"][2])


def test_each_batch_span_holds_one_forward_and_the_model_spans(runs):
    ann, rec = runs["ann"], runs["traced"][0]
    batches = [a for a in ann if a[0] == "zonal.batch"]
    assert len(batches) == rec["batches"]
    for b in batches:
        inside = [a for a in ann if _within(a, b)]
        forwards = [a for a in inside if a[0] == "zonal.forward"]
        assert len(forwards) == 1, [a[0] for a in inside]
        names = {a[0] for a in inside if _within(a, forwards[0])}
        assert {"model.encoder", "model.encoder.stage1", "model.encoder.stage4",
                "model.encoder.block", "model.decoder", "zonal.epilogue"} <= names
        assert {"zonal.stitch", "stripes.stream"} <= {a[0] for a in inside}
        assert ("zonal.gather" in {a[0] for a in inside}) == (runs["path"] == "resident")
    assert {"zonal.geometry", "zonal.slice", "zonal.dataset", "zonal.outputs"} <= \
        {a[0] for a in ann}


@pytest.mark.parametrize("name,key", [("zonal.put", "put_s"), ("zonal.batch", "dispatch_s"),
                                      ("stripes.finalize", "finalize_s")])
def test_record_keys_are_the_sums_of_their_spans(runs, name, key):
    got = runs["traced"][0][key]
    spans = [a for a in runs["ann"] if a[0] == name]
    assert spans
    traced_s = sum(a[2] - a[1] for a in spans) / 1e6
    # each span's clock reads lie inside its record_function's interval
    assert 0 < got <= traced_s + 1e-5 * len(spans)
    assert got == pytest.approx(traced_s, rel=0.25, abs=2e-3 * len(spans))


def test_top_level_spans_fit_in_total_s(runs):
    ann, path = runs["ann"], runs["path"]
    setup = next(a for a in ann if a[0] == "zonal.setup")
    final = next(a for a in ann if a[0] == "stripes.finalize")
    call = ("call", setup[1], final[2])
    inner = [a for a in ann if _within(a, call) or a in (setup, final)]
    top = [a for a in inner if not any(_within(a, b) for b in inner)]
    assert {a[0] for a in top} == TOP_LEVEL[path]
    for rec in (runs["traced"][0], runs["plain"][0]):
        assert sum(rec[k] for k in TOP_KEYS[path]) <= rec["total_s"]
    assert sum(a[2] - a[1] for a in top) / 1e6 <= runs["traced"][0]["total_s"]


def test_every_kept_key_is_present(runs):
    for rec in (runs["traced"][0], runs["plain"][0]):
        assert KEPT <= set(rec), KEPT - set(rec)
        assert set(zi.RECORD_KEYS) <= set(profiling.declared()) <= set(rec)
        assert rec["d2h_codec_mode"] in ("rle", "pack5")
        assert rec["blocked_s"] >= 0 and rec["forward_s"] > 0 and rec["stitch_s"] > 0
    # the second call at the same geometry finds every constant on the device
    assert runs["plain"][0]["const_uploads"] == 0


def _train_config():
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, N_CLS),))
    cfg["hyperparams"].update(learning_rate=1e-3, batch_size=1)
    return cfg


def test_train_step_emits_its_phase_spans_and_no_device_times(tmp_path):
    cfg = _train_config()
    model = FlairHubModel(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(cfg["hyperparams"], list(model.parameters()))
    steps = make_steps(model, cfg, opt, "cpu")
    rng = np.random.default_rng(0)
    lab = rng.integers(0, N_CLS, (1, 32, 32))
    batch = {"AERIAL_RGBI": rng.normal(size=(1, 3, 32, 32)).astype(np.float32),
             TASK: (lab[:, None] == np.arange(N_CLS)[None, :, None, None]).astype(np.float32)}
    before = dict(profiling.device_times())
    with profiling.profile_trace(str(tmp_path)):
        out = steps.train_step(batch, 1e-3)
    assert np.isfinite(float(out["loss"]))
    ann = [a for a in _annotations(tmp_path) if a[0].startswith("train.")]
    step = [a for a in ann if a[0] == "train.step"]
    assert len(step) == 1
    phases = [a[0] for a in ann if _within(a, step[0])]
    assert phases == ["train.h2d", "train.forward", "train.backward", "train.optimizer",
                      "train.confmat"]
    assert profiling.device_times() == before
    assert not {"train.forward", "train.backward"} & set(before)
