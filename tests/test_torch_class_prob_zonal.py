"""``output_type: class_prob`` through the port's ``run_inference`` against the
JAX package's, end to end on the CPU (ports of ``tests/test_zonal.py:116
test_run_inference_end_to_end[class_prob]`` and ``:605
test_class_prob_fused_epilogue_e2e``).

The raster and model of ``tests/test_torch_codec.py``'s zonal fixture: a
96 x 96 3-band raster at 0.5 m, 64 px tiles with an 8 px margin, 5
classes, weights from one JAX init written as a safetensors file that
both packages load, float32. Two routes: swin_micro-UPerNet with
``fused_epilogue: true`` (K4's class_prob epilogue: its plain version in
the port, the Pallas kernel in interpret mode in the JAX package) and
resnet18-UNet (the full-resolution head: crop, softmax, x 255, as the
reference test runs it).

* The K-band uint8 rasters agree within one uint8 step everywhere (the
  epilogue's contract on float32 logits, ``ops/pallas/epilogue.py:18-21``);
  the bands of every pixel sum to 255 within 3, as the reference asserts.
* The GeoTIFF has K bands, the raster's CRS and transform.
* ``pack_d2h: true`` still ships class_prob raw
  (``zonal/inference.py d2h_codec_choice``): the same bytes, the codec in
  raw mode.
"""

import copy
import os

import jax
import numpy as np
import pytest
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.zonal.inference import run_inference as jax_run_inference
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu.zonal.model_utils import prepare_model_config as jax_prepare
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal import stripes
from tests._torch_threads import few_torch_threads  # noqa: F401

RES, PATCH, MARGIN, N_CLS, SIDE = 0.5, 64, 8, 5, 96
TASK = "AERIAL_LABEL-COSIA"
ORIGIN = (10000.0, 20000.0)
ROUTES = {"swin_micro_k4": ("swin_micro_patch4_window12_384-upernet", True),
          "resnet18_unet": ("resnet18-unet", "auto")}


def _config(d, img: str, arch: str, fused) -> dict:
    return {
        "output_path": str(d / "out"), "output_name": "class_prob",
        "write_dataframe": False, "output_type": "class_prob", "cog_conversion": False,
        "model_weights": str(d / "w.safetensors"), "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": arch, "normalize_on_device": True, "fused_epilogue": fused,
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": [105.0, 111.0, 102.0],
                                              "stds": [52.0, 45.0, 44.0]}},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request, tmp_path_factory):
    """The route's config, with the JAX-initialised weights written, and
    the JAX package's class_prob raster."""
    arch, fused = ROUTES[request.param]
    d = tmp_path_factory.mktemp(request.param)
    img = str(d / "img.tif")
    raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
    write_geotiff(img, raster, from_origin(*ORIGIN, RES, RES), "EPSG:2154")
    cfg = _config(d, img, arch, fused)
    mc = jax_prepare({**cfg, "model_weights": ""})
    variables = jax.device_get(jax.jit(JaxModel(config=mc).init)(
        jax.random.key(3), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    sd = export_torch_state_dict({"params": variables["params"],
                                  "batch_stats": variables.get("batch_stats", {})})
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, cfg["model_weights"])
    jcfg = {**copy.deepcopy(cfg), "output_path": str(d / "jax")}
    os.makedirs(jcfg["output_path"])
    with open_raster(jax_run_inference(jcfg)[TASK]) as src:
        want = src.read()
    return {"cfg": cfg, "dir": d, "want": want}


def _port(cfg: dict, out_dir, **keys):
    c = {**copy.deepcopy(cfg), **keys, "output_path": str(out_dir)}
    os.makedirs(c["output_path"], exist_ok=True)
    path = zi.run_inference(c, device="cpu")[TASK]
    timings = dict(stripes.LAST_TIMINGS)
    with open_raster(path) as src:
        meta = (src.count, src.crs, src.transform, src.dtypes[0])
        return src.read(), meta, timings


def test_class_prob_matches_the_jax_engine_within_one_step(route):
    got, (count, crs, t, dtype), _ = _port(route["cfg"], route["dir"] / "port")
    want = route["want"]
    assert got.shape == want.shape == (N_CLS, SIDE, SIDE)
    assert count == N_CLS and dtype == "uint8" and crs == "EPSG:2154"
    assert np.allclose([t.a, t.b, t.c, t.d, t.e, t.f], [RES, 0, ORIGIN[0], 0, -RES, ORIGIN[1]])
    steps = np.abs(got.astype(int) - want.astype(int))
    assert steps.max() <= 1, (steps.max(), (steps > 1).sum())
    assert np.abs(got.astype(int).sum(axis=0) - 255).max() <= 3


def test_pack_d2h_ships_class_prob_raw(route):
    raw, _, t_raw = _port(route["cfg"], route["dir"] / "raw", pack_d2h=False)
    packed, _, t_packed = _port(route["cfg"], route["dir"] / "packed", pack_d2h=True,
                                d2h_codec="auto")
    assert t_raw["d2h_codec_mode"] == t_packed["d2h_codec_mode"] == "raw"
    assert t_packed["d2h_bytes"] == t_raw["d2h_bytes"]
    np.testing.assert_array_equal(packed, raw)
