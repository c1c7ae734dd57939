"""The PyTorch port's zonal main path against the JAX package's, end to end
on the CPU: swin_micro-upernet, 64 px tiles with an 8 px margin, a 96 x 96
3-band raster, float32, random weights from one JAX init written as a
safetensors file that both packages' ``run_inference`` load.

* The stride-4 logits of one batch agree within 1e-4 * max|logit|.
* The output GeoTIFFs are byte-identical except at pixels where the JAX
  logits' top-2 gap is below 1e-4 (every differing pixel must be such a
  near-tie), on the device-resident tiling path, the host-loader path, and
  with ``fused_epilogue`` at its default (the full-resolution head route on
  the CPU in both packages).
* A subprocess that runs the port's slice never imports jax or the JAX
  package.
* The in-memory raster IO that stands in for libtiff / GEOS on machines
  without them gives the native IO's output bytes.
"""

import contextlib
import copy
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.zonal.inference import run_inference as jax_run_inference
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu.zonal.model_utils import prepare_model_config as jax_prepare
from flair_for_aigle_tpu_torch.geo import geotiff as port_geotiff
from flair_for_aigle_tpu_torch.models.checkpoint import load_checkpoint
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.ops.epilogue import _interp_matrix
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal.memory_io import host_io, memory_host_io
from flair_for_aigle_tpu_torch.zonal.model_utils import prepare_model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, PATCH, MARGIN, N_CLS, SIDE = 0.5, 64, 8, 5, 96
ARCH = "swin_micro_patch4_window12_384-upernet"
TASK = "AERIAL_LABEL-COSIA"
MEANS, STDS = [105.0, 111.0, 102.0], [52.0, 45.0, 44.0]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    img = str(d / "img.tif")
    raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
    write_geotiff(img, raster, from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
    cfg = {
        "output_path": str(d / "out"), "output_name": "slice",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": str(d / "w.safetensors"), "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": ARCH, "normalize_on_device": True, "fused_epilogue": True,
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": MEANS,
                                              "stds": STDS}},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }
    mc = jax_prepare({**cfg, "model_weights": "", "zonal_stride4_logits": True})
    jmodel = JaxModel(config=mc)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(7), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    sd = export_torch_state_dict({"params": variables["params"],
                                  "batch_stats": variables["batch_stats"]})
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, cfg["model_weights"])
    # every tile through the JAX model once, in processing order
    order, tops, lefts = _tiles(cfg)
    x = _normalised_batch(raster, tops, lefts, order)
    batch = {"AERIAL_RGBI": x.copy(), TASK: np.zeros((len(x), 1, PATCH, PATCH), np.float32)}
    logits = np.asarray(jax.jit(jmodel.apply)(variables, batch)[0][TASK])  # NHWC stride 4
    return {"cfg": cfg, "raster": raster, "x": x, "logits": logits,
            "gap": _gap_canvas(logits, order, tops, lefts)}


def _tiles(cfg):
    """(processing order, tile tops, tile lefts) in output pixels, as the
    zonal engine computes them; at output resolution = input resolution the
    tops/lefts also index the margin-padded raster."""
    c = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    tiles = zi.generate_patches_from_reference(c)
    tops = np.array([round((c["image_bounds"]["top"] - t["top"]) / RES) for t in tiles])
    lefts = np.array([round((t["left"] - c["image_bounds"]["left"]) / RES) for t in tiles])
    order = np.lexsort((lefts, -tops))
    return order, tops, lefts


def _normalised_batch(raster, tops, lefts, idxs) -> np.ndarray:
    padded = np.pad(raster, ((0, 0), (MARGIN, MARGIN), (MARGIN, MARGIN)))
    tiles = np.stack([padded[:, tops[i]:tops[i] + PATCH, lefts[i]:lefts[i] + PATCH]
                      for i in idxs]).astype(np.float32)
    m = np.asarray(MEANS, np.float32)[None, :, None, None]
    s = np.asarray(STDS, np.float32)[None, :, None, None]
    return (tiles - m) / s


def _gap_canvas(logits, order, tops, lefts) -> np.ndarray:
    """Top-2 gap of the JAX upsampled logits at every output pixel, stitched
    like the engine stitches labels (processing order, last write wins)."""
    inner = PATCH - 2 * MARGIN
    r = _interp_matrix(PATCH // 4, 4, MARGIN, MARGIN + inner).astype(np.float64)
    up = np.sort(np.einsum("ia,bxyk,jy->bkij", r, logits.astype(np.float64), r), axis=1)
    gaps = up[:, -1] - up[:, -2]
    canvas = np.full((SIDE + inner, SIDE + inner), np.inf)
    for g, i in zip(gaps, order):
        canvas[tops[i]:tops[i] + inner, lefts[i]:lefts[i] + inner] = g
    return canvas[:SIDE, :SIDE]


def test_stride4_logits_of_one_batch_agree(setup):
    cfg = setup["cfg"]
    x, want = setup["x"][:2], setup["logits"][:2]
    mc = prepare_model_config(cfg)
    zi._set_labels(mc)
    mc["zonal_stride4_logits"] = True
    model = FlairHubModel(mc).eval()
    load_checkpoint(model, cfg["model_weights"])
    with torch.no_grad():
        got, _ = model({"AERIAL_RGBI": torch.from_numpy(x.copy()),
                        TASK: torch.zeros(2, 1, PATCH, PATCH)})
    got = got[TASK].numpy()
    assert got.shape == want.shape == (2, PATCH // 4, PATCH // 4, N_CLS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", ["resident", "host_loader", "default_epilogue"])
def test_geotiff_matches_jax_run_inference(setup, tmp_path, case):
    cfg = copy.deepcopy(setup["cfg"])
    if case == "host_loader":
        cfg["device_resident_tiles"] = False
    if case == "default_epilogue":
        del cfg["fused_epilogue"]
    outs = {}
    for name, run in (("jax", jax_run_inference),
                      ("torch", functools.partial(zi.run_inference, device="cpu"))):
        c = copy.deepcopy(cfg)
        c["output_path"] = str(tmp_path / name)
        os.makedirs(c["output_path"])
        with open_raster(run(c)[TASK]) as src:
            outs[name] = src.read()
            assert (src.height, src.width, src.crs) == (SIDE, SIDE, "EPSG:2154")
    assert outs["torch"].shape == outs["jax"].shape == (1, SIDE, SIDE)
    differ = outs["torch"][0] != outs["jax"][0]
    assert differ.mean() < 0.01
    assert np.all(setup["gap"][differ] < 1e-4), setup["gap"][differ]


def test_port_slice_never_imports_jax(setup, tmp_path):
    cfg = copy.deepcopy(setup["cfg"])
    cfg["output_path"] = str(tmp_path / "sub")
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from flair_for_aigle_tpu_torch.zonal.inference import run_inference\n"
        f"paths = run_inference(json.loads({json.dumps(cfg)!r}), device='cpu')\n"
        "assert paths, paths\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'flax', 'flair_for_aigle_tpu'))\n"
        "assert not leaked, leaked\n"
        "print('NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_memory_host_io_gives_the_native_output(setup, tmp_path):
    with host_io() as (_, desc):
        assert desc.startswith("native")
    native_reader = port_geotiff.RasterReader
    outs = {}
    for name in ("native", "memory"):
        cfg = copy.deepcopy(setup["cfg"])
        cfg["output_path"] = str(tmp_path / name)
        os.makedirs(cfg["output_path"])
        io = memory_host_io() if name == "memory" else contextlib.nullcontext(write_geotiff)
        with io as write:
            img = str(tmp_path / f"{name}.tif")
            write(img, setup["raster"], from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
            cfg["modalities"]["AERIAL_RGBI"]["input_img_path"] = img
            with port_geotiff.open_raster(zi.run_inference(cfg, device="cpu")[TASK]) as src:
                outs[name] = src.read()
                assert (src.height, src.width, src.crs) == (SIDE, SIDE, "EPSG:2154")
    assert port_geotiff.RasterReader is native_reader  # leaving the context restores it
    np.testing.assert_array_equal(outs["memory"], outs["native"])
