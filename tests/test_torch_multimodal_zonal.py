"""The port's multimodal zonal run against the JAX package's, on the CPU:
an AERIAL_RGBI raster (96 x 96 at 0.5 m) with a Sentinel-2 time series
over the same extent (12 x 12 at 4 m, 6 dates x 3 bands, a ``dates_txt``
and a cloud mask raster that clouds out date 2), swin_micro-upernet fused
with a UTAE on the zonal multitemp defaults (``multitemp_model_ref_date``),
64 px tiles with an 8 px margin (8 px Sentinel patches), float32, device
normalisation, seeded weights written once as a safetensors file that both
packages' ``run_inference`` load.

* The label GeoTIFFs are byte-identical except at pixels where the JAX
  logits' top-2 gap is below 1e-4, with the full-resolution head (the
  default on the CPU) and with ``fused_epilogue: True`` (the stride-4 head
  and the epilogue's plain version), at ``fixed_time_steps`` 8 (padded
  dates).
* The time-series route: no device-resident tiling plan, and the model
  gets ``SENTINEL2_TS`` in the compute dtype with a fixed T and
  ``SENTINEL2_DATES`` in float32, un-normalised (bf16 run).

``tests/test_torch_multimodal_zonal_io.py`` holds the run with fewer time
steps than dates, the legacy variant, the datasets' kept dates and the
in-memory raster reads.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.zonal import inference as jzi
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu.zonal.model_utils import prepare_model_config as jax_prepare
from flair_for_aigle_tpu_torch.models import flair_model as tfm
from flair_for_aigle_tpu_torch.ops.epilogue import _interp_matrix
from flair_for_aigle_tpu_torch.zonal import inference as zi
from tests.test_torch_utae import _fill

RES, S2_RES, PATCH, MARGIN, SIDE, T_DATES, N_CLS = 0.5, 4.0, 64, 8, 96, 6, 5
ARCH = "swin_micro_patch4_window12_384-upernet"
TASK = "AERIAL_LABEL-COSIA"
MEANS, STDS = [105.0, 111.0, 102.0], [52.0, 45.0, 44.0]
ORIGIN = (700000.0, 6600000.0)


def write_inputs(d, write=write_geotiff, seed=0):
    """(aerial, s2, mask, dates_txt) paths under ``d``."""
    rng = np.random.default_rng(seed)
    aerial = os.path.join(d, "aerial.tif")
    write(aerial, rng.integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8),
          from_origin(*ORIGIN, RES, RES), "EPSG:2154")
    s2_side = int(SIDE * RES / S2_RES)
    s2 = os.path.join(d, "s2.tif")
    write(s2, rng.normal(1000, 300, (T_DATES * 3, s2_side, s2_side)).astype(np.uint16),
          from_origin(*ORIGIN, S2_RES, S2_RES), "EPSG:2154")
    msk = np.zeros((T_DATES * 2, s2_side, s2_side), np.uint8)
    msk[2 * 2 + 1] = 99  # the cloud band of date 2
    msk[4 * 2 + 1, :3] = 99  # date 4 partly cloudy: the worst-covered kept date
    mask = os.path.join(d, "s2_msk.tif")
    write(mask, msk, from_origin(*ORIGIN, S2_RES, S2_RES), "EPSG:2154")
    dates = os.path.join(d, "dates.txt")
    with open(dates, "w") as f:
        f.write("\n".join(f"2021{m:02d}15" for m in range(1, T_DATES + 1)))
    return aerial, s2, mask, dates


def zonal_config(d, paths, weights, fixed_t=8) -> dict:
    aerial, s2, mask, dates = paths
    return {
        "output_path": os.path.join(d, "out"), "output_name": "mm",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": weights, "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": ARCH, "multitemp_model_ref_date": "05-15",
        "normalize_on_device": True, "fixed_time_steps": fixed_t,
        "modalities": {
            "inputs": {"AERIAL_RGBI": True, "SENTINEL2_TS": True},
            "AERIAL_RGBI": {"input_img_path": aerial, "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": MEANS,
                                              "stds": STDS}},
            "SENTINEL2_TS": {"input_img_path": s2, "channels": [1, 2, 3],
                             "dates_txt": dates, "filter_clouds": True,
                             "filter_clouds_img_path": mask, "temporal_average": False},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }


def jax_model_and_weights(cfg, path, stride4=False, seed=0):
    """The JAX model for ``cfg`` and seeded variables, written to ``path``
    in the torch layout."""
    mc = jax_prepare({**cfg, "model_weights": ""})
    jzi_labels(mc)
    if stride4:
        mc["zonal_stride4_logits"] = True
    model = JaxModel(config=mc)
    patch = {"AERIAL_RGBI": PATCH, "SENTINEL2_TS": PATCH * RES / S2_RES}
    example = example_batch_for(mc, {k: int(v) for k, v in patch.items()}, 1, t_steps=4)
    shapes = jax.eval_shape(lambda b: model.init(jax.random.key(0), b), example)
    rng = np.random.default_rng(seed)
    v = {col: _fill(tree, rng, col) for col, tree in shapes.items()}
    sd = export_torch_state_dict(v, transpose_conv_prefixes=tfm.FLAIR_TRANSPOSE_CONV_PATTERNS)
    save_file({k: np.ascontiguousarray(a) for k, a in sd.items()}, path)
    return model, v


def jzi_labels(cfg):
    cfg["labels"] = [TASK]
    cfg["labels_configs"] = {TASK: {"value_name": [f"c{i}" for i in range(N_CLS)]}}


def gap_canvas(cfg, model, variables, stride4, reduce="last"):
    """Top-2 gap of the JAX logits at every output pixel, each tile run
    through the JAX model on the JAX dataset's inputs and stitched as the
    engine stitches labels (bottom-up row-major, last write wins), or
    (``reduce="min"``) the smallest gap of the tiles over each pixel."""
    c = jzi.prep_config(copy.deepcopy(cfg))
    tiles = jzi.generate_patches_from_reference(c)
    ds = jzi.prep_dataset(c, tiles, jzi.compute_patch_sizes(c))
    apply = jax.jit(model.apply)
    inner = PATCH - 2 * MARGIN
    m = np.asarray(MEANS, np.float32)[:, None, None]
    s = np.asarray(STDS, np.float32)[:, None, None]
    gaps = {}
    host_norm = not c.get("normalize_on_device")
    for i in range(len(tiles)):
        item = ds[i]
        aerial = item["AERIAL_RGBI"] if host_norm else (item["AERIAL_RGBI"] - m) / s
        batch = {"AERIAL_RGBI": aerial.astype(np.float32)[None],
                 "SENTINEL2_TS": item["SENTINEL2_TS"][None],
                 "SENTINEL2_DATES": item["SENTINEL2_DATES"][None],
                 TASK: np.zeros((1, 1, PATCH, PATCH), np.float32)}
        lg = np.asarray(apply(variables, {k: jnp.asarray(v) for k, v in batch.items()})[0][TASK],
                        np.float64)
        if stride4:
            r = _interp_matrix(PATCH // 4, 4, MARGIN, MARGIN + inner).astype(np.float64)
            up = np.einsum("ia,bxyk,jy->bkij", r, lg, r)
        else:
            up = lg[:, :, MARGIN:PATCH - MARGIN, MARGIN:PATCH - MARGIN]
        up = np.sort(up[0], axis=0)
        gaps[i] = up[-1] - up[-2]
    ds.close()
    b = c["image_bounds"]
    tops = np.array([round((b["top"] - t["top"]) / RES) for t in tiles])
    lefts = np.array([round((t["left"] - b["left"]) / RES) for t in tiles])
    canvas = np.full((SIDE + inner, SIDE + inner), np.inf)
    for i in np.lexsort((lefts, -tops)):
        win = canvas[tops[i]:tops[i] + inner, lefts[i]:lefts[i] + inner]
        win[...] = gaps[i] if reduce == "last" else np.minimum(win, gaps[i])
    return canvas[:SIDE, :SIDE]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mm_zonal"))
    return d, write_inputs(d)


@pytest.mark.parametrize("case", ["default_epilogue", "fused_epilogue"])
def test_labels_match_jax_run_inference(env, tmp_path, case):
    compare_run_inference(env, tmp_path, case)


def compare_run_inference(env, tmp_path, case):
    d, paths = env
    weights = str(tmp_path / "w.safetensors")
    cfg = zonal_config(d, paths, weights, fixed_t=4 if case == "fewer_steps" else 8)
    stride4 = case == "fused_epilogue"
    if stride4:
        cfg["fused_epilogue"] = True
    model, variables = jax_model_and_weights(cfg, weights, stride4)
    outs = {}
    for name, run in (("jax", jzi.run_inference),
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
    if differ.any():
        gap = gap_canvas(cfg, model, variables, stride4)
        assert np.all(gap[differ] < 1e-4), gap[differ]


def test_time_series_route_keeps_dates_float32(env, tmp_path, monkeypatch):
    d, paths = env
    weights = str(tmp_path / "w.safetensors")
    cfg = zonal_config(d, paths, weights)
    cfg["compute_dtype"] = "bfloat16"
    jax_model_and_weights(cfg, weights)
    cfg["output_path"] = str(tmp_path / "out")
    os.makedirs(cfg["output_path"])
    c = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    assert zi.device_tiling_plan(c) is None
    seen = []
    forward = tfm.FlairHubModel.forward

    def recording(self, batch, *a, **kw):
        seen.append({k: (v.dtype, tuple(v.shape)) for k, v in batch.items()})
        return forward(self, batch, *a, **kw)

    monkeypatch.setattr(tfm.FlairHubModel, "forward", recording)
    with open_raster(zi.run_inference(cfg, device="cpu")[TASK]) as src:
        assert src.read().max() < N_CLS
    assert seen
    for b in seen:
        assert b["SENTINEL2_TS"] == (torch.bfloat16, (2, 8, 3, 8, 8))
        assert b["SENTINEL2_DATES"] == (torch.float32, (2, 8))
        assert b["AERIAL_RGBI"] == (torch.bfloat16, (2, 3, PATCH, PATCH))
