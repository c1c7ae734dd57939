"""The port's zonal engine on the other model families against the JAX
package's, on the CPU (the set-up of ``tests/test_torch_zonal_slice.py``:
64 px tiles with an 8 px margin over a 96 x 96 3-band raster, float32,
random weights from one JAX init written as a safetensors file that both
packages' ``run_inference`` load).

* ``resnet34-unet`` takes the full-resolution head route (logits at the
  tile's size, then crop and argmax), ``convnext_micro-upernet`` the
  stride-4 route (``fused_epilogue: true``: the epilogue's plain version).
  The output GeoTIFFs equal the JAX engine's except at pixels where the JAX
  logits' top-2 gap is below 1e-4 (every differing pixel must be such a
  near-tie).
* ``use_stride4_epilogue`` on a CUDA device takes the fused epilogue for a
  fitting ``*-upernet`` arch only, gives every other arch the
  full-resolution route, and still refuses ``attn_kernel: off`` and
  ``fused_epilogue: false``; it reads only ``device.type``, so it runs
  here.
"""

import copy
import os

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
from flair_for_aigle_tpu_torch.ops.epilogue import _interp_matrix
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal.model_utils import use_stride4_epilogue
from tests._torch_threads import few_torch_threads  # noqa: F401
from tests.test_torch_zonal_slice import (
    MARGIN,
    MEANS,
    N_CLS,
    PATCH,
    RES,
    SIDE,
    STDS,
    TASK,
    _normalised_batch,
    _tiles,
)

ROUTES = {"resnet34-unet": False, "convnext_micro-upernet": True}


def zonal_config(d, arch: str) -> dict:
    img = str(d / "img.tif")
    cfg = {
        "output_path": str(d / "out"), "output_name": "fam",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": str(d / "w.safetensors"), "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": arch, "normalize_on_device": True,
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": MEANS,
                                              "stds": STDS}},
        },
        "tasks": [{"name": TASK, "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLS)}}],
    }
    if ROUTES[arch]:
        cfg["fused_epilogue"] = True
    return cfg


def _gap_canvas(up, order, tops, lefts) -> np.ndarray:
    """Top-2 gap of (B, K, inner, inner) cropped logits at every output
    pixel, stitched as the engine stitches labels."""
    inner = PATCH - 2 * MARGIN
    up = np.sort(up.astype(np.float64), axis=1)
    canvas = np.full((SIDE + inner, SIDE + inner), np.inf)
    for g, i in zip(up[:, -1] - up[:, -2], order):
        canvas[tops[i]:tops[i] + inner, lefts[i]:lefts[i] + inner] = g
    return canvas[:SIDE, :SIDE]


@pytest.mark.parametrize("arch", sorted(ROUTES))
def test_zonal_labels_match_jax(arch, tmp_path):
    raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
    cfg = zonal_config(tmp_path, arch)
    write_geotiff(cfg["modalities"]["AERIAL_RGBI"]["input_img_path"], raster,
                  from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
    stride4 = ROUTES[arch]
    mc = jax_prepare({**cfg, "model_weights": "", "zonal_stride4_logits": stride4})
    jmodel = JaxModel(config=mc)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(7), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    save_file({k: np.ascontiguousarray(v) for k, v in export_torch_state_dict(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()},
        cfg["model_weights"])
    order, tops, lefts = _tiles(cfg)
    x = _normalised_batch(raster, tops, lefts, order)
    logits = np.asarray(jax.jit(jmodel.apply)(variables, {
        "AERIAL_RGBI": x, TASK: np.zeros((len(x), 1, PATCH, PATCH), np.float32)})[0][TASK])
    if stride4:  # NHWC at stride 4: the epilogue's upsample and crop
        r = _interp_matrix(PATCH // 4, 4, MARGIN, PATCH - MARGIN).astype(np.float64)
        up = np.einsum("ia,bxyk,jy->bkij", r, logits.astype(np.float64), r)
    else:  # NCHW at full resolution: the crop
        assert logits.shape == (len(x), N_CLS, PATCH, PATCH)
        up = logits[:, :, MARGIN:PATCH - MARGIN, MARGIN:PATCH - MARGIN]
    gap = _gap_canvas(up, order, tops, lefts)

    outs = {}
    for name, run in (("jax", jax_run_inference),
                      ("torch", lambda c: zi.run_inference(c, device="cpu"))):
        c = copy.deepcopy(cfg)
        c["output_path"] = str(tmp_path / name)
        os.makedirs(c["output_path"])
        with open_raster(run(c)[TASK]) as src:
            outs[name] = src.read()
    assert outs["torch"].shape == outs["jax"].shape == (1, SIDE, SIDE)
    assert outs["torch"].max() < N_CLS
    differ = outs["torch"][0] != outs["jax"][0]
    assert differ.mean() < 0.01
    assert np.all(gap[differ] < 1e-4), gap[differ]


def _gate_cfg(arch: str, **kw) -> dict:
    return {"monotemp_arch": arch, "img_pixels_detection": 512, "margin": 40,
            "tasks": [{"name": TASK, "active": True,
                       "class_names": {i: f"c{i}" for i in range(19)}}], **kw}


@pytest.mark.parametrize("arch,want", [
    ("swin_base_patch4_window12_384-upernet", True),
    ("convnext_base-upernet", True),
    ("resnet34-unet", False),
    ("swin_base_patch4_window12_384-fpn", False),
    ("efficientnet_b4-unetplusplus", False),
    ("resnet50-deeplabv3plus", False),
])
def test_stride4_gate_on_cuda(arch, want):
    cuda = torch.device("cuda")
    assert use_stride4_epilogue(_gate_cfg(arch), cuda) is want
    assert use_stride4_epilogue(_gate_cfg(arch), torch.device("cpu")) is False
    assert use_stride4_epilogue(_gate_cfg(arch, fused_epilogue=True),
                                torch.device("cpu")) is want
    # an upernet arch whose shape does not fit the epilogue: full resolution
    assert use_stride4_epilogue(_gate_cfg(arch, margin=256), cuda) is False
    for knob in ({"fused_epilogue": False}, {"attn_kernel": "off"}, {"attn_kernel": False}):
        with pytest.raises(ValueError, match="not available on CUDA"):
            use_stride4_epilogue(_gate_cfg(arch, **knob), cuda)
