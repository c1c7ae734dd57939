"""The repository's own zonal configuration
(``configs/config_model_zonal_segmentation.yaml``) through the port's CLI,
``flair_for_aigle_tpu_torch.zonal_main.main``, against the JAX package's
``zonal_main.py`` on the same YAML, on the CPU.

The YAML changes only where it must to run here: the input raster (a 144
x 144 3-band raster at its 0.2 m output resolution, 9 tiles: two batches of
its 8), ``model_weights`` (one JAX init of the model, written as a
safetensors file that both CLIs load), ``output_path``, ``monotemp_arch``
(swin_micro-UPerNet in place of swin-base) and the tile (64 px, 8 px margin
in place of 512 and 40). Its ``compute_dtype: bfloat16``, ``attn_f32:
True``, ``batch_size: 8``, ``pack_d2h: True`` with ``d2h_codec: auto``,
``normalize_on_device``, ``device_resident_tiles`` and ``preload_rasters``
stay as they are.

* bf16: the two label rasters agree on >= 99 % of the pixels (PERF.md's
  bf16 bound: random weights leave near-ties that bf16 rounding flips).
* float32 (the same file with ``compute_dtype: float32``): they differ on
  < 1 % of the pixels, and only where the JAX logits' float32 top-2 gap is
  below 1e-4 (``tests/test_torch_dp_zonal.py``'s near-tie bound).
* Both runs of the port took the stripe codec (``pack_d2h``).
"""

import copy
import glob
import os
import sys

import jax
import numpy as np
import pytest
import yaml
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu.zonal.model_utils import prepare_model_config as jax_prepare
from flair_for_aigle_tpu_torch import zonal_main
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal import stripes
from tests._torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config_model_zonal_segmentation.yaml")
RES, PATCH, MARGIN, SIDE = 0.2, 64, 8, 144
ARCH = "swin_micro_patch4_window12_384-upernet"
TASK = "AERIAL_LABEL-COSIA"
#: the YAML's keys that the test keeps as they are
KEPT = ("compute_dtype", "attn_f32", "batch_size", "pack_d2h", "d2h_codec",
        "normalize_on_device", "device_resident_tiles", "preload_rasters", "output_px_meters",
        "fused_epilogue", "attn_kernel", "tasks")


def zonal_yaml(path: str, img: str, weights: str, out_dir: str, **changes) -> dict:
    """The repository's zonal YAML with the input raster, weights, output
    path, arch and tile changed (and ``changes`` on top), written to
    ``path``; returns it as a dict."""
    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["modalities"]["AERIAL_RGBI"]["input_img_path"] = img
    cfg.update(model_weights=weights, output_path=out_dir, monotemp_arch=ARCH,
               img_pixels_detection=PATCH, margin=MARGIN, **changes)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def _tiles(cfg):
    """(processing order, tile tops, tile lefts) in output pixels, as the
    engine computes them."""
    c = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    tiles = zi.generate_patches_from_reference(c)
    tops = np.array([round((c["image_bounds"]["top"] - t["top"]) / RES) for t in tiles])
    lefts = np.array([round((t["left"] - c["image_bounds"]["left"]) / RES) for t in tiles])
    return np.lexsort((lefts, -tops)), tops, lefts


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("zonal_main")
    img, weights = str(d / "img.tif"), str(d / "w.safetensors")
    raster = np.random.default_rng(0).integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
    write_geotiff(img, raster, from_origin(10000.0, 20000.0, RES, RES), "EPSG:2154")
    cfg = zonal_yaml(str(d / "probe.yaml"), img, weights, str(d / "probe"))
    with open(YAML) as f:
        base = yaml.safe_load(f)
    assert {k: cfg[k] for k in KEPT} == {k: base[k] for k in KEPT}
    assert (cfg["compute_dtype"], cfg["attn_f32"], cfg["batch_size"], cfg["pack_d2h"],
            cfg["d2h_codec"]) == ("bfloat16", True, 8, True, "auto")
    mc = jax_prepare({**cfg, "model_weights": ""})
    jmodel = JaxModel(config=mc)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(5), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    save_file({k: np.ascontiguousarray(v) for k, v in export_torch_state_dict(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]}).items()},
        weights)
    # the float32 top-2 gap of the JAX logits (full resolution on the CPU)
    # at every output pixel, stitched as the engine stitches labels
    order, tops, lefts = _tiles(cfg)
    norm = cfg["modalities"]["AERIAL_RGBI"]["normalization"]
    padded = np.pad(raster, ((0, 0), (MARGIN, MARGIN), (MARGIN, MARGIN))).astype(np.float32)
    x = np.stack([padded[:, tops[i]:tops[i] + PATCH, lefts[i]:lefts[i] + PATCH]
                  for i in order])
    x = (x - np.float32(norm["means"])[:, None, None]) / np.float32(norm["stds"])[:, None, None]
    logits = np.asarray(jax.jit(jmodel.apply)(variables, {
        "AERIAL_RGBI": x.astype(np.float32),
        TASK: np.zeros((len(x), 1, PATCH, PATCH), np.float32)})[0][TASK])
    up = np.sort(logits[:, :, MARGIN:PATCH - MARGIN, MARGIN:PATCH - MARGIN].astype(np.float64),
                 axis=1)
    inner = PATCH - 2 * MARGIN
    gap = np.full((SIDE + inner, SIDE + inner), np.inf)
    for g, i in zip(up[:, -1] - up[:, -2], order):
        gap[tops[i]:tops[i] + inner, lefts[i]:lefts[i] + inner] = g
    return {"dir": d, "img": img, "weights": weights, "gap": gap[:SIDE, :SIDE]}


def _labels(out_dir: str) -> np.ndarray:
    (path,) = glob.glob(os.path.join(out_dir, f"*_{TASK}_argmax_i.tif"))
    with open_raster(path) as src:
        assert (src.count, src.height, src.width) == (1, SIDE, SIDE)
        return src.read()


def _both_clis(setup, monkeypatch, tag: str, **changes) -> tuple:
    """The port's CLI and the JAX package's on one written YAML: (port
    labels, JAX labels, the port's codec mode)."""
    import zonal_main as jax_zonal_main

    d = setup["dir"]
    path = str(d / f"{tag}.yaml")
    outs = {}
    for name in ("torch", "jax"):
        zonal_yaml(path, setup["img"], setup["weights"], str(d / tag / name), **changes)
        os.makedirs(d / tag / name)
        if name == "torch":
            zonal_main.main(["--config", path, "--device", "cpu"])
            mode = stripes.LAST_TIMINGS.get("d2h_codec_mode")
        else:
            monkeypatch.setattr(sys, "argv", ["zonal_main.py", "--config", path])
            jax_zonal_main.main()
        outs[name] = _labels(str(d / tag / name))
    return outs["torch"], outs["jax"], mode


def test_zonal_main_bf16_on_the_repository_yaml_matches_jax(setup, monkeypatch):
    port, want, mode = _both_clis(setup, monkeypatch, "bf16")
    assert mode in ("rle", "pack5")
    assert port.max() < 19
    assert (port == want).mean() >= 0.99


def test_zonal_main_float32_matches_jax_except_near_ties(setup, monkeypatch):
    port, want, mode = _both_clis(setup, monkeypatch, "f32", compute_dtype="float32")
    assert mode in ("rle", "pack5")
    differ = port[0] != want[0]
    assert differ.mean() < 0.01
    assert np.all(setup["gap"][differ] < 1e-4), setup["gap"][differ]
