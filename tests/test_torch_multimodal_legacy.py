"""The port's legacy accumulate zonal variant (``zonal/legacy.py``,
re-exported by ``zonal.inference``) against the JAX package's, on the CPU,
with the inputs and helpers of ``tests/test_torch_multimodal_zonal.py``
(AERIAL_RGBI + SENTINEL2_TS, swin_micro-upernet fused with a UTAE, 64 px
tiles, float32) on host-normalised inputs: the int8 canvases are equal
except at pixels where a covering tile's JAX logits have a top-2 gap below
1e-4, with the full-resolution head and with the stride-4 head (brought
back to full resolution by the align-corners resize).
"""

import copy

import jax
import numpy as np
import pytest

from flair_for_aigle_tpu.zonal import inference as jzi
from flair_for_aigle_tpu.zonal import legacy as jlegacy
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal import legacy
from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model
from tests.test_torch_multimodal_zonal import (  # noqa: F401 (env: a fixture)
    SIDE,
    env,
    gap_canvas,
    jax_model_and_weights,
    jzi_labels,
    zonal_config,
)


class _Jitted:
    """The JAX model with its ``apply`` jitted (the legacy variant calls
    ``model.apply`` per batch and reads ``model.config``)."""

    def __init__(self, model):
        self.config = model.config
        self.apply = jax.jit(model.apply)


@pytest.mark.parametrize("stride4", [False, True])
def test_legacy_inference_matches_jax(env, tmp_path, stride4):
    d, paths = env
    cfg = zonal_config(d, paths, str(tmp_path / "w.safetensors"))
    cfg["normalize_on_device"] = False
    cfg["fused_epilogue"] = stride4
    jmodel, variables = jax_model_and_weights(cfg, cfg["model_weights"], stride4)
    assert zi.inference is legacy.inference
    canvases = {}
    for name, z in (("jax", jzi), ("torch", zi)):
        c = z.prep_config(copy.deepcopy(cfg))
        tiles = z.generate_patches_from_reference(c)
        patch_sizes = z.compute_patch_sizes(c)
        jzi_labels(c)
        ds = z.prep_dataset(c, tiles, patch_sizes)
        loader = z.BatchedLoader(ds, batch_size=2)
        with z.open_raster(c["modalities"]["AERIAL_RGBI"]["input_img_path"]) as ref:
            if name == "jax":
                canvas, _ = jlegacy.inference(_Jitted(jmodel), variables, loader, tiles,
                                              c, ref)
            else:
                model, _ = build_inference_model(c, device="cpu")
                assert model.stride4 == stride4
                canvas, _ = zi.inference(model, loader, tiles, c, ref, device="cpu")
        ds.close()
        canvases[name] = canvas
        assert canvas.dtype == np.int8 and canvas.shape == (1, SIDE, SIDE)
    differ = (canvases["torch"] != canvases["jax"])[0]
    assert differ.mean() < 0.01
    if differ.any():
        gap = gap_canvas(cfg, jmodel, variables, stride4, reduce="min")
        assert np.all(gap[differ] < 1e-4), gap[differ]
    assert canvases["jax"].max() > 0
