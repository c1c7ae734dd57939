"""Checkpoint interop of the PyTorch port with the JAX package.

A JAX-initialised FlairHubModel (swin_micro-upernet, 64 px) converts with
``state_dict_from_flax`` into exactly ``export_torch_state_dict``'s keys and
arrays, loads strictly into the port's FlairHubModel, and round-trips
through a safetensors file and the port's ``load_checkpoint`` (with and
without a ``model.`` prefix). Head re-init on a class-count mismatch and
bias-table interpolation match the JAX loader.
"""

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from flair_for_aigle_tpu.models.checkpoint import (
    export_torch_state_dict,
    interpolate_bias_table,
    load_checkpoint as jax_load_checkpoint,
)
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from flair_for_aigle_tpu.zonal.model_utils import example_batch_for
from flair_for_aigle_tpu_torch.models.checkpoint import (
    load_checkpoint,
    state_dict_from_flax,
)
from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
from flair_for_aigle_tpu_torch.models.layers import init_weights
from flair_for_aigle_tpu_torch.zonal.model_utils import prepare_model_config

ARCH = "swin_micro_patch4_window12_384-upernet"


def _config(n_classes: int) -> dict:
    cfg = prepare_model_config({
        "model_weights": "", "monotemp_arch": ARCH,
        "modalities": {"inputs": {"AERIAL_RGBI": True},
                       "AERIAL_RGBI": {"channels": [1, 2, 3]}},
        "tasks": [{"name": "T", "active": True,
                   "class_names": {i: f"c{i}" for i in range(n_classes)}}],
    })
    return cfg


def _jax_variables(cfg: dict, seed: int) -> dict:
    model = JaxModel(config=cfg)
    v = jax.jit(model.init)(jax.random.key(seed),
                            example_batch_for(cfg, {"AERIAL_RGBI": 64}, 1))
    return jax.device_get({"params": v["params"], "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module")
def jax5():
    cfg = _config(5)
    return cfg, _jax_variables(cfg, 7)


def _port_model(cfg: dict, seed: int = 1) -> FlairHubModel:
    return init_weights(FlairHubModel(cfg), torch.Generator().manual_seed(seed))


def test_state_dict_from_flax_matches_export_and_loads_strictly(jax5):
    cfg, v = jax5
    sd = state_dict_from_flax(v["params"], v["batch_stats"])
    ref = export_torch_state_dict(v)
    assert set(sd) == set(ref)
    for k, arr in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), arr, err_msg=k)
    model = FlairHubModel(cfg)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("prefix", ["", "model."])
def test_load_checkpoint_safetensors_roundtrip(tmp_path, jax5, prefix):
    cfg, v = jax5
    ref = export_torch_state_dict(v)
    path = str(tmp_path / "w.safetensors")
    save_file({prefix + k: np.ascontiguousarray(a) for k, a in ref.items()}, path)
    model = _port_model(cfg)
    report = load_checkpoint(model, path)
    assert not report["missing"] and not report["shape_mismatch"]
    assert not report["unused"] and report["matched_tasks"] == ["T"]
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)


def test_load_checkpoint_head_reinit_and_bias_tables_match_jax(tmp_path, jax5):
    cfg5, v5 = jax5
    ref = export_torch_state_dict(v5)
    # a checkpoint whose tables were built for window 8 (15 x 15 entries)
    rng = np.random.default_rng(0)
    tables = [k for k in ref if k.endswith("relative_position_bias_table")]
    for k in tables:
        ref[k] = rng.normal(size=(225, ref[k].shape[1])).astype(np.float32)
    path = str(tmp_path / "w5.safetensors")
    save_file({k: np.ascontiguousarray(a) for k, a in ref.items()}, path)

    cfg6 = _config(6)  # 6 classes: the 5-class head re-initialises
    model = _port_model(cfg6)
    report = load_checkpoint(model, path)
    assert report["reinit_tasks"] == ["T"] and not report["shape_mismatch"]

    jcfg = dict(cfg6, paths={"ckpt_model_path": path})
    jvars, _ = jax_load_checkpoint(jcfg, _jax_variables(cfg6, 3))
    want = export_torch_state_dict(jax.device_get(jvars))
    got = model.state_dict()
    head = "main_decoders.T.seg_model.segmentation_head.0."
    np.testing.assert_array_equal(got[head + "weight"].numpy(), want[head + "weight"])
    np.testing.assert_array_equal(got[head + "bias"].numpy(), want[head + "bias"])
    for k in tables:
        np.testing.assert_allclose(
            got[k].numpy(), interpolate_bias_table(ref[k], want[k].shape),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6)
