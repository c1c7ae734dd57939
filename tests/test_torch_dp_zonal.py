"""Data-parallel zonal inference in the port, on the CPU (ports of
``tests/test_zonal.py:213``, ``:521`` and ``:556``, which hold the JAX
engine's ``shard_map`` over an 8-device mesh equal to its one-device run).

* ``data_parallel_devices: 2`` (two CPU replicas, each taking half of every
  batch) writes the one-device run's labels byte for byte: on the
  device-resident tiling route, on the host-loader route, and with the
  nearest output rescale; ``devices=`` with a device listed twice does the
  same.
* Those labels equal the JAX engine's with ``data_parallel_devices: 2``
  (two of the conftest's virtual CPU devices) except at near-ties, as
  ``tests/test_torch_zonal_slice.py`` allows for the one-device runs.
* A batch that does not split into equal shards raises the JAX engine's
  ``ValueError``; more CUDA devices than exist raise.
"""

import copy
import os

import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.geo.geotiff import open_raster
from flair_for_aigle_tpu.zonal.inference import run_inference as jax_run_inference
from flair_for_aigle_tpu_torch.zonal import inference as zi
from tests.test_torch_zonal_slice import SIDE, TASK, setup  # noqa: F401  (fixture)


def _labels(run, cfg, out_dir, **kw) -> np.ndarray:
    c = copy.deepcopy(cfg)
    c["output_path"] = str(out_dir)
    os.makedirs(c["output_path"], exist_ok=True)
    with open_raster(run(c, **kw)[TASK]) as src:
        return src.read()


def _case(cfg: dict, case: str) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["batch_size"] = 4  # 3 batches of the 9 tiles, the last one padded
    if case == "host_loader":
        cfg["device_resident_tiles"] = False
    if case == "rescale":
        cfg["output_px_meters"] = 1.0  # 2x coarser than the raster's 0.5 m
    return cfg


@pytest.mark.parametrize("case", ["resident", "host_loader", "rescale"])
def test_two_cpu_replicas_write_the_one_device_labels(setup, tmp_path, case):  # noqa: F811
    cfg = _case(setup["cfg"], case)
    c1 = zi.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
    assert (zi.device_tiling_plan(c1) is None) == (case == "host_loader")
    one = _labels(zi.run_inference, cfg, tmp_path / "one", device="cpu")
    two = _labels(zi.run_inference, {**cfg, "data_parallel_devices": 2}, tmp_path / "two",
                  device="cpu")
    listed = _labels(zi.run_inference, cfg, tmp_path / "listed", device="cpu",
                     devices=["cpu", "cpu"])
    side = SIDE // 2 if case == "rescale" else SIDE
    assert one.shape == (1, side, side)
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(listed, one)


@pytest.mark.parametrize("case", ["resident", "host_loader"])
def test_two_replicas_match_the_jax_engine_on_two_devices(setup, tmp_path, case):  # noqa: F811
    cfg = {**_case(setup["cfg"], case), "data_parallel_devices": 2}
    jax_labels = _labels(jax_run_inference, cfg, tmp_path / "jax")
    port = _labels(zi.run_inference, cfg, tmp_path / "torch", device="cpu")
    assert port.shape == jax_labels.shape == (1, SIDE, SIDE)
    differ = port[0] != jax_labels[0]
    assert differ.mean() < 0.01
    assert np.all(setup["gap"][differ] < 1e-4), setup["gap"][differ]


def test_batch_not_divisible_raises(setup, tmp_path):  # noqa: F811
    cfg = {**copy.deepcopy(setup["cfg"]), "batch_size": 3, "data_parallel_devices": 2}
    with pytest.raises(ValueError, match="batch_size 3 must be divisible by "
                                         "data_parallel_devices 2"):
        _labels(zi.run_inference, cfg, tmp_path / "odd", device="cpu")


def test_more_cuda_devices_than_exist_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        zi.zonal_mesh({"data_parallel_devices": 2}, torch.device("cuda", 0))
