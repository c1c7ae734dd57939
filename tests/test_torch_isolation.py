"""The PyTorch port stands alone: it imports neither jax nor the JAX package
(statically, by an AST scan of every module and of chip_smoke.py, and at run
time, in a fresh interpreter that imports every module of the port); its
entry points run on the CUDA card unless the caller asks for the CPU, and
raise before doing any work when there is no card; and its copies of the
JAX package's host modules give the same tiles and the same first training
batch on the same files.
"""

import ast
import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flair_for_aigle_tpu.data.dataset import FlairDataModule as JaxDataModule
from flair_for_aigle_tpu.data.paths import get_datasets as jax_get_datasets
from flair_for_aigle_tpu.geo.geotiff import write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.zonal import inference as jzi
from flair_for_aigle_tpu_torch import train_main, zonal_main
from flair_for_aigle_tpu_torch.train import stages
from flair_for_aigle_tpu_torch.zonal import inference as zi
from tests.test_torch_train_main import make_toy_split, toy_config

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "flair_for_aigle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flair_for_aigle_tpu")


def _sources() -> list:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    assert len(_sources()) > 40
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_every_module_of_the_port_leaves_jax_out():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
                     for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"leaked = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('IMPORTED', len([m for m in sys.modules if m.startswith('flair_for_aigle_tpu_torch')]),"
        " 'LEAKED', leaked)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd="/", timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout
    assert int(proc.stdout.split()[1]) >= len(modules)


class _Untouched:
    """A data module that fails the test if an entry point touches it."""

    def __getattr__(self, name):
        raise AssertionError(f"the entry point used the data module ({name}) without a card")


@pytest.mark.parametrize("entry", ["run_inference", "training_stage", "predict_stage",
                                   "zonal_main", "train_main"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.yaml")
    calls = {
        "run_inference": lambda: zi.run_inference({"output_path": str(tmp_path / "out")}),
        "training_stage": lambda: stages.training_stage({}, _Untouched(), tmp_path / "out"),
        "predict_stage": lambda: stages.predict_stage({}, _Untouched(), tmp_path / "out"),
        "zonal_main": lambda: zonal_main.main(["--config", missing]),
        "train_main": lambda: train_main.main(["--config", missing]),
    }
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        calls[entry]()
    assert not any(tmp_path.iterdir())


def test_copied_tiling_gives_the_jax_package_tiles(tmp_path):
    img = str(tmp_path / "img.tif")
    raster = np.random.default_rng(0).integers(0, 255, (3, 150, 170)).astype(np.uint8)
    write_geotiff(img, raster, from_origin(10000.0, 20000.0, 0.5, 0.5), "EPSG:2154")
    cfg = {"output_path": str(tmp_path), "output_name": "t", "write_dataframe": False,
           "img_pixels_detection": 64, "margin": 8, "output_px_meters": 0.5,
           "modalities": {"inputs": {"AERIAL_RGBI": True},
                          "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3]}},
           "tasks": [{"name": "T", "active": True, "class_names": {0: "a", 1: "b"}}]}
    tiles = {}
    for name, mod in (("jax", jzi), ("torch", zi)):
        c = mod.initialize_geometry_and_resolutions(copy.deepcopy(cfg))
        tiles[name] = mod.generate_patches_from_reference(c)
    assert len(tiles["torch"]) == len(tiles["jax"]) > 4
    for t, j in zip(tiles["torch"], tiles["jax"]):
        assert {k: v for k, v in t.items() if k != "geometry"} == \
            {k: v for k, v in j.items() if k != "geometry"}
        assert type(t["geometry"]).__module__.startswith("flair_for_aigle_tpu_torch.")
        assert t["geometry"].bounds == j["geometry"].bounds


def test_copied_loader_gives_the_jax_package_first_batch(tmp_path):
    cfg = toy_config(tmp_path, make_toy_split(tmp_path, {"train": 4, "val": 2, "test": 2}))
    splits = stages.get_datasets(cfg)
    jsplits = jax_get_datasets(cfg)
    batches = []
    for dm in (stages.build_data_module(cfg, *splits),
               JaxDataModule(config=cfg, dict_train=jsplits[0], dict_val=jsplits[1],
                             dict_test=jsplits[2], batch_size=cfg["hyperparams"]["batch_size"],
                             num_workers=0, drop_last=True,
                             use_augmentations=cfg["modalities"]["pre_processings"][
                                 "use_augmentation"])):
        dm.setup("fit")
        batches.append(next(iter(dm.train_dataloader())))
    got, want = batches
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
