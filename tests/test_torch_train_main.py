"""The port's training entry point on a toy FLAIR-HUB-style dataset, on the
CPU: ``python -m flair_for_aigle_tpu_torch.train_main --config <yaml>``
(swin_micro-upernet, 64 px, batch 2, 2 epochs, initialised from a
checkpoint that the JAX package exported, then predict) runs in a
subprocess that must never import jax; its checkpoints must load into the
JAX package's ``load_checkpoint`` with every key matched, and it must write
the predictions and ``metrics.json``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from safetensors.numpy import save_file

from flair_for_aigle_tpu.geo.geotiff import open_raster, write_geotiff
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
from flair_for_aigle_tpu.models.checkpoint import load_checkpoint as jax_load_checkpoint
from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
from tests._fixtures import make_batch, make_config
from tests._torch_threads import few_torch_threads  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK, N_CLS, PX, NAME = "AERIAL_LABEL-COSIA", 5, 64, "toy"


def make_toy_split(root: Path, n: dict) -> dict:
    """Image + label GeoTIFFs and one CSV per split; blocky labels (8 px
    superpixels) with the image intensity correlated to the class."""
    rng = np.random.default_rng(0)
    csvs = {}
    for split, count in n.items():
        lines = ["AERIAL_RGBI," + TASK]
        for i in range(count):
            area = f"D01_2020-{split}-{i:03d}"
            img, lab = root / split / f"IMG_{area}_0_{i}.tif", root / split / f"LAB_{area}_0_{i}.tif"
            img.parent.mkdir(parents=True, exist_ok=True)
            labels = np.kron(rng.integers(0, N_CLS, (PX // 8, PX // 8)), np.ones((8, 8)))
            labels = labels.astype(np.uint8)
            pixels = (labels[None].repeat(4, 0) * 40
                      + rng.normal(0, 5, (4, PX, PX))).clip(0, 255).astype(np.uint8)
            tr = from_origin(10000 + i * 100, 20000, 0.2, 0.2)
            write_geotiff(str(img), pixels, tr, "EPSG:2154")
            write_geotiff(str(lab), labels[None], tr, "EPSG:2154")
            lines.append(f"{img},{lab}")
        csvs[split] = root / f"{split}.csv"
        csvs[split].write_text("\n".join(lines) + "\n")
    return csvs


def toy_config(root: Path, csvs: dict) -> dict:
    cfg = make_config(arch="swin_micro_patch4_window12_384-upernet", tasks=((TASK, N_CLS),))
    cfg["paths"] = {"out_folder": str(root / "out"), "out_model_name": NAME,
                    "train_csv": str(csvs["train"]), "val_csv": str(csvs["val"]),
                    "test_csv": str(csvs["test"]), "global_mtd_folder": str(root) + "/",
                    "ckpt_model_path": ""}
    cfg["tasks"] = {"train": True,
                    "train_tasks": {"init_weights_only_from_ckpt": False,
                                    "resume_training_from_ckpt": False},
                    "predict": True, "write_files": True, "georeferencing_output": True,
                    "metrics_only": False}
    cfg["hyperparams"].update(num_epochs=2, batch_size=2, learning_rate=1e-3)
    cfg["hardware"] = {"accelerator": "gpu", "num_nodes": 1, "gpus_per_node": 1,
                       "strategy": "auto", "num_workers": 0}
    cfg["saving"] = {"ckpt_save_also_last": True, "ckpt_weights_only": False,
                     "ckpt_monitor": "val_miou", "ckpt_monitor_mode": "max",
                     "ckpt_earlystopping_patience": 20, "cp_csv_and_conf_to_output": True,
                     "enable_progress_bar": False, "progress_rate": 10, "ckpt_verbose": False,
                     "verbose_config": False}
    return cfg


def jax_variables(cfg):
    jmodel = JaxModel(config=cfg)
    return jmodel, jax.jit(jmodel.init)(jax.random.key(0), {
        k: jnp.asarray(v) for k, v in make_batch(cfg, 1, PX).items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    cfg = toy_config(root, make_toy_split(root, {"train": 4, "val": 2, "test": 2}))
    jmodel, variables = jax_variables(cfg)
    init = root / "jax_init.safetensors"
    save_file({k: np.ascontiguousarray(v) for k, v in export_torch_state_dict(
        jax.device_get(variables), transpose_conv_prefixes=(".up.0",)).items()}, str(init))
    run_cfg = {**cfg, "paths": {**cfg["paths"], "ckpt_model_path": str(init)},
               "tasks": {**cfg["tasks"], "train_tasks": {
                   "init_weights_only_from_ckpt": True, "resume_training_from_ckpt": False}}}
    (root / "cfg.yaml").write_text(yaml.safe_dump(run_cfg))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from flair_for_aigle_tpu_torch.train_main import main\n"
        f"main(['--config', {str(root / 'cfg.yaml')!r}])\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax'))\n"
        "print('IMPORTED:', leaked)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "2"  # as tests/_torch_threads.py
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(root), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return cfg, Path(cfg["paths"]["out_folder"], NAME), proc.stdout, proc.stderr, jmodel, variables


def test_training_path_never_imports_jax(run):
    assert "IMPORTED: []" in run[2], run[2][-2000:]


def test_training_starts_from_the_jax_checkpoint(run):
    log = run[3]
    assert "Loading checkpoint from" in log and "jax_init.safetensors" in log
    assert "matched=['AERIAL_LABEL-COSIA'] reinit=[] " in log and "missing=0 unused=0" in log


def test_checkpoints_load_into_the_jax_package(run):
    cfg, out, _, _, _, variables = run
    ckpts = sorted((out / "checkpoints").glob("*.safetensors"))
    names = [p.name for p in ckpts]
    assert f"last_{NAME}.safetensors" in names and any(n.startswith("ckpt-epoch") for n in names)
    for path in ckpts:
        loaded, report = jax_load_checkpoint({**cfg, "paths": {**cfg["paths"],
                                                               "ckpt_model_path": str(path)}},
                                             variables)
        assert not report["missing"] and not report["unused"] and not report["shape_mismatch"]
        assert report["matched_tasks"] == [TASK] and not report["reinit_tasks"]


def test_predictions_and_metrics_written(run):
    out = run[1]
    res = out / f"results_{NAME}"
    preds = sorted((res / f"predictions_{NAME}" / TASK).glob("PRED_*.tif"))
    assert len(preds) == 2
    with open_raster(str(preds[0])) as src:
        p = src.read()
        assert p.shape == (1, PX, PX) and p.max() < N_CLS and src.crs == "EPSG:2154"
    metrics = json.loads((res / f"metrics_{NAME}" / TASK / "metrics.json").read_text())
    assert "Avg_metrics" in metrics
    assert (out / "used_csv_and_config" / "cfg.yaml").exists()


def test_full_state_flags_raise(tmp_path):
    from flair_for_aigle_tpu_torch.train.trainer import check_full_state_flags

    cfg = toy_config(tmp_path, {"train": "a", "val": "b", "test": "c"})
    check_full_state_flags(cfg)
    for flags in ({"saving": {**cfg["saving"], "save_full_state_orbax": True}},
                  {"tasks": {**cfg["tasks"], "train_tasks": {
                      "resume_full_state_from_orbax": "ckpt"}}}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A 9"):
            check_full_state_flags({**cfg, **flags})


def test_batch_size_one_aborts_training(tmp_path):
    from flair_for_aigle_tpu_torch.train.trainer import check_batchnorm_and_batch_size

    cfg = toy_config(tmp_path, {"train": "a", "val": "b", "test": "c"})
    check_batchnorm_and_batch_size(cfg)
    cfg["hyperparams"]["batch_size"] = 1
    with pytest.raises(SystemExit):
        check_batchnorm_and_batch_size(cfg)
