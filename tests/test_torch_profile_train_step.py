"""The training-step profile tool (flair_for_aigle_tpu_torch.tools.
profile_train_step) on the CPU at a small size: its random batch has the
data module's layout (images of the configured channels, one-hot labels of
every class), and ``--device cpu`` runs the plain versions and prints the
CPU line and one ``ms_per_step`` JSON line (the profile lines need a card)."""

import json

import numpy as np

from flair_for_aigle_tpu_torch.tools import profile_train_step as tool
from tests._torch_threads import few_torch_threads  # noqa: F401


def test_random_batch_layout():
    cfg = tool.train_config("float32")
    batch = tool.random_batch(cfg, 2, 16)
    task = cfg["labels"][0]
    k = len(cfg["labels_configs"][task]["value_name"])
    assert batch["AERIAL_RGBI"].shape == (2, 3, 16, 16)
    assert batch[task].shape == (2, k, 16, 16)
    np.testing.assert_array_equal(batch[task].sum(1), 1.0)


def test_cpu_run_prints_the_step_time(capsys):
    tool.main(["--device", "cpu", "--px", "32", "--batch", "1", "--steps", "1",
               "--dtype", "float32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu (plain versions)"
    assert len(lines) == 2 and json.loads(lines[1])["ms_per_step"] > 0
