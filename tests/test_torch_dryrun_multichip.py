"""The port's data-parallel dry run (``python -m
flair_for_aigle_tpu_torch.tools.dryrun_multichip``, the counterpart of
``__graft_entry__.py dryrun_multichip``) at W = 2 gloo ranks on the CPU:
it exits 0 and prints ``dryrun_multichip(2) ok: loss=...`` with a finite
loss, and imports neither jax nor the JAX package; a card it asks for and
does not find stops it with an error.
"""

import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    code = ("import sys\n"
            "from flair_for_aigle_tpu_torch.tools.dryrun_multichip import main\n"
            "rc = main(sys.argv[1:])\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'flax', 'flair_for_aigle_tpu'))\n"
            "print('IMPORTED:', leaked)\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code, *args], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)


def test_dryrun_on_two_cpu_ranks():
    proc = _run("--world", "2", "--device", "cpu", "--timeout", "240")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    m = re.search(r"^dryrun_multichip\(2\) ok: loss=(\S+)$", proc.stdout, re.M)
    assert m and math.isfinite(float(m.group(1))), proc.stdout
    assert "IMPORTED: []" in proc.stdout


def test_dryrun_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        return
    proc = _run("--world", "2", "--device", "cuda", timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert "ok: loss" not in proc.stdout
