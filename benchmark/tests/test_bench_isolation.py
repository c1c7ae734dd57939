"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""

import json
import os
import subprocess
import sys

from benchmark import isolation, registry

ROOT = registry.ROOT


def test_names_are_compared_whole():
    assert isolation.is_forbidden("flair_for_aigle_tpu")
    assert isolation.is_forbidden("flair_for_aigle_tpu.models.swin")
    assert isolation.is_forbidden("jax.numpy") and isolation.is_forbidden("jaxlib")
    assert isolation.is_forbidden("flax.linen")
    assert not isolation.is_forbidden("flair_for_aigle_tpu_torch")
    assert not isolation.is_forbidden("flair_for_aigle_tpu_torch.zonal.inference")
    assert not isolation.is_forbidden("jax_like") and not isolation.is_forbidden("flaxen")
    assert isolation.forbidden_loaded(["torch", "jax.numpy", "flair_for_aigle_tpu_torch",
                                       "flair_for_aigle_tpu.ops"]) == ["flair_for_aigle_tpu",
                                                                      "jax"]


def test_no_source_imports_them():
    assert isolation.forbidden_imports(registry.HERE) == {}


def test_the_port_imports_none_of_them():
    port = os.path.join(ROOT, "flair_for_aigle_tpu_torch")
    assert isolation.forbidden_imports(port) == {}


def test_a_run_loads_none_of_them():
    """A whole run of a small cell on the CPU, in a fresh process, leaves
    no forbidden module in ``sys.modules``."""
    code = (
        "import json, sys, torch\n"
        "from benchmark import context, isolation, registry\n"
        "from benchmark.tests import small\n"
        "ctx = small.context_for('zonal-swinb-dalle-b16', 3)\n"
        "registry.driver(ctx.traffic['kind']).run(ctx)\n"
        "context.result(ctx)\n"
        "print(json.dumps(isolation.forbidden_loaded()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "zonal-swinb-dalle-b16", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
