"""The port's attention-product A/B (flair_for_aigle_tpu_torch.ops.attn_dots
and its tool) against the JAX tool itself, ``tools/exp_attn_dots.py``, on
the CPU.

The JAX tool does its work at import, so the test executes its module body
up to ``build`` (without its two compilation-cache settings) under a small
geometry, with ``pl.pallas_call`` shimmed to ``interpret=True``; nothing in
the tool's file changes. Its own ``xq, xk, xv``, ``body_a`` and ``body_b``
then hold the port: the plain version and both CPU wrappers match
``body_a``, and ``body_b`` once a wrapping body zeroes its two
block-diagonal panels, within 4e-3 of the largest |output|: sums of exact
bf16 products taken in another float32 order flip single bf16 roundings of
the scores and the outputs (measured: 0.125 at a largest |output| of 334
with 4 heads, 1.0 at 348 with 8, one unit in the last place at 128-256).

Two faults of the JAX tool that the port diverges from on purpose: body_b
never zeroes its block-diagonal scratch panels, so in interpret mode (which
fills fresh scratch with NaN) its output is not finite; and ``N_INST = BNW
// BW`` leaves the last BNW % BW windows unwritten, where the port raises.
"""

import ast
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flair_for_aigle_tpu_torch.ops import attn_dots
from flair_for_aigle_tpu_torch.tools import exp_attn_dots
from tests._torch_threads import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "exp_attn_dots.py"
SMALL = {"DB": "1", "DHW": "24", "BW": "2"}
GEOMS = [{**SMALL, "DC": "128", "DNH": "4"}, {**SMALL, "DC": "256", "DNH": "8"}]


def _jax_tool(env: dict, monkeypatch) -> dict:
    """The JAX tool's namespace after its module body up to ``build``, at
    ``env``, with ``pl.pallas_call`` in interpret mode."""
    tree = ast.parse(TOOL.read_text(), str(TOOL))
    body = []
    for node in tree.body:
        if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
                and ast.unparse(node.value.func) == "jax.config.update"):
            continue  # the compilation-cache settings
        body.append(node)
        if isinstance(node, ast.FunctionDef) and node.name == "build":
            break
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ns = {"__file__": str(TOOL), "__name__": "exp_attn_dots"}
    exec(compile(ast.Module(body, []), str(TOOL), "exec"), ns)
    real = ns["pl"]
    ns["pl"] = SimpleNamespace(BlockSpec=real.BlockSpec,
                               pallas_call=partial(real.pallas_call, interpret=True))
    return ns


def _scratch(ns: dict) -> list:
    """body_b's scratch, as the tool declares it (:93-97)."""
    vmem, bw, g, tp, dt = ns["pltpu"].VMEM, ns["BW"], ns["G"], ns["TP"], ns["DT"]
    return [vmem((bw, 128, g * tp), dt), vmem((bw, g * tp, 128), dt),
            vmem((bw, ns["T"], g * tp), jnp.float32)]


def _zeroed_body_b(ns: dict):
    def body(q_ref, k_ref, v_ref, out_ref, kbd_ref, vbd_ref, s_ref):
        kbd_ref[...] = jnp.zeros(kbd_ref.shape, kbd_ref.dtype)
        vbd_ref[...] = jnp.zeros(vbd_ref.shape, vbd_ref.dtype)
        ns["body_b"](q_ref, k_ref, v_ref, out_ref, kbd_ref, vbd_ref, s_ref)
    return body


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(_np(x).copy()).to(torch.bfloat16)


@pytest.mark.parametrize("env", GEOMS, ids=["c128_4h", "c256_8h"])
def test_port_matches_the_jax_tool_bodies(env, monkeypatch):
    ns = _jax_tool(env, monkeypatch)
    assert ns["BNW"] == 4 and ns["NG"] == int(env["DC"]) // 128
    xq, xk, xv = ns["xq"], ns["xk"], ns["xv"]
    want_a = _np(ns["build"](ns["body_a"], [])(xq, xk, xv))
    want_b = _np(ns["build"](_zeroed_body_b(ns), _scratch(ns))(xq, xk, xv))
    q, k, v = (_torch(x) for x in (xq, xk, xv))
    kw = {"num_heads": ns["NH"]}
    got = {"reference": attn_dots.attn_dots_reference(q, k, v, **kw),
           "per_head": attn_dots.attn_dots_per_head(q, k, v, bw=ns["BW"], **kw),
           "grouped": attn_dots.attn_dots_grouped(q, k, v, bw=ns["BW"], **kw)}
    tol = 4e-3 * np.abs(want_a).max()
    for name, out in got.items():
        assert out.dtype == torch.bfloat16 and out.shape == (4, 144, int(env["DC"]))
        out = out.float().numpy()
        assert np.abs(out - want_a).max() <= tol, (name, "body_a")
        assert np.abs(out - want_b).max() <= tol, (name, "zeroed body_b")


def test_the_jax_tool_body_b_reads_unset_scratch(monkeypatch):
    ns = _jax_tool(GEOMS[0], monkeypatch)
    out = _np(ns["build"](ns["body_b"], _scratch(ns))(ns["xq"], ns["xk"], ns["xv"]))
    assert not np.isfinite(out).all()


@pytest.mark.parametrize("fn", [attn_dots.attn_dots_per_head, attn_dots.attn_dots_grouped])
def test_windows_not_a_multiple_of_bw_raise(fn):
    x = torch.zeros((4, 144, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of bw"):
        fn(x, x, x, num_heads=4, bw=3)


def test_grouped_needs_whole_head_groups():
    x = torch.zeros((2, 144, 96), dtype=torch.bfloat16)
    assert attn_dots.attn_dots_per_head(x, x, x, num_heads=3).shape == x.shape
    with pytest.raises(ValueError, match="grouped"):
        attn_dots.attn_dots_grouped(x, x, x, num_heads=3)


def _run_tool(env: dict, *args) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    return subprocess.run(
        [sys.executable, "-m", "flair_for_aigle_tpu_torch.tools.exp_attn_dots", *args],
        capture_output=True, text=True, env={**full, **env}, cwd=str(REPO), timeout=300)


@pytest.mark.parametrize("env", GEOMS, ids=["c128_4h", "c256_8h"])
def test_tool_cli_on_the_cpu_prints_the_three_lines(env):
    proc = _run_tool(env, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4 and lines[0].startswith("cpu")
    rows = [json.loads(line) for line in lines[1:]]
    assert [list(r) for r in rows] == [["max_abs_diff"], ["per_head_ms"], ["grouped_ms"]]
    assert rows[0]["max_abs_diff"] == 0.0
    # host-clock times of a tiny CPU run: a difference of two noisy sums,
    # so only their type is checked here (chip_smoke.py requires > 0 on the
    # card, where CUDA events time the device)
    assert all(isinstance(r[k], float) for r, k in zip(rows[1:], ("per_head_ms", "grouped_ms")))
    # on the CPU every call takes the plain version: no kernel launch
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == {
        "launches": {"attn_dots_per_head": 0, "attn_dots_grouped": 0}}


def test_tool_geometry_and_inputs_are_the_jax_tool_ones(monkeypatch):
    ns = _jax_tool(GEOMS[1], monkeypatch)
    g = exp_attn_dots.geometry()
    assert (g["bnw"], g["c"], g["nh"], g["bw"]) == (ns["BNW"], ns["C"], ns["NH"], ns["BW"])
    got = exp_attn_dots.inputs(g["bnw"], g["c"], "cpu")
    for a, b in zip(got, (ns["xq"], ns["xk"], ns["xv"])):
        np.testing.assert_array_equal(a.float().numpy(), _np(b))
    assert exp_attn_dots.geometry({}) == {"b": 16, "hw": 128, "c": 128, "nh": 4, "bw": 4,
                                          "bnw": 16 * 11 * 11}


def test_tool_defaults_to_the_card_and_raises_without_one(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        exp_attn_dots.main([])
    assert capsys.readouterr().out == ""


def test_tool_raises_when_bw_does_not_divide_the_windows():
    proc = _run_tool({**GEOMS[0], "BW": "3"}, "--device", "cpu")
    assert proc.returncode != 0 and "multiple of bw" in proc.stderr


def test_importing_the_tool_prints_nothing():
    proc = subprocess.run([sys.executable, "-c",
                           "import flair_for_aigle_tpu_torch.tools.exp_attn_dots"],
                          capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == "" and proc.stderr == ""
