"""The training-step profile tool (flair_for_aigle_tpu_torch.tools.
profile_train_step) on the CPU at a small size: its random batch has the
data module's layout (images of the configured channels, one-hot labels of
every class), and ``--device cpu`` runs the plain versions and prints the
CPU line and one ``ms_per_step`` JSON line (the profile lines need a card)."""

import json

import numpy as np
import pytest

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


def test_gemm_tallies_split_the_tensor_core_gemm_by_its_epilogue():
    """gemm_mma_kernel serves K3 (GELU, residual and split-K epilogues,
    codes 0-2, with resid_sum_kernel; K7's dln takes code 2 too), K2's and
    K6's projections (the bias epilogue, code 3) and K6's and K7's do, dx
    and weight gradients (the rounding and weight-gradient epilogues, codes
    4 and 5): each lands in its own tally, K5's gemm_mma_ln_kernel (its
    LayerNorm producer) in a fourth, gemm_mma_aux_kernel's K7 fc1
    recompute and dh (codes 6 and 7) in a fifth; other kernels in none,
    and an epilogue code that no epilogue has raises."""
    rows = [("void flair::gemm_mma_kernel<float, 64, 128, 0>(float const*, float const*)", 3.0, 24),
            ("void flair::gemm_mma_kernel<float, 64, 128, 1>(float const*, float const*)", 2.0, 20),
            ("void flair::gemm_mma_kernel<__nv_bfloat16, 128, 128, 2>(__nv_bfloat16 const*)",
             1.0, 4),
            ("void flair::resid_sum_kernel<float>(float const*, int, long long, int)", 0.5, 4),
            ("void flair::gemm_mma_kernel<float, 64, 128, 3>(float const*, float const*)", 9.0, 72),
            ("void flair::gemm_mma_aux_kernel<float, 64, 128, 6>(float const*, float const*)",
             1.5, 24),
            ("void flair::gemm_mma_kernel<float, 64, 128, 4>(float const*, float const*)", 7.0, 48),
            ("void flair::gemm_mma_kernel<float, 64, 128, 5>(float const*, float const*)", 6.0, 48),
            ("void flair::gemm_mma_aux_kernel<float, 64, 128, 7>(float const*, float const*)",
             1.2, 24),
            ("void flair::attn_core_f32_kernel<9>(float const*)", 1.8, 24),
            ("void flair::gemm_mma_ln_kernel<float, 64, 128, 4, flair::MergeA<float> >"
             "(float const*)", 0.5, 3),
            ("void flair::sum_partials_kernel(float const*, float*, long long, int)", 0.4, 96)]
    out = tool.gemm_tallies(rows)
    assert sorted(out) == ["attn_gemms", "bwd_gemms", "ffn_bwd_gemms", "ffn_gemms",
                           "merge_gemms"]
    assert [k[:40] for k in out["attn_gemms"]] == [rows[4][0][:40]]
    assert list(out["attn_gemms"].values()) == [[9.0, 72]]
    assert sorted(v[1] for v in out["ffn_gemms"].values()) == [4, 4, 20, 24]
    assert list(out["bwd_gemms"].values()) == [[7.0, 48], [6.0, 48]]
    assert list(out["ffn_bwd_gemms"].values()) == [[1.5, 24], [1.2, 24]]
    assert list(out["merge_gemms"].values()) == [[0.5, 3]]
    with pytest.raises(ValueError, match="unknown epilogue"):
        tool.gemm_tallies([("void flair::gemm_mma_kernel<float, 64, 128, 8>(float const*)", 1, 1)])
