"""The trace summariser on a synthetic Chrome trace: busy time as the
union of device intervals, idle gaps attributed to the innermost host
event, the port's kernels told from the library's."""

import pytest

from benchmark import trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


PORT = frozenset({"gemm_mma_kernel", "prep_kernel"})
TRACE = {"traceEvents": [
    X("bench.traced", "user_annotation", 0, 1000),
    X("void gemm_mma_kernel<__nv_bfloat16, 128, 3>(Params)", "kernel", 100, 100),
    X("ampere_sgemm_128x64_nn", "kernel", 150, 100),  # overlaps the port kernel
    X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 400, 100),
    X("Memset (Device)", "gpu_memset", 600, 10),
    X("aten::copy_", "cpu_op", 300, 90),
    X("cudaMemcpyAsync", "cuda_runtime", 310, 80),
    X("aten::conv2d", "cpu_op", 450, 200),
    X("prep_kernel", "kernel", 2000, 50),  # outside the window
    {"ph": "i", "name": "marker", "ts": 5},
]}


def test_union_idle_and_split():
    s = trace.summarize(TRACE, PORT, window="bench.traced")
    assert s.window_us == 1000
    assert s.busy_us == pytest.approx(150 + 100 + 10)
    assert s.idle_share == pytest.approx(0.74)
    assert s.port_us == 100 and s.library_us == 100
    assert s.memcpy_us == {"HtoD": 100}
    assert "prep_kernel" not in s.device_by_name


def test_gaps_by_what_the_host_did():
    s = trace.summarize(TRACE, PORT, window="bench.traced")
    gaps = dict(s.idle_gaps)
    # 250-400: cudaMemcpyAsync is the innermost host event over 325
    assert gaps["cudaMemcpyAsync"] == pytest.approx(150)
    assert gaps["aten::conv2d"] == pytest.approx(100)  # 500-600
    assert gaps["host, no traced op"] == pytest.approx(100 + 390)  # 0-100, 610-1000
    assert s.idle_gaps[0][0] == "host, no traced op"


def test_short_gaps_are_launch_gaps():
    t = {"traceEvents": [X("a_kernel", "kernel", 0, 10), X("b_kernel", "kernel", 15, 10)]}
    s = trace.summarize(t, frozenset())
    assert s.window_us == 25 and s.busy_us == 20
    assert s.idle_gaps == [["launch gaps under 20 us", 5.0]]


def test_no_device_event_is_refused():
    with pytest.raises(ValueError):
        trace.summarize({"traceEvents": [X("x", "cpu_op", 0, 1)]}, PORT)


def test_base_names():
    assert trace.base_name("void gemm_mma_kernel<float, 2>(Args)") == "gemm_mma_kernel"
    assert trace.base_name("void at::native::vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"
    assert trace.base_name("prep_kernel(float const*)") == "prep_kernel"


def test_port_kernel_names(tmp_path):
    (tmp_path / "a.cu").write_text(
        "template <int EPI>\n__global__ void __launch_bounds__(256, 2)\n"
        "gemm_mma_kernel(Params p) {}\n__global__ void prep_kernel(const float* x) {}\n"
        "__device__ void helper() {}\n")
    (tmp_path / "b.cuh").write_text("__global__ static void colsum_kernel(int n) {}\n")
    (tmp_path / "c.txt").write_text("__global__ void not_a_source(int n) {}\n")
    assert trace.port_kernel_names(str(tmp_path)) == {"gemm_mma_kernel", "prep_kernel",
                                                      "colsum_kernel"}


def test_the_port_has_kernels():
    from flair_for_aigle_tpu_torch.ops import _build

    names = trace.port_kernel_names(_build.CSRC)
    assert {"prep_kernel", "gemm_mma_kernel", "attn_core_bf16_kernel",
            "epilogue_kernel"} <= names
