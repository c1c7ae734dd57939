"""K2 (``csrc/window_attn.cu``, ``window_attn_f32.cu``; qkv and output
projections on ``gemm_mma.cuh``): window attention of every Swin block: the
qkv product and the output projection on the block's tokens, the scores with
the relative-position bias and shift mask, softmax and the value product on
its padded windows (``families/swin.py block_flops`` counts alike)."""

NAME = "k2_window_attn"
PATTERNS = (r"\battn_core_(bf16|f32)_kernel\b", r"gemm_mma_kernel<[^>]*?\b3\s*>")


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    flops = nbytes = 0
    for st in geo["stages"]:
        n = batch * st.tokens  # the block's tokens, no padding
        t = st.ws * st.ws
        per_block = (2 * n * st.c * 3 * st.c  # qkv
                     + 2 * 2 * batch * st.windows * t * t * st.c  # q k^T, p v
                     + 2 * n * st.c * st.c)  # output projection
        flops += st.depth * per_block
        weights = (4 * st.c * st.c + 4 * st.c) * elem_bytes + (2 * st.ws - 1) ** 2 * st.heads * 4
        nbytes += st.depth * (2 * n * st.c * elem_bytes + weights)
    return float(flops), float(nbytes)
