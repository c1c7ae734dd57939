"""K6 (``csrc/window_attn_bwd.cu``, ``window_attn_bwd_f32.cu``; its
products on ``gemm_mma.cuh``): the backward of every Swin block's window
attention from its input and the output's gradient: the qkv recompute, the
gradients of the output projection (input and weight) and of the qkv
projection (input and weight) on the block's tokens; the scores,
probabilities and output recomputed and the gradients of p, v, q and k on
its padded windows."""

NAME = "k6_window_attn_bwd"
PATTERNS = (r"\battn_bwd_core_(bf16|f32)_kernel\b", r"gemm_mma_kernel<[^>]*?\b[45]\s*>",
            r"\bcolsum_partial_kernel\b", r"\bsum_partials_kernel\b")


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    flops = nbytes = 0
    for st in geo["stages"]:
        n = batch * st.tokens  # the block's tokens, no padding
        t = st.ws * st.ws
        c = st.c
        per_block = (2 * n * c * 3 * c  # qkv recompute
                     + 6 * 2 * batch * st.windows * t * t * c  # s, o, dp, dv, dq, dk
                     + 2 * 2 * n * c * c  # output projection: dinput, dweight
                     + 2 * 2 * n * c * 3 * c)  # qkv projection: dinput, dweight
        flops += st.depth * per_block
        nbytes += st.depth * (3 * n * c * elem_bytes  # x, g in; dx out
                              + (4 * c * c + 4 * c) * (elem_bytes + 4)  # weights in, grads out
                              + 2 * (2 * st.ws - 1) ** 2 * st.heads * 4)
    return float(flops), float(nbytes)
