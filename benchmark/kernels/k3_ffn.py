"""K3 (``csrc/ffn.cu`` + ``ln.cuh``; fc1 and fc2 on ``gemm_mma.cuh``):
every Swin block's tail: attention residual, LayerNorm 2, fc1, GELU, fc2
and the MLP residual on the block's tokens."""

NAME = "k3_ffn"
PATTERNS = (r"\bffn_ln_kernel\b", r"\bresid_sum_kernel\b", r"gemm_mma_kernel<[^>]*?\b[012]\s*>")


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    flops = nbytes = 0
    r = geo["mlp_ratio"]
    for st in geo["stages"]:
        n = batch * st.tokens
        flops += st.depth * 2 * 2 * n * st.c * r * st.c
        weights = (2 * r * st.c * st.c + r * st.c + st.c) * elem_bytes + 2 * st.c * 4
        nbytes += st.depth * (3 * n * st.c * elem_bytes + weights)  # x, attn in; out
    return float(flops), float(nbytes)
