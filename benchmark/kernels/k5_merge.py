"""K5 (``csrc/merge.cu``: ``gemm_mma_ln_kernel``): Swin's patch merging at
the start of stages 2-4: 2 x 2 gather, LayerNorm over 4C and the 4C -> 2C
reduction."""

NAME = "k5_merge"
PATTERNS = (r"\bgemm_mma_ln_kernel\b", r"\bsum_round_kernel\b")


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    flops = nbytes = 0
    sts = geo["stages"]
    for prev, st in zip(sts, sts[1:]):
        n_out = batch * st.tokens
        flops += 2 * n_out * 4 * prev.c * st.c
        nbytes += (batch * prev.tokens * prev.c + n_out * st.c) * elem_bytes
        nbytes += 4 * prev.c * st.c * elem_bytes + 2 * 4 * prev.c * 4
    return float(flops), float(nbytes)
