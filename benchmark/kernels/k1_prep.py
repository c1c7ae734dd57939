"""K1 (``csrc/prep.cu``): LayerNorm 1, cyclic shift, padding and window
partition of every Swin block's input. Reads the tokens once, writes the
padded windows once; no products."""

NAME = "k1_prep"
PATTERNS = (r"\bprep_kernel\b",)


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    """(tensor-core operations, bytes) of one batch: every block."""
    nbytes = 0
    for st in geo["stages"]:
        nbytes += st.depth * batch * (st.tokens + st.hp * st.wp) * st.c * elem_bytes
        nbytes += st.depth * 2 * st.c * 4  # LayerNorm scale and bias, float32
    return 0.0, float(nbytes)
