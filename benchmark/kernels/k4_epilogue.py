"""K4 (``csrc/epilogue.cu``): the zonal epilogue of a UPerNet head at
stride 4: x4 bilinear upsampling (align_corners), margin crop and argmax to
uint8 labels, one launch a batch. Counted by its bytes: the stride-4 logits
read once, the labels written once (its interpolation is not a product)."""

NAME = "k4_epilogue"
PATTERNS = (r"\bepilogue_kernel\b",)


def work(geo: dict, batch: int, elem_bytes: int) -> tuple[float, float]:
    h4 = geo["px"] // 4
    inner = geo["px"] - 2 * geo["margin"]
    nbytes = batch * (geo["classes"] * h4 * h4 * elem_bytes + inner * inner)
    return 0.0, float(nbytes)
