"""Device time of AdamW's ``_foreach`` kernels
(``multi_tensor_apply_kernel``) per traced step."""

from benchmark import readers


def read(ctx):
    if ctx.summary is None:
        return None
    us = ctx.summary.sum_matching(lambda name: "multi_tensor_apply_kernel" in name)
    return readers.traced_ms_per_unit(ctx, us) if us > 0 else None
