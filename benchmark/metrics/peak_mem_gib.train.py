"""Peak device memory of the training window
(``torch.cuda.max_memory_allocated``), GiB: it decides the largest batch a
card can train."""


def read(ctx):
    return ctx.peak_mem_bytes / 2 ** 30 if ctx.peak_mem_bytes else None
