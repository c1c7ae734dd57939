"""Process start to the first timed unit: imports, the build or load
of the kernels, weights and inputs made from the seed, warm-up."""


def read(ctx):
    return ctx.setup_s
