"""setup_s: seconds from the process's start to the first measured step
(imports, the kernels' load or build, weights and inputs from the seed,
the cell's shapes warmed)."""


def read(ctx):
    return ctx.outcome.setup_s
