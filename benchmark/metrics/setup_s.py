"""Set-up: seconds from the process's start to the first measured dispatch
or call (imports, CUDA context, corpus or pool, weights, the watched first
dispatch, warm-up; the first run in a checkout also builds the kernels)."""


def read(rec):
    return rec.get("setup_s")
