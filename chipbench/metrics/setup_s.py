"""Seconds from the process's start to the first timed step: imports, the
card's first use, the kernels' build or load, the weights, the trainer and
the checked first steps, which warm every shape the window uses."""


def read(ctx):
    return ctx.setup_s
