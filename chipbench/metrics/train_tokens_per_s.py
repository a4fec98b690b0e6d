"""Unique tokens a step's decoded gradient covers (k * part_mb * seq_len),
summed over every step of the window, over the window's wall time: from
the first timed step's start to the device synchronize after the last."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.steps * ctx.tokens_per_step / ctx.window_s
