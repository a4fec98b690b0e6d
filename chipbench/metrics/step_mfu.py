"""The whole step's share of the card's bf16 peak: the FLOPs of the
forward and backward of the real coded rows of every window step
(``chipbench.flops.train_step``: no padding rows, no recompute, causal
pairs only), over the window's wall time, over the published peak."""

from chipbench import flops


def read(ctx):
    if ctx.peaks is None or not ctx.steps:
        return None
    rate = ctx.steps * flops.train_step(ctx.model, ctx.traffic) / ctx.window_s
    return 100.0 * rate / ctx.peaks["bf16_flops"]
