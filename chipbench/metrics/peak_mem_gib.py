"""``torch.cuda.max_memory_allocated()`` over the timed window (the peak is
reset as the window starts), in GiB: the batch one card holds."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
