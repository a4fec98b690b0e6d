"""Device milliseconds a window step spends in the model's mixers (the
program's own ``device.mixer`` spans, forward, recompute and backward):
attention on a dense model, the SSD layers on Mamba2."""


def read(ctx):
    steps = set(ctx.window_steps)
    total = sum(t1 - t0 for name, t0, t1, a in ctx.spans
                if name == "device.mixer" and a.get("step") in steps)
    return 1e3 * total / len(steps) if steps and total > 0 else None
