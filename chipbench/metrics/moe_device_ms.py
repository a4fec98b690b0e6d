"""Device milliseconds a window step spends in the model's MoE layers (the
program's own ``device.mlp`` spans of kind ``moe``: the norm, the routing,
the held experts and the shared expert; forward, recompute and backward)."""


def read(ctx):
    steps = set(ctx.window_steps)
    total = sum(t1 - t0 for name, t0, t1, a in ctx.spans
                if name == "device.mlp" and a.get("kind") == "moe" and a.get("step") in steps)
    return 1e3 * total / len(steps) if steps and total > 0 else None
