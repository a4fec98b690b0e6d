"""Milliseconds a window step spends in the control plane: the trainer's
own ``step.resolve`` (straggler draw, arrival clocks, decode) and
``step.observe`` (the throughput estimate) spans, summed a step and
averaged over the window's steps."""


def read(ctx):
    steps = set(ctx.window_steps)
    total = sum(t1 - t0 for name, t0, t1, args in ctx.spans
                if name in ("step.resolve", "step.observe") and args.get("step") in steps)
    return 1e3 * total / len(steps) if steps and total > 0 else None
