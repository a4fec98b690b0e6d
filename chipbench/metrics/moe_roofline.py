"""The MoE layers' share of the card's bf16 peak, from the program's own
``device.mlp`` spans of kind ``moe`` in the window's steps.

The work is counted from each forward span's args, the same whatever
implements the layer: the router's 2 d E a token, the held experts' three
products, 6 d ff a (token, choice) pair routed to a held expert (``pairs``,
the program's device count), and the shared expert's 6 d sff a token;
times 3 for the forward and the backward, no recompute.  The time is the
summed duration of every MoE span, forward, recompute and backward.
Spans without ``pairs`` (a MoE that holds no share) are not read."""


def forward_flops(a: dict) -> float:
    """One MoE forward span's FLOPs (2 per multiply-add)."""
    tokens, d = a["B"] * a["S"], a["d_model"]
    return (2 * tokens * d * a["experts"] + 6 * d * a["expert_d_ff"] * a["pairs"]
            + 6 * tokens * d * a["shared_d_ff"])


def read(ctx):
    if ctx.peaks is None:
        return None
    steps = set(ctx.window_steps)
    work = busy = 0.0
    for name, t0, t1, a in ctx.spans:
        if (name != "device.mlp" or a.get("kind") != "moe" or "pairs" not in a
                or a.get("step") not in steps):
            continue
        busy += t1 - t0
        if a.get("pass") == "fwd":
            work += 3 * forward_flops(a)
    if work <= 0 or busy <= 0:
        return None
    return 100.0 * work / busy / ctx.peaks["bf16_flops"]
