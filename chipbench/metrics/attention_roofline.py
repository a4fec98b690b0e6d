"""Attention's share of the card's bf16 peak, from the program's own
``device.mixer`` spans of kind ``attn`` in the window's steps.

The work is counted from each forward span's shape, the same whatever
implements attention: the Q, K, V and O projections and the causal core
(q.k and p.v over the S(S+1)/2 pairs the mask keeps, 4 hd H S(S+1)/2 a
row), times 3 for the forward and the backward, no recompute.  The time
is the summed duration of every attention span, forward, recompute and
backward.  Rows the program does not compute are not counted."""


def forward_flops(a: dict) -> float:
    """One attention forward span's FLOPs (2 per multiply-add)."""
    B, S, d = a["B"], a["S"], a["d_model"]
    H, K, hd = a["heads"], a["kv_heads"], a["head_dim"]
    proj = 2 * S * d * (2 * H * hd + 2 * K * hd)
    core = 4 * hd * H * S * (S + 1) / 2
    return B * (proj + core)


def read(ctx):
    if ctx.peaks is None:
        return None
    steps = set(ctx.window_steps)
    work = busy = 0.0
    for name, t0, t1, a in ctx.spans:
        if name != "device.mixer" or a.get("kind") != "attn" or a.get("step") not in steps:
            continue
        busy += t1 - t0
        if a.get("pass") == "fwd":
            work += 3 * forward_flops(a)
    if work <= 0 or busy <= 0:
        return None
    return 100.0 * work / busy / ctx.peaks["bf16_flops"]
