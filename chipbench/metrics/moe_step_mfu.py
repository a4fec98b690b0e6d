"""The whole step's share of the card's bf16 peak on a hybrid with a
dropless MoE (granite): the FLOPs of the forward and backward of the real
coded rows of every window step, over the window's wall time, over the
published peak.

The forward of one row of S tokens (2 per multiply-add; causal pairs only;
norms, activations and softmaxes not counted):

- each Mamba2 layer as ``chipbench.flops.ssm_forward`` counts one;
- each attention layer its Q, K, V and O projections and the causal core,
  4 hd H S(S+1)/2;
- each layer's router, 2 d E a token, and shared expert, 6 d sff a token;
- the head, 2 d V a token;
- the held experts, 6 d ff a (token, choice) pair: from the program's
  count (``pairs`` on each forward ``device.mlp`` span), which covers every
  row of the fused pass, scaled to the real rows (``(s+1) k part_mb`` of
  the span's B).

Times 3 for the forward and the backward, no recompute, no padding rows.
Without ``pairs`` spans in a window step the reading is left out."""

from chipbench import flops


def dense_part(cfg: dict, S: int) -> float:
    """One row's forward FLOPs but the held experts'."""
    period, d, V = cfg["attn_period"], cfg["d_model"], cfg["vocab"]
    n_attn = sum(l % period == cfg["attn_offset"] for l in range(cfg["n_layers"]))
    n_mamba = cfg["n_layers"] - n_attn
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    mamba = flops.ssm_forward({**cfg, "n_layers": n_mamba, "vocab": 0}, S)
    attn = 2 * S * d * (2 * H * hd + 2 * K * hd) + 4 * hd * H * S * (S + 1) / 2
    moe = 2 * S * d * cfg["n_experts"] + 6 * S * d * cfg["shared_d_ff"]
    return mamba + n_attn * attn + cfg["n_layers"] * moe + 2 * S * d * V


def read(ctx):
    if ctx.peaks is None or not ctx.steps:
        return None
    t = ctx.traffic
    rows = (t["s"] + 1) * t["k"] * t["part_mb"]
    steps = set(ctx.window_steps)
    expert, seen = 0.0, set()
    for name, _, _, a in ctx.spans:
        if (name == "device.mlp" and a.get("kind") == "moe" and "pairs" in a
                and a.get("pass") == "fwd" and a.get("step") in steps):
            expert += 6 * a["d_model"] * a["expert_d_ff"] * a["pairs"] * rows / a["B"]
            seen.add(a["step"])
    if seen != steps:
        return None
    work = 3.0 * (ctx.steps * rows * dense_part(ctx.model, t["seq_len"]) + expert)
    return 100.0 * work / ctx.window_s / ctx.peaks["bf16_flops"]
