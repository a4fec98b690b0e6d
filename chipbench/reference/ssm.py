"""Mamba2 (SSD) language model in plain PyTorch float32, after the paper
(arXiv:2405.21060) and ``mamba_ssm``'s Mamba2 layer.

Each layer: x += out_proj(gated_rms(ssd(conv(in_proj(rms(x)))))), with
in_proj -> [z | xBC | dt]; a causal depthwise conv of width k with bias on
xBC, then silu; xBC -> [x | B | C]; dt = softplus(dt + dt_bias); A =
-exp(A_log).  The SSD is

    y[t] = sum_{s <= t} (C[t] . B[s]) exp(sum_{s < u <= t} dt[u] A) dt[s] x[s]

per head, B and C shared by the heads of a group; the exponent's sums are
differences of a float64 cumulative sum.  It is taken as the paper's
block decomposition (its section 6, "SSD minimal"): the quadratic form
inside each chunk, and the state carried from chunk to chunk by the plain
recurrence; any chunk length gives the same y.  Then y += D x; gated RMSNorm
rms(y * silu(z)) over d_inner (one group, eps 1e-5); out_proj.  Logits
through the tied embedding; the loss as in ``dense.py``.  Each layer runs
under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference.common import matmul, rms_norm
from chipbench.weights import Leaf

LAYER_LEAVES = ("norm", "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm",
                "out_proj")


def _sizes(cfg: dict) -> tuple[int, int, int, int, int, int]:
    di, H, N, G = cfg["ssm_d_inner"], cfg["ssm_heads"], cfg["ssm_state"], cfg["ssm_groups"]
    return di, H, di // H, N, G, di + 2 * G * N  # d_inner, heads, head dim, state, groups, conv ch


def leaves(cfg: dict) -> list[Leaf]:
    L, d, V, k = cfg["n_layers"], cfg["d_model"], cfg["vocab"], cfg["conv_kernel"]
    di, H, _, N, G, C = _sizes(cfg)
    d_proj = 2 * di + 2 * G * N + H
    cb = 1.0 / math.sqrt(k)  # Conv1d's default bound at fan-in k (one channel a group)
    return [
        Leaf("embed", (V, d), "normal", (0.02,)),
        Leaf("layers.norm", (L, d), "scale", (0.05,)),
        Leaf("layers.in_proj", (L, d, d_proj), "normal", (d ** -0.5,)),
        Leaf("layers.conv_w", (L, k, C), "uniform", (-cb, cb)),
        Leaf("layers.conv_b", (L, C), "uniform", (-cb, cb)),
        Leaf("layers.A_log", (L, H), "log_uniform", (1.0, 16.0)),
        Leaf("layers.D", (L, H), "const", (1.0,)),
        Leaf("layers.dt_bias", (L, H), "dt_bias", (0.001, 0.1)),
        Leaf("layers.gate_norm", (L, di), "scale", (0.05,)),
        Leaf("layers.out_proj", (L, di, d), "normal", (di ** -0.5 / math.sqrt(2 * L),)),
        Leaf("final_norm", (d,), "scale", (0.05,)),
    ]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int, mm=matmul) -> torch.Tensor:
    """The SSD by blocks of ``chunk`` positions (the whole sequence where
    ``chunk`` does not divide it).  x (S, H, P), dt (S, H), A (H,), Bm / Cm
    (S, G, N) -> y (S, H, P)."""
    S, H, P = x.shape
    G = Bm.shape[1]
    Q = chunk if S % chunk == 0 else S
    c = S // Q
    cs = torch.cumsum((dt * A).double(), dim=0).view(c, Q, H)  # log-decay from position 0
    end = cs[:, -1]  # (c, H): at each chunk's last position
    start = torch.cat([torch.zeros_like(end[:1]), end[:-1]])  # (c, H): at the one before it
    xdt = (x * dt[..., None]).view(c, Q, H, P).permute(0, 2, 1, 3)  # (c, H, Q, P)
    Bg, Cg = (t.view(c, Q, G, -1).permute(0, 2, 1, 3) for t in (Bm, Cm))  # (c, G, Q, N)
    Bh, Ch = (t.repeat_interleave(H // G, dim=1) for t in (Bg, Cg))  # head h reads group h // (H / G)
    # inside each chunk: the quadratic form
    seg = (cs[:, :, None, :] - cs[:, None, :, :]).float().permute(0, 3, 1, 2)  # (c, H, t, s)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = mm(Cg, Bg.transpose(-1, -2)).repeat_interleave(H // G, dim=1)  # (c, H, t, s)
    y = mm(cb * decay, xdt)  # (c, H, Q, P)
    # each chunk's own contribution to the state at its end, (c, H, P, N)
    to_end = torch.exp((end[:, None, :] - cs).float()).permute(0, 2, 1)[..., None]  # (c, H, Q, 1)
    own = mm((xdt * to_end).transpose(-1, -2), Bh)
    # the state entering each chunk, carried from chunk to chunk
    h, entering = torch.zeros_like(own[0]), []
    for i in range(c):
        entering.append(h)
        h = h * torch.exp((end[i] - start[i]).float())[:, None, None] + own[i]
    h_in = torch.stack(entering)  # (c, H, P, N)
    from_start = torch.exp((cs - start[:, None, :]).float()).permute(0, 2, 1)[..., None]
    y = y + mm(Ch, h_in.transpose(-1, -2)) * from_start
    return y.permute(0, 2, 1, 3).reshape(S, H, P)


def _layer(x, norm, in_proj, conv_w, conv_b, A_log, D, dt_bias, gate_norm, out_proj, *, cfg, mm):
    S = x.shape[0]
    di, H, P, N, G, C = _sizes(cfg)
    k = conv_w.shape[0]
    zxbcdt = mm(rms_norm(x, norm, cfg["norm_eps"]), in_proj)
    z, xbc, dt = torch.split(zxbcdt, [di, C, H], dim=-1)
    # causal depthwise conv: out[t] = sum_i x[t - (k-1) + i] conv_w[i] + conv_b
    xbc = F.conv1d(xbc.t()[None], conv_w.t()[:, None, :], conv_b, padding=k - 1, groups=C)
    xbc = F.silu(xbc[0, :, :S].t())
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(S, H, P)
    dt = F.softplus(dt + dt_bias)
    y = ssd(xs, dt, -torch.exp(A_log), Bm.reshape(S, G, N), Cm.reshape(S, G, N),
            cfg["ssm_chunk"], mm)
    y = (y + D[:, None] * xs).reshape(S, di)
    y = rms_norm(y * F.silu(z), gate_norm, 1e-5)
    return x + mm(y, out_proj)


def seq_loss(w: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence (S,)."""
    layer = functools.partial(_layer, cfg=cfg, mm=mm)
    x = w["embed"][tokens.long()]
    for l in range(cfg["n_layers"]):
        args = [w[f"layers.{l}.{n}"] for n in LAYER_LEAVES]
        x = checkpoint(layer, x, *args, use_reentrant=False)
    x = rms_norm(x, w["final_norm"], cfg["norm_eps"])
    head = w["lm_head"] if "lm_head" in w else w["embed"].t()
    return F.cross_entropy(mm(x[:-1], head), tokens[1:].long())
