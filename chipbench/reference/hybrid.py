"""Granite 4.0-H (HF ``GraniteMoeHybridForCausalLM``) in plain PyTorch
float32: Mamba2 and attention layers, each with a routed MoE and a shared
expert, on one chip's share of the experts.

The layer plan repeats with a period of ``attn_period`` layers, attention at
``attn_offset`` and Mamba2 elsewhere; leaves are named as the port names
them (``blocks.<j>.<leaf>``, stacked over the period's repeats) and layer
``r * period + j`` reads row r.  Each layer (HF ``GraniteMoeHybridDecoderLayer``):

    h   = x + m * mixer(rms(x))
    out = h + m * (moe(rms(h)) + shared(rms(h)))        m = residual_multiplier

- mixer: Mamba2 as ``ssm.py`` computes it (in_proj, causal conv with bias,
  the SSD by 256-position blocks, D skip, gated RMSNorm, out_proj); or
  causal GQA attention with no positional embedding (NoPE), the scores
  q k^T scaled by ``attention_multiplier``.
- moe: router logits over all E experts, the top k of them and a softmax
  over those k (HF's ``GraniteMoeTopKGating``); of the E experts the chip
  holds ``[expert_offset, expert_offset + experts_held)``, and a plain loop
  over them adds, for each token that chose one, its gate times the
  expert's SwiGLU output.  What the experts held elsewhere add is left out,
  as on the chip.
- shared: a SwiGLU of width ``shared_d_ff`` on every token.
- embeddings times ``embedding_multiplier``; logits through the tied
  embedding (the chip's slice of the vocabulary) over ``logits_scaling``;
  the loss as in ``dense.py``.

Departures from HF: the router is computed in float32 from float32
weights (the port keeps its router leaf in f32; HF in the model's dtype),
and the load-balance term is left out (the configuration sets its
coefficient to 0: HF adds it only with ``output_router_logits``).  Each
layer runs under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference import ssm
from chipbench.reference.common import matmul, rms_norm
from chipbench.weights import Leaf

MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm", "out_proj")
ATTN = ("wq", "wk", "wv", "wo")
MOE = ("router", "w_gate", "w_up", "w_down")
SWIGLU = ("w_gate", "w_up", "w_down")


def plan(cfg: dict) -> list[str]:
    """Each layer of the period: "attn" or "mamba"."""
    return ["attn" if j == cfg["attn_offset"] else "mamba" for j in range(cfg["attn_period"])]


def _block_leaves(cfg: dict, j: int) -> list[str]:
    """The names of block j's leaves below ``blocks.<j>.``."""
    mixer = [f"attn.{n}" for n in ATTN] if plan(cfg)[j] == "attn" else [f"mamba.{n}" for n in MAMBA]
    return (["mixer_norm.scale", *mixer, "mlp_norm.scale", *(f"moe.{n}" for n in MOE)]
            + [f"shared.{n}" for n in SWIGLU])


def leaves(cfg: dict) -> list[Leaf]:
    """Every parameter, a block's leaves stacked over the period's repeats."""
    L, d, V, period = cfg["n_layers"], cfg["d_model"], cfg["vocab"], cfg["attn_period"]
    R = L // period
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    di, Hs, _, N, G, C = ssm._sizes(cfg)
    k = cfg["conv_kernel"]
    E, n, ff, sff = cfg["n_experts"], cfg["experts_held"], cfg["expert_d_ff"], cfg["shared_d_ff"]
    out = 1.0 / math.sqrt(2 * L)
    cb = 1.0 / math.sqrt(k)
    shapes = {
        "mixer_norm.scale": ((d,), "scale", (0.05,)),
        "attn.wq": ((d, H * hd), "normal", (d ** -0.5,)),
        "attn.wk": ((d, K * hd), "normal", (d ** -0.5,)),
        "attn.wv": ((d, K * hd), "normal", (d ** -0.5,)),
        "attn.wo": ((H * hd, d), "normal", ((H * hd) ** -0.5 * out,)),
        "mamba.in_proj": ((d, 2 * di + 2 * G * N + Hs), "normal", (d ** -0.5,)),
        "mamba.conv_w": ((k, C), "uniform", (-cb, cb)),
        "mamba.conv_b": ((C,), "uniform", (-cb, cb)),
        "mamba.A_log": ((Hs,), "log_uniform", (1.0, 16.0)),
        "mamba.D": ((Hs,), "const", (1.0,)),
        "mamba.dt_bias": ((Hs,), "dt_bias", (0.001, 0.1)),
        "mamba.norm": ((di,), "scale", (0.05,)),
        "mamba.out_proj": ((di, d), "normal", (di ** -0.5 * out,)),
        "mlp_norm.scale": ((d,), "scale", (0.05,)),
        "moe.router": ((d, E), "normal", (d ** -0.5,)),
        "moe.w_gate": ((n, d, ff), "normal", (d ** -0.5,)),
        "moe.w_up": ((n, d, ff), "normal", (d ** -0.5,)),
        "moe.w_down": ((n, ff, d), "normal", (ff ** -0.5 * out,)),
        "shared.w_gate": ((d, sff), "normal", (d ** -0.5,)),
        "shared.w_up": ((d, sff), "normal", (d ** -0.5,)),
        "shared.w_down": ((sff, d), "normal", (sff ** -0.5 * out,)),
    }
    result = [Leaf("embed", (V, d), "normal", (0.02,))]
    for j in range(period):
        for name in _block_leaves(cfg, j):
            shape, init, args = shapes[name]
            result.append(Leaf(f"blocks.{j}.{name}", (R, *shape), init, args))
    result.append(Leaf("final_norm.scale", (d,), "scale", (0.05,)))
    return result


def _attention(h, wq, wk, wv, wo, *, cfg, mm):
    S = h.shape[0]
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(h, wq).view(S, H, hd).transpose(0, 1)  # no positional embedding
    k = mm(h, wk).view(S, K, hd).transpose(0, 1).repeat_interleave(H // K, dim=0)
    v = mm(h, wv).view(S, K, hd).transpose(0, 1).repeat_interleave(H // K, dim=0)
    s = mm(q, k.transpose(1, 2)) * cfg["attention_multiplier"]  # (H, S, S)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return mm(mm(p, v).transpose(0, 1).reshape(S, H * hd), wo)


def _mamba(h, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm, out_proj, *, cfg, mm):
    S = h.shape[0]
    di, H, P, N, G, C = ssm._sizes(cfg)
    k = conv_w.shape[0]
    z, xbc, dt = torch.split(mm(h, in_proj), [di, C, H], dim=-1)
    xbc = F.conv1d(xbc.t()[None], conv_w.t()[:, None, :], conv_b, padding=k - 1, groups=C)
    xbc = F.silu(xbc[0, :, :S].t())
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(S, H, P)
    dt = F.softplus(dt + dt_bias)
    y = ssm.ssd(xs, dt, -torch.exp(A_log), Bm.reshape(S, G, N), Cm.reshape(S, G, N),
                cfg["ssm_chunk"], mm)
    y = (y + D[:, None] * xs).reshape(S, di)
    return mm(rms_norm(y * F.silu(z), norm, 1e-5), out_proj)


def _swiglu(h, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(h, w_gate)) * mm(h, w_up), w_down)


def moe(h, router, w_gate, w_up, w_down, *, cfg, mm=matmul):
    """The held experts' part of the MoE on h (S, d): top-k of the router's
    logits over all experts, a softmax over the k, and a loop over the held
    experts."""
    top, ids = mm(h, router).topk(cfg["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)  # (S, k)
    y = torch.zeros_like(h)
    for i in range(w_gate.shape[0]):
        tok, choice = torch.nonzero(ids == cfg["expert_offset"] + i, as_tuple=True)
        if tok.numel():
            out = _swiglu(h[tok], w_gate[i], w_up[i], w_down[i], mm)
            y = y.index_add(0, tok, gates[tok, choice][:, None] * out)
    return y


def _layer(x, *w, cfg, kind, mm):
    m = cfg["residual_multiplier"]
    n_mix = len(ATTN) if kind == "attn" else len(MAMBA)
    mixer_norm, mixer, mlp_norm = w[0], w[1:1 + n_mix], w[1 + n_mix]
    moe_w, shared = w[2 + n_mix:6 + n_mix], w[6 + n_mix:]
    eps = cfg["norm_eps"]
    mix = _attention if kind == "attn" else _mamba
    x = x + m * mix(rms_norm(x, mixer_norm, eps), *mixer, cfg=cfg, mm=mm)
    h = rms_norm(x, mlp_norm, eps)
    return x + m * (moe(h, *moe_w, cfg=cfg, mm=mm) + _swiglu(h, *shared, mm))


def seq_loss(w: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence (S,)."""
    kinds = plan(cfg)
    x = w["embed"][tokens.long()] * cfg["embedding_multiplier"]
    for r in range(cfg["n_layers"] // cfg["attn_period"]):
        for j, kind in enumerate(kinds):
            args = [w[f"blocks.{j}.{n}"][r] for n in _block_leaves(cfg, j)]
            layer = functools.partial(_layer, cfg=cfg, kind=kind, mm=mm)
            x = checkpoint(layer, x, *args, use_reentrant=False)
    x = rms_norm(x, w["final_norm.scale"], cfg["norm_eps"])
    logits = mm(x[:-1], w["embed"].t()) / cfg["logits_scaling"]
    return F.cross_entropy(logits, tokens[1:].long())
