"""Dense decoder (Llama form: SmolLM) in plain PyTorch float32.

x = embed[tokens]; each layer x += attn(rms(x)); x += mlp(rms(x)); logits =
rms(x) @ embed^T (tied) or @ lm_head.  Attention: GQA (query head i reads
KV head i // (H / K)), rotary over the whole head dim, causal softmax of
q k^T / sqrt(hd).  MLP: silu(x W_gate) * (x W_up), then W_down.  The loss
of a sequence is the mean next-token cross-entropy over its S - 1
positions.  Each layer runs under ``torch.utils.checkpoint``, so one
sequence of 2048 fits beside the f32 state.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chipbench.reference.common import matmul, rms_norm, rope
from chipbench.weights import Leaf

LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def leaves(cfg: dict) -> list[Leaf]:
    """Every parameter, layer leaves stacked (n_layers, ...)."""
    L, d, V, ff = cfg["n_layers"], cfg["d_model"], cfg["vocab"], cfg["d_ff"]
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    out_scale = 1.0 / math.sqrt(2 * L)
    out = [
        Leaf("embed", (V, d), "normal", (0.02,)),
        Leaf("layers.attn_norm", (L, d), "scale", (0.05,)),
        Leaf("layers.wq", (L, d, H * hd), "normal", (d ** -0.5,)),
        Leaf("layers.wk", (L, d, K * hd), "normal", (d ** -0.5,)),
        Leaf("layers.wv", (L, d, K * hd), "normal", (d ** -0.5,)),
        Leaf("layers.wo", (L, H * hd, d), "normal", ((H * hd) ** -0.5 * out_scale,)),
        Leaf("layers.mlp_norm", (L, d), "scale", (0.05,)),
        Leaf("layers.w_gate", (L, d, ff), "normal", (d ** -0.5,)),
        Leaf("layers.w_up", (L, d, ff), "normal", (d ** -0.5,)),
        Leaf("layers.w_down", (L, ff, d), "normal", (ff ** -0.5 * out_scale,)),
        Leaf("final_norm", (d,), "scale", (0.05,)),
    ]
    if not cfg.get("tie_embeddings", False):
        out.append(Leaf("lm_head", (d, V), "normal", (d ** -0.5,)))
    return out


def _layer(x, attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up, w_down, *, cfg, mm):
    S = x.shape[0]
    H, K, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    h = rms_norm(x, attn_norm, eps)
    q = rope(mm(h, wq).view(S, H, hd), cfg["rope_theta"]).transpose(0, 1)
    k = rope(mm(h, wk).view(S, K, hd), cfg["rope_theta"]).transpose(0, 1)
    v = mm(h, wv).view(S, K, hd).transpose(0, 1)
    k, v = k.repeat_interleave(H // K, dim=0), v.repeat_interleave(H // K, dim=0)
    s = mm(q, k.transpose(1, 2)) / math.sqrt(hd)  # (H, S, S)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v).transpose(0, 1).reshape(S, H * hd)
    x = x + mm(o, wo)
    h = rms_norm(x, mlp_norm, eps)
    return x + mm(F.silu(mm(h, w_gate)) * mm(h, w_up), w_down)


def seq_loss(w: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: dict, mm=matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence (S,) under the
    per-layer leaves ``w`` (``layers.<l>.<leaf>``)."""
    layer = functools.partial(_layer, cfg=cfg, mm=mm)
    x = w["embed"][tokens.long()]
    for l in range(cfg["n_layers"]):
        args = [w[f"layers.{l}.{n}"] for n in LAYER_LEAVES]
        x = checkpoint(layer, x, *args, use_reentrant=False)
    x = rms_norm(x, w["final_norm"], cfg["norm_eps"])
    head = w["lm_head"] if "lm_head" in w else w["embed"].t()
    logits = mm(x[:-1], head)
    return F.cross_entropy(logits, tokens[1:].long())
