"""The operations and bytes the benchmark charges a step and a kernel
call, from shapes alone: frozen here, apart from the port, so that no
change to the program moves the yardstick.

A training step's FLOPs are the forward and backward (3x the forward) of
the (s+1) k part_mb sequences the code assigns to the workers: no padding
rows and no recompute.  A forward counts the matmuls (2 per
multiply-add); causal attention counts the (query, key) pairs its mask
keeps, S(S+1)/2, and the SSD's within-chunk products the pairs of each
chunk's causal mask.  Norms, activations and the softmax are not counted.
"""

from __future__ import annotations


def dense_forward(cfg: dict, S: int) -> float:
    """Llama-form decoder, one sequence of S tokens."""
    d, ff, V = cfg["d_model"], cfg["d_ff"], cfg["vocab"]
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    proj = 2 * S * d * (2 * H * hd + 2 * K * hd)  # q, o and k, v
    mlp = 3 * 2 * S * d * ff
    attn = 2 * 2 * H * hd * S * (S + 1) / 2  # q.k and p.v over the kept pairs
    return cfg["n_layers"] * (proj + mlp + attn) + 2 * S * d * V


def ssm_forward(cfg: dict, S: int) -> float:
    """Mamba2, one sequence of S tokens, the SSD chunked at the
    configuration's ``ssm_chunk``."""
    d, V, k = cfg["d_model"], cfg["vocab"], cfg["conv_kernel"]
    di, H, N, G = cfg["ssm_d_inner"], cfg["ssm_heads"], cfg["ssm_state"], cfg["ssm_groups"]
    P, Q = di // H, cfg["ssm_chunk"]
    C = di + 2 * G * N
    nc = -(-S // Q)
    pairs = nc * Q * (Q + 1) / 2  # within-chunk causal pairs
    in_proj = 2 * S * d * (2 * di + 2 * G * N + H)
    conv = 2 * S * C * k
    cb = 2 * G * N * pairs  # C . B
    y_diag = 2 * H * P * pairs
    states = 2 * H * P * N * nc * Q  # chunk states
    y_off = 2 * H * P * N * nc * Q  # carried-state readout
    out_proj = 2 * S * di * d
    layer = in_proj + conv + cb + y_diag + states + y_off + out_proj
    return cfg["n_layers"] * layer + 2 * S * d * V


FORWARD = {"dense": dense_forward, "ssm": ssm_forward}


def train_step(cfg: dict, traffic: dict) -> float:
    """FLOPs of one coded training step: fwd + bwd of the real coded rows."""
    rows = (traffic["s"] + 1) * traffic["k"] * traffic["part_mb"]
    return 3.0 * rows * FORWARD[cfg["family"]](cfg, traffic["seq_len"])


def ssd_scan_bytes(B: int, S: int, H: int, P: int, G: int, N: int, bc_bytes: int) -> int:
    """One ssd_scan call: x (B,S,H,P) f32 and dA (B,S,H) f32 read, B and C
    (B,S,G,N) read in their dtype, y (B,S,H,P) f32 and the final state h
    (B,H,P,N) f32 written, each byte once."""
    return 4 * B * S * H * P + 4 * B * S * H + 2 * bc_bytes * B * S * G * N \
        + 4 * B * S * H * P + 4 * B * H * P * N
