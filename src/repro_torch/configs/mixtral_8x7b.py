"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]  32L d_model=4096 32H kv=8 d_ff=14336 vocab=32000.

SWA window 4096 bounds the decode KV cache, which is why this arch runs the
long_500k cell (ring-buffer cache of 4096 entries, O(1) in stream length)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=32000,
    n_experts=8,
    top_k=2,
    expert_d_ff=14336,
    moe_every=1,
    window=4096,
)
