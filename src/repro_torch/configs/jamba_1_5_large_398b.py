"""jamba-1.5-large-398b [hybrid] — Mamba+attention 7:1 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]  72L d_model=8192 64H kv=8 d_ff=24576 vocab=65536.

Period-8 layer pattern: one attention layer per 8 (offset 4, matching the
published interleave), mamba elsewhere; MoE replaces the dense MLP every
2nd layer.  DESIGN.md note: Jamba ships mamba-1 mixers; we substitute
mamba2/SSD blocks (d_inner=2*d, head_dim 64 -> 256 heads, N=128) so one SSM
kernel serves the whole zoo — param count stays within ~2% of 398B."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    expert_d_ff=24576,
    moe_every=2,
    attn_period=8,
    attn_offset=4,
    ssm_d_inner=16384,
    ssm_heads=256,
    ssm_state=128,
    ssm_groups=1,
    ssm_chunk=256,
)
