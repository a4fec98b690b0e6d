"""granite-4.0-h-small [hybrid] — Mamba2 + attention 9:1, 72 experts top-10
and a shared expert in every layer.
[hf:ibm-granite/granite-4.0-h-small config.json; model_type granitemoehybrid]
40L d_model=4096 32H kv=8 (hd 128, NoPE) expert d_ff=768 shared d_ff=1536
vocab=100352, mamba2 128 heads of 64 (d_inner 8192), state 128, 1 group.

Layers 5, 15, 25 and 35 are attention, the rest Mamba2 (a period of 10,
offset 5); every layer has the MoE (HF ``GraniteMoeHybridDecoderLayer``):
``h = x + 0.22 mixer(norm(x))``, ``out = h + 0.22 (moe(norm(h)) +
shared(norm(h)))``.  The router is a top-10 over 72 logits and a softmax
over the 10, nothing dropped (``moe_dispatch="dropless"``); the port keeps
it in f32.  Embeddings x 12, logits / 16, scores scaled by 1/128, tied
embeddings.  The load-balance term is off (HF adds it only with
``output_router_logits``).  Not in ``ARCHS``: the dry run's list stays the
JAX package's, which has no granite."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab=100352,
    position_embedding="nope",
    attention_multiplier=0.0078125,
    n_experts=72,
    top_k=10,
    expert_d_ff=768,
    moe_every=1,
    aux_coef=0.0,
    moe_dispatch="dropless",
    shared_d_ff=1536,
    attn_period=10,
    attn_offset=5,
    ssm_d_inner=8192,
    ssm_heads=128,
    ssm_state=128,
    ssm_groups=1,
    ssm_chunk=256,
    conv_kernel=4,
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)
