"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128.
d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads, 1 group."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_d_inner=2048,
    ssm_heads=32,
    ssm_state=128,
    ssm_groups=1,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
)
