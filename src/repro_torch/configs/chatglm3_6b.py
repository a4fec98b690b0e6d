"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2, QKV bias.
[arXiv:2406.12793; hf]  28L d_model=4096 32H kv=2 d_ff=13696 vocab=65024."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rotary_fraction=0.5,  # chatglm rotates only half of each head dim ("2d" RoPE)
    qkv_bias=True,
)
