"""internvl2-2b [vlm] — InternViT + InternLM2 backbone.
[arXiv:2404.16821; hf]  24L d_model=2048 16H kv=8 d_ff=8192 vocab=92553.

Per spec, the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, n_patches, d_model) that are prepended to
the token embeddings; the InternViT tower itself is out of scope."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend="vision",
    n_patches=256,
)
