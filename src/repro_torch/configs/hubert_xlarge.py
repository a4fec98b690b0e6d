"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone.
[arXiv:2106.07447; unverified]  48L d_model=1280 16H kv=16 d_ff=5120 vocab=504.

Per spec, the conv waveform frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, S, d_model).  Encoder-only: bidirectional
attention, frame-level classification head over 504 cluster targets, and no
decode step (decode_32k / long_500k cells are skipped — DESIGN.md §5)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    encoder_only=True,
    frontend="audio",
    act="gelu",
)
