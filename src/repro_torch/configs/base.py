"""Config system: architecture + shape + run configs (plain dataclasses)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Every assigned arch is an instance of this."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int  # dense MLP width (per-expert width lives in expert_d_ff)
    vocab: int
    # attention
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0  # chatglm "2d" RoPE rotates half the dims
    position_embedding: str = "rope"  # "rope" | "nope" (granite: no positional embedding)
    attention_multiplier: float = 0.0  # the score scale; 0 -> head_dim ** -0.5
    qkv_bias: bool = False
    window: int | None = None  # sliding-window attention (mixtral)
    causal: bool = True
    encoder_only: bool = False  # hubert: no decode step exists
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_every: int = 1  # MoE replaces the dense MLP every N layers
    aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # "dense": GShard one-hot dispatch (GSPMD-friendly, the distributed
    # default); "sort": argsort/scatter dispatch (lean single-device form);
    # "dropless": every (token, choice) pair on a held expert computed, no
    # capacity (granite; models/moe.py::moe_apply_dropless)
    moe_dispatch: str = "dense"
    # expert parallelism: this chip holds experts [expert_offset,
    # expert_offset + experts_held) of n_experts (0: all of them); the
    # router still scores all n_experts
    experts_held: int = 0
    expert_offset: int = 0
    shared_d_ff: int = 0  # a shared SwiGLU expert beside the routed ones (0: none)
    # SSM (mamba2 / SSD)
    ssm_d_inner: int = 0
    ssm_heads: int = 0
    ssm_state: int = 0
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # hybrid (jamba): attention layer every `attn_period` layers (else mamba)
    attn_period: int = 0  # 0 -> pure per-family default
    attn_offset: int = 0
    # frontend stubs
    frontend: str | None = None  # "vision" | "audio"
    n_patches: int = 256  # vision stub: patch embeddings prepended
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    # granite's scalars on the residual path: the embeddings times
    # embedding_multiplier, each branch times residual_multiplier before
    # its residual add, the logits divided by logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" — activation checkpointing per layer

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def rotary_dim(self) -> int:
        """The rotated width of a head: 0 without positional embedding."""
        if self.position_embedding == "nope":
            return 0
        hd = self.resolved_head_dim
        r = int(hd * self.rotary_fraction)
        return r - (r % 2)

    @property
    def attn_scale(self) -> float:
        return self.attention_multiplier or self.resolved_head_dim ** -0.5

    @property
    def n_held(self) -> int:
        """Experts held here: ``experts_held``, or every expert."""
        return self.experts_held or self.n_experts

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def supports_long_context(self) -> bool:
        """long_500k needs sub-quadratic attention state: SSM/hybrid, or SWA."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def reduced(self) -> "ModelConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        def shrink(v, lo, cap):
            return max(lo, min(v, cap))

        return dataclasses.replace(
            self,
            n_layers=shrink(self.n_layers, 2, 4 if self.attn_period == 0 else 2 * max(self.attn_period, self.moe_every)),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            expert_d_ff=128 if self.expert_d_ff else 0,
            # a share of the experts stays a share: 1 of the 4
            experts_held=1 if self.experts_held else 0,
            expert_offset=0,
            shared_d_ff=128 if self.shared_d_ff else 0,
            # no token dropping at toy scale so prefill/decode tests are exact
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            ssm_d_inner=256 if self.ssm_d_inner else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_chunk=8,
            window=min(self.window, 16) if self.window else None,
            n_patches=8,
            dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch × shape) is a runnable dry-run cell; reason if skipped.
    Skip rules are recorded in DESIGN.md §Arch-applicability."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch; 500k KV cache is not sub-quadratic"
    return True, ""


@dataclasses.dataclass(frozen=True)
class CodingConfig:
    """Gradient-coding runtime config (the paper's knobs)."""

    scheme: str = "heter_aware"  # heter_aware | group_based | cyclic | naive | fractional_repetition
    s: int = 1  # designed straggler tolerance
    partitions_per_worker: int = 2  # k = m * this (granularity of allocation)
    coding_axes: tuple[str, ...] = ("data",)  # mesh axes that form coded workers
    rebalance_every: int = 50  # steps between c_i re-estimation checks
    deadline_factor: float = 3.0  # straggler if step_time > factor * median
    compress: bool = False  # int8 wire compression (faithful path)
    # fused Pallas wire kernels for the compress path: None = decide on the
    # measuring host (on only where the fused encode beat the unfused
    # composition — repro_torch.kernels.autotune.wire_kernel_default)
    wire_kernel: bool | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    fsdp: bool = False  # ZeRO-style sharding of params/optimizer over 'data'
    seed: int = 0
