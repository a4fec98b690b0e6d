"""The LM of the port (``src/repro/models/lm.py``): the dense and SSM
families.

Parameters are a flat ``dict[str, Tensor]`` whose keys are the JAX pytree
paths joined by dots (``"blocks.0.attn.wq"``) and whose insertion order is
JAX's flatten order (dict keys sorted, tuples in order).  So the weight
converter (:func:`params_from_numpy` / :func:`params_to_numpy`) is a
key-for-key copy, mixed dtypes included, and raveling the dict in order
reproduces ``jax.flatten_util.ravel_pytree``.  As in JAX, a per-layer
*plan* (:func:`layer_plan`) repeats with a period (:func:`plan_period`);
``blocks.j`` holds the j-th layer of the period with its leaves stacked
``(n_rep, ...)``, one row per repeat.

Ported: dense (attention + SiLU MLP) and ssm (mamba2 mixer, no MLP).  The
MoE, hybrid, VLM and audio families raise ``NotImplementedError`` (ROADMAP
Queue 1).  Activation checkpointing (``remat="full"``) is not applied (ROADMAP
Queue 1): at the launcher's sequence lengths the activations fit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward
from repro_torch.models.layers import dense_init, embed_init, mlp, rms_norm
from repro_torch.models.ssm import init_mamba, mamba_forward

Params = dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_PORTED_FAMILIES = ("dense", "ssm")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "mamba"
    mlp: str  # "dense" | "moe" | "none"


def layer_plan(cfg: ModelConfig) -> tuple[LayerSpec, ...]:
    plan = []
    for l in range(cfg.n_layers):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.family == "hybrid":
            mixer = "attn" if (l % cfg.attn_period) == cfg.attn_offset else "mamba"
        else:
            mixer = "attn"
        if cfg.family in ("moe",):
            m = "moe" if (l % cfg.moe_every) == (cfg.moe_every - 1) else "dense"
        elif cfg.family == "hybrid" and cfg.n_experts:
            m = "moe" if (l % cfg.moe_every) == (cfg.moe_every - 1) else "dense"
        elif cfg.family == "ssm":
            m = "none" if cfg.d_ff == 0 else "dense"
        else:
            m = "dense"
        plan.append(LayerSpec(mixer, m))
    return tuple(plan)


def plan_period(plan: tuple[LayerSpec, ...]) -> int:
    """Smallest p dividing len(plan) with plan repeating at period p."""
    L = len(plan)
    for p in range(1, L + 1):
        if L % p == 0 and all(plan[i] == plan[i % p] for i in range(L)):
            return p
    return L


def flatten_tree(tree, prefix: str = "") -> dict:
    """JAX's flatten order over nested dicts (sorted keys) and tuples/lists,
    as ``{dotted path: leaf}``."""
    out: dict = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(flatten_tree(tree[key], f"{prefix}{key}."))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            out.update(flatten_tree(sub, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    """Inverse of :func:`flatten_tree`: digit path parts become tuples."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, device: torch.device | str = "cuda") -> Params:
    """JAX parameter pytree (leaves as numpy arrays) -> the port's params on
    ``device`` (the card unless the caller asks for the CPU)."""
    return {k: _to_torch(v).to(device) for k, v in flatten_tree(tree).items()}


def params_to_numpy(params: Params):
    """The port's params -> a pytree shaped like the JAX one, numpy leaves
    (bf16 leaves come back as f32 arrays: numpy has no bfloat16)."""
    flat = {}
    for k, v in params.items():
        v = v.detach().cpu()
        flat[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return _unflatten(flat)


class LM:
    """Decoder-only LM over explicit parameter dicts (dense and ssm).

    ``ssd_impl`` picks the SSD scan of the mamba layers (``kernels.ops``):
    None for the kernel on a CUDA tensor and the plain version on a CPU
    one, ``"torch"`` for the plain version anywhere."""

    def __init__(self, cfg: ModelConfig, ssd_impl: str | None = None):
        if cfg.family not in _PORTED_FAMILIES or cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                "(ROADMAP Queue 1: the other model families)"
            )
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.period = plan_period(self.plan)
        self.n_rep = cfg.n_layers // self.period
        if any(s.mixer == "attn" for s in self.plan) and cfg.window is not None:
            raise NotImplementedError(f"{cfg.name}: sliding-window attention is not ported")
        if any(s.mlp == "dense" for s in self.plan) and cfg.act != "silu":
            raise NotImplementedError(f"{cfg.name}: only SiLU MLPs are ported")
        self.dtype = _DTYPES[cfg.dtype]
        self.ssd_impl = ssd_impl

    # -- init ----------------------------------------------------------------

    def _init_block(self, gen: torch.Generator, spec: LayerSpec, dev: torch.device) -> dict:
        """One layer of the period, its leaves stacked over the n_rep repeats."""
        cfg, dt, n = self.cfg, self.dtype, self.n_rep
        d, hd = cfg.d_model, cfg.resolved_head_dim

        def stacked(shape):
            return dense_init(gen, (n, *shape), dt, dev, scale=(1.0 / shape[0]) ** 0.5)

        block: dict = {"mixer_norm": {"scale": torch.ones((n, d), dtype=dt, device=dev)}}
        if spec.mixer == "attn":
            block["attn"] = {
                "wq": stacked((d, cfg.n_heads * hd)),
                "wk": stacked((d, cfg.n_kv_heads * hd)),
                "wv": stacked((d, cfg.n_kv_heads * hd)),
                "wo": stacked((cfg.n_heads * hd, d)),
            }
            if cfg.qkv_bias:
                for b, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
                    block["attn"][b] = torch.zeros((n, width * hd), dtype=dt, device=dev)
        else:
            block["mamba"] = init_mamba(
                gen, n, d, d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads,
                d_state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                conv_kernel=cfg.conv_kernel, dtype=dt, device=dev,
            )
        if spec.mlp == "dense":
            block["mlp_norm"] = {"scale": torch.ones((n, d), dtype=dt, device=dev)}
            block["mlp"] = {
                "w_gate": stacked((d, cfg.d_ff)),
                "w_up": stacked((d, cfg.d_ff)),
                "w_down": stacked((cfg.d_ff, d)),
            }
        return block

    def init(self, gen: torch.Generator, device: torch.device | str = "cuda") -> Params:
        """Random weights from ``gen`` (a generator on ``device``), with the
        JAX package's distributions, layout and dtypes."""
        cfg, dt, dev = self.cfg, self.dtype, torch.device(device)
        blocks = tuple(self._init_block(gen, self.plan[j], dev) for j in range(self.period))
        tree = {
            "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt, dev),
            "blocks": blocks,
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dt, device=dev)},
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab), dt, dev)
        return flatten_tree(tree)

    @staticmethod
    def param_count(params: Params) -> int:
        return sum(int(math.prod(p.shape)) for p in params.values())

    # -- forward -------------------------------------------------------------

    def _apply_block(
        self, spec: LayerSpec, bp: dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor,
    ) -> torch.Tensor:
        cfg = self.cfg

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in bp.items() if k.startswith(prefix)}

        h = rms_norm(x, bp["mixer_norm.scale"], cfg.norm_eps)
        if spec.mixer == "attn":
            x = x + attention_forward(
                sub("attn."), h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rotary_dim=cfg.rotary_dim,
                rope_theta=cfg.rope_theta, causal=cfg.causal,
            )
        else:
            x = x + mamba_forward(
                sub("mamba."), h, d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads,
                d_state=cfg.ssm_state, n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk,
                impl=self.ssd_impl,
            )
        if spec.mlp == "dense":
            h = rms_norm(x, bp["mlp_norm.scale"], cfg.norm_eps)
            x = x + mlp(sub("mlp."), h)
        return x

    def forward(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) in the parameter dtype."""
        cfg = self.cfg
        x = F.embedding(batch["tokens"].long(), params["embed"])
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        # one unbind per stacked leaf: its backward stacks the per-layer
        # grads once, instead of a full-size scatter per layer
        blocks = []
        for j in range(self.period):
            prefix = f"blocks.{j}."
            blocks.append({
                name[len(prefix):]: leaf.unbind(0)
                for name, leaf in params.items() if name.startswith(prefix)
            })
        for r in range(self.n_rep):
            for j, layers in enumerate(blocks):
                x = self._apply_block(
                    self.plan[j], {k: v[r] for k, v in layers.items()}, x, positions
                )
        x = rms_norm(x, params["final_norm.scale"], cfg.norm_eps)
        head = params["lm_head"] if "lm_head" in params else params["embed"].t()
        return x @ head

    def seq_losses(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-sequence mean next-token CE, shape (B,)."""
        logits = self.forward(params, batch)
        labels = batch["labels"]
        if not self.cfg.encoder_only:
            logits, labels = logits[:, :-1], labels[:, 1:]
        valid = labels >= 0
        lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, lab[..., None])[..., 0]
        return -(ll * valid).sum(-1) / valid.sum(-1).clamp(min=1)

    def weighted_loss(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ_b weight_b · seq_loss_b — the coded-DP training objective."""
        return (self.seq_losses(params, batch) * batch["weight"]).sum()


def build_model(cfg: ModelConfig, ssd_impl: str | None = None) -> LM:
    return LM(cfg, ssd_impl=ssd_impl)
