"""The dense LM of the port (the dense family of ``src/repro/models/lm.py``).

Parameters are a flat ``dict[str, Tensor]`` whose keys are the JAX pytree
paths joined by dots (``"blocks.0.attn.wq"``) and whose insertion order is
JAX's flatten order (dict keys sorted, tuples in order).  So the weight
converter (:func:`params_from_numpy` / :func:`params_to_numpy`) is a
key-for-key copy, and raveling the dict in order reproduces
``jax.flatten_util.ravel_pytree``.  The per-period block parameters keep
the JAX stacking: leaves are ``(n_rep, ...)``, one row per repeat.

Only the dense family is ported; the MoE, SSM, hybrid, VLM and audio
families raise ``NotImplementedError`` (ROADMAP Queue 1, "other model
families").  Activation checkpointing (``remat="full"``) is not applied:
at the launcher's sequence length of 64 the activations are small.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward
from repro_torch.models.layers import dense_init, embed_init, mlp, rms_norm

Params = dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """Dense decoder-only LM over explicit parameter dicts."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                "(ROADMAP Queue 1: the other model families)"
            )
        if cfg.act != "silu" or cfg.window is not None:
            raise NotImplementedError(
                f"{cfg.name}: only SiLU MLPs and full causal attention are ported "
                "(every dense config uses them)"
            )
        self.cfg = cfg
        # dense: every layer is attention + MLP, so the period block is one
        # layer and its leaves stack all n_layers (JAX: blocks = (block,))
        self.n_rep = cfg.n_layers
        self.dtype = _DTYPES[cfg.dtype]

    # -- init ----------------------------------------------------------------

    def init(self, gen: torch.Generator, device: torch.device | str = "cuda") -> Params:
        """Random weights from ``gen`` (a generator on ``device``), with the
        JAX package's distributions and layout."""
        cfg, dt, dev = self.cfg, self.dtype, torch.device(device)
        d, hd, n = cfg.d_model, cfg.resolved_head_dim, self.n_rep

        def stacked(shape):
            return dense_init(gen, (n, *shape), dt, dev, scale=(1.0 / shape[0]) ** 0.5)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        block = {
            "mixer_norm": {"scale": ones(n, d)},
            "attn": {
                "wq": stacked((d, cfg.n_heads * hd)),
                "wk": stacked((d, cfg.n_kv_heads * hd)),
                "wv": stacked((d, cfg.n_kv_heads * hd)),
                "wo": stacked((cfg.n_heads * hd, d)),
            },
            "mlp_norm": {"scale": ones(n, d)},
            "mlp": {
                "w_gate": stacked((d, cfg.d_ff)),
                "w_up": stacked((d, cfg.d_ff)),
                "w_down": stacked((cfg.d_ff, d)),
            },
        }
        if cfg.qkv_bias:
            for b, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
                block["attn"][b] = torch.zeros((n, width * hd), dtype=dt, device=dev)
        tree = {
            "embed": embed_init(gen, (cfg.vocab, d), dt, dev),
            "blocks": (block,),
            "final_norm": {"scale": ones(d)},
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = embed_init(gen, (d, cfg.vocab), dt, dev)
        return flatten_tree(tree)

    @staticmethod
    def param_count(params: Params) -> int:
        return sum(int(math.prod(p.shape)) for p in params.values())

    # -- forward -------------------------------------------------------------

    def forward(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) in the parameter dtype."""
        cfg = self.cfg
        x = F.embedding(batch["tokens"].long(), params["embed"])
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        # one unbind per stacked leaf: its backward stacks the per-layer
        # grads once, instead of a full-size scatter per layer
        prefix = "blocks.0."
        layers = {
            name[len(prefix):]: leaf.unbind(0)
            for name, leaf in params.items() if name.startswith(prefix)
        }
        kw = dict(
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        )
        for r in range(self.n_rep):
            attn = {k[len("attn."):]: v[r] for k, v in layers.items() if k.startswith("attn.")}
            mlp_w = {k[len("mlp."):]: v[r] for k, v in layers.items() if k.startswith("mlp.")}
            h = rms_norm(x, layers["mixer_norm.scale"][r], cfg.norm_eps)
            x = x + attention_forward(attn, h, positions, **kw)
            h = rms_norm(x, layers["mlp_norm.scale"][r], cfg.norm_eps)
            x = x + mlp(mlp_w, h)
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


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
