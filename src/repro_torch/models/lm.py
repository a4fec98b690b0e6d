"""The LM of the port (``src/repro/models/lm.py``): every family of the
JAX package's configs (dense, moe, ssm, hybrid, vlm, audio).

Parameters are a flat ``dict[str, Tensor]`` whose keys are the JAX pytree
paths joined by dots (``"blocks.0.attn.wq"``) and whose insertion order is
JAX's flatten order (dict keys sorted, tuples in order).  So the weight
converter (:func:`params_from_numpy` / :func:`params_to_numpy`) is a
key-for-key copy, mixed dtypes included, and raveling the dict in order
reproduces ``jax.flatten_util.ravel_pytree``.  As in JAX, a per-layer
*plan* (:func:`layer_plan`) repeats with a period (:func:`plan_period`);
``blocks.j`` holds the j-th layer of the period with its leaves stacked
``(n_rep, ...)``, one row per repeat.

A layer's mixer is attention (a sliding window where the config has one)
or a mamba2 block, and its MLP dense (SiLU or GELU), MoE (``models/moe.py``,
the form that ``cfg.moe_dispatch`` names) or none; jamba's period of 8 mixes
all four.  Granite's layers (HF ``GraniteMoeHybridDecoderLayer``) add a
shared SwiGLU expert to the MoE's output (``cfg.shared_d_ff``), hold a
share of the experts (``cfg.experts_held``, the dropless form), and scale
the embeddings, each branch before its residual add and the logits
(``cfg.embedding_multiplier``, ``residual_multiplier``,
``logits_scaling``).  The MoE load-balance loss is each layer's mean over
batch rows, summed over layers, and ``seq_losses`` adds ``aux_coef`` times
it to every sequence.  Frontends are the JAX package's stubs: audio takes ``frames``
(B, S, d) and has no ``embed`` leaf; vision prepends ``patches`` (B,
n_patches, d) to the token embeddings, and its labels cover the text span.
Activation checkpointing: with ``remat="full"`` (every full config; the
reduced ones set ``"none"``) a training forward with grad enabled runs each
layer under ``torch.utils.checkpoint`` (non-reentrant): only the layer's
input is kept, and the layer runs again in the backward.  At a period of
one layer that is JAX's ``jax.checkpoint`` of its scan body; a longer
period (jamba's 8, granite's 10) keeps one input a layer where JAX keeps
one a repeat, and computes the same numbers.  Serving (prefill, decode) is
never checkpointed.

Device regions: with a tracer installed (``LM.tracer``, the trainer's) the
training path records ``device.embed``, per layer ``device.mixer`` (from
the mixer's norm through its output projection; ``kind`` ``attn`` or
``ssd`` with the shape that sets its work) and ``device.mlp`` (a dropless
MoE's with the routing's shape, ``impl`` and ``pairs``, the pairs routed to
held experts, a device count read once the step has synchronized), and
``device.head_loss`` (final norm, logits, log-softmax, NLL and the
weighted sum), each in its forward, recompute and backward pass
(:meth:`repro_torch.obs.trace.Tracer.device_span`); with a dropless MoE,
the counter ``moe.expert_load_max`` once a step
(:meth:`LM._record_expert_load`).  Tracing off adds no autograd node and
the gradients are bit-equal either way.

Sharding: :meth:`LM.param_specs` and :meth:`LM.fsdp_specs` give each
parameter's layout as a tuple of mesh-axis names a dim (JAX's
``PartitionSpec``), which ``models/sharding.py`` turns into DTensor
placements; the forward then runs on DTensor parameters and batches, with
``shard_batch`` anchoring the batch dim where the JAX model does.

Serving: :meth:`LM.prefill` (the flash-attention kernel and the SSD kernel
forward-only on the card), :meth:`LM.decode_step` and the slot cache
(:meth:`LM.empty_slot_cache`, :meth:`LM.cache_insert_slot`,
:meth:`LM.cache_evict_slot`).  A cache is a flat dict like the parameters:
the JAX cache tree's dotted keys (``"layers.0.k"``, ``"layers.0.h"``,
``"pos"``), each layer leaf stacked ``(n_rep, B, ...)``; its converter is
:func:`cache_from_numpy` / :func:`cache_to_numpy`.  They run under
``torch.inference_mode()`` and update caches in place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_decode, attention_forward
from repro_torch.models.layers import dense_init, embed_init, mlp, rms_norm
from repro_torch.models.moe import init_moe, moe_apply, moe_apply_dense, moe_apply_dropless
from repro_torch.models.sharding import (embedding, gather_data_shards, reduce_partial,
                                         shard_batch, unshard_dim)
from repro_torch.models.ssm import init_mamba, mamba_decode, mamba_forward
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER

Params = dict[str, torch.Tensor]
Cache = dict[str, torch.Tensor]
Spec = tuple  # one entry a dim: a mesh-axis name, a tuple of them, or None

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def _sub(bp: dict[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The leaves of a layer under ``prefix``, named below it."""
    return {k[len(prefix):]: v for k, v in bp.items() if k.startswith(prefix)}


class LM:
    """The LM over explicit parameter dicts, every family.

    ``ssd_impl`` picks the SSD scan of the mamba layers (``kernels.ops``):
    None for the kernel on a CUDA tensor and the plain version on a CPU
    one, ``"torch"`` for the plain version anywhere.  ``attn_impl`` picks
    the attention of :meth:`prefill` the same way (the flash kernel or its
    plain version) and of :meth:`forward`, the training path: the training
    kernels (forward and backward) where ``attention.train_kernel`` admits
    the tensors, the model's own chain otherwise and with ``"torch"``.
    Decode runs plain attention over the cache."""

    def __init__(self, cfg: ModelConfig, ssd_impl: str | None = None,
                 attn_impl: str | None = None):
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.period = plan_period(self.plan)
        self.n_rep = cfg.n_layers // self.period
        self.dtype = _DTYPES[cfg.dtype]
        self.ssd_impl = ssd_impl
        self.attn_impl = attn_impl
        self.tracer = NULL_TRACER  # the trainer installs its own
        self._loads: list[torch.Tensor] = []  # a traced forward's held-expert pair counts

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
        if spec.mlp != "none":
            block["mlp_norm"] = {"scale": torch.ones((n, d), dtype=dt, device=dev)}
        if spec.mlp == "moe":
            block["moe"] = init_moe(gen, n, d, cfg.n_experts, cfg.expert_d_ff, dt, dev,
                                    held=cfg.experts_held or None)
            if cfg.shared_d_ff:
                block["shared"] = {
                    "w_gate": stacked((d, cfg.shared_d_ff)),
                    "w_up": stacked((d, cfg.shared_d_ff)),
                    "w_down": stacked((cfg.shared_d_ff, d)),
                }
        elif spec.mlp == "dense":
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
            "blocks": blocks,
            "final_norm": {"scale": torch.ones((cfg.d_model,), dtype=dt, device=dev)},
        }
        if cfg.frontend != "audio":
            tree["embed"] = embed_init(gen, (cfg.vocab, cfg.d_model), dt, dev)
        if not cfg.tie_embeddings or cfg.frontend == "audio":
            tree["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab), dt, dev)
        return flatten_tree(tree)

    @staticmethod
    def param_count(params: Params) -> int:
        return sum(int(math.prod(p.shape)) for p in params.values())

    # -- forward -------------------------------------------------------------

    def _apply_block(
        self, spec: LayerSpec, bp: dict[str, torch.Tensor], x: torch.Tensor,
        positions: torch.Tensor, mode: str = "train", cache: dict | None = None,
        pos: torch.Tensor | None = None, cache_len: int | None = None, layer: int = 0,
    ) -> tuple[torch.Tensor, torch.Tensor | None, dict | None]:
        """One layer (``layer``, its index in the model) in ``mode``
        "train", "prefill" (also returns the layer's decode cache, padded
        to ``cache_len``) or "decode" (one token at ``pos`` against
        ``cache``).  Returns (x, the MoE layer's load-balance loss averaged
        over batch rows or None, the layer's cache or None)."""
        cfg = self.cfg
        traced = self.tracer.enabled and mode == "train"
        region = self._mixer_span(spec, x, layer) if traced else NULL_SPAN
        with region:
            # the input marker takes the residual's branch too: on the norm's
            # branch alone it would sum the norm's gradients before the
            # residual's and change their bits where x has three consumers
            # (f32, whose .float() is x itself); the residual's arrives first,
            # so the backward span closes at the same point
            x = region.input(x)
            out, new_cache = self._mixer(spec, bp, x, positions, mode, cache, pos, cache_len,
                                         region)
            out = region.output(out)
        # a row-parallel output (wo, out_proj, w_down over 'model') is a
        # pending sum: reduced here, as Megatron's all-reduce, so the norm
        # and the next projections see whole activations (no-op unsharded)
        x = x + self._branch(reduce_partial(out))
        aux = None
        if spec.mlp != "none":
            x = shard_batch(x)  # pins the MLP input's gradient (see sharding.py)
            region = self._mlp_span(spec, x, layer) if traced else NULL_SPAN
            with region:
                x = region.input(x)
                h = rms_norm(x, bp["mlp_norm.scale"], cfg.norm_eps)
                if spec.mlp == "moe":
                    y, a = self._moe(bp, h, region)
                    aux = a.mean()
                else:
                    y = mlp(_sub(bp, "mlp."), h, cfg.act)
                y = region.output(y)
            x = x + self._branch(reduce_partial(y))
        return x, aux, new_cache

    def _branch(self, y: torch.Tensor) -> torch.Tensor:
        """A branch's output on its way to the residual add."""
        rm = self.cfg.residual_multiplier
        return y if rm == 1.0 else y * rm

    def _moe(self, bp: dict[str, torch.Tensor], h: torch.Tensor, region=NULL_SPAN):
        """The MoE on the normed input ``h`` in the form ``cfg.moe_dispatch``
        names, plus the shared expert where the config has one: (y, aux
        (B,)).  The dropless form sets ``pairs`` on ``region`` and keeps its
        counts for the step's ``moe.expert_load_max`` when traced."""
        cfg = self.cfg
        if cfg.moe_dispatch == "dropless":
            y, a, counts = moe_apply_dropless(_sub(bp, "moe."), h, top_k=cfg.top_k,
                                              offset=cfg.expert_offset, act=cfg.act)
            if region is not NULL_SPAN:
                region.set(pairs=self.tracer.device_value(counts.sum()))
                self._loads.append(counts)
        else:
            moe_fn = moe_apply_dense if cfg.moe_dispatch == "dense" else moe_apply
            y, a = moe_fn(_sub(bp, "moe."), h, top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor, act=cfg.act)
        if cfg.shared_d_ff:
            y = y + mlp(_sub(bp, "shared."), h, cfg.act)
        return y, a

    def _record_expert_load(self) -> None:
        """The counter ``moe.expert_load_max`` of a traced forward: in each
        dropless MoE layer the most pairs a held expert got over the held
        experts' mean (1 where none got any), the largest over the layers.
        A device value, recorded once the step has synchronized."""
        if self._loads:
            c = torch.stack(self._loads).float()  # (layers, held)
            mean = c.mean(1)
            load = torch.where(mean > 0, c.amax(1) / mean.clamp(min=1e-30), torch.ones_like(mean))
            self.tracer.device_counter("moe.expert_load_max", load.amax())
        self._loads = []

    def _mixer(self, spec: LayerSpec, bp: dict[str, torch.Tensor], x: torch.Tensor,
               positions: torch.Tensor, mode: str, cache: dict | None, pos: torch.Tensor | None,
               cache_len: int | None, region=NULL_SPAN):
        """The mixer's norm, attention or mamba2 block and output projection:
        (out, the layer's cache or None).  Training attention sets which
        implementation ran on ``region``, the layer's ``device.mixer``
        span, as ``impl``; the SSD which backward its scan gets, as
        ``bwd_impl``."""
        cfg = self.cfg
        h = rms_norm(x, bp["mixer_norm.scale"], cfg.norm_eps)
        if spec.mixer == "attn":
            kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                      rotary_dim=cfg.rotary_dim, rope_theta=cfg.rope_theta, window=cfg.window,
                      scale=cfg.attn_scale)
            if mode == "decode":
                out, new_cache = attention_decode(_sub(bp, "attn."), h, cache, pos, **kw)
            else:
                prefill = mode == "prefill"
                out, new_cache = attention_forward(
                    _sub(bp, "attn."), h, positions, causal=cfg.causal, return_cache=prefill,
                    cache_len=cache_len, flash=prefill, impl=self.attn_impl, region=region,
                    **kw,
                )
        else:
            kw = dict(d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                      n_groups=cfg.ssm_groups)
            if mode == "decode":
                out, new_cache = mamba_decode(_sub(bp, "mamba."), h, cache, **kw)
            else:
                out, new_cache = mamba_forward(
                    _sub(bp, "mamba."), h, chunk=cfg.ssm_chunk, impl=self.ssd_impl,
                    return_cache=(mode == "prefill"), region=region, **kw,
                )
        return out, new_cache

    # -- device regions of a traced training step ------------------------------

    def _mixer_span(self, spec: LayerSpec, x: torch.Tensor, layer: int):
        """``device.mixer`` with the shape that sets its work: attention's
        (B, S, d_model, heads, kv heads, head_dim, window; the attention
        sets ``impl``, "kernel" or "plain"), or the SSD's
        ``ssd_scan`` call (B, S, H, P, G, N, its chunk and the bytes of a
        B/C element; the scan pads S to a multiple of the chunk)."""
        cfg = self.cfg
        B, S = int(x.shape[0]), int(x.shape[1])
        if spec.mixer == "attn":
            shape = dict(kind="attn", B=B, S=S, d_model=cfg.d_model, heads=cfg.n_heads,
                         kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                         window=cfg.window)
        else:
            shape = dict(kind="ssd", B=B, S=S, H=cfg.ssm_heads,
                         P=cfg.ssm_d_inner // cfg.ssm_heads, G=cfg.ssm_groups, N=cfg.ssm_state,
                         chunk=cfg.ssm_chunk, bc_bytes=x.element_size())
        return self.tracer.device_span("device.mixer", device=x.device, layer=layer, **shape)

    def _mlp_span(self, spec: LayerSpec, x: torch.Tensor, layer: int):
        """``device.mlp``; a dropless MoE's also with the routing's shape
        (``experts``, ``held``, ``top_k``, ``expert_d_ff``, ``shared_d_ff``)
        and ``impl`` "grouped", the route the model runs, which takes no
        synchronize (the MoE sets ``pairs``)."""
        cfg = self.cfg
        d_ff = cfg.expert_d_ff if spec.mlp == "moe" else cfg.d_ff
        extra = {}
        if spec.mlp == "moe" and cfg.moe_dispatch == "dropless":
            extra = dict(experts=cfg.n_experts, held=cfg.n_held, top_k=cfg.top_k,
                         expert_d_ff=cfg.expert_d_ff, shared_d_ff=cfg.shared_d_ff,
                         impl="grouped")
        return self.tracer.device_span("device.mlp", device=x.device, layer=layer, kind=spec.mlp,
                                       B=int(x.shape[0]), S=int(x.shape[1]),
                                       d_model=cfg.d_model, d_ff=d_ff, **extra)

    def _layers(self, params: Params) -> list[dict[str, torch.Tensor]]:
        """Per layer of the period, its stacked leaves under their names
        below ``blocks.j.`` (a stacked dim sharded by FSDP gathered whole)."""
        out = []
        for j in range(self.period):
            prefix = f"blocks.{j}."
            out.append({n[len(prefix):]: unshard_dim(v) for n, v in params.items()
                        if n.startswith(prefix)})
        return out

    def _embed(self, params: Params, batch: dict[str, torch.Tensor],
               mark=lambda w: w) -> torch.Tensor:
        """(B, S, d): audio frames in the model dtype; token embeddings,
        with a vision prompt's patch embeddings ahead of them.  ``mark``
        takes the embedding table on its way into the lookup."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            return batch["frames"].to(self.dtype)
        tok = self._scale_embed(reduce_partial(embedding(batch["tokens"].long(),
                                                         mark(params["embed"]))))
        if cfg.frontend == "vision":
            return torch.cat([batch["patches"].to(tok.dtype), tok], dim=1)
        return tok

    def _scale_embed(self, tok: torch.Tensor) -> torch.Tensor:
        m = self.cfg.embedding_multiplier
        return tok if m == 1.0 else tok * m

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        head = params["lm_head"] if "lm_head" in params else params["embed"].t()
        logits = x @ head
        s = self.cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    def forward(
        self, params: Params, batch: dict[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, S_total, V) in the parameter dtype, the MoE
        load-balance loss summed over layers, f32 0-d)."""
        params = {k: gather_data_shards(v) for k, v in params.items()}  # FSDP's gather
        x, aux = self._trunk(params, batch)
        x = rms_norm(x, params["final_norm.scale"], self.cfg.norm_eps)
        return self._logits(params, x), aux

    def _trunk(
        self, params: Params, batch: dict[str, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The embedding and every layer: (x before the final norm, the MoE
        load-balance loss summed over layers)."""
        cfg = self.cfg
        tr = self.tracer
        if tr.enabled:
            lead = batch["frames" if cfg.frontend == "audio" else "tokens"].shape
            region = tr.device_span("device.embed", device=params["final_norm.scale"].device,
                                    B=int(lead[0]), S=int(lead[1]), d_model=cfg.d_model,
                                    vocab=cfg.vocab)
        else:
            region = NULL_SPAN
        with region:
            x = region.output(self._embed(params, batch, region.input))
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        self._loads = []
        # one unbind per stacked leaf: its backward stacks the per-layer
        # grads once, instead of a full-size scatter per layer
        blocks = [{k: v.unbind(0) for k, v in layer.items()} for layer in self._layers(params)]

        def layer(x, j, r):
            x = shard_batch(x)  # re-anchor the batch sharding each block
            x, a, _ = self._apply_block(self.plan[j], {k: v[r] for k, v in blocks[j].items()},
                                        x, positions, layer=r * self.period + j)
            return x, a

        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for r in range(self.n_rep):
            for j in range(self.period):
                if remat:
                    # the model draws no random numbers: no RNG state to
                    # keep, and keeping the card's costs a host-device round trip
                    x, a = checkpoint(layer, x, j, r, use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    x, a = layer(x, j, r)
                if a is not None:
                    aux = aux + a
        return shard_batch(x), aux  # pins the head's input gradient (see sharding.py)

    def seq_losses(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-sequence mean CE plus ``aux_coef`` x the MoE loss, shape (B,):
        next-token CE over the text span (a vision prompt's patch positions
        carry no labels); an encoder-only model's frame-level CE unshifted."""
        return self._losses(params, batch, None)

    def weighted_loss(self, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ_b weight_b · seq_loss_b — the coded-DP training objective."""
        return self._losses(params, batch, batch["weight"])

    def _losses(self, params: Params, batch: dict[str, torch.Tensor],
                weight: torch.Tensor | None) -> torch.Tensor:
        """:meth:`seq_losses`, or with ``weight`` their weighted sum; the
        head and the loss are the ``device.head_loss`` region."""
        cfg = self.cfg
        params = {k: gather_data_shards(v) for k, v in params.items()}  # FSDP's gather
        x, aux = self._trunk(params, batch)
        tr = self.tracer
        region = tr.device_span("device.head_loss", device=x.device, B=int(x.shape[0]),
                                S=int(x.shape[1]), d_model=cfg.d_model,
                                vocab=cfg.vocab) if tr.enabled else NULL_SPAN
        with region:
            x = rms_norm(region.input(x), params["final_norm.scale"], cfg.norm_eps)
            logits, labels = self._logits(params, x), batch["labels"]
            if cfg.frontend == "vision":
                logits = logits[:, cfg.n_patches:]
            if not cfg.encoder_only:
                logits, labels = logits[:, :-1], labels[:, 1:]
            valid = labels >= 0
            lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
            logp = torch.log_softmax(logits.float(), dim=-1)
            # logp at each label: nll_loss picks the same values as a gather,
            # and its backward is one op that DTensor shards by the batch rows
            # (a gather's composite backward makes a zero tensor of the whole
            # batch on every rank)
            ll = -F.nll_loss(logp.flatten(0, -2), lab.flatten(), reduction="none").view(lab.shape)
            ce = -(ll * valid).sum(-1) / valid.sum(-1).clamp(min=1)
            loss = ce + cfg.aux_coef * aux
            if weight is not None:
                loss = (loss * weight).sum()
            loss = region.output(loss)
        if tr.enabled:
            self._record_expert_load()
        return loss

    # -- serving: prefill, decode and the slot cache ---------------------------

    @torch.inference_mode()
    def prefill(
        self, params: Params, batch: dict[str, torch.Tensor], cache_len: int
    ) -> tuple[torch.Tensor, Cache]:
        """Returns (last-position logits (B, V), cache).  The cache holds
        each layer's leaves stacked ``(n_rep, B, ...)`` under the JAX cache
        tree's dotted keys (``"layers.j.k"``, ``"layers.j.h"``) and
        ``"pos"``, the prompt length (a vision prompt's patches included)
        as a 0-d int32 tensor.  A sliding-window layer's cache is its ring
        of ``window`` rows whatever ``cache_len`` is."""
        cfg = self.cfg
        params = {k: gather_data_shards(v) for k, v in params.items()}
        x = self._embed(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        per_layer: list[list[dict]] = [[] for _ in range(self.period)]
        layers = self._layers(params)
        for r in range(self.n_rep):
            for j, layer in enumerate(layers):
                x, _, c = self._apply_block(
                    self.plan[j], {k: v[r] for k, v in layer.items()}, x, positions,
                    mode="prefill", cache_len=cache_len,
                )
                per_layer[j].append(c)
        x = rms_norm(x, params["final_norm.scale"], cfg.norm_eps)
        logits = self._logits(params, x[:, -1])
        cache: Cache = {}
        for j, caches in enumerate(per_layer):
            for name in sorted(caches[0]):
                cache[f"layers.{j}.{name}"] = torch.stack([c[name] for c in caches])
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return logits, cache

    @torch.inference_mode()
    def decode_step(
        self, params: Params, tokens: torch.Tensor, cache: Cache
    ) -> tuple[torch.Tensor, Cache]:
        """One token.  tokens: (B, 1) int.  Returns (logits (B, V), cache).

        ``cache["pos"]`` may be a 0-d tensor (all rows at one position) or
        (B,) (slot-indexed continuous batching: each row at its own
        position).  The layer leaves are updated IN PLACE and returned in a
        new dict with ``pos + 1``, the values the JAX function returns."""
        cfg = self.cfg
        params = {k: gather_data_shards(v) for k, v in params.items()}
        x = self._scale_embed(reduce_partial(embedding(tokens.long(), params["embed"])))
        pos = cache["pos"]
        layers = self._layers(params)
        for r in range(self.n_rep):
            for j, layer in enumerate(layers):
                prefix = f"layers.{j}."
                stacked = {n[len(prefix):]: v for n, v in cache.items() if n.startswith(prefix)}
                x, _, new = self._apply_block(
                    self.plan[j], {k: v[r] for k, v in layer.items()}, x, None,
                    mode="decode", cache={n: v[r] for n, v in stacked.items()}, pos=pos,
                )
                # attention wrote its rows of the stack in place; the mamba
                # state and conv inputs come back new and are copied in
                for n, v in new.items():
                    if v.data_ptr() != stacked[n][r].data_ptr():
                        stacked[n][r].copy_(v)
        x = rms_norm(x, params["final_norm.scale"], cfg.norm_eps)
        return self._logits(params, x[:, 0]), {**cache, "pos": pos + 1}

    @torch.inference_mode()
    def empty_slot_cache(self, params: Params, n_slots: int, cache_len: int) -> Cache:
        """Zeroed decode cache for ``n_slots`` independent requests with a
        per-slot ``pos`` vector, on the parameters' device.  The shapes are
        built here (the KV cache of an attention layer, a ring of ``window``
        rows with a sliding window, the SSM state and
        the conv inputs of a mamba layer; :meth:`cache_shapes`), not traced
        from a prefill."""
        cfg = self.cfg
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only; no decode cache")
        if cfg.frontend == "vision" and cache_len < cfg.n_patches + 1:
            # the JAX package traces a prefill of n_patches + 1 positions
            raise ValueError(f"cache_len {cache_len} cannot hold a vision prompt's "
                             f"{cfg.n_patches} patch positions and a token")
        dev = params["embed"].device
        cache: Cache = {k: torch.zeros(shape, dtype=dt, device=dev)
                        for k, (shape, dt) in self.cache_shapes(n_slots, cache_len).items()}
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return cache

    def cache_shapes(self, batch: int, cache_len: int) -> dict[str, tuple[tuple, torch.dtype]]:
        """Each layer leaf of a decode cache for ``batch`` rows: its key,
        shape ``(n_rep, batch, ...)`` and dtype (``"pos"`` not included)."""
        cfg, n = self.cfg, self.n_rep
        out: dict[str, tuple[tuple, torch.dtype]] = {}
        for j, spec in enumerate(self.plan[: self.period]):
            if spec.mixer == "attn":
                rows = cfg.window if cfg.window is not None else cache_len
                for name in ("k", "v"):
                    out[f"layers.{j}.{name}"] = (
                        (n, batch, rows, cfg.n_kv_heads, cfg.resolved_head_dim), self.dtype)
            else:
                conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                P = cfg.ssm_d_inner // cfg.ssm_heads
                out[f"layers.{j}.conv"] = ((n, batch, cfg.conv_kernel - 1, conv_ch), self.dtype)
                out[f"layers.{j}.h"] = ((n, batch, cfg.ssm_heads, P, cfg.ssm_state),
                                        torch.float32)
        return out

    @staticmethod
    @torch.inference_mode()
    def cache_insert_slot(batch_cache: Cache, req_cache: Cache, slot: int) -> Cache:
        """Write a single-request prefill cache (batch dim 1) into ``slot``
        of a slot cache, in place; returns the slot cache.  Layer leaves are
        stacked (n_rep, B, ...), so the batch dim is axis 1."""
        for name, big in batch_cache.items():
            if name != "pos":
                big[:, slot].copy_(req_cache[name][:, 0])
        batch_cache["pos"][slot] = req_cache["pos"]
        return batch_cache

    @staticmethod
    @torch.inference_mode()
    def cache_evict_slot(batch_cache: Cache, slot: int) -> Cache:
        """Zero one slot (finished or cancelled request), in place; returns
        the slot cache.  Decode never reads an inactive slot's values into
        an active one, but a zero slot keeps stale state from leaking NaN or
        Inf into later occupants."""
        for name, big in batch_cache.items():
            if name != "pos":
                big[:, slot].zero_()
        batch_cache["pos"][slot] = 0
        return batch_cache


    # -- sharding ------------------------------------------------------------

    def _block_specs(self, spec: LayerSpec, tp: str, moe_on_experts: bool) -> dict[str, Spec]:
        """One layer of the period's specs under their names below
        ``blocks.j.``; the leading stacked-layer dim is never sharded."""
        cfg = self.cfg

        def n(*dims):
            return (None, *dims)

        blk = {"mixer_norm.scale": n(None)}
        if spec.mixer == "attn":
            blk |= {"attn.wq": n(None, tp), "attn.wk": n(None, tp), "attn.wv": n(None, tp),
                    "attn.wo": n(tp, None)}
            if cfg.qkv_bias:
                blk |= {"attn.bq": n(tp), "attn.bk": n(tp), "attn.bv": n(tp)}
        else:
            blk |= {f"mamba.{k}": v for k, v in {
                "in_proj": n(None, tp), "conv_w": n(None, tp), "conv_b": n(tp), "A_log": n(tp),
                "D": n(tp), "dt_bias": n(tp), "norm": n(tp), "out_proj": n(tp, None)}.items()}
        if spec.mlp == "dense":
            blk |= {"mlp_norm.scale": n(None), "mlp.w_gate": n(None, tp), "mlp.w_up": n(None, tp),
                    "mlp.w_down": n(tp, None)}
        elif spec.mlp == "moe":
            blk |= {"mlp_norm.scale": n(None), "moe.router": n(None, None)}
            if cfg.shared_d_ff:
                blk |= {"shared.w_gate": n(None, tp), "shared.w_up": n(None, tp),
                        "shared.w_down": n(tp, None)}
            if moe_on_experts:
                blk |= {f"moe.{w}": n(tp, None, None) for w in ("w_gate", "w_up", "w_down")}
            else:
                blk |= {"moe.w_gate": n(None, None, tp), "moe.w_up": n(None, None, tp),
                        "moe.w_down": n(None, tp, None)}
        return blk

    def param_specs(self, tp_axis: str = "model", tp_size: int = 16) -> dict[str, Spec]:
        """Tensor-parallel layout: for each dotted key of the params, the
        mesh axis of each dim (JAX's ``LM.param_specs``).  Column-parallel
        q/k/v, gate and up projections and mamba's inputs, row-parallel
        outputs; MoE weights over experts when ``n_experts % tp_size == 0``,
        else over their hidden width; the vocab dim of the embedding and
        head only when ``vocab % tp_size == 0``, else their d_model dim."""
        cfg = self.cfg
        moe_on_experts = cfg.n_experts > 0 and cfg.n_experts % tp_size == 0
        vocab_ok = cfg.vocab % tp_size == 0
        specs: dict[str, Spec] = {}
        for j in range(self.period):
            for k, v in self._block_specs(self.plan[j], tp_axis, moe_on_experts).items():
                specs[f"blocks.{j}.{k}"] = v
        if cfg.frontend != "audio":
            specs["embed"] = (tp_axis, None) if vocab_ok else (None, tp_axis)
        specs["final_norm.scale"] = (None,)
        if not cfg.tie_embeddings or cfg.frontend == "audio":
            specs["lm_head"] = (None, tp_axis) if vocab_ok else (tp_axis, None)
        return {k: specs[k] for k in sorted(specs, key=self._key_order)}

    def _key_order(self, key: str):
        """Sort key of a dotted parameter key in JAX's flatten order."""
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in key.split(".")]

    @staticmethod
    def fsdp_specs(
        param_shapes: dict[str, tuple[int, ...]], base_specs: dict[str, Spec],
        fsdp_axis: str = "data", fsdp_size: int = 16,
    ) -> dict[str, Spec]:
        """ZeRO-style extension (JAX's ``LM.fsdp_specs``): ``fsdp_axis`` on
        the first unsharded dim of each leaf that ``fsdp_size`` divides (the
        stacked-layer dim included), so per-rank bytes scale with 1/(tp·dp)
        instead of 1/tp.  ``param_shapes`` maps each key to its shape."""
        out = {}
        for key, spec in base_specs.items():
            shape = tuple(param_shapes[key])
            dims = list(spec) + [None] * (len(shape) - len(spec))
            for i, d in enumerate(shape):
                if dims[i] is None and d % fsdp_size == 0 and d >= fsdp_size:
                    dims[i] = fsdp_axis
                    break
            out[key] = tuple(dims)
        return out


def cache_from_numpy(tree, device: torch.device | str = "cuda") -> Cache:
    """A JAX decode cache (``{"layers": ..., "pos": ...}``, numpy leaves) ->
    the port's cache on ``device``, key for key."""
    return params_from_numpy(tree, device)


def cache_to_numpy(cache: Cache):
    """The port's cache -> a tree shaped like the JAX cache, numpy leaves
    (bf16 leaves come back as f32 arrays)."""
    return params_to_numpy(cache)


def build_model(
    cfg: ModelConfig, ssd_impl: str | None = None, attn_impl: str | None = None
) -> LM:
    return LM(cfg, ssd_impl=ssd_impl, attn_impl=attn_impl)
