"""Step functions shared by the dry run and the chip smoke test (the port
of ``src/repro/train/steps.py``).

``make_fused_train_step`` is the production coded training step: weighted
forward and backward (the encode and decode live in ``batch["weight"]``,
see ``core/aggregator.py``) and AdamW.  ``accum_steps`` > 1 runs the batch
in that many sequential chunks along its leading dim, in order, with the
loss and f32 gradients accumulated: the memory lever (the checkpointed
repeats' boundary activations live for one chunk only).

On DTensor parameters and batches (``models/sharding.py``) the step runs
under implicit replication (plain tensors such as rope angles and masks
count as replicated), each gradient is put back on its parameter's
placements before the optimizer reads it, as the JAX jit's out-shardings
do; a chunk is the same rows of the whole batch as on one process.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import TrainConfig
from repro_torch.models.lm import LM
from repro_torch.optim.adam import AdamWState, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["make_fused_train_step"]

Params = dict[str, torch.Tensor]


def _chunks(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` split along dim 0 into ``n`` chunks, in order.  A DTensor
    sharded on dim 0 is gathered whole once and each chunk placed back on
    its placements (a chunk is rows i·B/n .. (i+1)·B/n of the whole batch,
    as in JAX: the MoE load-balance loss, a batch mean, depends on which
    rows share a chunk)."""
    if isinstance(x, DTensor):
        mesh, pl = x.device_mesh, x.placements
        x = x.redistribute(mesh, [Replicate() if p.is_shard(0) else p for p in pl])
    chunks = x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)
    return [c.redistribute(mesh, pl) for c in chunks] if isinstance(x, DTensor) else list(chunks)


def _on_spec(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(model: LM, params: Params, batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The weighted loss of ``batch`` and its gradients, in the params'
    order and dtypes."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = model.weighted_loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), list(grads)


def accumulate(acc: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """One chunk's gradients added to the f32 accumulators."""
    return [a + _on_spec(g, a).float() for a, g in zip(acc, grads)]


def apply_update(params: Params, opt: AdamWState, grads: list[torch.Tensor], step: int,
                 tc: TrainConfig):
    """The gradients put on their parameters' placements, the lr, the global
    norm and AdamW (in place); returns (params, opt, grad_norm, lr)."""
    grads = {k: _on_spec(g, p) for (k, p), g in zip(params.items(), grads)}
    lr = cosine_warmup(step, base_lr=tc.lr, warmup_steps=tc.warmup_steps,
                       total_steps=tc.total_steps)
    gnorm = global_norm(grads)
    params, opt = adamw_update(
        params, grads, opt,
        lr=float(lr), beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
        weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
    )
    return params, opt, gnorm, lr


def make_fused_train_step(model: LM, tc: TrainConfig, accum_steps: int = 1):
    """``step_fn(params, opt, batch, step) -> (params, opt, {"loss",
    "grad_norm", "lr"})``; params and the optimizer state are updated in
    place, as ``optim/adam.py`` does."""

    def step_fn(params: Params, opt: AdamWState, batch: dict, step: int):
        sharded = any(isinstance(p, DTensor) for p in params.values())
        with implicit_replication() if sharded else contextlib.nullcontext():
            if accum_steps == 1:
                loss, grads = value_and_grad(model, params, batch)
            else:
                chunks = {k: _chunks(v, accum_steps) for k, v in batch.items()}
                loss = None
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in params.values()]
                for i in range(accum_steps):
                    l, g = value_and_grad(model, params, {k: v[i] for k, v in chunks.items()})
                    loss = l if loss is None else loss + l
                    grads = accumulate(grads, g)
            params, opt, gnorm, lr = apply_update(params, opt, grads, step, tc)
        return params, opt, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step_fn
