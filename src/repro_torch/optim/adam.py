"""AdamW with f32 master weights and moments (the port of
``src/repro/optim/adam.py``).

Where the JAX function returns new pytrees, :func:`adamw_update` updates
the parameter, moment and master tensors in place: at full width that
saves one copy of each (about 5 GB for smollm-360m).
"""

from __future__ import annotations

import dataclasses

import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Params  # first moment
    nu: Params  # second moment
    master: Params | None  # f32 master weights (None when params are f32)


def adamw_init(
    params: Params, state_dtype: torch.dtype = torch.float32, keep_master: bool | None = None
) -> AdamWState:
    if keep_master is None:
        keep_master = any(p.dtype != torch.float32 for p in params.values())
    # zeros_like: a DTensor parameter's moments take its placements
    zeros = {k: torch.zeros_like(p, dtype=state_dtype) for k, p in params.items()}
    return AdamWState(
        step=0,
        mu=zeros,
        nu={k: torch.zeros_like(z) for k, z in zeros.items()},
        master={k: p.float().clone() for k, p in params.items()} if keep_master else None,
    )


def global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


@torch.no_grad()
def adamw_update(
    params: Params,
    grads: Params,
    state: AdamWState,
    *,
    lr: float,
    beta1: float = 0.9,
    beta2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 0.0,
) -> tuple[Params, AdamWState]:
    """One AdamW step, in place; returns (params, state) for symmetry with
    the JAX function."""
    step = state.step + 1
    scale = None
    if grad_clip:
        gn = global_norm(grads)
        scale = torch.clamp(grad_clip / (gn + 1e-12), max=1.0)
    f32 = torch.float32
    dev = next(iter(params.values())).device
    t = torch.tensor(float(step), dtype=f32, device=dev)
    c1 = 1.0 - torch.tensor(beta1, dtype=f32, device=dev) ** t
    c2 = 1.0 - torch.tensor(beta2, dtype=f32, device=dev) ** t
    for key, p in params.items():
        g32 = grads[key].float()
        if scale is not None:
            g32 = g32 * scale
        m, v = state.mu[key], state.nu[key]
        m.copy_(beta1 * m.float() + (1 - beta1) * g32)
        v.copy_(beta2 * v.float() + (1 - beta2) * g32.square())
        mhat = m.float() / c1
        vhat = v.float() / c2
        w = state.master[key] if state.master is not None else p
        base = w.float()
        neww = base - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * base)
        if state.master is not None:
            state.master[key].copy_(neww)
        p.copy_(neww)
    state.step = step
    return params, state
