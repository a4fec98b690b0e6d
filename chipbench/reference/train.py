"""The reference's training steps and the readings the comparison takes.

Plain data-parallel training on the step's distinct sequences: the loss is
their mean, its gradient the exact gradient that any decodable coded step
must reproduce, whatever the code, the stragglers or the decode vector.
Then global-norm clipping and AdamW with decoupled weight decay on every
leaf, the learning rate warmed up linearly and then on a cosine.

Precision, as the configuration states it: the optimizer keeps f32 master
weights and moments, and the model holds each leaf in the dtype it is
served in (bf16 but a few f32 leaves), so each step's forward reads the
master rounded to that dtype.  Everything is computed in float32 with TF32
off.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from chipbench.reference import family
from chipbench.reference.common import matmul
from chipbench.weights import per_layer


@dataclasses.dataclass
class Readings:
    losses: list[float]  # each step's loss before its update
    grad: dict[str, float]  # each leaf's norm of the first gradient, clipped
    update: dict[str, float]  # each leaf's norm of its change after the steps
    stale: int = 0  # served leaves that are not their master rounded (the program's side)


def lr_at(step: int, tc: dict, min_ratio: float = 0.1) -> float:
    warm, total = max(tc["warmup_steps"], 1), tc["total_steps"]
    if step < tc["warmup_steps"]:
        return tc["lr"] * step / warm
    prog = min(max((step - tc["warmup_steps"]) / max(total - tc["warmup_steps"], 1), 0.0), 1.0)
    return tc["lr"] * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run(model_cfg: dict, tc: dict, served: dict[str, torch.Tensor], steps: list[np.ndarray],
        device: torch.device | str, mm=matmul, keep: float = 1.0) -> Readings:
    """Train from ``served`` (the weights as the program got them) on
    ``steps``, one (n, S) array of distinct token rows a step.  ``mm`` is
    the matmul (the fp8 control passes its own); ``keep`` < 1 trains on
    that share of each step's rows only (a fault the check must catch)."""
    no_tf32()
    fam = family(model_cfg["family"])
    dev = torch.device(device)
    stored = {k: v.dtype for k, v in per_layer(served).items()}
    w0 = {k: v.detach().float() for k, v in per_layer(served).items()}
    master = {k: v.clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w0.items()}
    nu = {k: torch.zeros_like(v) for k, v in w0.items()}
    b1, b2 = tc["beta1"], tc["beta2"]
    losses, grad = [], {}
    for step, rows in enumerate(steps):
        rows = rows[: max(1, int(round(len(rows) * keep)))]
        w = {k: v.to(stored[k]).to(torch.float32, copy=True).requires_grad_(True)
             for k, v in master.items()}
        total = 0.0
        for r in rows:
            loss = fam.seq_loss(w, torch.as_tensor(r, device=dev), model_cfg, mm) / len(rows)
            loss.backward()
            total += loss.item()
        losses.append(total)
        with torch.no_grad():
            g = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in w.items()}
            gnorm = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
            scale = min(1.0, tc["grad_clip"] / (gnorm + 1e-12)) if tc["grad_clip"] else 1.0
            if step == 0:
                grad = {k: float(x.norm()) * scale for k, x in g.items()}
            lr, t = lr_at(step, tc), step + 1
            for k, p in master.items():
                gk = g[k] * scale
                mu[k].mul_(b1).add_((1 - b1) * gk)
                nu[k].mul_(b2).add_((1 - b2) * gk.square())
                mhat, vhat = mu[k] / (1 - b1 ** t), nu[k] / (1 - b2 ** t)
                p.sub_(lr * (mhat / (vhat.sqrt() + tc["eps"]) + tc["weight_decay"] * p))
    with torch.no_grad():
        update = {k: float((master[k] - w0[k]).norm()) for k in master}
    return Readings(losses=losses, grad=grad, update=update)
