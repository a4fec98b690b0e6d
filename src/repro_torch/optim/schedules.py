"""LR schedules (the port of ``src/repro/optim/schedules.py``), computed in
f32 as the JAX function computes them."""

from __future__ import annotations

import numpy as np


def cosine_warmup(
    step, *, base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> np.float32:
    f32 = np.float32
    step = f32(step)
    warm = step / f32(max(warmup_steps, 1))
    prog = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                   f32(0), f32(1))
    cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
    return f32(base_lr) * (warm if step < warmup_steps else cos)
