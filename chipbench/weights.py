"""Random weights from the seed, made by the benchmark and handed to both
the program and the reference.

A family's reference module lists its leaves (:class:`Leaf`: a canonical
name, a shape whose first dim is the layer for ``layers.*`` leaves, and a
distribution).  :func:`make` draws every standard-normal number the leaves
need in one call and every uniform one in one more, on the generator's
device, then shapes, scales and casts each leaf to the dtype it is served
in.  The same seed gives the same bits on the same device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    init: str  # normal | scale | uniform | log_uniform | dt_bias | const
    args: tuple[float, ...] = ()

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def draws(self) -> str | None:
        """Which stream the leaf draws from: "normal", "uniform" or none."""
        if self.init in ("normal", "scale"):
            return "normal"
        if self.init in ("uniform", "log_uniform", "dt_bias"):
            return "uniform"
        return None


def _shape(leaf: Leaf, z: torch.Tensor) -> torch.Tensor:
    """One leaf's f32 values from its slice ``z`` of its stream."""
    a = leaf.args
    if leaf.init == "normal":
        return z * a[0]
    if leaf.init == "scale":
        return 1.0 + a[0] * z
    if leaf.init == "uniform":
        return a[0] + (a[1] - a[0]) * z
    if leaf.init == "log_uniform":  # log of U(lo, hi): mamba2's A_log
        return torch.log(a[0] + (a[1] - a[0]) * z)
    if leaf.init == "dt_bias":  # softplus^-1 of a log-uniform dt in [lo, hi]
        dt = torch.exp(math.log(a[0]) + (math.log(a[1]) - math.log(a[0])) * z)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {leaf.init!r} of {leaf.name}")


def make(leaves: list[Leaf], dtypes: dict[str, str], seed: int,
         device: torch.device | str) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` in each leaf's served dtype (``dtypes[name]``)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    need = {"normal": 0, "uniform": 0}
    for leaf in leaves:
        if leaf.draws:
            need[leaf.draws] += leaf.numel
    streams = {
        "normal": torch.randn(need["normal"], generator=gen, device=dev),
        "uniform": torch.rand(need["uniform"], generator=gen, device=dev),
    }
    at = {"normal": 0, "uniform": 0}
    out = {}
    for leaf in leaves:
        dt = DTYPES[dtypes[leaf.name]]
        if leaf.draws is None:
            out[leaf.name] = torch.full(leaf.shape, leaf.args[0], dtype=dt, device=dev)
            continue
        s, n = leaf.draws, leaf.numel
        z = streams[s][at[s]:at[s] + n].view(leaf.shape)
        at[s] += n
        out[leaf.name] = _shape(leaf, z).to(dt)
    return out


def per_layer(served: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Stacked ``layers.<x>`` leaves split into ``layers.<l>.<x>`` views;
    other leaves as they are.  The names every comparison uses."""
    out = {}
    for name, t in served.items():
        if name.startswith("layers."):
            kind = name[len("layers."):]
            for l, row in enumerate(t.unbind(0)):
                out[f"layers.{l}.{kind}"] = row
        else:
            out[name] = t
    return out
