"""The system under test: the port's ``CodedTrainer``, built from a cell's
configuration and traffic the way ``repro_torch.launch.train`` builds it.
The only module of the benchmark that imports the port.

It also reads the program's side of the comparison (the loss each step
reports, the first gradient from AdamW's first moment, each leaf's change
from the f32 master weights, and whether each served leaf is its master
rounded to the served dtype) and, in a traced run, counts at two call
sites: the rows and nonzero-weight rows that reach the model's
``weighted_loss`` (the engine's call into the model), and the shapes of
every ``ssd_scan`` call with the time it was made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import CodingConfig, ModelConfig, TrainConfig
from repro_torch.core.straggler import FixedDelayStragglers, NoStragglers
from repro_torch.kernels import ops
from repro_torch.models.lm import build_model
from repro_torch.obs.trace import Tracer
from repro_torch.optim.adam import adamw_init
from repro_torch.train.trainer import CodedTrainer, TrainerState


def straggler_model(spec: dict):
    """A mix's straggler model: ``none``, or ``fixed_delay`` (the paper's
    Fig. 2 model: ``s`` random workers a step ``delay`` seconds late on the
    simulated clock; ``"inf"`` makes them faults, as the launcher's
    ``--straggler fault``)."""
    kind = spec["kind"]
    if kind == "none":
        return NoStragglers()
    if kind == "fixed_delay":
        return FixedDelayStragglers(s=int(spec["s"]), delay=float(spec["delay"]))
    raise ValueError(f"unknown straggler kind {kind!r}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """Per-layer norms of a stacked leaf (n_layers, ...), f32."""
    return t.detach().float().flatten(1).norm(dim=1)


class Program:
    def __init__(self, cfg: dict, traffic: dict, layout: dict, seed: int,
                 device: torch.device, trace: bool):
        self.model = build_model(ModelConfig(**cfg["model"]))
        self.tc = TrainConfig(**cfg["train"])
        self.layout = layout
        m, k = int(traffic["m"]), int(traffic["k"])
        coding = CodingConfig(scheme=traffic["scheme"], s=int(traffic["s"]),
                              partitions_per_worker=k // m)
        c_init = traffic.get("c_init")
        self.tracer = Tracer(capacity=1 << 20) if trace else None
        self.trainer = CodedTrainer(
            self.model, coding, self.tc, m=m, part_mb=int(traffic["part_mb"]),
            straggler_model=straggler_model(traffic["straggler"]),
            true_speeds=np.asarray(traffic["speeds"], np.float64),
            c_init=None if c_init is None else np.asarray(c_init, np.float64),
            rng=int(seed), backend=traffic["backend"], trace=self.tracer, device=device,
        )
        if self.trainer.k != k:
            raise ValueError(f"the scheme settled k={self.trainer.k}, the traffic says k={k}")
        self.rows = 0
        self.weighted = None  # device count of nonzero-weight rows
        self.ssd_calls: list[tuple[float, tuple, int]] = []
        self._ssd_inner = None
        if trace:
            self._count_rows()
            self._record_ssd_calls()

    def state(self, served: dict[str, torch.Tensor]) -> TrainerState:
        """The trainer's state over the benchmark's weights (the tensors
        themselves: the program updates them in place)."""
        params = {self.layout[name][0]: t for name, t in served.items()}
        params = dict(sorted(params.items()))
        return TrainerState(params=params, opt=adamw_init(params), step=0)

    def step(self, state: TrainerState, batch: dict) -> tuple[TrainerState, dict]:
        return self.trainer.step(state, batch)

    def _per_layer(self, tree: dict[str, torch.Tensor], scale: float = 1.0,
                   base: dict[str, torch.Tensor] | None = None) -> dict[str, float]:
        out = {}
        for name, (key, _) in self.layout.items():
            if key not in tree:
                continue
            t = tree[key].detach().float()
            if base is not None:
                t = t - base[name].float()
            if name.startswith("layers."):
                kind = name[len("layers."):]
                for l, v in enumerate(_rows(t).tolist()):
                    out[f"layers.{l}.{kind}"] = v * scale
            else:
                out[name] = float(t.norm()) * scale
        return out

    def first_grad(self, state: TrainerState) -> dict[str, float]:
        """After the first step: each leaf's gradient as AdamW got it,
        ``mu / (1 - beta1)`` (the first moment starts at zero)."""
        return self._per_layer(state.opt.mu, 1.0 / (1.0 - self.tc.beta1))

    def update(self, state: TrainerState, served0: dict[str, torch.Tensor]) -> dict[str, float]:
        """Each leaf's change from the served weights, in the f32 master
        weights the next step starts from (the parameters themselves where
        they are f32 and no master is kept)."""
        tree = state.opt.master if state.opt.master is not None else state.params
        return self._per_layer(tree, base=served0)

    def stale_leaves(self, state: TrainerState) -> int:
        """How many served leaves are not, bit for bit, their f32 master
        weights rounded to the served dtype: the forward would read weights
        other than those the optimizer keeps (0 where no master is kept)."""
        if state.opt.master is None:
            return 0
        return sum(not torch.equal(p, state.opt.master[k].to(p.dtype))
                   for k, p in state.params.items())

    # -- counters of a traced run -----------------------------------------

    def _count_rows(self) -> None:
        inner = self.model.weighted_loss

        def weighted_loss(params, batch):
            w = batch["weight"]
            self.rows += int(w.numel())
            n = (w != 0).sum()
            self.weighted = n if self.weighted is None else self.weighted + n
            return inner(params, batch)

        self.model.weighted_loss = weighted_loss

    def _record_ssd_calls(self) -> None:
        inner = self._ssd_inner = ops.ssd_scan

        def ssd_scan(x, dA, Bm, Cm, **kw):
            B, S, H, P = x.shape
            self.ssd_calls.append((time.perf_counter(), (B, S, H, P, Bm.shape[2], Bm.shape[3]),
                                   Bm.element_size()))
            return inner(x, dA, Bm, Cm, **kw)

        ops.ssd_scan = ssd_scan

    def reset_counters(self) -> None:
        self.rows, self.weighted, self.ssd_calls = 0, None, []

    def counters(self) -> dict:
        return {"rows": self.rows,
                "weighted_rows": 0 if self.weighted is None else int(self.weighted),
                "ssd_calls": list(self.ssd_calls)}

    def spans(self) -> list[tuple[str, float, float, dict]]:
        """The trainer's and engine's wall-clock spans, on ``perf_counter``."""
        if self.tracer is None:
            return []
        epoch = time.perf_counter() - self.tracer.clock()
        return [(r["name"], r["t0"] + epoch, r["t1"] + epoch, r["args"])
                for r in self.tracer.records("span") if r["clock"] == "wall"]

    def close(self) -> None:
        """Put back what a traced run wrapped."""
        if "weighted_loss" in vars(self.model):
            del self.model.weighted_loss
        if self._ssd_inner is not None:
            ops.ssd_scan, self._ssd_inner = self._ssd_inner, None
