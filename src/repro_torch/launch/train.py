"""Training launcher CLI (the port of ``src/repro/launch/train.py``).

Example (one H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --backend spmd --scheme heter_aware --s 1 --m 4 --straggler fault --steps 4

The flags and defaults are the JAX launcher's, plus ``--device``.  The
``spmd`` backend runs the m coded workers in turn in this one process on
one device.  Not accepted yet (their modules are not ported):
``--ckpt-dir/--resume``, ``--trace-out/--log-jsonl``, ``--faults`` and
``--compress/--wire-kernel``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.approx import DEADLINE_MODES, DeadlinePolicy
from repro_torch.configs import CodingConfig, TrainConfig, get_config
from repro_torch.core.registry import scheme_names
from repro_torch.core.straggler import FixedDelayStragglers, NoStragglers, TransientStragglers
from repro_torch.data.pipeline import SyntheticData
from repro_torch.models.lm import build_model
from repro_torch.train.engine import BACKENDS
from repro_torch.train.trainer import CodedTrainer


def straggler_from_args(args):
    if args.straggler == "none":
        return NoStragglers()
    if args.straggler == "delay":
        return FixedDelayStragglers(s=args.s, delay=args.delay)
    if args.straggler == "fault":
        return FixedDelayStragglers(s=args.s, delay=np.inf)
    if args.straggler == "transient":
        return TransientStragglers()
    raise ValueError(args.straggler)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scheme", default="heter_aware", choices=list(scheme_names()))
    ap.add_argument("--backend", default="fused", choices=list(BACKENDS),
                    help="gradient backend: fused (production) | reference "
                         "(oracle) | spmd (per-worker encode + decode through "
                         "the coded_reduce kernel, m workers in one process)")
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--m", type=int, default=4, help="coded workers")
    ap.add_argument("--part-mb", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--straggler", default="none", choices=["none", "delay", "fault", "transient"])
    ap.add_argument("--delay", type=float, default=2.0)
    ap.add_argument("--deadline-mode", default="none", choices=["none", *DEADLINE_MODES],
                    help="inexact stepping: step at a deadline with whatever decoded "
                         "(none = the paper's exact semantics)")
    ap.add_argument("--target-residual", type=float, default=0.2,
                    help="bounded_residual mode: step once the decode's RMS residual "
                         "drops to this")
    ap.add_argument("--deadline-slack", type=float, default=1.5,
                    help="adaptive deadline = slack x EWMA-predicted exact iteration time")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="fixed deadline in (simulated) seconds; overrides adaptation")
    ap.add_argument("--speeds", default=None, help="comma-sep true worker speeds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and kernels run (cpu: plain PyTorch "
                         "versions of the kernels, for tests)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is available (pass --device cpu to "
            "run the plain PyTorch path on the CPU)"
        )
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    speeds = (
        np.array([float(x) for x in args.speeds.split(",")])
        if args.speeds
        else np.linspace(1.0, 2.0, args.m)
    )
    coding = CodingConfig(scheme=args.scheme, s=args.s)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, seed=args.seed)
    policy = None
    if args.deadline_mode != "none":
        policy = DeadlinePolicy(
            mode=args.deadline_mode, target_residual=args.target_residual,
            slack=args.deadline_slack, deadline_s=args.deadline_s,
        )
    trainer = CodedTrainer(
        model, coding, tc, m=args.m, part_mb=args.part_mb,
        straggler_model=straggler_from_args(args), true_speeds=speeds, rng=args.seed,
        backend=args.backend, deadline_policy=policy, device=device,
    )
    data = SyntheticData(cfg, k=trainer.k, part_mb=args.part_mb, seq_len=args.seq_len,
                         seed=args.seed)
    state = trainer.init_state(args.seed)

    t0 = time.time()
    totals = {"sim": 0.0}
    history: list[dict] = []
    step_s: list[float] = []  # host seconds per step (each step ends in a device sync)
    last = [time.perf_counter()]

    def on_step(step, st, metrics):
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now
        history.append(metrics)
        totals["sim"] += (
            metrics["sim_iter_time"] if np.isfinite(metrics["sim_iter_time"]) else 0.0
        )
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {metrics['loss']:.4f} gnorm {metrics['grad_norm']:.3f} "
                f"sim_T {metrics['sim_iter_time']:.3f}s stragglers {metrics['n_stragglers']:.0f} "
                f"used {metrics['n_used']:.0f} residual {metrics['decode_residual']:.3f} "
                f"exact_frac {metrics['exact_fraction']:.2f}",
                flush=True,
            )

    state, metrics = trainer.run(state, data, args.steps, on_step=on_step)
    summary = {
        "final_loss": metrics.get("loss"), "wall_s": time.time() - t0,
        "sim_time_total_s": totals["sim"], "scheme": args.scheme, "m": args.m,
        "deadline_mode": args.deadline_mode,
        "exact_fraction": metrics.get("exact_fraction"),
        "steps_run": max(args.steps, 0),
        "device": str(device), "backend": args.backend,
    }
    print(json.dumps(summary))
    return {"summary": summary, "history": history, "step_s": step_s,
            "trainer": trainer, "state": state, "data": data}


if __name__ == "__main__":
    main()
