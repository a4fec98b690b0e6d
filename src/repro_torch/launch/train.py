"""Training launcher CLI (the port of ``src/repro/launch/train.py``).

Example (one H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --backend spmd --scheme heter_aware --s 1 --m 4 --straggler fault --steps 4

and the same on the int8 compressed wire, through the fused encode kernel:
  ... --steps 4 --compress --wire-kernel on

mamba2-370m (the ssm family; every layer's SSD scan is the ssd_scan CUDA
kernel) at seq 512, two SSD chunks of 256:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --backend spmd --scheme heter_aware --s 1 --m 4 --straggler fault --steps 4 \\
      --seq-len 512

with injected faults (the fault supervisor convicts, repairs, evicts and
re-admits), a trace and event log, and checkpoints every 4 steps:
  ... --steps 8 --faults "corrupt:1@1..3,crash:3@4" \
      --trace-out /tmp/run.trace.json --log-jsonl /tmp/run.jsonl \
      --ckpt-dir /tmp/ck --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.obs_report /tmp/run.jsonl

and resumed from the newest checkpoint (params and optimizer state; the
worker count may differ):
  ... --steps 10 --ckpt-dir /tmp/ck --resume

Across processes, one ``torch.distributed`` rank a coded worker (the JAX
launcher's ``(m, 1)`` mesh), the ranks sharing the card over gloo or each on
a card of its own over NCCL:
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m -- repro_torch.launch.train --arch smollm-360m --backend spmd --m 4 ...
(``--device cpu`` runs the ranks on the CPU over gloo.)  Only rank 0 prints,
writes the trace, the event log and the checkpoints; its summary gains
``ranks``: each rank's kernel launches, peak memory, step time, params
digest and elastic rebuilds.

The flags and defaults are the JAX launcher's, plus ``--device`` and
``--audit-rebuilds``.  Without ``torch.distributed.run``'s environment the
``spmd`` backend runs the m coded workers in turn in this one process on
one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.approx import DEADLINE_MODES, DeadlinePolicy
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import CodingConfig, TrainConfig, get_config
from repro_torch.core.registry import scheme_names
from repro_torch.core.straggler import FixedDelayStragglers, NoStragglers, TransientStragglers
from repro_torch.data.pipeline import SyntheticData
from repro_torch.kernels.coded_reduce import coded_reduce
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.wire import coded_decode_int8, coded_encode_int8
from repro_torch.launch.mesh import (
    all_gather_objects,
    init_coded_group,
    launched_by_torchrun,
    remesh_for_m,
)
from repro_torch.models.lm import build_model
from repro_torch.obs.trace import Tracer
from repro_torch.resilience import parse_fault_spec
from repro_torch.train.engine import BACKENDS
from repro_torch.train.trainer import CodedTrainer, TrainerState


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
    ap.add_argument("--arch", required=True,
                    help="a config of repro_torch.configs (every family: e.g. "
                         "smollm-360m, mamba2-370m, moonshot-v1-16b-a3b, "
                         "jamba-1.5-large-398b, granite-4.0-h-small, internvl2-2b, "
                         "hubert-xlarge)")
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
    ap.add_argument("--seq-len", type=int, default=64,
                    help="tokens a sequence; an ssm model pads it to a multiple "
                         "of its SSD chunk (mamba2-370m: 256)")
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run (open in "
                         "ui.perfetto.dev); enables the flight recorder")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write the structured event log (one train.step JSON "
                         "object per step + instants) for "
                         "repro_torch.launch.obs_report")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16,
                    help="flight-recorder ring size (records); oldest dropped beyond it")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="inject failures, e.g. "
                         "'crash:3@40,hang:1@20+10,flaky:2@0..100:0.3,"
                         "corrupt:0@50..60'; enables the fault supervisor "
                         "(suspicion-driven eviction + re-admission)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="RNG key for flaky/corrupt fault realizations")
    ap.add_argument("--compress", action="store_true",
                    help="int8 wire compression with error feedback on the "
                         "coded gradient (the spmd backend; the fused and "
                         "reference backends send no wire and ignore it)")
    ap.add_argument("--wire-kernel", default="auto", choices=["auto", "on", "off"],
                    help="fused CUDA int8 wire encode for --compress: "
                         "auto = on only where the fused encode measured "
                         "faster than the unfused composition on this card")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and kernels run (cpu: plain PyTorch "
                         "versions of the kernels, for tests)")
    ap.add_argument("--audit-rebuilds", action="store_true",
                    help="under torch.distributed.run: after every elastic group "
                         "rebuild, check that each carried error-feedback row is "
                         "bit-equal to its worker's row before it (a sha256 of "
                         "every row, gathered across the ranks)")
    return ap


_KERNELS = {"coded_reduce": coded_reduce, "coded_encode_int8": coded_encode_int8,
            "coded_decode_int8": coded_decode_int8, "ssd_scan": ssd_scan,
            "flash_attention": flash_attention}


def _params_digest(params) -> str:
    h = hashlib.sha256()
    for key, p in params.items():
        h.update(key.encode() + p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _rank_report(trainer, state, step_s, rebuilds) -> dict:
    """This rank's part of the summary's ``ranks``."""
    eng = trainer.engine
    dev = eng.device
    return {
        "rank": eng.group.rank, "device": str(dev), "member": eng.group.member,
        "launches": {name: fn.launches for name, fn in _KERNELS.items()},
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None),
        "step_s_median": statistics.median(step_s) if step_s else None,
        "params_sha256": _params_digest(state.params),
        "rebuilds": [dataclasses.asdict(r) for r in rebuilds],
        "row_audits": eng.row_audits,
    }


def main(argv=None, on_step=None) -> dict:
    """Run the CLI with ``argv``.  ``on_step(trainer, step, state, metrics)``,
    for callers that drive the launcher in process, runs after each step,
    outside the step's timing."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda: no CUDA device is available (pass --device cpu to "
            "run the plain PyTorch path on the CPU)"
        )
    device = torch.device(args.device)
    group = None
    if args.backend == "spmd" and launched_by_torchrun():
        world = init_coded_group(args.device)
        if world.world_size < args.m:
            torch.distributed.destroy_process_group()
            raise SystemExit(
                f"--backend spmd needs >= {args.m} ranks for m={args.m} coded workers, "
                f"found {world.world_size}; launch via python -m torch.distributed.run "
                f"--nproc-per-node {args.m} -m -- repro_torch.launch.train ... (or more, so "
                f"membership can grow)"
            )
        group = remesh_for_m(world, args.m)
        device = group.device
    try:
        return _run(args, device, group, on_step)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def _run(args, device: torch.device, group, on_step) -> dict:
    lead = group is None or group.rank == 0  # prints and writes files
    if group is not None and lead:
        print(f"process group: {group.world_size} ranks, {group.transport} transport "
              f"({group.why}), rank 0 on {device}", flush=True)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    speeds = (
        np.array([float(x) for x in args.speeds.split(",")])
        if args.speeds
        else np.linspace(1.0, 2.0, args.m)
    )
    coding = CodingConfig(
        scheme=args.scheme, s=args.s, compress=args.compress,
        wire_kernel={"auto": None, "on": True, "off": False}[args.wire_kernel],
    )
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps, seed=args.seed)
    policy = None
    if args.deadline_mode != "none":
        policy = DeadlinePolicy(
            mode=args.deadline_mode, target_residual=args.target_residual,
            slack=args.deadline_slack, deadline_s=args.deadline_s,
        )
    tracer = (
        Tracer(capacity=args.trace_capacity)
        if lead and (args.trace_out or args.log_jsonl)
        else None
    )
    faults = parse_fault_spec(args.faults) if args.faults else None
    trainer = CodedTrainer(
        model, coding, tc, m=args.m, part_mb=args.part_mb,
        straggler_model=straggler_from_args(args), true_speeds=speeds, rng=args.seed,
        backend=args.backend, deadline_policy=policy, trace=tracer,
        faults=faults, fault_seed=args.fault_seed, device=device, group=group,
    )
    trainer.engine.audit_rows = args.audit_rebuilds
    data = SyntheticData(cfg, k=trainer.k, part_mb=args.part_mb, seq_len=args.seq_len,
                         seed=args.seed)
    state = trainer.init_state(args.seed)
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir, group=group) if args.ckpt_dir else None
    if ckpt and args.resume:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            like = {"params": state.params, "opt": state.opt}
            restored, meta = restore_checkpoint(args.ckpt_dir, last, like)
            state = TrainerState(params=restored["params"], opt=restored["opt"], step=last)
            start = last
            if lead:
                print(f"resumed from step {last} (saved with m={meta.get('m')}, "
                      f"now m={args.m})")

    t0 = time.time()
    totals = {"sim": 0.0}
    history: list[dict] = []
    step_s: list[float] = []  # host seconds per step (each step ends in a device sync)
    rebuilds: list = []  # the engine's elastic rebuild reports, in order
    last = [time.perf_counter()]

    def log_step(step, st, metrics):
        now = time.perf_counter()
        step_s.append(now - last[0])
        history.append(metrics)
        rb = trainer.engine.last_rebuild
        if rb is not None and (not rebuilds or rb is not rebuilds[-1]):
            rebuilds.append(rb)
            if lead and rb.m_before != rb.m_after:
                print(f"rebuild at step {step}: m {rb.m_before} -> {rb.m_after}, err rows "
                      f"carried {rb.err_rows_carried} zeroed {rb.err_rows_zeroed}, "
                      f"{rb.ms:.1f} ms", flush=True)
        totals["sim"] += (
            metrics["sim_iter_time"] if np.isfinite(metrics["sim_iter_time"]) else 0.0
        )
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(
                f"step {step:5d} loss {metrics['loss']:.4f} gnorm {metrics['grad_norm']:.3f} "
                f"sim_T {metrics['sim_iter_time']:.3f}s stragglers {metrics['n_stragglers']:.0f} "
                f"used {metrics['n_used']:.0f} residual {metrics['decode_residual']:.3f} "
                f"exact_frac {metrics['exact_fraction']:.2f}",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": st.params, "opt": st.opt},
                      meta={"m": args.m, "scheme": args.scheme, "arch": args.arch})
        if on_step is not None:
            on_step(trainer, step, st, metrics)
        last[0] = time.perf_counter()

    state, metrics = trainer.run(state, data, args.steps, start=start, on_step=log_step)
    if ckpt:
        ckpt.wait()
    if tracer is not None:
        if args.trace_out:
            tracer.write_chrome(args.trace_out)
            print(f"chrome trace: {args.trace_out} ({len(tracer)} records, "
                  f"{tracer.n_dropped} dropped) — open in ui.perfetto.dev")
        if args.log_jsonl:
            n = tracer.write_jsonl(args.log_jsonl)
            print(f"event log: {args.log_jsonl} ({n} lines) — analyse with "
                  f"python -m repro_torch.launch.obs_report {args.log_jsonl}")
    # metrics is {} when the loop ran zero steps (e.g. --resume at --steps)
    summary = {
        "final_loss": metrics.get("loss"), "wall_s": time.time() - t0,
        "sim_time_total_s": totals["sim"], "scheme": args.scheme, "m": args.m,
        "deadline_mode": args.deadline_mode,
        "exact_fraction": metrics.get("exact_fraction"),
        "steps_run": max(args.steps - start, 0),
        **(
            {"resilience": trainer.supervisor.summary(), "m_final": trainer.m}
            if trainer.supervisor is not None else {}
        ),
        "device": str(device), "backend": args.backend,
        "compress": args.compress, "wire_kernel": trainer.engine.wire_kernel,
    }
    if group is not None:
        ranks = all_gather_objects(_rank_report(trainer, state, step_s, rebuilds), group)
        members = [r for r in ranks if r["member"]]
        summary.update(
            world_size=group.world_size, transport=group.transport,
            n_params=sum(p.numel() for p in state.params.values()), ranks=ranks,
            replicas_bit_equal=all(r["params_sha256"] == ranks[0]["params_sha256"]
                                   for r in members),
        )
    if lead:
        print(json.dumps(summary), flush=True)
    return {"summary": summary, "history": history, "step_s": step_s,
            "trainer": trainer, "state": state, "data": data}


if __name__ == "__main__":
    main()
