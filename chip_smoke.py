#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and drives only ``src/repro_torch`` (it
never imports ``jax`` or the JAX package):

  1. the card: ``nvidia-smi`` name and power limit, and CUDA's version;
  2. the build of every kernel on the main path from the sources in the
     checkout (``nvcc``, sm_90a), with ptxas' register and spill report;
  3. each kernel against its plain PyTorch version on the card, over
     ragged shapes and every dtype it takes, with the tolerance stated;
  4. each kernel's time at the main path's shapes (CUDA events, median)
     beside its bound, the plain version's time and one PyTorch library
     call computing the same function (timed here, never used by the port);
  5. the main path: ``repro_torch.launch.train`` on smollm-360m at full
     width, spmd backend, heter_aware, s=1, m=4, one faulted worker per
     step, 4 steps, checking losses, the decode metrics and that the
     kernel ran m+1 times per step;
  6. a cross-check at full width in f32: one decoded gradient from the
     spmd backend (through the kernel) against the fused backend
     (autograd), relative L2 error <= 1e-4;
  7. a JSON line of the kernels, then the card as the last line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH, M, S, STEPS = "smollm-360m", 4, 1, 4
SLICE_ARGS = ["--arch", ARCH, "--backend", "spmd", "--scheme", "heter_aware",
              "--s", str(S), "--m", str(M), "--straggler", "fault", "--steps", str(STEPS)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_kernel_vs_plain(torch, cr) -> float:
    """Phase 3: ragged shapes x dtypes; returns the largest scaled error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [("f32->f32", torch.float32, torch.float32, 1e-5),
             ("bf16->bf16", torch.bfloat16, torch.bfloat16, 5e-2),
             ("int8->f32", torch.int8, torch.float32, 1e-5)]
    worst = 0.0
    for P in (1, 5, 130):
        for D in (1, 4095, 1_000_003, 1 << 20):
            for name, din, dout, tol in cases:
                w = torch.randn(P, generator=gen, device=dev)
                if din == torch.int8:
                    g = torch.randint(-127, 128, (P, D), generator=gen, device=dev,
                                      dtype=torch.int8)
                else:
                    g = torch.randn(P, D, generator=gen, device=dev).to(din)
                got = cr.coded_reduce(g, w, dout)
                torch.cuda.synchronize()
                ref = cr.coded_reduce_torch(g, w, dout)
                err = float((got.float() - ref.float()).abs().max())
                scale = max(1.0, float(ref.float().abs().max()))
                ok = err <= tol * scale and got.dtype == dout and got.shape == (D,)
                log(f"check coded_reduce {name} P={P} D={D}: max_abs_err {err:.3e} "
                    f"(tolerance {tol:g} x max(1, max|ref|) = {tol * scale:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"coded_reduce {name} P={P} D={D} disagrees")
                worst = max(worst, err / scale)
    # the poisoned-payload contract: a NaN weight gives NaN where it multiplies
    g = torch.ones(3, 4096, device=dev)
    out = cr.coded_reduce(g, torch.tensor([0.0, float("nan"), 1.0], device=dev))
    if not bool(torch.isnan(out).all()):
        raise AssertionError("a NaN weight did not poison the reduction")
    log("check coded_reduce NaN weight -> NaN output: ok")
    return worst


def time_kernel(torch, cr, P: int, D: int, label: str) -> dict:
    """Phase 4 at one main-path shape: f32 (P, D) -> f32 (D,)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(P)
    g = torch.randn(P, D, generator=gen, device=dev)
    w = torch.randn(P, generator=gen, device=dev)
    out = torch.empty(D, device=dev)
    ms = time_cuda(lambda: cr.coded_reduce(g, w, torch.float32, out=out))
    ref = cr.coded_reduce_torch(g, w, torch.float32)
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{label}: kernel vs plain max_abs_err {err} > {1e-5 * scale}")
    del ref
    plain_ms = time_cuda(lambda: cr.coded_reduce_torch(g, w, torch.float32), reps=5, warmup=1)
    library_ms = time_cuda(lambda: torch.mv(g.t(), w))
    nbytes = P * D * 4 + D * 4
    flops = 2 * P * D
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / 67e12) * 1e3
    res = dict(P=P, D=D, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / 67e12
               else "operations", max_abs_err=err, GBps=nbytes / ms / 1e6)
    log(f"time coded_reduce {label} f32 P={P} D={D}: kernel {ms:.4f} ms "
        f"({res['GBps']:.0f} GB/s, bound {bound_ms:.4f} ms by {res['bound_by']}, "
        f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, torch.mv {library_ms:.4f} ms, "
        f"max_abs_err {err:.3e}")
    del g, out
    torch.cuda.empty_cache()
    return res


def main_path(torch, cr) -> dict:
    """Phase 5: the slice command in process, counts reset just before."""
    from repro_torch.launch.train import main as train_main

    # the control plane is independent of the model: the same run at the
    # reduced width on the CPU must give the same per-step decode metrics
    log("control-plane replay (reduced width, CPU):")
    expect = train_main([*SLICE_ARGS, "--reduced", "--device", "cpu"])["history"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cr.coded_reduce.launches = 0
    log("main path: python -m repro_torch.launch.train " + " ".join(SLICE_ARGS))
    t0 = time.perf_counter()
    out = train_main([*SLICE_ARGS, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cr.coded_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    n_params = sum(p.numel() for p in out["state"].params.values())
    log(f"main path: {ARCH} full width, {n_params} parameters "
        f"({next(iter(out['state'].params.values())).dtype}), {len(hist)} steps in "
        f"{wall:.2f} s wall ({wall / max(len(hist), 1):.3f} s/step, launch and init included), "
        f"peak memory {peak / 2**30:.2f} GiB, coded_reduce launches {launches}")
    for i, h in enumerate(hist):
        log(f"  step {i}: {out['step_s'][i]:.4f} s, loss {h['loss']:.5f} grad_norm {h['grad_norm']:.4f} "
            f"n_used {h['n_used']:.0f} n_stragglers {h['n_stragglers']:.0f} "
            f"sim_iter_time {h['sim_iter_time']:.3f} exact_fraction {h['exact_fraction']:.2f}")
    if len(hist) != STEPS:
        raise AssertionError(f"ran {len(hist)} steps, expected {STEPS}")
    for i, (h, e) in enumerate(zip(hist, expect)):
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"step {i}: non-finite loss or grad norm")
        for key in ("n_used", "n_stragglers", "sim_iter_time", "decode_residual",
                    "exact_fraction", "skipped"):
            if h[key] != e[key]:
                raise AssertionError(f"step {i}: {key} {h[key]} != control-plane replay {e[key]}")
        if not (h["n_stragglers"] == S and 1 <= h["n_used"] <= M - S
                and h["exact_fraction"] == 1.0 and h["skipped"] == 0.0):
            raise AssertionError(f"step {i}: unexpected decode metrics {h}")
    if n_params != 361_821_120:
        raise AssertionError(f"{n_params} parameters, expected 361821120 for {ARCH}")
    steps_taken = sum(1 for h in hist if h["skipped"] == 0.0)
    if launches != steps_taken * (M + 1):
        raise AssertionError(f"coded_reduce launches {launches} != {steps_taken} x (m+1)")
    log(f"main path ok: every loss finite, exact decode every step, "
        f"launches {launches} == {steps_taken} x (m+1)")
    losses = [h["loss"] for h in hist]
    steady = statistics.median(out["step_s"][1:])
    log(f"main path step time: median of steps 1-{STEPS - 1} {steady:.4f} s "
        f"(step 0 {out['step_s'][0]:.4f} s includes the first batch and warm-up)")
    breakdown = profile_step(torch, out)
    del out
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_gib=peak / 2**30, wall_s=wall, losses=losses,
                n_params=n_params, step_s=steady, breakdown=breakdown)


def profile_step(torch, out) -> dict:
    """One more main-path step under ``torch.profiler``: device time by kernel
    group and the device's busy share of the step's wall time.  Reported,
    not checked: where the profiler sees no device time it says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, state, data = out["trainer"], out["state"], out["data"]
    batch = data.batch(STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    kernels: list[tuple[float, int, str]] = []
    for ev in prof.key_averages():
        # only the device's own events: a CPU op also carries the device
        # time of the kernels it launched, which would count them twice
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = ev.self_device_time_total
        if not dev_us:
            continue
        kernels.append((dev_us / 1e3, int(ev.count), ev.key))
        name = ev.key.lower()
        if "coded_reduce" in name:
            grp = "coded_reduce"
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "sm90_xmma", "cublas", "nvjet")):
            grp = "matmul (cuBLAS)"
        elif "memcpy" in name or "memset" in name:
            grp = "memcpy/memset"
        else:
            grp = "other kernels"
        groups[grp] = groups.get(grp, 0.0) + dev_us / 1e3
        counts[grp] = counts.get(grp, 0) + int(ev.count)
    busy = sum(groups.values())
    if busy == 0.0:
        log("profile: the profiler reported no device time (not measured)")
        return {}
    log(f"profile of one main-path step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall_ms:.1%}), idle share {1 - busy / wall_ms:.1%}")
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {grp}: {ms:.1f} ms device ({ms / busy:.1%} of busy), {counts[grp]} launches")
    log(f"  {sum(c for _, c, _ in kernels)} device operations in the step; the 8 largest:")
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"    {ms:8.2f} ms {count:7d}x {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **{f"{g}_ms": v for g, v in groups.items()}}


def cross_check(torch) -> float:
    """Phase 6: spmd (kernel) vs fused (autograd) decoded gradient, f32."""
    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.core.codec import Codec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model
    from repro_torch.train.engine import StepEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("cross-check: TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32})")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    model = build_model(cfg)
    codec = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1)
    outcome = codec.decode_outcome([w for w in range(M) if w != 1])  # worker 1 faulted
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticData(cfg, k=codec.k, part_mb=2, seq_len=64, seed=0).batch(0)
    grads = {}
    for backend in ("spmd", "fused"):
        eng = StepEngine(model, TrainConfig(), codec, backend=backend, device=dev)
        grads[backend] = eng.gradients(params, batch, outcome)
        torch.cuda.synchronize()
    num = sum(float((grads["spmd"][k].double() - grads["fused"][k].double()).square().sum())
              for k in params)
    den = sum(float(grads["fused"][k].double().square().sum()) for k in params)
    rel = (num / den) ** 0.5
    ok = rel <= 1e-4
    log(f"cross-check {ARCH} f32 full width, decode a={list(map(float, outcome.a))}: "
        f"spmd vs fused relative L2 error {rel:.3e} (limit 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"spmd vs fused relative L2 error {rel} > 1e-4")
    del grads, params
    torch.cuda.empty_cache()
    return rel


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "coded_reduce.cu").is_file():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import coded_reduce as cr

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(card)

    # 2. the build
    t0 = time.perf_counter()
    cr.build_coded_reduce()
    info = cr.BUILD_INFO
    log(f"build coded_reduce.cu: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s, cached={info['cached']}) -> {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version
    worst = check_kernel_vs_plain(torch, cr)

    # 4. timing at the main path's shapes
    from repro_torch.configs import CodingConfig
    from repro_torch.core.codec import Codec

    n_slots = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1).n_slots
    D = 361_821_120
    enc = time_kernel(torch, cr, n_slots, D, "encode (P = n_slots)")
    dec = time_kernel(torch, cr, M, D, "decode (P = m)")

    # 5. the main path, 6. the f32 cross-check
    run = main_path(torch, cr)
    rel = cross_check(torch)

    # 7. the kernels line, then the card
    kernels = [{
        "name": "coded_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce.py:150",
        "launches": run["launches"],
        "max_abs_err": max(enc["max_abs_err"], dec["max_abs_err"]),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "shape": f"f32 ({enc['P']}, {enc['D']}) -> ({enc['D']},), the per-worker encode",
        "decode": {k: dec[k] for k in ("P", "D", "ms", "plain_ms", "bound_ms", "library_ms",
                                        "max_abs_err")},
        "checks_worst_scaled_err": worst,
    }]
    log(f"summary: step {run['step_s']:.4f} s (median), peak {run['peak_gib']:.2f} GiB, "
        f"losses {run['losses']}, cross-check rel L2 {rel:.3e}, profile {run['breakdown']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
