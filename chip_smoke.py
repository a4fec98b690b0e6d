#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and drives only ``src/repro_torch`` (it
never imports ``jax`` or the JAX package):

  1. the card: ``nvidia-smi`` name and power limit, and CUDA's version;
  2. the build of every kernel source in the checkout (one ``nvcc`` per
     ``csrc/*.cu``, all started together, sm_90a), with ptxas' register and
     spill report for each entry, and the count of HGMMA (wgmma)
     instructions in flash attention's and the SSD scan's libraries where
     the toolkit has ``cuobjdump`` (0 fails);
  3. each kernel against its plain PyTorch version on the card, over
     ragged shapes and every dtype it takes, with the tolerance stated; the
     fused int8 encode BIT-equal to the wire format's numpy oracle (whose
     reduce is the CUDA ``coded_reduce``) over the sweep, edge shapes, the
     EPS floor, an error-feedback chain, NaN and in-place cases; the SSD
     scan's y and h over the JAX test's shapes (G > 1, f32 and bf16 B/C)
     and the full mamba2 layer with the model's dA (finite); flash attention
     over the JAX test's shapes (causal or not, window None or 32, f32 and
     bf16), ragged S up to 2047 with windows 1 and > S, hd = 128, the
     tensor-core kernel's stress cases (peaked softmax, zero-mean v, GQA
     groups of 1, 3 and 5 with windows across tile edges, every head size
     at a ragged S), and the full prefill shapes;
  4. each kernel's time at the main path's shapes (CUDA events, median)
     beside its bound, the plain version's time, the unfused composition's
     time for the wire kernels, and one PyTorch library call computing the
     same function where there is one (timed here, never used by the port);
     flash attention at the generate prefill's shape and the engine's
     longest and shortest prompts, kernel and library call in turns; the
     SSD scan at the training micro-batch, the generate prefill and the
     engine's longest prompt;
  5. the main path: ``repro_torch.launch.train`` on smollm-360m at full
     width, spmd backend, heter_aware, s=1, m=4, one faulted worker per
     step, 4 steps, checking losses, the decode metrics and that
     ``coded_reduce`` ran m+1 times per step; then the same on the int8
     wire (``--compress --wire-kernel on``): the encode kernel m times a
     step, the decode once, the error feedback finite and non-zero after
     every step; then mamba2-370m at full width
     and seq 512 (two SSD chunks), the same flags: ``coded_reduce`` m+1
     times a step and ``ssd_scan`` 48 times a forward pass, (m*n_slots + 1)
     passes a step; one more mamba2 step under ``torch.profiler`` (device
     time by kernel group, the device's busy share);
  6. a cross-check at full width in f32 with TF32 off: one decoded gradient
     from the spmd backend (through the kernels) against the fused backend
     (autograd), relative L2 error <= 1e-4; and the compressed spmd
     gradient with the wire kernel on against it off (rtol 1e-4, atol
     2e-5), each within 0.05 of max|.| of the uncompressed one (the whole
     vector: one scale covers it; each leaf's number is printed); for
     mamba2 the spmd gradient against the fused one at seq 512 (relative
     L2 <= 1e-4), and the loss and gradients through the SSD kernel
     against the plain version (1e-4 relative; relative L2 1e-3 over all
     leaves and over each mamba leaf alone);
  7. serving at full width, random bf16 weights from seed 0, for
     smollm-360m and mamba2-370m: ``LMServer.generate`` (4 prompts of 1024
     tokens, 64 new) and ``ServingEngine.run`` on the trace of
     examples/serve_lm.py at real prompt lengths (16 requests, prompts of
     128-2048 tokens, 32-128 new, Poisson arrivals, 8 slots, a coded-prefill
     ReplicaPool of 8 replicas with 2 stragglers); every request completes
     with tokens in [0, vocab), the prefill kernel (flash attention, or the
     SSD scan) launches once per layer and prefill call and never in
     decode; prefill and decode-step times, tokens per wall second, TTFT
     on the virtual clock against wait-for-all, peak memory; one more
     ``generate`` prefill under ``torch.profiler`` for its device busy time
     and the prefill kernel's part of it;
  8. the serving cross-checks in f32 with TF32 off: prefill through the
     kernel against the plain version (logits within 1e-4 of max|logit|,
     cache leaves), ``generate`` tokens equal, and continuous batching equal
     to sequential decode, a parting token allowed only at a near-tie (top-2
     gap <= 1e-5 of max|logit|); in bf16 the kernel-vs-plain logit
     difference and token agreement are printed, not held;
  9. the fault-tolerant trainer on full-width smollm-360m, int8 wire, m=4
     at equal speeds, faults ``corrupt:1@1..3,crash:3@4``: (a) 8 steps with
     tracing, the event log and a checkpoint every 4 steps; every step
     finite or skipped as non-finite, at least one step repaired, an
     eviction and an exact step at the smaller m; the error feedback finite
     and (m, D) after every step; the trajectory (m, decode metrics,
     repairs, the supervisor's summary, the gradient attempts) equal to a
     CPU replay at reduced width; each wire kernel's launches equal to what
     the attempts imply (the encode m a step attempt, the decode 1); (b)
     ``obs_report`` on the event log, its phase table (the host/device split
     of ``phase.spmd.pack/grads/unravel``) and its fault section with the
     convicted workers; (c) the last checkpoint restored bit-equal to the
     state the run ended with, then ``--resume`` on the uncompressed wire:
     ``resumed from step 8`` and two more finite steps, ``coded_reduce``
     m+1 times a step;
 10. a JSON line of the kernels, then the card as the last line.

Each main path and serving path is driven with every kernel's launch count
set to 0 just before it and read just after.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout.  Any failed phase exits non-zero.
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
WIRE_ARGS = [*SLICE_ARGS, "--compress", "--wire-kernel", "on"]
D_FULL = 361_821_120  # smollm-360m parameters: the flat wire's length
# mamba2-370m at seq 512: two SSD chunks of 256, so the carried state runs
MAMBA, MAMBA_SEQ, MAMBA_LAYERS = "mamba2-370m", 512, 48
MAMBA_ARGS = [*SLICE_ARGS[:1], MAMBA, *SLICE_ARGS[2:], "--seq-len", str(MAMBA_SEQ)]
D_MAMBA = 368_338_432  # mamba2-370m parameters (bf16, A_log / D / dt_bias f32)
# the full mamba2 layer's SSD scan: B = part_mb, S, H, P, G, N, chunk
SSD_FULL = dict(B=2, S=MAMBA_SEQ, H=32, P=64, G=1, N=128, chunk=256)
SSD_CHUNK = 128  # the tensor-core kernel's own chunk along S (csrc/ssd_scan.cu kL)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
F32_FLOPS = 67e12  # H100 SXM published f32 rate outside the tensor cores
# H100 SXM published dense bf16 tensor-core rate (NVIDIA H100 datasheet,
# without sparsity): the least time of bf16 attention, whatever unit runs it
BF16_FLOPS = 989.4e12
# serving: smollm-360m's attention heads, and the full-width traffic
SMOLLM_HEADS = dict(H=15, K=5, hd=64)
SMOLLM_LAYERS = 32
# flash_attention's timed shapes (B, S): the generate path's prefill (the
# kernels line's ms), and the engine's longest and shortest prompts
FLASH_TIMED = ((4, 1024), (1, 2048), (1, 128))
FLASH_BATCH = 20  # launches a timed reading of flash attention spans
GEN = dict(B=4, S=1024, new=64, cache_len=1088)
TRACE = dict(n=16, prompt=(128, 2048), new=(32, 128), gap_s=0.3, n_slots=8, cache_len=2176,
             m=8, s=2, delay=5.0)
# ssd_scan's timed shapes (B, S): the training micro-batch (the kernels
# line's ms), generate's prefill and the engine's longest prompt
SSD_TIMED = ((SSD_FULL["B"], SSD_FULL["S"]), (GEN["B"], GEN["S"]), (1, TRACE["prompt"][1]))
SSD_BATCH = 20  # calls a timed reading of ssd_scan spans
# flash_attention against its plain version beyond the JAX test's shapes:
# (atol, rtol).  In bf16 one spacing of the value (2^-7 of it at most) over
# a floor for values near zero; in f32 a few f32 spacings of summation order.
FLASH_TOL = {"bf16": (1e-4, 2.0**-7), "f32": (1e-5, 1e-5)}
NEAR_TIE = 1e-5  # a parting token passes only at a top-2 gap <= this x max|logit|
NO_LIBRARY = ("no single PyTorch call computes it: torch.mv takes no int8 input, "
              "and PyTorch has no fused reduce + int8 quantize")
NO_SSD_LIBRARY = "no single PyTorch call computes an SSD scan"
# the fault-tolerant trainer: equal speeds, so every worker arrives at the
# step's resolution time and a quarantined worker can be decoded around.
# Worker 1's payload is corrupt at steps 1-2 (repaired by excluding it, then
# convicted and evicted: m 4 -> 3); worker 3 crashes at step 4 (convicted on
# timeout and evicted: m 3 -> 2).
FAULT_SPEC, FAULT_STEPS, CKPT_EVERY, RESUME_STEPS = "corrupt:1@1..3,crash:3@4", 8, 4, 10
FAULT_BASE = ["--arch", ARCH, "--backend", "spmd", "--scheme", "heter_aware", "--s", str(S),
              "--m", str(M), "--straggler", "none", "--speeds", ",".join(["1"] * M)]
FAULT_ARGS = [*FAULT_BASE, "--compress", "--wire-kernel", "on", "--faults", FAULT_SPEC,
              "--steps", str(FAULT_STEPS)]
RESUME_ARGS = [*FAULT_BASE, "--steps", str(RESUME_STEPS)]
# the control-plane trajectory of a faulted run: none of it depends on width
TRAJECTORY = ("n_used", "exact", "repaired", "skipped_nonfinite", "skipped", "sim_iter_time",
              "decode_residual", "n_stragglers", "exact_fraction")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the report, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_cuda(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events).
    With ``batch`` > 1 each reading spans that many calls back to back and
    is divided by it: the device's time per call once the host runs ahead,
    where one call alone would also count the host's time to launch it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def device_split(torch, fn, calls: int) -> dict[str, float]:
    """Device milliseconds a call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls; empty where the profiler sees
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            key = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = key.split("(")[0].strip()[:60]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / calls
    return out


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over ``rate`` (default the f32 rate), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def count_hgmma(lib: str) -> int | None:
    """Phase 2: the HGMMA (wgmma) instructions in a built library's SASS,
    where the toolkit has ``cuobjdump``; None where it has not.  Fails on 0:
    the bf16 flash and SSD kernels must run on the tensor cores."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).is_file():
        log("cuobjdump not found: HGMMA count not taken")
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    log(f"cuobjdump -sass {Path(lib).name}: {n} HGMMA instructions")
    if n == 0:
        raise AssertionError(f"{Path(lib).name} has no HGMMA instruction")
    return n


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
    bound_ms, bound_by = bound(nbytes, flops)
    res = dict(P=P, D=D, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err, GBps=nbytes / ms / 1e6)
    log(f"time coded_reduce {label} f32 P={P} D={D}: kernel {ms:.4f} ms "
        f"({res['GBps']:.0f} GB/s, bound {bound_ms:.4f} ms by {res['bound_by']}, "
        f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, torch.mv {library_ms:.4f} ms, "
        f"max_abs_err {err:.3e}")
    del g, out
    torch.cuda.empty_cache()
    return res


def check_encode_vs_oracle(torch) -> int:
    """Phase 3, the fused int8 encode: q, scale and new_err BIT-equal to the
    numpy oracle whose reduce is the CUDA coded_reduce (f32 out), and NaN
    propagation.  Returns the number of bit-equal cases."""
    import numpy as np

    from repro_torch.kernels import ref, wire
    from repro_torch.kernels.coded_reduce import coded_reduce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def reduce_f32(g, w):
        return coded_reduce(g, w, torch.float32)

    def case(label, g, w, err, out_err=None):
        oq, oscale, onew = ref.encode_int8_oracle_np(g, w, err, reduce_fn=reduce_f32)
        q, scale, new_err = wire.coded_encode_int8(g, w, err, out_err=out_err)
        torch.cuda.synchronize()
        got_q, got_s, got_e = q.cpu().numpy(), scale.cpu().numpy(), new_err.cpu().numpy()
        bad = {
            "q": int(np.count_nonzero(got_q != oq)),
            "scale": int(got_s.tobytes() != np.float32(oscale).tobytes()),
            "new_err": int(np.count_nonzero(got_e.view(np.int32) != onew.view(np.int32))),
        }
        ok = not any(bad.values()) and got_q.shape == oq.shape
        log(f"check coded_encode_int8 {label}: bit-equal to the oracle "
            f"(differing q {bad['q']}, scale {bad['scale']}, new_err {bad['new_err']}; "
            f"scale {float(got_s):.6e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"coded_encode_int8 {label} is not bit-equal to the oracle")
        return q, scale, new_err

    def rand(P, D, dtype, err_scale=1e-3):
        g = torch.randn(P, D, generator=gen, device=dev).to(dtype)
        w = torch.randn(P, generator=gen, device=dev)
        return g, w, torch.randn(D, generator=gen, device=dev) * err_scale

    n = 0
    eps, inv = wire.kernel_constants()
    if inv.tobytes() != np.float32(1.0 / 127.0).tobytes() or eps.tobytes() != np.float32(1e-12).tobytes():
        raise AssertionError(f"kernel constants {eps!r}, {inv!r} lack the format's bits")
    log(f"check coded_encode_int8 constants: 1/127 as 0x{inv.view(np.uint32):08x}, "
        f"EPS as 0x{eps.view(np.uint32):08x}, the bits of np.float32: ok")
    for P in (1, 5, 130):
        for D in (1, 4095, 1_000_003, 1 << 20):
            for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                case(f"{name} P={P} D={D}", *rand(P, D, dtype))
                n += 1
    for P, D in [(8, 512), (8, 513), (1, 1), (1, 7), (7, 511), (2, 129), (20, 4097),
                 (128, 128), (130, 1025)]:
        case(f"edge f32 P={P} D={D}", *rand(P, D, torch.float32, 1e-2))
        n += 1
    z = torch.zeros(4, 100, device=dev)
    q, _, _ = case("all-zero coded (EPS floor)", z, torch.zeros(4, device=dev),
                   torch.zeros(100, device=dev))
    if q.any():
        raise AssertionError("a zero coded tensor gave non-zero q")
    n += 1
    w = torch.randn(6, generator=gen, device=dev)
    err = torch.zeros(777, device=dev)
    for step in range(6):
        g = torch.randn(6, 777, generator=gen, device=dev)
        _, _, err = case(f"error-feedback chain step {step}", g, w, err)
        n += 1
    g, w, err = rand(5, 1 << 20, torch.float32)
    q0, s0, e0 = wire.coded_encode_int8(g, w, err)
    case("in place, out_err=err", g, w, err, out_err=err)
    if e0.cpu().numpy().tobytes() != err.cpu().numpy().tobytes():
        raise AssertionError("out_err=err in place differs from a separate buffer")
    n += 1
    g, w, err = rand(3, 4096, torch.float32)
    g[1, 1234] = float("nan")
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    out = wire.coded_decode_int8(q[None], scale[None] * 0.0)
    if not (torch.isnan(scale) and torch.isnan(new_err).all() and torch.isnan(out).all()):
        raise AssertionError("a NaN in g did not reach the scale and the decode")
    log("check coded_encode_int8 NaN in g -> NaN scale, NaN new_err, NaN decode: ok")
    return n


def check_decode_vs_plain(torch) -> float:
    """Phase 3, the int8 decode against its plain version, within
    1e-5 x max(1, max|ref|).  Returns the largest scaled error."""
    from repro_torch.kernels import wire

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    for m, D in [(1, 1), (4, 4095), (4, 1_000_003), (4, 1 << 20), (10, 1500), (130, 4097)]:
        q = torch.randint(-127, 128, (m, D), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.randn(m, generator=gen, device=dev) * 1e-2
        got = wire.coded_decode_int8(q, ws)
        torch.cuda.synchronize()
        ref = wire.coded_decode_int8_torch(q, ws)
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        ok = err <= 1e-5 * scale and got.dtype == torch.float32 and got.shape == (D,)
        log(f"check coded_decode_int8 m={m} D={D}: max_abs_err {err:.3e} "
            f"(tolerance 1e-5 x max(1, max|ref|) = {1e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"coded_decode_int8 m={m} D={D} disagrees")
        worst = max(worst, err / scale)
    return worst


def time_encode(torch, P: int, D: int) -> dict:
    """Phase 4, the fused encode at f32 (P, D): kernel (in place, as the main
    path runs it), plain version, unfused composition (coded_reduce + the
    plain quantize, what ``--wire-kernel off`` runs)."""
    from repro_torch.kernels import ref, wire
    from repro_torch.kernels.coded_reduce import coded_reduce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(P + 1)
    g = torch.randn(P, D, generator=gen, device=dev)
    w = torch.randn(P, generator=gen, device=dev)
    err = torch.randn(D, generator=gen, device=dev) * 1e-3
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    pq, pscale, perr = wire.coded_encode_int8_torch(g, w, err)
    # the plain reduce rounds each product before it sums, so coded differs
    # in its last bits: the scale agrees to rtol 1e-6, at most 1 % of q moves
    # (by 1), and the reconstructed coded values q*scale + new_err agree to
    # 1e-5 x max(1, max|coded|)
    rel_scale = abs(float(scale) - float(pscale)) / float(pscale)
    dq = (q.int() - pq.int()).abs()
    moved = float((dq > 0).float().mean())
    recon = q.float() * scale + new_err
    precon = pq.float() * pscale + perr
    max_err = float((recon - precon).abs().max())
    tol = 1e-5 * max(1.0, float(precon.abs().max()))
    ok = rel_scale <= 1e-6 and int(dq.max()) <= 1 and moved <= 0.01 and max_err <= tol
    log(f"check coded_encode_int8 main-path shape f32 P={P} D={D} vs plain: scale rel diff "
        f"{rel_scale:.2e}, q moved in {moved:.2e} of entries (max {int(dq.max())}), "
        f"reconstructed coded max_abs_err {max_err:.3e} (tolerance {tol:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("coded_encode_int8 at the main path's shape disagrees with plain")
    del q, new_err, pq, perr, recon, precon, dq
    torch.cuda.empty_cache()
    ms = time_cuda(lambda: wire.coded_encode_int8(g, w, err, out_err=err))
    plain_ms = time_cuda(lambda: wire.coded_encode_int8_torch(g, w, err), reps=5, warmup=1)
    reduce_f32 = lambda gg, ww: coded_reduce(gg, ww, torch.float32)  # noqa: E731
    unfused_ms = time_cuda(lambda: ref.encode_int8_ref(g, w, err, reduce_fn=reduce_f32),
                           reps=5, warmup=1)
    nbytes = (4 * P + 9) * D  # g, err, new_err once each in f32, q in int8
    bound_ms, bound_by = bound(nbytes, (2 * P + 6) * D)
    res = dict(P=P, D=D, ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, bound_ms=bound_ms,
               bound_by=bound_by, max_abs_err=max_err, GBps=nbytes / ms / 1e6)
    log(f"time coded_encode_int8 f32 P={P} D={D}: kernel {ms:.4f} ms "
        f"({res['GBps']:.0f} GB/s of the least bytes, bound {bound_ms:.4f} ms by {bound_by}, "
        f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, unfused composition "
        f"{unfused_ms:.4f} ms, library call none ({NO_LIBRARY})")
    del g, err
    torch.cuda.empty_cache()
    return res


def time_decode(torch, m: int, D: int) -> dict:
    """Phase 4, the int8 decode at (m, D) int8 -> f32: kernel, plain
    version, unfused composition (dequantize to f32, then the f32
    coded_reduce: what ``--wire-kernel off`` decodes from)."""
    from repro_torch.kernels import wire
    from repro_torch.kernels.coded_reduce import coded_reduce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(m + 2)
    q = torch.randint(-127, 128, (m, D), generator=gen, device=dev, dtype=torch.int8)
    a = torch.randn(m, generator=gen, device=dev)
    scales = torch.rand(m, generator=gen, device=dev) * 1e-2
    ws = a * scales
    out = wire.coded_decode_int8(q, ws)
    ref = wire.coded_decode_int8_torch(q, ws)
    err = float((out - ref).abs().max())
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"coded_decode_int8 at the main path's shape: {err} > {tol}")
    del out, ref
    ms = time_cuda(lambda: wire.coded_decode_int8(q, ws))
    plain_ms = time_cuda(lambda: wire.coded_decode_int8_torch(q, ws), reps=5, warmup=1)
    unfused_ms = time_cuda(lambda: coded_reduce(q.float() * scales[:, None], a, torch.float32),
                           reps=5, warmup=1)
    nbytes = m * D + 4 * D
    bound_ms, bound_by = bound(nbytes, 2 * m * D)
    res = dict(m=m, D=D, ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, bound_ms=bound_ms,
               bound_by=bound_by, max_abs_err=err, GBps=nbytes / ms / 1e6)
    log(f"time coded_decode_int8 int8 m={m} D={D} -> f32: kernel {ms:.4f} ms "
        f"({res['GBps']:.0f} GB/s, bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} "
        f"of it), plain {plain_ms:.4f} ms, unfused composition {unfused_ms:.4f} ms, "
        f"max_abs_err {err:.3e} (tolerance {tol:.3e}), library call none ({NO_LIBRARY})")
    del q
    torch.cuda.empty_cache()
    return res


def launch_counters() -> dict:
    from repro_torch.kernels.coded_reduce import coded_reduce
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.wire import coded_decode_int8, coded_encode_int8

    return {"coded_reduce": coded_reduce, "coded_encode_int8": coded_encode_int8,
            "coded_decode_int8": coded_decode_int8, "ssd_scan": ssd_scan,
            "flash_attention": flash_attention}


def main_path(torch, label: str, args: list[str], expected, on_step=None,
              n_params_want: int = D_FULL, profile: bool = False) -> dict:
    """Phase 5: one slice command in process, every kernel's count set to 0
    just before it and read just after, then, with ``profile``, one more
    step under ``torch.profiler``.  ``expected(steps_taken)`` maps each
    kernel to the launches the path must make."""
    arch = args[args.index("--arch") + 1]
    from repro_torch.launch.train import main as train_main

    # the control plane is independent of the model: the same run at the
    # reduced width on the CPU must give the same per-step decode metrics
    log(f"control-plane replay of the {label} path (reduced width, CPU):")
    expect = train_main([*args, "--reduced", "--device", "cpu"])["history"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    log(f"main path ({label}): python -m repro_torch.launch.train " + " ".join(args))
    t0 = time.perf_counter()
    out = train_main([*args, "--device", "cuda"], on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    n_params = sum(p.numel() for p in out["state"].params.values())
    dtypes = sorted({str(p.dtype) for p in out["state"].params.values()})
    log(f"main path ({label}): {arch} full width, {n_params} parameters "
        f"({', '.join(dtypes)}), {len(hist)} steps in "
        f"{wall:.2f} s wall ({wall / max(len(hist), 1):.3f} s/step, launch and init included), "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}")
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
    if n_params != n_params_want:
        raise AssertionError(f"{n_params} parameters, expected {n_params_want} for {arch}")
    steps_taken = sum(1 for h in hist if h["skipped"] == 0.0)
    want = expected(steps_taken)
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want} for {steps_taken} steps")
    log(f"main path ({label}) ok: every loss finite, exact decode every step, "
        f"launches {launches} == expected for {steps_taken} steps")
    losses = [h["loss"] for h in hist]
    steady = statistics.median(out["step_s"][1:])
    log(f"main path ({label}) step time: median of steps 1-{STEPS - 1} {steady:.4f} s "
        f"(step 0 {out['step_s'][0]:.4f} s includes the first batch and warm-up)")
    breakdown = profile_step(torch, out, label) if profile else {}
    del out
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps_taken, peak_gib=peak / 2**30, wall_s=wall,
                losses=losses,
                n_params=n_params, step_s=steady, breakdown=breakdown)


def check_err_after_step(torch):
    """The compressed path's per-step hook: every worker's error feedback
    is finite and non-zero after every step."""

    def hook(trainer, step, state, metrics):
        err = trainer.engine._err
        finite = bool(torch.isfinite(err).all())
        mx = float(err.abs().max())
        log(f"  after step {step}: error feedback {tuple(err.shape)} finite {finite}, "
            f"max|err| {mx:.3e}")
        if not (finite and mx > 0 and tuple(err.shape) == (M, D_FULL)):
            raise AssertionError(f"step {step}: error feedback not finite and non-zero")

    return hook


def profile_step(torch, out, label: str) -> dict:
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
    averages = prof.key_averages()  # one pass over the step's events
    for ev in averages:
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
        elif "ssd_scan" in name:
            grp = "ssd_scan"
        elif "encode_coded_max" in name or "encode_quantize" in name:
            grp = "coded_encode_int8"
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
        log(f"profile ({label}): the profiler reported no device time (not measured)")
        return {}
    log(f"profile of one {label} main-path step: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), idle share {1 - busy / wall_ms:.1%}")
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {grp}: {ms:.1f} ms device ({ms / busy:.1%} of busy), {counts[grp]} launches")
    log(f"  {sum(c for _, c, _ in kernels)} device operations in the step; the 8 largest:")
    for ms, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"    {ms:8.2f} ms {count:7d}x {key[:100]}")
    host = sorted(((ev.self_cpu_time_total / 1e3, int(ev.count), ev.key)
                   for ev in averages if ev.device_type == DeviceType.CPU),
                  reverse=True)
    log(f"  host: {sum(ms for ms, _, _ in host):.1f} ms of self CPU time in the step "
        "(profiler overhead included); the 8 largest ops:")
    for ms, count, key in host[:8]:
        log(f"    {ms:8.2f} ms {count:7d}x {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **{f"{g}_ms": v for g, v in groups.items()}}


def _attempts(records: list[dict]) -> list[tuple[int, int]]:
    """(engine.step attempts, m) of each step of a traced run: the
    ``phase.spmd.grads`` spans inside each ``step`` span (one a gradient
    attempt, repairs included), and the worker count of its ``train.step``
    record (evictions apply at the top of a step, before its attempts)."""
    spans = [r for r in records if r["kind"] == "span"]
    steps = sorted((r for r in spans if r["name"] == "step"), key=lambda r: r["args"]["step"])
    grads = [r for r in spans if r["name"] == "phase.spmd.grads"]
    m_of = {r["args"]["step"]: int(r["args"]["m"]) for r in records
            if r["kind"] == "event" and r["name"] == "train.step"}
    return [(sum(1 for g in grads if s["t0"] <= g["t0"] and g["t1"] <= s["t1"]),
             m_of[s["args"]["step"]]) for s in steps]


def _same_bits(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def fault_path(torch) -> dict:
    """Phase 9, the fault-tolerant trainer at full width on the int8 wire:
    (a) a faulted, traced, checkpointed run, held against a CPU replay at
    reduced width (the control plane does not depend on width) and its
    kernels' launches against the attempts its event log shows; (b)
    ``obs_report`` on its event log; (c) ``--resume`` from its last
    checkpoint on the uncompressed wire, the restored state bit-equal to
    the saved one.  The checkpoints (params, f32 master and moments, about
    5.8 GB each) live under build/ and are removed at the end."""
    import contextlib
    import io
    import shutil

    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.launch import obs_report
    from repro_torch.launch.train import main as train_main

    tmp = ROOT / "build" / "chip_smoke_faults"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ck, logf, tracef = tmp / "ck", tmp / "run.jsonl", tmp / "run.trace.json"
    try:
        free = shutil.disk_usage(tmp).free
        log(f"fault path: {free / 2**30:.1f} GiB free under {tmp}")
        # (a) the CPU replay, then the run on the card
        log("control-plane replay of the fault path (reduced width, CPU):")
        replay = train_main([*FAULT_ARGS, "--reduced", "--device", "cpu",
                             "--log-jsonl", str(tmp / "replay.jsonl")])
        replay_att = _attempts(obs_report.load_records(str(tmp / "replay.jsonl")))
        counters = launch_counters()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0

        def check_err(trainer, step, state, metrics):
            err = trainer.engine._err
            finite = bool(torch.isfinite(err).all())
            log(f"  after step {step}: m {trainer.m}, error feedback {tuple(err.shape)} "
                f"finite {finite}, max|err| {float(err.abs().max()):.3e}")
            if not finite or tuple(err.shape) != (trainer.m, D_FULL):
                raise AssertionError(f"step {step}: error feedback not finite or not "
                                     f"({trainer.m}, {D_FULL})")

        args = [*FAULT_ARGS, "--ckpt-dir", str(ck), "--ckpt-every", str(CKPT_EVERY),
                "--trace-out", str(tracef), "--log-jsonl", str(logf), "--device", "cuda"]
        log("fault path (a): python -m repro_torch.launch.train " + " ".join(args))
        t0 = time.perf_counter()
        out = train_main(args, on_step=check_err)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        hist, summary, trainer = out["history"], out["summary"], out["trainer"]
        records = obs_report.load_records(str(logf))
        att = _attempts(records)
        ms = [m for _, m in att]
        for i, (h, (n, m)) in enumerate(zip(hist, att)):
            log(f"  step {i}: {out['step_s'][i]:.4f} s, m {m}, attempts {n}, loss {h['loss']:.5f} "
                f"grad_norm {h['grad_norm']:.4f} n_used {h['n_used']:.0f} exact {h['exact']:.0f} "
                f"repaired {h.get('repaired', 0.0):.0f} skipped_nonfinite "
                f"{h['skipped_nonfinite']:.0f}")
        log(f"fault path (a): {len(hist)} steps in {wall:.2f} s wall (init, checkpoints and "
            f"trace included), peak memory {peak:.2f} GiB, launches {launches}, "
            f"resilience {summary['resilience']}, m_final {summary['m_final']}")
        if len(hist) != FAULT_STEPS or len(att) != FAULT_STEPS:
            raise AssertionError(f"ran {len(hist)} steps ({len(att)} traced), "
                                 f"expected {FAULT_STEPS}")
        for i, (h, e) in enumerate(zip(hist, replay["history"])):
            finite = math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            if not (finite or h["skipped_nonfinite"] == 1.0):
                raise AssertionError(f"step {i}: non-finite and not skipped_nonfinite: {h}")
            for key in TRAJECTORY:
                if h.get(key, 0.0) != e.get(key, 0.0):
                    raise AssertionError(f"step {i}: {key} {h.get(key)} != CPU replay {e.get(key)}")
        if att != replay_att or summary["resilience"] != replay["summary"]["resilience"] \
                or summary["m_final"] != replay["summary"]["m_final"]:
            raise AssertionError(f"trajectory {att} {summary['resilience']} m_final "
                                 f"{summary['m_final']} != CPU replay {replay_att} "
                                 f"{replay['summary']['resilience']} "
                                 f"{replay['summary']['m_final']}")
        m_final = summary["m_final"]
        repaired = sum(h.get("repaired", 0.0) for h in hist)
        if not (repaired >= 1 and summary["resilience"]["evictions"] >= 1 and m_final < M
                and ms[-1] == m_final and hist[-1]["exact"] == 1.0):
            raise AssertionError(f"the run shows no repair, eviction and exact step at the "
                                 f"smaller m: repaired {repaired}, {summary['resilience']}, m {ms}")
        err = trainer.engine._err
        if tuple(err.shape) != (m_final, D_FULL) or not bool(torch.isfinite(err).all()):
            raise AssertionError(f"final error feedback {tuple(err.shape)} not finite "
                                 f"({m_final}, {D_FULL})")
        # the encode m_cur a step attempt, the decode 1 (counted in coded_reduce too)
        n_att = sum(n for n, _ in att)
        want = {"coded_reduce": n_att, "coded_encode_int8": sum(n * m for n, m in att),
                "coded_decode_int8": n_att, "ssd_scan": 0, "flash_attention": 0}
        if launches != want:
            raise AssertionError(f"launches {launches} != {want} from the attempts {att}")
        log(f"fault path (a) ok: {repaired:.0f} steps repaired, m {ms}, every step finite or "
            f"skipped, launches == the attempts' {want}, trajectory == CPU replay")
        step_s = out["step_s"]
        state = out["state"]
        del out, trainer, err
        torch.cuda.empty_cache()

        # (b) obs_report on the event log
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            obs_report.main([str(logf)])
        report = buf.getvalue()
        log("fault path (b): python -m repro_torch.launch.obs_report " + str(logf))
        for line in report.splitlines():
            log("  | " + line)
        convicted = [c["worker"] for c in obs_report.fault_section(records)["convictions"]]
        for want_text in ("phase.spmd.pack", "phase.spmd.grads", "phase.spmd.unravel",
                          "== faults ==", "-- convictions --"):
            if want_text not in report:
                raise AssertionError(f"obs_report printed no {want_text!r}")
        if not convicted or summary["resilience"]["convictions"] != len(convicted):
            raise AssertionError(f"fault section convictions {convicted} != {summary['resilience']}")
        phases = {r["phase"]: r for r in obs_report.phase_table(records) if r["clock"] == "wall"}
        split = {name: {"n": phases[name]["n"], "total_ms": phases[name]["total_s"] * 1e3,
                        "p50_ms": phases[name]["p50"] * 1e3}
                 for name in ("step", "phase.pack+encode+wire+decode", "phase.spmd.pack",
                              "phase.spmd.grads", "phase.spmd.unravel", "phase.loss",
                              "phase.apply", "prefetch.upload") if name in phases}
        log(f"fault path (b) ok: convicted workers {convicted}; phase split (ms) {split}")

        # (c) resume: the restored state bit-equal to the saved one, then more steps
        last = latest_step(str(ck))
        t1 = time.perf_counter()
        restored, meta = restore_checkpoint(str(ck), last, {"params": state.params,
                                                            "opt": state.opt})
        restore_s = time.perf_counter() - t1
        opt, ropt = state.opt, restored["opt"]
        pairs = [(state.params, restored["params"]), (opt.mu, ropt.mu), (opt.nu, ropt.nu),
                 (opt.master or {}, ropt.master or {})]
        n_leaves = sum(len(a) for a, _ in pairs)
        if last != FAULT_STEPS or ropt.step != opt.step or not all(
                _same_bits(torch, a[k], b[k]) for a, b in pairs for k in a):
            raise AssertionError(f"checkpoint {last} does not restore bit-equal to the state "
                                 f"the run ended with")
        ck_gb = sum(f.stat().st_size for f in (ck / f"step_{last:08d}").iterdir()) / 1e9
        log(f"fault path (c): checkpoint step {last} ({ck_gb:.2f} GB on disk, meta {meta}) "
            f"restored in {restore_s:.2f} s, {n_leaves} leaves (params, mu, nu, master) and "
            f"the optimizer step bit-equal to the saved state")
        del state, opt, restored, ropt, pairs
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        args = [*RESUME_ARGS, "--ckpt-dir", str(ck), "--resume", "--device", "cuda"]
        log("fault path (c): python -m repro_torch.launch.train " + " ".join(args))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train_main(args)
        torch.cuda.synchronize()
        for line in buf.getvalue().splitlines():
            log("  | " + line)
        r_launches = {name: fn.launches for name, fn in counters.items()}
        n_res = RESUME_STEPS - FAULT_STEPS
        r_want = {"coded_reduce": n_res * (M + 1), "coded_encode_int8": 0,
                  "coded_decode_int8": 0, "ssd_scan": 0, "flash_attention": 0}
        if f"resumed from step {FAULT_STEPS}" not in buf.getvalue():
            raise AssertionError(f"no 'resumed from step {FAULT_STEPS}' line")
        if res["summary"]["steps_run"] != n_res or len(res["history"]) != n_res or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in res["history"]):
            raise AssertionError(f"resume: {res['summary']}, {res['history']}")
        if r_launches != r_want:
            raise AssertionError(f"resume launches {r_launches} != {r_want}")
        log(f"fault path (c) ok: {n_res} more finite steps, losses "
            f"{[h['loss'] for h in res['history']]}, launches {r_launches}")
        del res
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(wall_s=wall, steps=FAULT_STEPS, step_s=step_s, attempts=att, m=ms,
                launches=launches, resilience=summary["resilience"], m_final=m_final,
                peak_gib=peak, phase_split=split, convicted=convicted, ckpt_gb=ck_gb,
                restore_s=restore_s, resume_launches=r_launches)


def rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every leaf of ``b``, in f64."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


def cross_check(torch, arch: str, seq_len: int, part_mb: int, wire: bool) -> dict:
    """Phase 6 at full width in f32, TF32 off, one faulted worker: spmd
    (kernels) vs fused (autograd), relative L2 <= 1e-4; with ``wire``, the
    compressed spmd gradient with the wire kernel on vs off, each against
    the uncompressed fused one.  The fused backend takes all m * n_slots
    coded micro-batches in one pass, so ``part_mb`` x ``seq_len`` must fit."""
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
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = build_model(cfg)
    codec = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1)
    outcome = codec.decode_outcome([w for w in range(M) if w != 1])  # worker 1 faulted
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticData(cfg, k=codec.k, part_mb=part_mb, seq_len=seq_len, seed=0).batch(0)
    runs = [("fused", dict(backend="fused")), ("spmd", dict(backend="spmd"))]
    if wire:
        runs += [("wire_on", dict(backend="spmd", compress=True, wire_kernel=True)),
                 ("wire_off", dict(backend="spmd", compress=True, wire_kernel=False))]
    grads = {}
    for name, kw in runs:
        eng = StepEngine(model, TrainConfig(), codec, device=dev, **kw)
        grads[name] = eng.gradients(params, batch, outcome)
        torch.cuda.synchronize()
        del eng
        torch.cuda.empty_cache()
    rel = rel_l2(grads["spmd"], grads["fused"])
    ok = rel <= 1e-4
    log(f"cross-check {arch} f32 full width, micro-batches of {part_mb} x {seq_len} tokens, "
        f"decode a={list(map(float, outcome.a))}: spmd vs fused relative L2 error {rel:.3e} "
        f"(limit 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} spmd vs fused relative L2 error {rel} > 1e-4")
    if not wire:
        del grads, params
        torch.cuda.empty_cache()
        return dict(rel_l2=rel)
    # wire on vs off: the fused and unfused quantize differ by at most 1 ulp
    # of the scale (the bound of the JAX package's check_engine_spmd_wire)
    worst_excess, max_diff = -math.inf, 0.0
    for k in params:
        on, off = grads["wire_on"][k].double(), grads["wire_off"][k].double()
        diff = (on - off).abs()
        worst_excess = max(worst_excess, float((diff - (2e-5 + 1e-4 * off.abs())).max()))
        max_diff = max(max_diff, float(diff.max()))
    ok = worst_excess <= 0.0
    log(f"cross-check wire kernel on vs off: max_abs_diff {max_diff:.3e}, "
        f"within rtol 1e-4 atol 2e-5 {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("compressed gradients with the wire kernel on and off disagree")
    # each within 0.05 of max|.| of the uncompressed gradient (the int8
    # wire's compression tolerance in check_engine_spmd_wire).  One scale covers
    # the whole flat vector, so the quantization error is bounded against
    # the vector's max, not each leaf's: checked on the whole vector, and
    # each leaf's max|diff|/max|fused| printed beside it
    fused_max = max(float(grads["fused"][k].abs().max()) for k in params)
    wire_rel, leaf_rel = {}, {}
    for name in ("wire_on", "wire_off"):
        diffs = {k: float((grads[name][k] - grads["fused"][k]).abs().max()) for k in params}
        leaf_rel[name] = {k: d / (float(grads["fused"][k].abs().max()) + 1e-9)
                          for k, d in diffs.items()}
        wire_rel[name] = max(diffs.values()) / fused_max
        ok = wire_rel[name] < 0.05
        log(f"cross-check {name} vs uncompressed fused: max|diff|/max|fused| over the whole "
            f"gradient {wire_rel[name]:.3e} (limit 0.05) {'ok' if ok else 'FAIL'}; per leaf "
            "(not checked): " + ", ".join(f"{k} {v:.2e}" for k, v in leaf_rel[name].items()))
        if not ok:
            raise AssertionError(f"{name} gradient outside the int8 wire's tolerance")
    del grads, params
    torch.cuda.empty_cache()
    return dict(rel_l2=rel, wire_on_off_max_abs_diff=max_diff, wire_vs_fused=wire_rel,
                wire_vs_fused_worst_leaf={n: max(v.values()) for n, v in leaf_rel.items()})


def ssd_inputs(torch, B, S, H, P, G, N, bc_dtype, seed, model_dA=False):
    """SSD scan inputs on the card: x (pre-multiplied by dt) and dA f32, B and
    C in ``bc_dtype``.  ``model_dA`` draws dt as mamba2-370m's layer does at
    init (softplus(N(0,1) + dt_bias), dt_bias the inverse softplus of
    log-uniform [1e-3, 0.1]) and A = -(1..H), so cumsum(dA) over a 256-row
    chunk falls to hundreds below zero; otherwise the draws of
    tests/test_kernels.py (dt ~ U(0.01, 0.2), A ~ -U(0.3, 2))."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if model_dA:
        u = torch.rand(H, generator=gen, device=dev)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        raw = torch.randn(B, S, H, generator=gen, device=dev)
        dt = torch.logaddexp(raw + dt_bias, torch.zeros((), device=dev))
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        act = torch.nn.functional.silu
        x = act(torch.randn(B, S, H, P, generator=gen, device=dev))
        Bm = act(torch.randn(B, S, G, N, generator=gen, device=dev))
        Cm = act(torch.randn(B, S, G, N, generator=gen, device=dev))
    else:
        dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.19 + 0.01
        A = -(torch.rand(H, generator=gen, device=dev) * 1.7 + 0.3)
        x = torch.randn(B, S, H, P, generator=gen, device=dev)
        Bm = torch.randn(B, S, G, N, generator=gen, device=dev)
        Cm = torch.randn(B, S, G, N, generator=gen, device=dev)
    return ((x * dt[..., None]).contiguous(), (dt * A).contiguous(),
            Bm.to(bc_dtype).contiguous(), Cm.to(bc_dtype).contiguous())


def check_ssd_vs_plain(torch) -> dict:
    """Phase 3, the SSD scan: y and h of the kernel against the plain
    chunked version on the card.  The shapes of tests/test_kernels.py
    (G > 1 among them; chunk S/4), f32 and bf16 B/C, within atol 1e-4 /
    rtol 1e-3 as the JAX test; then the full mamba2 layer (chunk 256,
    model-drawn dA) within 1e-3 x max|plain|, finite: at the training shape
    with bf16 and f32 B/C, and at the serving prefills' shapes (B=4 S=1024
    of ``generate``, B=1 S=2048 of the engine's longest prompt) with bf16
    B/C, as the bf16 model gives them.  The decay is exp of a
    difference of cumulative sums, which the two sum in different orders
    (the kernels' own chunks against 256-row ones): where |cumsum| reaches
    hundreds, the f32 spacing (6e-5 at 800) moves the decay by about 1e-4
    relative."""
    from repro_torch.kernels import ssd_scan as ssd

    worst = 0.0
    for S_, H, G, P, N in [(32, 2, 1, 8, 16), (64, 4, 2, 16, 32), (64, 4, 4, 8, 8),
                           (96, 8, 2, 32, 16)]:
        for bc_name, bc in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            for seed in range(2):
                x, dA, Bm, Cm = ssd_inputs(torch, 2, S_, H, P, G, N, bc, seed)
                y, h = ssd.ssd_scan(x, dA, Bm, Cm, S_ // 4)
                torch.cuda.synchronize()
                py, ph = ssd.ssd_scan_torch(x, dA, Bm, Cm, S_ // 4)
                errs = [float((y - py).abs().max()), float((h - ph).abs().max())]
                ok = (torch.allclose(y, py, atol=1e-4, rtol=1e-3)
                      and torch.allclose(h, ph, atol=1e-4, rtol=1e-3))
                log(f"check ssd_scan S={S_} H={H} G={G} P={P} N={N} B/C {bc_name} seed {seed}: "
                    f"max_abs_err y {errs[0]:.3e} h {errs[1]:.3e} (atol 1e-4, rtol 1e-3) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"ssd_scan S={S_} H={H} G={G} P={P} N={N} {bc_name} disagrees")
                worst = max(worst, *errs)
    full = {}
    for B_, S_, bc_name, bc in (
        (SSD_FULL["B"], SSD_FULL["S"], "bf16", torch.bfloat16),
        (SSD_FULL["B"], SSD_FULL["S"], "f32", torch.float32),
        (GEN["B"], GEN["S"], "bf16", torch.bfloat16),
        (1, TRACE["prompt"][1], "bf16", torch.bfloat16),
    ):
        f = dict(SSD_FULL, B=B_, S=S_)
        x, dA, Bm, Cm = ssd_inputs(torch, f["B"], f["S"], f["H"], f["P"], f["G"], f["N"], bc,
                                   11, model_dA=True)
        low = float(dA.reshape(f["B"], -1, f["chunk"], f["H"]).cumsum(2).min())
        y, h = ssd.ssd_scan(x, dA, Bm, Cm, f["chunk"])
        torch.cuda.synchronize()
        py, ph = ssd.ssd_scan_torch(x, dA, Bm, Cm, f["chunk"])
        finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
        ey, eh = float((y - py).abs().max()), float((h - ph).abs().max())
        ty, th = 1e-3 * float(py.abs().max()), 1e-3 * float(ph.abs().max())
        ok = finite and ey <= ty and eh <= th and bool(torch.isfinite(py).all())
        log(f"check ssd_scan full layer B={f['B']} S={f['S']} H={f['H']} P={f['P']} G={f['G']} "
            f"N={f['N']} chunk {f['chunk']} B/C {bc_name}, min cumsum(dA) over a chunk {low:.1f}: "
            f"finite {finite}, max_abs_err y {ey:.3e} (limit {ty:.3e}), h {eh:.3e} "
            f"(limit {th:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssd_scan at the full layer shape B={B_} S={S_} ({bc_name}) "
                                 "disagrees")
        full[f"B{B_}_S{S_}_{bc_name}"] = dict(max_abs_err=max(ey, eh), min_cumsum=low)
        del x, dA, Bm, Cm, y, h, py, ph
    torch.cuda.empty_cache()
    return dict(worst_small=worst, full=full)


def time_ssd(torch) -> dict:
    """Phase 4, the SSD scan at the full mamba2 layer's heads (H=32, P=64,
    G=1, N=128, chunk 256) and bf16 B/C, as the main path gives them, at
    each (B, S) of SSD_TIMED: the training micro-batch, ``generate``'s
    prefill and the engine's longest prompt.  Each kernel reading spans
    SSD_BATCH calls (the device's time a call once the host runs ahead);
    the plain version is read one call at a time; no library call computes
    it.  The bound counts the least work of any form of the scan: the state
    update and the readout, one multiply-add each per (row, head, p, n),
    4*B*S*H*P*N operations, over the bf16 tensor-core rate (the unit the
    bf16 kernel runs them on), against each input read once and y, h
    written once; the same operations over the f32 CUDA-core rate are
    logged beside it, and so is the tensor-core kernel's own executed work
    (its split products and its 128-row chunks' triangles, csrc/ssd_scan.cu).
    The first shape's numbers head the result."""
    from repro_torch.kernels import ssd_scan as ssd

    f = SSD_FULL
    H, P, G, N, chunk = f["H"], f["P"], f["G"], f["N"], f["chunk"]
    shapes = []
    for B, S_ in SSD_TIMED:
        x, dA, Bm, Cm = ssd_inputs(torch, B, S_, H, P, G, N, torch.bfloat16, 12, model_dA=True)
        y, h = ssd.ssd_scan(x, dA, Bm, Cm, chunk)
        py, ph = ssd.ssd_scan_torch(x, dA, Bm, Cm, chunk)
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        del y, h, py, ph
        ms = time_cuda(lambda: ssd.ssd_scan(x, dA, Bm, Cm, chunk), batch=SSD_BATCH)
        passes = device_split(torch, lambda: ssd.ssd_scan(x, dA, Bm, Cm, chunk), SSD_BATCH)
        plain_ms = time_cuda(lambda: ssd.ssd_scan_torch(x, dA, Bm, Cm, chunk), reps=5, warmup=1)
        # x, dA, B, C read once; y and h written once
        nbytes = (2 * x.numel() + dA.numel() + B * H * P * N) * 4 + (Bm.numel() + Cm.numel()) * 2
        flops = 4 * B * S_ * H * P * N
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        f32_bound_ms = bound(nbytes, flops)[0]
        # the tensor-core kernel's executed work a call, at its L-row chunks:
        # C B^T per (batch, group, chunk) over the 64 x 64 and 64 x L blocks
        # its two row halves read; per (batch, chunk, head) the state
        # product twice (X tail split), the readout twice (h split, chunks
        # after the first) and the intra-chunk product three times
        nc, L = -(-S_ // SSD_CHUNK), SSD_CHUNK
        tri = 64 * 64 + 64 * L
        flops_kernel = (2 * B * nc * (G * tri * N + H * (2 * P * L * N + 3 * tri * P))
                        + 2 * 2 * B * (nc - 1) * H * L * P * N)
        kernel_ms = bound(nbytes, flops_kernel, BF16_FLOPS)[0]
        shapes.append(dict(B=B, S=S_, ms=ms, passes_ms=passes, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, f32_bound_ms=f32_bound_ms,
                           max_abs_err=err, flops=flops, flops_kernel=flops_kernel,
                           nbytes=nbytes, TFLOPs=flops / ms / 1e9))
        log(f"time ssd_scan B={B} S={S_} H={H} P={P} G={G} N={N} bf16 B/C: kernel {ms:.4f} ms "
            f"a call ({SSD_BATCH} calls a reading; {flops / ms / 1e9:.2f} TFLOP/s of the least "
            f"{flops / 1e9:.3f} GFLOP; bound {bound_ms:.4f} ms by {bound_by} over "
            f"{nbytes / 1e6:.2f} MB, {bound_ms / ms:.1%} of it; the same operations on the f32 "
            f"CUDA cores {f32_bound_ms:.4f} ms; the tensor-core kernel's own "
            f"{flops_kernel / 1e9:.3f} GFLOP would take {kernel_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library call none ({NO_SSD_LIBRARY}), max_abs_err "
            f"{err:.3e}; device time a call by kernel (profiler): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
        del x, dA, Bm, Cm
        torch.cuda.empty_cache()
    return dict(shapes[0], shape=f, shapes=shapes)


def mamba_kernel_check(torch) -> dict:
    """Phase 6 for mamba2-370m at full width in f32, TF32 off: one
    micro-batch of the main path's shape (2 x 512, two chunks) through the
    SSD kernel against ``ssd_impl="torch"``.  The weighted loss within 1e-4
    relative, and the gradients within relative L2 1e-3, over all leaves and
    over each mamba leaf on its own.  At random init the loss and the
    all-leaf number hardly see the SSD output (the tied embedding's gradient
    dominates); the mamba leaves' gradients are the ones that do."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(MAMBA), dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    part = SyntheticData(cfg, k=1, part_mb=2, seq_len=MAMBA_SEQ, seed=3).partition(0, 0)
    mb = {k: torch.as_tensor(v, device=dev) for k, v in part.items()}
    mb["weight"] = torch.full((2,), 0.5, device=dev)
    out = {}
    for impl in (None, "torch"):
        m_impl = build_model(cfg, ssd_impl=impl)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        before = launch_counters()["ssd_scan"].launches
        loss = m_impl.weighted_loss(leaves, mb)
        g = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        launched = launch_counters()["ssd_scan"].launches - before
        out[impl or "kernel"] = (float(loss.detach()), dict(zip(params, g)), launched)
        del leaves, loss, g
    (lk, gk, nk), (lt, gt, nt) = out["kernel"], out["torch"]
    loss_rel = abs(lk - lt) / abs(lt)
    grad_rel = rel_l2(gk, gt)
    leaf_rel = {k: rel_l2({k: gk[k]}, {k: gt[k]}) for k in gt if ".mamba." in k}
    ok = (loss_rel <= 1e-4 and grad_rel <= 1e-3 and max(leaf_rel.values()) <= 1e-3
          and nk == MAMBA_LAYERS and nt == 0)
    log(f"cross-check {MAMBA} f32 full width, one 2 x {MAMBA_SEQ} micro-batch: weighted loss "
        f"through the kernel {lk:.6f} vs plain {lt:.6f}, relative diff {loss_rel:.3e} (limit "
        f"1e-4); gradients relative L2 {grad_rel:.3e} over all leaves (limit 1e-3), each mamba "
        "leaf (limit 1e-3): " + ", ".join(f"{k} {v:.3e}" for k, v in leaf_rel.items())
        + f"; kernel launches {nk} / {nt} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mamba2 loss or gradients through the SSD kernel disagree with plain")
    del out, params
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, mamba_leaf_rel_l2=leaf_rel)


def flash_inputs(torch, B, S, H, K, hd, dtype, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=gen, device=dev).to(dtype) for n in (H, K, K)]


def check_flash_vs_plain(torch) -> dict:
    """Phase 3, flash attention: the kernel against its plain version on
    the card.  The JAX test's shapes (causal or not, window None or 32, f32
    and bf16) at its tolerances, 2e-3 at f32 and 3e-2 at bf16.  Then, at
    FLASH_TOL, ragged S at smollm-360m's heads with windows 1 and wider than
    S, hd = 128, the stress cases of the tensor-core kernel (a peaked
    softmax, q x 8, which drives the m rescaling; zero-mean v, outputs near
    0 where atol decides; GQA groups G in {1, 3, 5} with windows across the
    64-row tile edges; every head size at a ragged S), and the full prefill
    shapes (bf16, causal), finite: both sides compute in f32 and round once
    to the output dtype, so they may part by one bf16 spacing of the value
    (at most 2^-7 of it) and no more."""
    from repro_torch.kernels import flash_attention as fa

    sweep_tol = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (3e-2, 3e-2)}
    bf16, tight = torch.bfloat16, FLASH_TOL["bf16"]
    h = SMOLLM_HEADS
    cases = []  # (B, S, H, K, hd, dtype, causal, window, tol, inputs)
    for S_, H, K, hd in [(64, 4, 2, 32), (128, 6, 3, 32), (128, 8, 8, 64), (64, 5, 1, 16)]:
        for causal in (True, False):
            for window in (None, 32):
                for dt in (torch.float32, bf16):
                    cases.append((2, S_, H, K, hd, dt, causal, window, sweep_tol[dt], None))
    for S_ in (1, 100, 1000, 2047):
        for window in (None, 1, S_ + 1):
            cases.append((1, S_, h["H"], h["K"], h["hd"], bf16, True, window, tight, None))
    for name, dt in (("f32", torch.float32), ("bf16", bf16)):
        cases.append((2, 300, 8, 2, 128, dt, True, None, FLASH_TOL[name], None))
    for kind in ("peaked", "zero_mean_v"):
        cases.append((1, 2048, h["H"], h["K"], h["hd"], bf16, True, None, tight, kind))
    for G in (1, 3, 5):
        for window in (63, 64, 65, 129):
            cases.append((1, 300, 2 * G, 2, 64, bf16, True, window, tight, None))
    for hd in fa.HEAD_DIMS:
        cases.append((2, 333, 6, 2, hd, bf16, True, None, tight, None))
    worst = 0.0
    for i, (B, S_, H, K, hd, dt, causal, window, (atol, rtol), kind) in enumerate(cases):
        q, k, v = flash_inputs(torch, B, S_, H, K, hd, dt, i)
        if kind == "peaked":
            q = (q.float() * 8).to(dt)
        elif kind == "zero_mean_v":
            v = (v.float() - v.float().mean(dim=1, keepdim=True)).to(dt)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_torch(q, k, v, causal=causal, window=window)
        err = float((out.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(out.float()).all())
        ok = finite and out.dtype == dt and bool(torch.allclose(out.float(), ref.float(),
                                                                atol=atol, rtol=rtol))
        log(f"check flash_attention B={B} S={S_} H={H} K={K} hd={hd} {str(dt)[6:]} "
            f"causal={causal} window={window}{' ' + kind if kind else ''}: finite {finite}, "
            f"max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention case {i} disagrees with the plain version")
        worst = max(worst, err)
    full = {}
    atol, rtol = FLASH_TOL["bf16"]
    for B, S_ in ((1, 2048), (4, 1024)):
        q, k, v = flash_inputs(torch, B, S_, h["H"], h["K"], h["hd"], torch.bfloat16, B)
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = fa.flash_attention_torch(q, k, v, causal=True)
        err = float((out.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(out.float()).all())
        ok = finite and bool(torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))
        log(f"check flash_attention full prefill B={B} S={S_} H={h['H']} K={h['K']} "
            f"hd={h['hd']} bf16 causal: finite {finite}, max_abs_err {err:.3e} (atol {atol:g}, "
            f"rtol {rtol:g}; max|plain| {float(ref.float().abs().max()):.3f}, rms "
            f"{float(ref.float().pow(2).mean().sqrt()):.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention at the full prefill shape B={B} S={S_}")
        full[f"B{B}_S{S_}"] = err
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return dict(cases=len(cases) + len(full), worst_small=worst, full=full)


def time_flash(torch) -> dict:
    """Phase 4, flash attention at smollm-360m's heads, bf16, causal, at
    each shape of FLASH_TIMED: the kernel and
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    (B, H, S, hd) views (the library call: timed here, never used by the
    port) in turns, kernel, library, library, kernel, each reading a median
    of 10 launches, and the plain version.  The bound counts the least work,
    the causal half of the two products, 4 * hd * B * H * S(S+1)/2
    operations over the bf16 tensor-core rate, against q, k, v and o moved
    once.  Each reading spans FLASH_BATCH launches (the device's time per
    call); the same turns with one launch a reading, which adds the host's
    time to launch, are kept beside them.  The first shape's numbers head
    the result."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    H, K, hd = SMOLLM_HEADS["H"], SMOLLM_HEADS["K"], SMOLLM_HEADS["hd"]
    shapes = []
    for B, S_ in FLASH_TIMED:
        q, k, v = flash_inputs(torch, B, S_, H, K, hd, torch.bfloat16, 99)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        ref = fa.flash_attention_torch(q, k, v, causal=True)
        err = float((kern().float() - ref.float()).abs().max())
        lib_err = float((lib().transpose(1, 2).float() - ref.float()).abs().max())
        del ref
        turns = [time_cuda(f, batch=FLASH_BATCH) for f in (kern, lib, lib, kern)]
        single = [time_cuda(f) for f in (kern, lib, lib, kern)]
        plain_ms = time_cuda(lambda: fa.flash_attention_torch(q, k, v, causal=True), reps=5,
                             warmup=1)
        flops = 4 * hd * B * H * S_ * (S_ + 1) // 2
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        shapes.append(dict(
            B=B, S=S_, **SMOLLM_HEADS, ms=ms, library_ms=library_ms, plain_ms=plain_ms,
            turns_ms=turns, single_launch_ms=(single[0] + single[3]) / 2,
            library_single_launch_ms=(single[1] + single[2]) / 2, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=err, library_max_abs_err=lib_err, flops=flops,
            nbytes=nbytes, TFLOPs=flops / ms / 1e9))
        log(f"time flash_attention B={B} S={S_} H={H} K={K} hd={hd} bf16 causal: kernel "
            f"{ms:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}; {flops / ms / 1e9:.2f} TFLOP/s of the "
            f"least {flops / 1e9:.3f} GFLOP; bound {bound_ms:.4f} ms by {bound_by} over "
            f"{nbytes / 1e6:.2f} MB, {bound_ms / ms:.1%} of it), scaled_dot_product_attention "
            f"{library_ms:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}; its max_abs_err "
            f"{lib_err:.3e}), kernel / library {ms / library_ms:.2f}; one launch alone: kernel "
            f"{single[0]:.4f}, {single[3]:.4f}, library {single[1]:.4f}, {single[2]:.4f} ms; "
            f"plain {plain_ms:.4f} ms, kernel max_abs_err {err:.3e}")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return dict(shapes[0], shapes=shapes)


def greedy_trace(torch, model, params, tokens, steps: int, cache_len: int):
    """LMServer.generate's loop (no EOS, no budgets) with each step's top-2
    logit gap and max|logit| kept: tokens, gaps, maxima as (B, steps)
    numpy arrays.  Token i is the argmax of the i-th logits."""
    toks, gaps, tops = [], [], []
    logits, cache = model.prefill(params, {"tokens": tokens}, cache_len=cache_len)
    for i in range(steps):
        lf = logits.float()
        top2 = lf.topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tops.append(lf.abs().amax(-1))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(tok[:, 0])
        if i + 1 < steps:
            logits, cache = model.decode_step(params, tok, cache)
    stack = lambda xs: torch.stack(xs, 1).cpu().numpy()  # noqa: E731
    return stack(toks), stack(gaps), stack(tops)


def tokens_agree(label: str, got, ref, gaps, tops) -> dict:
    """``got`` against ``ref`` row by row: equal, or parting first where the
    reference's top-2 gap is at most NEAR_TIE x its max|logit| (a near-tie
    that a last-bit difference may flip).  Raises otherwise."""
    import numpy as np

    parted = []
    for b in range(ref.shape[0]):
        diff = np.flatnonzero(got[b] != ref[b])
        if not diff.size:
            continue
        i = int(diff[0])
        rel = float(gaps[b, i] / max(tops[b, i], 1e-30))
        log(f"  {label} row {b}: tokens part at step {i} of {ref.shape[1]}, the reference's "
            f"top-2 gap there {gaps[b, i]:.3e} = {rel:.3e} of max|logit| (limit {NEAR_TIE:g}) "
            f"{'ok (near-tie)' if rel <= NEAR_TIE else 'FAIL'}")
        if rel > NEAR_TIE:
            raise AssertionError(f"{label}: row {b} parts at step {i} with no near-tie")
        parted.append(dict(row=b, step=i, rel_gap=rel))
    log(f"  {label}: {ref.shape[0] - len(parted)} of {ref.shape[0]} rows equal over "
        f"{ref.shape[1]} tokens")
    return dict(rows=int(ref.shape[0]), parted=parted)


def full_model(torch, arch: str, dtype: str | None = None, **impl):
    """The full-width model from seed 0, in the config's dtype (or
    ``dtype``), on the card; with its parameter count checked."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, **impl)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    want = D_FULL if arch == ARCH else D_MAMBA
    if model.param_count(params) != want:
        raise AssertionError(f"{arch}: {model.param_count(params)} parameters, expected {want}")
    return cfg, model, params


def serve_path(torch, arch: str) -> dict:
    """Phase 7: serving at full width, random bf16 weights from seed 0.
    ``LMServer.generate`` on B=4 prompts of 1024 tokens, 64 new, then
    ``ServingEngine.run`` on the trace of examples/serve_lm.py at real
    prompt lengths, with every kernel's launch count set to 0 just before
    each and read just after.  The prefill kernel (flash attention for
    smollm, the SSD scan for mamba2) launches once per layer and prefill
    call and never in decode; every request completes with tokens in
    [0, vocab).  One more generate prefill, profiled outside the counted
    windows, gives the device's busy time against the prefill's wall time."""
    import numpy as np

    from repro_torch.approx.deadline import SLOPolicy
    from repro_torch.core.straggler import FixedDelayStragglers
    from repro_torch.serve import ReplicaPool, Request, ServingEngine
    from repro_torch.train.serve import LMServer

    cfg, model, params = full_model(torch, arch)
    kernel = "flash_attention" if arch == ARCH else "ssd_scan"
    layers = SMOLLM_LAYERS if arch == ARCH else MAMBA_LAYERS
    counters = launch_counters()
    server = LMServer(model)
    calls = {"prefill": [], "decode": [], "prefill_launches": 0, "decode_launches": 0}
    server._prefill = timed(torch, server._prefill, calls, "prefill", counters)
    server._decode = timed(torch, server._decode, calls, "decode", counters)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (GEN["B"], GEN["S"])).astype(np.int32)

    def check(label, want_prefills, toks, peak, wall):
        launches = {name: fn.launches for name, fn in counters.items()}
        want = {name: 0 for name in counters}
        want[kernel] = layers * want_prefills
        in_range = bool(((toks >= 0) & (toks < cfg.vocab)).all())
        ok = (launches == want and len(calls["prefill"]) == want_prefills and in_range
              and calls["decode_launches"] == 0)
        log(f"serve {arch} {label}: {len(calls['prefill'])} prefill calls, launches {launches} "
            f"(expected {want}), kernel launches during decode {calls['decode_launches']}, "
            f"tokens in [0, {cfg.vocab}) {in_range}, peak memory {peak / 2**30:.2f} GiB, "
            f"{wall:.2f} s wall {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve {arch} {label}: launches or tokens wrong")
        return launches

    # LMServer.generate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    gen_toks = server.generate(params, {"tokens": prompts}, GEN["new"], cache_len=GEN["cache_len"])
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = check("LMServer.generate", 1, gen_toks, torch.cuda.max_memory_allocated(),
                         gen_wall)
    if gen_toks.shape != (GEN["B"], GEN["new"]):
        raise AssertionError(f"generate returned {gen_toks.shape}")
    gen_prefill_ms = calls["prefill"][0] * 1e3
    gen_decode_ms = statistics.median(calls["decode"]) * 1e3
    log(f"serve {arch} generate B={GEN['B']} S={GEN['S']} new={GEN['new']}: prefill "
        f"{gen_prefill_ms:.2f} ms, decode step median {gen_decode_ms:.2f} ms, "
        f"{gen_toks.size / gen_wall:.1f} generated tokens per wall second")
    # the same prefill once more under torch.profiler, outside the counted
    # windows: the device's busy time and the prefill kernel's part of it,
    # against the unprofiled prefill's wall time
    dev_prompts = torch.as_tensor(prompts, device=params["embed"].device)
    with torch.inference_mode():
        split = device_split(torch, lambda: model.prefill(
            params, {"tokens": dev_prompts}, cache_len=GEN["cache_len"]), 1)
    busy = sum(split.values())
    # the kernels' device names: flash_bf16_kernel, ssd_scan_*_kernel
    kernel_ms = sum(v for k, v in split.items() if k.startswith(kernel.split("_")[0]))
    log(f"serve {arch} generate prefill under torch.profiler: device busy {busy:.2f} ms, "
        f"{busy / gen_prefill_ms:.1%} of the unprofiled prefill's {gen_prefill_ms:.2f} ms wall; "
        f"{kernel} {kernel_ms:.2f} ms of it ({kernel_ms / busy:.1%}); the largest: "
        + ", ".join(f"{k} {v:.2f} ms"
                    for k, v in sorted(split.items(), key=lambda kv: -kv[1])[:5]))

    # ServingEngine.run on the trace of examples/serve_lm.py
    tr = TRACE
    trng = np.random.default_rng(0)
    pool = ReplicaPool(trng.uniform(1.0, 4.0, tr["m"]), s=tr["s"], k=2 * tr["m"],
                       straggler_model=FixedDelayStragglers(s=tr["s"], delay=tr["delay"]),
                       policy=SLOPolicy.for_slo(ttft_slo_s=np.inf), seed=0)
    arrivals = np.cumsum(trng.exponential(tr["gap_s"], tr["n"]))
    reqs = [Request(rid=i,
                    tokens=trng.integers(0, cfg.vocab,
                                         (int(trng.integers(tr["prompt"][0], tr["prompt"][1] + 1)),)),
                    max_new_tokens=int(trng.integers(tr["new"][0], tr["new"][1] + 1)),
                    arrival_t=float(arrivals[i]))
            for i in range(tr["n"])]
    engine = ServingEngine(server, params, n_slots=tr["n_slots"], cache_len=tr["cache_len"],
                           replicas=pool, decode_dt=None)
    calls.update(prefill=[], decode=[], prefill_launches=0, decode_launches=0)
    # the engine's batched decode step, timed and counted alike
    engine.batch._step = timed(torch, engine.batch._step, calls, "decode", counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    comps, metrics = engine.run(reqs)
    torch.cuda.synchronize()
    eng_wall = time.perf_counter() - t0
    all_toks = np.concatenate([c.tokens for c in comps]) if comps else np.zeros(0, np.int32)
    eng_launches = check("ServingEngine.run", tr["n"], all_toks,
                         torch.cuda.max_memory_allocated(), eng_wall)
    done = sorted(c.rid for c in comps)
    counts_ok = all(len(c.tokens) == reqs[c.rid].max_new_tokens for c in comps)
    if done != list(range(tr["n"])) or not counts_ok:
        raise AssertionError(f"serve {arch}: completed {done}, token counts ok {counts_ok}")
    summ = metrics.summary()
    ttft_all = [r.prefill_all_done_t - r.arrival_t + (r.first_token_t - r.prefill_done_t)
                for r in metrics.records]
    res = dict(
        generate=dict(launches=gen_launches, prefill_ms=gen_prefill_ms,
                      prefill_device_busy_ms=busy, prefill_kernel_device_ms=kernel_ms,
                      decode_step_ms=gen_decode_ms, tokens_per_wall_s=gen_toks.size / gen_wall,
                      wall_s=gen_wall),
        engine=dict(launches=eng_launches, prefill_calls=len(calls["prefill"]),
                    prefill_ms_median=statistics.median(calls["prefill"]) * 1e3,
                    decode_step_ms_median=statistics.median(calls["decode"]) * 1e3,
                    decode_steps=len(calls["decode"]), tokens=int(all_toks.size),
                    tokens_per_wall_s=all_toks.size / eng_wall, wall_s=eng_wall,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    ttft_p50_s=summ["ttft_p50_s"], ttft_p99_s=summ["ttft_p99_s"],
                    ttft_wait_for_all_p50_s=float(np.percentile(ttft_all, 50)),
                    ttft_wait_for_all_p99_s=float(np.percentile(ttft_all, 99)),
                    prompt_tokens=int(sum(len(r.tokens) for r in reqs))),
        gen_tokens=gen_toks, prompts=prompts)
    e = res["engine"]
    log(f"serve {arch} ServingEngine: {tr['n']} requests ({e['prompt_tokens']} prompt tokens, "
        f"{e['tokens']} generated) in {eng_wall:.2f} s wall: prefill per request median "
        f"{e['prefill_ms_median']:.2f} ms, decode step median {e['decode_step_ms_median']:.2f} ms "
        f"over {e['decode_steps']} steps of {tr['n_slots']} slots, {e['tokens_per_wall_s']:.1f} "
        f"generated tokens per wall second; TTFT on the virtual clock p50 {e['ttft_p50_s']:.3f} s "
        f"p99 {e['ttft_p99_s']:.3f} s against wait-for-all p50 {e['ttft_wait_for_all_p50_s']:.3f} "
        f"s p99 {e['ttft_wait_for_all_p99_s']:.3f} s; peak memory {e['peak_gib']:.2f} GiB; "
        "device busy share not measured (CUDA events give elapsed time, not busy time, and no "
        "profiled step is added)")
    del engine, server, model, params
    torch.cuda.empty_cache()
    return res


def timed(torch, fn, calls: dict, key: str, counters: dict):
    """``fn`` wrapped to synchronize after each call, append its wall
    seconds to ``calls[key]`` and add the kernel launches it made to
    ``calls[key + "_launches"]``."""

    def wrapped(*a, **kw):
        before = sum(c.launches for c in counters.values())
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        calls[key].append(time.perf_counter() - t0)
        calls[key + "_launches"] += sum(c.launches for c in counters.values()) - before
        return out

    return wrapped


def serve_cross_check(torch, arch: str, served: dict) -> dict:
    """Phase 8, the kernel on the serving path against the plain version,
    with TF32 off.  In bf16 (not held: the kernel keeps p in f32, the plain
    model path rounds it): the last-position logits and phase 7's generate
    tokens against ``attn_impl`` / ``ssd_impl="torch"``; beside them, the
    plain path against itself with the embedding one bf16 ulp up, and both
    bf16 paths' logits and tokens against the f32 plain model's.  In f32, held:
    prefill's last-position logits within 1e-4 of max|logit|; the cache
    leaves that no kernel touched (layer 0's k and v, or its conv inputs)
    equal, the others within 1e-4 (k, v, conv) or 1e-3 (the SSD state, as
    the full-layer scan check) of their max; ``generate``'s tokens equal,
    and ``ServingEngine``'s continuous batch equal to sequential B=1 decode
    on the trace of tests/test_serving.py scaled to 256-512 tokens, each
    under the near-tie rule."""
    import numpy as np

    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.train.serve import LMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    key = "attn_impl" if arch == ARCH else "ssd_impl"
    new, L = GEN["new"], GEN["cache_len"]
    cfg, plain, params = full_model(torch, arch, **{key: "torch"})
    dev = params["embed"].device
    prompts = torch.as_tensor(served["prompts"], device=dev)
    kernel = build_model(cfg)
    lk16, _ = kernel.prefill(params, {"tokens": prompts}, cache_len=L)
    lt16, _ = plain.prefill(params, {"tokens": prompts}, cache_len=L)
    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    bf16_rel = rel(lk16, lt16)
    # the plain path against itself with every embedding entry moved by one
    # bf16 spacing: how far one ulp at the input carries through the depth
    nudged = dict(params, embed=(params["embed"].view(torch.int16) + 1).view(torch.bfloat16))
    lu16, _ = plain.prefill(nudged, {"tokens": prompts}, cache_len=L)
    ulp_rel = rel(lu16, lt16)
    del nudged, lu16
    plain_toks = LMServer(plain).generate(params, {"tokens": prompts}, new, cache_len=L)
    agree = float((plain_toks == served["gen_tokens"]).mean())
    rows_equal = int((plain_toks == served["gen_tokens"]).all(1).sum())
    log(f"cross-check serve {arch} bf16 (reported, not held): last-position logits through the "
        f"kernel vs {key}='torch' max|diff|/max|logit| {bf16_rel:.3e}; generate tokens agree in "
        f"{agree:.1%} of {plain_toks.size}, {rows_equal} of {plain_toks.shape[0]} rows equal; "
        f"plain vs plain with the embedding one bf16 ulp up {ulp_rel:.3e}")
    params = {k: v.float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kernel, plain = build_model(cfg32), build_model(cfg32, **{key: "torch"})
    lk, ck = kernel.prefill(params, {"tokens": prompts}, cache_len=L)
    lt, ct = plain.prefill(params, {"tokens": prompts}, cache_len=L)
    logit_rel = float((lk - lt).abs().max() / lt.abs().max())
    untouched = ("layers.0.k", "layers.0.v") if arch == ARCH else ("layers.0.conv",)
    first_equal = all(torch.equal(ck[n][0], ct[n][0]) for n in untouched)
    leaf_rel = {n: float((ck[n] - ct[n]).abs().max() / ct[n].abs().max().clamp(min=1e-30))
                for n in ct if n != "pos"}
    leaf_ok = all(v <= (1e-3 if n.endswith(".h") else 1e-4) for n, v in leaf_rel.items())
    ok = logit_rel <= 1e-4 and first_equal and leaf_ok and torch.equal(ck["pos"], ct["pos"])
    log(f"cross-check serve {arch} f32 prefill B={GEN['B']} S={GEN['S']}: last-position logits "
        f"max|diff|/max|logit| {logit_rel:.3e} (limit 1e-4); layer 0's {', '.join(untouched)} "
        f"(no kernel before them) equal {first_equal}; each cache leaf's max|diff|/max: "
        + ", ".join(f"{n} {v:.2e}" for n, v in leaf_rel.items())
        + f" (limits 1e-4, the SSD state 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} f32 prefill through the kernel disagrees with plain")
    del ck, ct
    got = LMServer(kernel).generate(params, {"tokens": prompts}, new, cache_len=L)
    ref, gaps, tops = greedy_trace(torch, plain, params, prompts, new, L)
    gen_agree = tokens_agree(f"cross-check serve {arch} f32 generate, kernel vs plain", got, ref,
                             gaps, tops)
    # both bf16 paths against the f32 model: a kernel fault would put the
    # kernel's path further from f32 than the plain one
    to_f32 = dict(kernel_logit_rel=rel(lk16, lt), plain_logit_rel=rel(lt16, lt),
                  kernel_token_agreement=float((served["gen_tokens"] == ref).mean()),
                  plain_token_agreement=float((plain_toks == ref).mean()))
    log(f"cross-check serve {arch} bf16 against f32 plain (reported, not held): last-position "
        f"logits max|diff|/max|logit| kernel path {to_f32['kernel_logit_rel']:.3e}, plain path "
        f"{to_f32['plain_logit_rel']:.3e}; generate tokens agree kernel path "
        f"{to_f32['kernel_token_agreement']:.1%}, plain path "
        f"{to_f32['plain_token_agreement']:.1%} of {ref.size}")
    del lk16, lt16
    lens = [32 * n for n in (8, 14, 11, 9, 16)]
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                    max_new_tokens=7, arrival_t=0.02 * i) for i, n in enumerate(lens)]
    comps, _ = ServingEngine(LMServer(kernel), params, n_slots=2, cache_len=max(lens) + 8,
                             decode_dt=0.01).run(reqs)
    batch_agree = []
    for c, r in zip(comps, reqs):
        ref, gaps, tops = greedy_trace(torch, kernel, params,
                                       torch.as_tensor(r.tokens[None], device=dev), 7,
                                       max(lens) + 8)
        batch_agree.append(tokens_agree(
            f"cross-check serve {arch} f32 continuous batch vs sequential, request {c.rid} "
            f"({len(r.tokens)} tokens)", c.tokens[None], ref, gaps, tops))
    del params, kernel, plain
    torch.cuda.empty_cache()
    return dict(bf16_logit_rel=bf16_rel, bf16_token_agreement=agree, bf16_rows_equal=rows_equal,
                bf16_one_ulp_logit_rel=ulp_rel, bf16_vs_f32=to_f32,
                f32_logit_rel=logit_rel, f32_cache_leaf_rel=leaf_rel, f32_generate=gen_agree,
                f32_continuous_vs_sequential=batch_agree)


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
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import coded_reduce as cr

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    print(card, flush=True)  # as nvidia-smi gives it, on a line of its own

    # 2. the build: one nvcc per source, all started together
    t0 = time.perf_counter()
    build.build_all()
    info = build.BUILD_INFO
    log(f"build {len(info['sources'])} sources: {time.perf_counter() - t0:.2f} s "
        f"(nvcc in parallel {info['seconds']:.2f} s, cached={info['cached']}) -> {info['dir']}")
    for stem, src in info["sources"].items():
        log(f"  {stem}.cu -> {src['path']}")
        for line in src["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()}")
    hgmma = count_hgmma(info["sources"]["flash_attention"]["path"])
    ssd_hgmma = count_hgmma(info["sources"]["ssd_scan"]["path"])

    # 3. each kernel vs its plain version; the encode vs the bit oracle
    worst = check_kernel_vs_plain(torch, cr)
    n_bit = check_encode_vs_oracle(torch)
    dec_worst = check_decode_vs_plain(torch)
    ssd_check = check_ssd_vs_plain(torch)
    flash_check = check_flash_vs_plain(torch)

    # 4. timing at the main path's shapes
    from repro_torch.configs import CodingConfig
    from repro_torch.core.codec import Codec

    n_slots = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1).n_slots
    enc = time_kernel(torch, cr, n_slots, D_FULL, "encode (P = n_slots)")
    dec = time_kernel(torch, cr, M, D_FULL, "decode (P = m)")
    wenc = time_encode(torch, n_slots, D_FULL)
    wdec = time_decode(torch, M, D_FULL)
    tssd = time_ssd(torch)
    tflash = time_flash(torch)
    auto = autotune.wire_kernel_default("cuda")
    probe = next(iter(autotune.PROBE_US.values()))
    log(f"wire_kernel_default on this card: {auto} (probe at f32 (8, 65536): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in probe.items()) + ")")

    # 5. the main paths, 6. the f32 cross-checks
    plain_launches = lambda n: {  # noqa: E731
        "coded_reduce": n * (M + 1), "coded_encode_int8": 0, "coded_decode_int8": 0,
        "ssd_scan": 0, "flash_attention": 0}
    wire_launches = lambda n: {  # noqa: E731
        "coded_reduce": n, "coded_encode_int8": n * M, "coded_decode_int8": n, "ssd_scan": 0,
        "flash_attention": 0}
    # a step's forward passes: one per worker slot (m * n_slots gradients)
    # and one more for the step's loss at the decoded weights
    passes = M * n_slots + 1
    mamba_launches = lambda n: {  # noqa: E731
        "coded_reduce": n * (M + 1), "coded_encode_int8": 0, "coded_decode_int8": 0,
        "ssd_scan": n * passes * MAMBA_LAYERS, "flash_attention": 0}
    run = main_path(torch, "spmd", SLICE_ARGS, plain_launches)
    wire_run = main_path(torch, "spmd --compress", WIRE_ARGS, wire_launches,
                         on_step=check_err_after_step(torch))
    xc = cross_check(torch, ARCH, seq_len=64, part_mb=2, wire=True)
    log(f"mamba2 main path: {passes} forward passes a step (m * n_slots = {M * n_slots} "
        f"gradients + 1 loss), so ssd_scan {passes * MAMBA_LAYERS} launches a step")
    # one profiled step, mamba2's: the smollm paths' profiles (PERF.md § 5)
    # cost 200 s of the time limit, and phase 9's spans split their steps
    mamba_run = main_path(torch, "mamba2 spmd", MAMBA_ARGS, mamba_launches,
                          n_params_want=D_MAMBA, profile=True)
    # seq 512 in micro-batches of 1: two chunks, so the carried state runs
    mxc = {**cross_check(torch, MAMBA, seq_len=MAMBA_SEQ, part_mb=1, wire=False),
           **mamba_kernel_check(torch)}

    # 7. serving at full width, 8. its f32 cross-checks
    serve = {}
    for arch in (ARCH, MAMBA):
        serve[arch] = serve_path(torch, arch)
        serve[arch]["cross_check"] = serve_cross_check(torch, arch, serve[arch])
        del serve[arch]["gen_tokens"], serve[arch]["prompts"]

    # 9. the fault-tolerant trainer
    faults = fault_path(torch)

    # 10. the kernels line, then the card
    kernels = [{
        "name": "coded_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce.py:150",
        "launches": run["launches"]["coded_reduce"],
        "max_abs_err": max(enc["max_abs_err"], dec["max_abs_err"]),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "shape": f"f32 ({enc['P']}, {enc['D']}) -> ({enc['D']},), the per-worker encode",
        "decode": {k: dec[k] for k in ("P", "D", "ms", "plain_ms", "bound_ms", "library_ms",
                                        "max_abs_err")},
        "launches_compressed_path": wire_run["launches"]["coded_reduce"],
        "launches_fault_path": faults["launches"]["coded_reduce"],
        "launches_resume": faults["resume_launches"]["coded_reduce"],
        "checks_worst_scaled_err": worst,
    }, {
        "name": "coded_encode_int8",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wire_encode.cu",
        "replaces": "src/repro/kernels/wire.py:128",
        "launches": wire_run["launches"]["coded_encode_int8"],
        "max_abs_err": wenc["max_abs_err"],
        "ms": wenc["ms"], "plain_ms": wenc["plain_ms"], "bound_ms": wenc["bound_ms"],
        "bound_by": wenc["bound_by"], "library_ms": None, "library_none": NO_LIBRARY,
        "unfused_ms": wenc["unfused_ms"],
        "shape": f"f32 ({wenc['P']}, {wenc['D']}) + err -> int8 q, scale, new_err in place",
        "oracle_cases_bit_equal": n_bit,
        "launches_fault_path": faults["launches"]["coded_encode_int8"],
        "wire_kernel_default": auto,
    }, {
        "name": "coded_decode_int8",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/wire.py:193",
        "launches": wire_run["launches"]["coded_decode_int8"],
        "max_abs_err": wdec["max_abs_err"],
        "ms": wdec["ms"], "plain_ms": wdec["plain_ms"], "bound_ms": wdec["bound_ms"],
        "bound_by": wdec["bound_by"], "library_ms": None, "library_none": NO_LIBRARY,
        "unfused_ms": wdec["unfused_ms"],
        "shape": f"int8 ({wdec['m']}, {wdec['D']}) -> f32 ({wdec['D']},), coded_reduce's "
                 "int8 instantiation",
        "checks_worst_scaled_err": dec_worst,
        "launches_fault_path": faults["launches"]["coded_decode_int8"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": mamba_run["launches"]["ssd_scan"],
        "max_abs_err": tssd["max_abs_err"],
        "ms": tssd["ms"], "plain_ms": tssd["plain_ms"], "bound_ms": tssd["bound_ms"],
        "bound_by": tssd["bound_by"], "library_ms": None, "library_none": NO_SSD_LIBRARY,
        "shape": "x (2, 512, 32, 64) f32, dA f32, B/C (2, 512, 1, 128) bf16 -> y f32, h "
                 f"(2, 32, 64, 128) f32, chunk 256 (kernel chunks {SSD_CHUNK})",
        "shapes": [{k: t[k] for k in ("B", "S", "ms", "plain_ms", "bound_ms", "f32_bound_ms",
                                      "max_abs_err")} for t in tssd["shapes"]],
        "route_by_dtype": {"bf16": "wgmma, three launches a call (chunk, state, output "
                                   "passes), f32 operands split bf16 hi + lo",
                           "f32": "f32 FMAs on the CUDA cores, one launch a call"},
        "hgmma_instructions": ssd_hgmma,
        "launches_per_step": mamba_run["launches"]["ssd_scan"] / mamba_run["steps"],
        "launches_serving": {k: serve[MAMBA][k]["launches"]["ssd_scan"]
                             for k in ("generate", "engine")},
        "checks": ssd_check,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": sum(serve[ARCH][k]["launches"]["flash_attention"]
                        for k in ("generate", "engine")),
        "launches_serving": {k: serve[ARCH][k]["launches"]["flash_attention"]
                             for k in ("generate", "engine")},
        "max_abs_err": max(*(t["max_abs_err"] for t in tflash["shapes"]),
                           flash_check["worst_small"], *flash_check["full"].values()),
        "ms": tflash["ms"], "plain_ms": tflash["plain_ms"], "bound_ms": tflash["bound_ms"],
        "bound_by": tflash["bound_by"], "library_ms": tflash["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "shape": f"q ({tflash['B']}, {tflash['S']}, {tflash['H']}, {tflash['hd']}) bf16, k/v "
                 f"({tflash['B']}, {tflash['S']}, {tflash['K']}, {tflash['hd']}) bf16, causal",
        "shapes": [{k: t[k] for k in ("B", "S", "ms", "library_ms", "plain_ms", "bound_ms",
                                      "turns_ms", "single_launch_ms", "library_single_launch_ms",
                                      "max_abs_err")} for t in tflash["shapes"]],
        "route_by_dtype": {"bf16": "wgmma fed by TMA, P.V split bf16 hi + lo",
                           "f32": "f32 FMAs on the CUDA cores"},
        "hgmma_instructions": hgmma,
        "checks": flash_check,
    }]
    log(f"summary: spmd step {run['step_s']:.4f} s (median), peak {run['peak_gib']:.2f} GiB, "
        f"losses {run['losses']}; spmd --compress step {wire_run['step_s']:.4f} s, "
        f"peak {wire_run['peak_gib']:.2f} GiB, losses {wire_run['losses']}; cross-check {xc}")
    log(f"summary: mamba2 spmd step {mamba_run['step_s']:.4f} s (median), peak "
        f"{mamba_run['peak_gib']:.2f} GiB, losses {mamba_run['losses']}, launches "
        f"{mamba_run['launches']}; cross-check {mxc}; profile {mamba_run['breakdown']}")
    for arch in (ARCH, MAMBA):
        log(f"summary: serve {arch} {json.dumps(serve[arch], default=str)}")
    log(f"summary: fault path {json.dumps(faults, default=str)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
