#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and drives only ``src/repro_torch`` (it
never imports ``jax`` or the JAX package):

  1. the card: ``nvidia-smi`` name and power limit, and CUDA's version;
  2. the build of every kernel source in the checkout (one ``nvcc`` per
     ``csrc/*.cu``, all started together, sm_90a), with ptxas' register and
     spill report for each entry;
  3. each kernel against its plain PyTorch version on the card, over
     ragged shapes and every dtype it takes, with the tolerance stated; the
     fused int8 encode BIT-equal to the wire format's numpy oracle (whose
     reduce is the CUDA ``coded_reduce``) over the sweep, edge shapes, the
     EPS floor, an error-feedback chain, NaN and in-place cases;
  4. each kernel's time at the main path's shapes (CUDA events, median)
     beside its bound, the plain version's time, the unfused composition's
     time for the wire kernels, and one PyTorch library call computing the
     same function where there is one (timed here, never used by the port);
  5. the main path: ``repro_torch.launch.train`` on smollm-360m at full
     width, spmd backend, heter_aware, s=1, m=4, one faulted worker per
     step, 4 steps, checking losses, the decode metrics and that
     ``coded_reduce`` ran m+1 times per step; then the same on the int8
     wire (``--compress --wire-kernel on``): the encode kernel m times a
     step, the decode once, the error feedback finite and non-zero after
     every step; after phase 6 both paths run again in reverse order, so
     their step times are compared A B B A;
  6. a cross-check at full width in f32 with TF32 off: one decoded gradient
     from the spmd backend (through the kernels) against the fused backend
     (autograd), relative L2 error <= 1e-4; and the compressed spmd
     gradient with the wire kernel on against it off (rtol 1e-4, atol
     2e-5), each within 0.05 of max|.| of the uncompressed one (the whole
     vector: one scale covers it; each leaf's number is printed);
  7. a JSON line of the kernels, then the card as the last line.

Each main path is driven with every kernel's launch count set to 0 just
before it and read just after.  Exits non-zero, printing no result,
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
F32_FLOPS = 67e12  # H100 SXM published f32 rate outside the tensor cores
NO_LIBRARY = ("no single PyTorch call computes it: torch.mv takes no int8 input, "
              "and PyTorch has no fused reduce + int8 quantize")


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate or
    f32 operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    from repro_torch.kernels.wire import coded_decode_int8, coded_encode_int8

    return {"coded_reduce": coded_reduce, "coded_encode_int8": coded_encode_int8,
            "coded_decode_int8": coded_decode_int8}


def main_path(torch, label: str, args: list[str], expected, on_step=None,
              expect=None) -> dict:
    """Phase 5: one slice command in process, every kernel's count set to 0
    just before it and read just after.  ``expected(steps_taken)`` maps each
    kernel to the launches the path must make.  ``expect`` is an earlier
    control-plane replay to reuse (a repeat run then skips the profile)."""
    from repro_torch.launch.train import main as train_main

    repeat = expect is not None
    if not repeat:
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
    log(f"main path ({label}): {ARCH} full width, {n_params} parameters "
        f"({next(iter(out['state'].params.values())).dtype}), {len(hist)} steps in "
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
    if n_params != D_FULL:
        raise AssertionError(f"{n_params} parameters, expected {D_FULL} for {ARCH}")
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
    breakdown = {} if repeat else profile_step(torch, out, label)
    del out
    torch.cuda.empty_cache()
    return dict(launches=launches, peak_gib=peak / 2**30, wall_s=wall, losses=losses,
                n_params=n_params, step_s=steady, breakdown=breakdown, expect=expect)


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
                   for ev in prof.key_averages() if ev.device_type == DeviceType.CPU),
                  reverse=True)
    log(f"  host: {sum(ms for ms, _, _ in host):.1f} ms of self CPU time in the step "
        "(profiler overhead included); the 8 largest ops:")
    for ms, count, key in host[:8]:
        log(f"    {ms:8.2f} ms {count:7d}x {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **{f"{g}_ms": v for g, v in groups.items()}}


def cross_check(torch) -> dict:
    """Phase 6 at full width in f32, TF32 off, one faulted worker: spmd
    (kernels) vs fused (autograd); then the compressed spmd gradient with
    the wire kernel on vs off, each against the uncompressed fused one."""
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
    for name, kw in (("fused", dict(backend="fused")), ("spmd", dict(backend="spmd")),
                     ("wire_on", dict(backend="spmd", compress=True, wire_kernel=True)),
                     ("wire_off", dict(backend="spmd", compress=True, wire_kernel=False))):
        eng = StepEngine(model, TrainConfig(), codec, device=dev, **kw)
        grads[name] = eng.gradients(params, batch, outcome)
        torch.cuda.synchronize()
        del eng
        torch.cuda.empty_cache()
    num = sum(float((grads["spmd"][k].double() - grads["fused"][k].double()).square().sum())
              for k in params)
    den = sum(float(grads["fused"][k].double().square().sum()) for k in params)
    rel = (num / den) ** 0.5
    ok = rel <= 1e-4
    log(f"cross-check {ARCH} f32 full width, decode a={list(map(float, outcome.a))}: "
        f"spmd vs fused relative L2 error {rel:.3e} (limit 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"spmd vs fused relative L2 error {rel} > 1e-4")
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
    log(card)

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

    # 3. each kernel vs its plain version; the encode vs the bit oracle
    worst = check_kernel_vs_plain(torch, cr)
    n_bit = check_encode_vs_oracle(torch)
    dec_worst = check_decode_vs_plain(torch)

    # 4. timing at the main path's shapes
    from repro_torch.configs import CodingConfig
    from repro_torch.core.codec import Codec

    n_slots = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1).n_slots
    enc = time_kernel(torch, cr, n_slots, D_FULL, "encode (P = n_slots)")
    dec = time_kernel(torch, cr, M, D_FULL, "decode (P = m)")
    wenc = time_encode(torch, n_slots, D_FULL)
    wdec = time_decode(torch, M, D_FULL)
    auto = autotune.wire_kernel_default("cuda")
    probe = next(iter(autotune.PROBE_US.values()))
    log(f"wire_kernel_default on this card: {auto} (probe at f32 (8, 65536): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in probe.items()) + ")")

    # 5. the main paths, 6. the f32 cross-checks
    plain_launches = lambda n: {  # noqa: E731
        "coded_reduce": n * (M + 1), "coded_encode_int8": 0, "coded_decode_int8": 0}
    wire_launches = lambda n: {  # noqa: E731
        "coded_reduce": n, "coded_encode_int8": n * M, "coded_decode_int8": n}
    run = main_path(torch, "spmd", SLICE_ARGS, plain_launches)
    wire_run = main_path(torch, "spmd --compress", WIRE_ARGS, wire_launches,
                         on_step=check_err_after_step(torch))
    xc = cross_check(torch)
    # the host sets the step time and its speed drifts within a call, so the
    # two paths run again in reverse order (A B B A) before they are compared
    wire_again = main_path(torch, "spmd --compress, repeat", WIRE_ARGS, wire_launches,
                           expect=wire_run["expect"])
    run_again = main_path(torch, "spmd, repeat", SLICE_ARGS, plain_launches,
                          expect=run["expect"])
    log(f"step time, A B B A order: spmd {run['step_s']:.4f} / {run_again['step_s']:.4f} s, "
        f"spmd --compress {wire_run['step_s']:.4f} / {wire_again['step_s']:.4f} s")

    # 7. the kernels line, then the card
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
    }]
    log(f"summary: spmd step {run['step_s']:.4f} / {run_again['step_s']:.4f} s (median, "
        f"A B B A order), peak {run['peak_gib']:.2f} GiB, losses {run['losses']}; "
        f"spmd --compress step {wire_run['step_s']:.4f} / {wire_again['step_s']:.4f} s, "
        f"peak {wire_run['peak_gib']:.2f} GiB, losses {wire_run['losses']}; cross-check {xc}; "
        f"profiles {run['breakdown']} / {wire_run['breakdown']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
