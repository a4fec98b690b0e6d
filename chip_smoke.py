#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and drives only ``src/repro_torch`` (it
never imports ``jax`` or the JAX package):

  1. the card: ``nvidia-smi`` name and power limit, CUDA's version and the
     card's ``total_memory`` (the dry run's ``CARD_BYTES``);
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
     at a ragged S), the full prefill shapes, and the model families'
     prefill shapes (hd 128 at GQA groups 1 and 2, and a window of 4096
     over 6144 tokens);
  4. each kernel's time at the main path's shapes (CUDA events, median)
     beside its bound, the plain version's time, the unfused composition's
     time for the wire kernels, and one PyTorch library call computing the
     same function where there is one (timed here, never used by the port);
     flash attention at the generate prefill's shape and the engine's
     longest and shortest prompts, kernel and library call in turns, and
     at the families' prefill shapes (a window's bound counting only the
     pairs inside it; the library call takes it as a boolean mask); the
     SSD scan at the training micro-batch, the generate prefill and the
     engine's longest prompt; the SSD backward kernels at a pass of the
     benchmark's mamba2 and granite cells, checked against the plain
     backward and timed beside it;
  5. the main path: ``repro_torch.launch.train`` on smollm-360m at full
     width, spmd backend, heter_aware, s=1, m=4, one faulted worker per
     step, 4 steps, checking losses, the decode metrics and that
     ``coded_reduce`` ran m+1 times per step; then the same on the int8
     wire (``--compress --wire-kernel on``): the encode kernel m times a
     step, the decode once, the error feedback finite and non-zero after
     every step; then mamba2-370m at full width
     and seq 512 (two SSD chunks), the same flags: ``coded_reduce`` m+1
     times a step and ``ssd_scan`` 48 times a forward pass: m*n_slots
     gradient passes a step, each run twice (remat recomputes every repeat
     of the period in the backward), and one loss pass;
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
 10. the model families, random bf16 weights from seed 0, each parameter
     count checked: (a) moonshot-v1-16b-a3b (MoE, 64 experts top-6) at
     full width and depth, ``LMServer.generate`` on 4 prompts of 1024
     tokens, 64 new, cache 1088; (b) mixtral-8x7b at full width and 16 of
     its 32 layers (memory), one prompt of 6144 tokens through its window of
     4096, 64 new, decode past the ring's wrap; (c) internvl2-2b at full
     width and depth, 4 prompts of 256 patch embeddings and 768 tokens, 64
     new, cache 1088: flash attention once per attention layer of the
     prefill call and never in decode, every call's logits finite, tokens in
     [0, vocab); prefill and decode-step times, tokens per wall second, peak
     memory; the bf16 kernel-vs-plain logit gap beside the one-ulp nudge of
     the embedding, and the token agreement (printed, not held), through
     phases 7 and 8's own helpers; (d) the reduced jamba (mamba, attention,
     dense and MoE layers in one period) in bf16: generate with the SSD scan
     and flash attention once per mamba and attention layer of the prefill,
     the prefill's logits within one bf16 spacing of max|logit| of the plain
     versions' and the tokens equal under the near-tie rule at four bf16
     spacings, then one ``fused`` coded step through the launcher held to a
     CPU replay, the step's own sequence losses each the plain model's
     cross-entropy plus aux_coef x a finite, positive MoE term; (e)
     hubert-xlarge at full width and depth, the spmd main path
     (``coded_reduce`` m+1 times a step), step time and peak memory, then
     ``coded_reduce`` at its wire's shapes, (n_slots, D) and (m, D) f32 with
     D = 1,259,060,480 (past 2^31 elements a stack), held to the plain
     version and timed; (f) at the reduced width in f32, TF32 off, for moonshot,
     mixtral (prompts past its window), internvl2 and jamba: prefill through
     the kernels against the plain versions (logits within 1e-4 of
     max|logit|), ``generate`` tokens equal, and (but internvl2's, the
     engine being tokens-only) continuous batching equal to sequential
     decode, under the near-tie rule;
 11. the spmd backend across processes: ``python -m torch.distributed.run
     --standalone --nproc-per-node 4 -m repro_torch.launch.train``, one rank
     a coded worker, the four ranks sharing the card over gloo, this
     process holding nothing on it: (a) the main path's command at full
     width: rank 0's decode metrics equal to the CPU replay, every loss
     finite, ``coded_reduce`` once a rank a step, every rank's params
     bit-equal to rank 0's (sha256), the step median and each rank's peak
     memory; (b) phase 9's faulted command on the int8 wire with
     ``--audit-rebuilds``: m 4 -> 3 -> 2 through two group rebuilds (each
     printed), the trajectory (m, decode metrics, repairs, attempts) equal
     to phase 9's and the CPU replay's, one encode and one decode a live
     rank a gradient attempt, the carried error-feedback rows bit-equal to
     the rows before each rebuild; (c) in f32 with TF32 off, one decoded
     gradient through the four ranks against phase 6's single-process spmd
     one: relative L2 <= 1e-5 uncompressed; on the int8 wire bit-equal
     wherever the gathered q and scale * a_w equal phase 6's, elsewhere
     within one wire step max_w |a_w * scale_w|;
 12. the large-model training levers on full-width models, bf16, random
     weights from seed 0: (a) llama3.2-1b (1.24 B parameters) through
     ``train/steps.py``'s ``make_fused_train_step`` at seq 4096, with the
     dry run's dp_all optimizer policy (bf16 moments, no f32 master): B = 1
     with remat "none" and "full" (the first loss and grad norm equal to
     rtol 1e-4, bit-equality printed; remat's peak below none's), B = 4
     with remat and accumulation 1 and 2 (losses to rtol 1e-3), each run's
     state bytes, peak and median step, and one more accumulation-1 step
     under ``torch.profiler`` (device busy share, the largest kernels); (b)
     the dry run of that B = 4 cell on a one-rank mesh in a subprocess
     (``repro_torch.launch.dryrun --mesh-shape 1,1 --variant dp_all``): its
     state bytes within 1 MiB of the bytes params, optimizer state and
     batch asked the card's allocator for (``requested_bytes``; what it
     allocated, each block rounded up, is printed beside), its counted
     FLOPs over the measured step (achieved TFLOP/s, share of 989.4) and
     t_compute over the step; (c) mamba2-370m's fused step with remat at
     B = 2, seq 2048: ``ssd_scan`` twice a layer a step (the checkpoint runs
     the forward again), one more step profiled (device busy share); (d)
     ``repro_torch.launch.kernel_credit`` on JAX's cells (smollm-360m and
     mamba2-370m dp_all and llama3.2-1b on 16×16, jamba-1.5-large-398b on
     2×16×16, train_4k), each a process of its own started at the phase's
     beginning, one row each of the dry run (state per GPU, fits, the three
     terms, bottleneck) and of the credit;
     (d) also runs, in the same pool, the dry run's decode cells over a KV
     cache sharded on the sequence (chatglm3-6b x decode_32k and
     mixtral-8x7b x long_500k on 16×16, jamba-1.5-large-398b x long_500k on
     2×16×16): each must run to a row whose collectives count the
     softmax's all-reduce across the sequence shards (phase 13 (d));
 13. the last modules of the port: (b) ``ops.coded_reduce(impl="best")``
     at smollm's wire, (n_slots, D) and (m, D) f32 and (m, D) int8 -> f32,
     from a cold tuner with the counts at 0: ``best_launch``'s pick
     bit-equal to the default launch, its time beside the default's, the
     plain version's, ``torch.mv``'s and ``best_reduce_schedule``'s pick,
     and every candidate launch shape bit-equal to the default at ragged D,
     a misaligned base and int8 / bf16 stacks; (a) full-width smollm-360m
     through ``StepEngine`` on ``fused`` at phase 1's shapes, three steps
     with ``host_pack=True`` and three with the device pack from the same
     weights and batches (losses and grad norms to rtol 1e-6, bit-equality
     printed; median ``phase.pack+upload`` against ``phase.upload``, each
     step's time); (c) the four ``examples/torch/*.py`` on the card, each a
     process of its own, all started together, each exiting 0 with its own
     checks passing, their wall times printed;
 14. a JSON line of the kernels, then the card as the last line.

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
# the training kernels' timed shape (B, S, H, K, hd): the benchmark cell's
# fused pass of smollm-360m (40 rows of 2048 tokens)
FLASH_TRAIN = (40, 2048, 15, 5, 64)
# and at mixtral-8x7b's heads and window past one window, hd 128, as its
# prefill shape in FLASH_FAMILY (B, S, H, K, hd, window)
FLASH_TRAIN_FAMILY = ((1, 6144, 32, 8, 128, 4096),)
FLASH_TRAIN_BATCH = 3  # calls a timed reading of the training kernels spans
# the training kernels' relative error (Frobenius) to the plain chain's, as
# the card test holds it: each side is about 2.3e-3 from f32 (the outputs'
# bf16 rounding); 2.9e-3 measured on an H100 at the cell's shape
FLASH_TRAIN_TOL = 5e-3
GEN = dict(B=4, S=1024, new=64, cache_len=1088)
TRACE = dict(n=16, prompt=(128, 2048), new=(32, 128), gap_s=0.3, n_slots=8, cache_len=2176,
             m=8, s=2, delay=5.0)
# ssd_scan's timed shapes (B, S): the training micro-batch (the kernels
# line's ms), generate's prefill and the engine's longest prompt
SSD_TIMED = ((SSD_FULL["B"], SSD_FULL["S"]), (GEN["B"], GEN["S"]), (1, TRACE["prompt"][1]))
SSD_BATCH = 20  # calls a timed reading of ssd_scan spans
# the SSD backward's timed shapes (B, S, H): one pass of the benchmark's
# mamba2-370m and granite-4.0-h-small cells (P 64, G 1, N 128)
SSD_BWD_TIMED = ((40, 2048, 32), (20, 1024, 128))
SSD_BWD_BATCH = 5  # calls a timed reading of ssd_scan_bwd
# flash_attention against its plain version beyond the JAX test's shapes:
# (atol, rtol).  In bf16 one spacing of the value (2^-7 of it at most) over
# a floor for values near zero; in f32 a few f32 spacings of summation order.
FLASH_TOL = {"bf16": (1e-4, 2.0**-7), "f32": (1e-5, 1e-5)}
NEAR_TIE = 1e-5  # a parting token passes only at a top-2 gap <= this x max|logit|
# the same rule for bf16 logits: four bf16 spacings of max|logit|
BF16_NEAR_TIE = 2.0**-5
# bf16 logits through the kernels against the plain versions, where held
# (the reduced jamba): one bf16 spacing of max|logit|
BF16_LOGIT_LIMIT = 2.0**-7
# phase 10, the model families, random bf16 weights from seed 0: each
# model's parameters at the depth it runs (mixtral: 16 of its 32 layers,
# 47.0 GB of bf16 weights; all 32 are 93.4 GB, past one 80 GB card)
FAMILY_PARAMS = {"moonshot-v1-16b-a3b": 28_057_995_264, "mixtral-8x7b": 23_482_470_400,
                 "internvl2-2b": 1_889_146_880, "hubert-xlarge": 1_259_060_480}
MIXTRAL_LAYERS = 16
# every full-width model's parameter count, and the depth cuts of memory
PARAMS = {ARCH: D_FULL, MAMBA: D_MAMBA, **FAMILY_PARAMS}
DEPTH = {"mixtral-8x7b": MIXTRAL_LAYERS}
# generate: B prompts of S tokens, new tokens, cache_len (None: the server's
# default; mixtral's attention keeps its ring of 4096 rows whatever it is)
FAMILY_GEN = {"moonshot-v1-16b-a3b": dict(B=4, S=1024, new=64, cache_len=1088),
              "mixtral-8x7b": dict(B=1, S=6144, new=64, cache_len=None),
              "internvl2-2b": dict(B=4, S=768, new=64, cache_len=1088)}
JAMBA = "jamba-1.5-large-398b"
JAMBA_GEN = dict(B=4, S=64, new=9)  # prefill, then 8 decode steps
JAMBA_ARGS = ["--arch", JAMBA, "--reduced", "--backend", "fused", "--scheme", "heter_aware",
              "--s", str(S), "--m", str(M), "--straggler", "fault", "--steps", "1"]
HUBERT_ARGS = ["--arch", "hubert-xlarge", *SLICE_ARGS[2:]]
# flash_attention at the families' prefill shapes (B, S, H, K, hd, window):
# moonshot (hd 128, no GQA), mixtral (GQA 4, window 4096 over 6144 tokens),
# internvl2 (GQA 2)
FLASH_FAMILY = ((4, 1024, 16, 16, 128, None), (1, 6144, 32, 8, 128, 4096),
                (4, 1024, 16, 8, 128, None))
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
# phase 11, the spmd backend across processes: its files (phase 6's saved
# gradients, the event logs), and the time limit of one torchrun of M ranks
GROUP_DIR = ROOT / "build" / "chip_smoke_group"
GROUP_TIMEOUT_S = 420
# phase 12, the large-model training levers: full-width llama3.2-1b at
# train_4k's sequence length, its step timed over LLAMA_STEPS steps (the
# first a warm-up), its optimizer state by the dry run's dp_all policy for a
# replicated model past 5e8 parameters (bf16 moments, no f32 master: with
# f32 ones, B = 1 without remat runs out of the card's 79.18 GiB); the
# one-rank dry run of its B = 4 step (a coded global batch of 2 at s = 1: 4
# sequences); mamba2-370m's fused step with remat; and JAX's kernel_credit
# cells, dry-run on the CPU, each in a process of its own
LLAMA, LLAMA_SEQ, LLAMA_PARAMS = "llama3.2-1b", 4096, 1_235_814_400
LLAMA_STEPS = 4
MAMBA_REMAT = dict(B=2, S=2048, steps=3)
DRY_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRY_CELLS = ("smollm-360m:train_4k:single:dp_all", "mamba2-370m:train_4k:single:dp_all",
             "llama3.2-1b:train_4k:single:baseline", "jamba-1.5-large-398b:train_4k:multi:baseline")
DRY_TIMEOUT_S = 600
MIB = 2**20
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
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_train_bwd,
                                                     flash_attention_train_fwd)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.kernels.wire import coded_decode_int8, coded_encode_int8

    return {"coded_reduce": coded_reduce, "coded_encode_int8": coded_encode_int8,
            "coded_decode_int8": coded_decode_int8, "ssd_scan": ssd_scan,
            "flash_attention": flash_attention,
            "flash_attention_train_fwd": flash_attention_train_fwd,
            "flash_attention_train_bwd": flash_attention_train_bwd,
            "ssd_scan_bwd": ssd_scan_bwd}


# the training kernels' counters where no layer runs them (f32, hd 80; the
# SSD's backward where no bf16 SSD layer is differentiated)
NO_TRAIN = {"flash_attention_train_fwd": 0, "flash_attention_train_bwd": 0, "ssd_scan_bwd": 0}


def smollm_train(n_grads: int, n_losses: int) -> dict:
    """The training kernels' launches of full-width smollm-360m (bf16, hd
    64, full remat): each gradient runs the forward twice a layer (the
    forward and remat's recompute) and the backward once; each loss-only
    forward (no grad) the forward once; it has no SSD layer."""
    return {"flash_attention_train_fwd": (2 * n_grads + n_losses) * SMOLLM_LAYERS,
            "flash_attention_train_bwd": n_grads * SMOLLM_LAYERS, "ssd_scan_bwd": 0}


def _passes(records: list[dict]) -> tuple[int, int]:
    """(gradients, loss-only forwards) of a traced run, from its attention
    layers' ``device.mixer`` spans: one ``bwd`` span a layer and gradient,
    one ``fwd`` span a layer and forward of either kind."""
    mixer = [r for r in records if r["kind"] == "span" and r["name"] == "device.mixer"
             and r["args"].get("kind") == "attn"]
    layers = len({r["args"]["layer"] for r in mixer})
    bwd = sum(r["args"]["pass"] == "bwd" for r in mixer) // max(layers, 1)
    fwd = sum(r["args"]["pass"] == "fwd" for r in mixer) // max(layers, 1)
    return bwd, fwd - bwd


def main_path(torch, label: str, args: list[str], expected, on_step=None,
              n_params_want: int = D_FULL, steps: int = STEPS) -> dict:
    """Phase 5: one slice command in process, every kernel's count set to 0
    just before it and read just after.  ``expected(steps_taken)`` maps each
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
    if len(hist) != steps:
        raise AssertionError(f"ran {len(hist)} steps, expected {steps}")
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
    steady = statistics.median(out["step_s"][1:] or out["step_s"])
    log(f"main path ({label}) step time: median of steps 1-{steps - 1} {steady:.4f} s "
        f"(step 0 {out['step_s'][0]:.4f} s includes the first batch and warm-up)")
    del out
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps_taken, peak_gib=peak / 2**30, wall_s=wall,
                losses=losses, n_params=n_params, step_s=steady)


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
    from repro_torch.configs import CodingConfig
    from repro_torch.core.codec import Codec
    from repro_torch.launch import obs_report
    from repro_torch.launch.train import main as train_main

    n_slots = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1).n_slots

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
        replay_recs = obs_report.load_records(str(tmp / "replay.jsonl"))
        replay_att, replay_passes = _attempts(replay_recs), _passes(replay_recs)
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
        # the training kernels: the CPU replay's gradients and loss forwards
        want = {"coded_reduce": n_att, "coded_encode_int8": sum(n * m for n, m in att),
                "coded_decode_int8": n_att, "ssd_scan": 0, "flash_attention": 0,
                **smollm_train(*replay_passes)}
        if launches != want:
            raise AssertionError(f"launches {launches} != {want} from the attempts {att} and "
                                 f"the replay's (gradients, loss forwards) {replay_passes}")
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
                  "coded_decode_int8": 0, "ssd_scan": 0, "flash_attention": 0,
                  **smollm_train(n_res * M * n_slots, n_res)}
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
                trajectory=[{k: h.get(k, 0.0) for k in TRAJECTORY} for h in hist],
                launches=launches, resilience=summary["resilience"], m_final=m_final,
                peak_gib=peak, phase_split=split, convicted=convicted, ckpt_gb=ck_gb,
                restore_s=restore_s, resume_launches=r_launches)


def rel_l2(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every leaf of ``b``, in f64."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / den) ** 0.5


def cross_check(torch, arch: str, seq_len: int, part_mb: int, wire: bool,
                save: Path | None = None) -> dict:
    """Phase 6 at full width in f32, TF32 off, one faulted worker: spmd
    (kernels) vs fused (autograd), relative L2 <= 1e-4; with ``wire``, the
    compressed spmd gradient with the wire kernel on vs off, each against
    the uncompressed fused one.  The fused backend takes all m * n_slots
    coded micro-batches in one pass, so ``part_mb`` x ``seq_len`` must fit.
    ``save`` keeps the spmd and wire-on decoded gradients (flat, with the
    int8 wire the decode read) for phase 11 (c)."""
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
        eng.wire_out = {}
        grads[name] = eng.gradients(params, batch, outcome)
        torch.cuda.synchronize()
        if save is not None and name in ("spmd", "wire_on"):
            torch.save({"decoded": _flat(torch, grads[name]).cpu(),
                        **{k: v.cpu() for k, v in eng.wire_out.items()}},
                       save / f"emulated_{name}.pt")
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
    with bf16 and f32 B/C, at phase 12 (c)'s remat'd fused step (B=2
    S=2048) and at the serving prefills' shapes (B=4 S=1024 of ``generate``,
    B=1 S=2048 of the engine's longest prompt) with bf16 B/C, as the bf16
    model gives them.  The decay is exp of a
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
        (MAMBA_REMAT["B"], MAMBA_REMAT["S"], "bf16", torch.bfloat16),
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


def time_ssd_bwd(torch) -> dict:
    """Phase 4, the SSD backward kernels at one pass of each SSD cell of the
    benchmark (SSD_BWD_TIMED; bf16 B/C, the model's dA, no gradient of h, as
    training gives them): each gradient against the plain backward (f32
    autograd of the plain version at chunk 256) within 1e-4 x its largest
    magnitude for dx and ddA (f32) and one bf16 spacing of it (2^-7) for dB
    and dC, both rounded once to bf16; then the kernels' time a call over
    SSD_BWD_BATCH calls, the device time of each of the five launches, and
    the plain backward's time one call at a time.  The bound: x, dy and dx,
    dA and ddA (f32) and B, C, dB and dC (bf16), each read or written once,
    at the HBM rate (the states the forward kept are the kernels' choice,
    not counted)."""
    from repro_torch.kernels import ssd_scan as ssd

    f = SSD_FULL
    P, G, N, chunk = f["P"], f["G"], f["N"], f["chunk"]
    shapes = []
    for B, S_, H in SSD_BWD_TIMED:
        x, dA, Bm, Cm = ssd_inputs(torch, B, S_, H, P, G, N, torch.bfloat16, 13, model_dA=True)
        gy = torch.randn(B, S_, H, P, generator=torch.Generator(device="cuda").manual_seed(14),
                         device="cuda")
        _, _, ws = ssd.ssd_scan_with_states(x, dA, Bm, Cm, chunk)
        got = ssd.ssd_scan_bwd(x, dA, Bm, Cm, chunk, gy, None, ws)
        want = ssd.ssd_scan_bwd_torch(x, dA, Bm, Cm, chunk, gy, None)
        errs, ok = {}, True
        for name, k, p in zip(("dx", "ddA", "dB", "dC"), got, want):
            top = float(p.float().abs().max())
            err = float((k.float() - p.float()).abs().max())
            limit = (1e-4 if p.dtype == torch.float32 else 2.0**-7) * top
            errs[name] = err / top
            ok = ok and bool(torch.isfinite(k).all()) and err <= limit
        del got, want
        torch.cuda.empty_cache()
        run = lambda: ssd.ssd_scan_bwd(x, dA, Bm, Cm, chunk, gy, None, ws)  # noqa: E731
        ms = time_cuda(run, reps=5, warmup=1, batch=SSD_BWD_BATCH)
        passes = device_split(torch, run, SSD_BWD_BATCH)
        plain_ms = time_cuda(lambda: ssd.ssd_scan_bwd_torch(x, dA, Bm, Cm, chunk, gy, None),
                             reps=3, warmup=1)
        nbytes = (3 * x.numel() + 2 * dA.numel()) * 4 + 4 * Bm.numel() * 2
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes.append(dict(B=B, S=S_, H=H, ms=ms, passes_ms=passes, plain_ms=plain_ms,
                           bound_ms=bound_ms, nbytes=nbytes, rel_err=errs))
        log(f"time ssd_scan_bwd B={B} S={S_} H={H} P={P} G={G} N={N} bf16 B/C: kernels "
            f"{ms:.4f} ms a call ({SSD_BWD_BATCH} calls a reading; bound {bound_ms:.4f} ms by bytes "
            f"over {nbytes / 1e6:.2f} MB, {bound_ms / ms:.1%} of it), plain backward "
            f"{plain_ms:.3f} ms ({plain_ms / ms:.1f}x); against the plain backward, error over "
            f"its max " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" {'ok' if ok else 'FAIL'}; device time a call by kernel (profiler): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
        if not ok:
            raise AssertionError(f"ssd_scan_bwd at B={B} S={S_} H={H} disagrees with the plain "
                                 "backward")
        del x, dA, Bm, Cm, gy, ws
        torch.cuda.empty_cache()
    return dict(shapes=shapes)


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
          and nk == 2 * MAMBA_LAYERS and nt == 0)  # remat: forward and recompute
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
    for B, S_, H, K, hd, window in FLASH_FAMILY:
        q, k, v = flash_inputs(torch, B, S_, H, K, hd, torch.bfloat16, S_ + H + K)
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_torch(q, k, v, causal=True, window=window)
        err = float((out.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(out.float()).all())
        ok = finite and bool(torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))
        log(f"check flash_attention family prefill B={B} S={S_} H={H} K={K} hd={hd} bf16 causal "
            f"window={window}: finite {finite}, max_abs_err {err:.3e} (atol {atol:g}, rtol "
            f"{rtol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention at the family shape B={B} S={S_} H={H} K={K}")
        full[f"B{B}_S{S_}_H{H}_K{K}_hd{hd}_w{window}"] = err
        del q, k, v, out, ref
        torch.cuda.empty_cache()
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
    return dict(shapes[0], shapes=shapes, family_shapes=time_flash_family(torch),
                train=time_flash_train(torch, *FLASH_TRAIN),
                train_family=[time_flash_train(torch, *shape, library=False)
                              for shape in FLASH_TRAIN_FAMILY])


def check_flash_train(torch, kern, q, k, v, do, causal, window) -> dict:
    """The training kernels' o, dq, dk and dv (``kern``) against autograd
    of the plain version (the model's chain) on the same bf16 inputs and on
    them in f32 (no rounding anywhere), by the card test's rules: each
    one's relative error (Frobenius) to f32 at most 1.1x the plain chain's
    plus 1e-5, and within FLASH_TRAIN_TOL of the plain chain's.  Raises
    AssertionError on a value over either or one that is not finite."""
    from repro_torch.kernels import flash_attention as fa

    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())  # noqa: E731
    sides = []
    for dtype in (torch.bfloat16, torch.float32):
        leaves = [t.detach().to(dtype, copy=True).requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention_train_torch(*leaves, causal=causal, window=window)
        o.backward(do.to(dtype))
        sides.append([o.detach()] + [t.grad for t in leaves])
        del o, leaves
        torch.cuda.empty_cache()
    errs, bad = {}, []
    for name, a, p, r in zip(("o", "dq", "dk", "dv"), kern, *sides):
        ek, ep, ekp = rel(a, r), rel(p, r), rel(a, p)
        errs[name] = dict(to_plain=ekp, to_f32=ek, plain_to_f32=ep)
        if not (bool(torch.isfinite(a.float()).all()) and ek <= 1.1 * ep + 1e-5
                and ekp <= FLASH_TRAIN_TOL):
            bad.append(name)
    if bad:
        raise AssertionError(f"flash_attention_train {bad} disagree with the plain chain: {errs}")
    return errs


def time_flash_train(torch, B, S_, H, K, hd, window=None, library=True) -> dict:
    """Phase 4, the training kernels at one shape (bf16, causal): the
    forward (o and lse) and the backward (D, dQ, dK and dV) each timed in
    turns with the library call, kernel, library, library, kernel, a
    reading a median of 5 of FLASH_TRAIN_BATCH calls; the plain version
    (the model's chain, forward and autograd backward, on a part of the
    work, scaled up) beside them.  That part is a quarter of the rows where
    B >= 4, else the first kv head with its G query heads; the outputs on
    it are held to the plain version's by :func:`check_flash_train`.
    With ``library``, the library call is
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    (B, H, S, hd) views, forward alone and forward + backward (its
    backward's time is the difference): a yardstick, never called by the
    port; it takes no window.  Bounds: the forward's least work is the two
    products over the causal (and window) pairs, 4 hd B H pairs
    operations; the backward's 2.5x that (dP, dV, dQ and dK, and S once
    more, since P is not kept), over the bf16 tensor-core rate against q,
    k, v, o, dO (and dq, dk, dv) moved once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(torch, B, S_, H, K, hd, torch.float32, 97)
    q = (q * hd**-0.5).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    do = torch.randn(q.shape, device=q.device,
                     generator=torch.Generator(device=q.device).manual_seed(96)).to(torch.bfloat16)
    o, lse = fa.flash_attention_train_fwd(q, k, v, True, window)
    grads = fa.flash_attention_train_bwd(q, k, v, o, do, lse, True, window)
    # the plain chain on a part of the work (its (B, K, G, S, S) f32 tensors
    # are 9.4 GiB each at B 40); its work is linear in the rows and heads
    if B >= 4:
        parts, part_q, part_kv = 4, (slice(0, B // 4),), (slice(0, B // 4),)
    else:
        parts, part_q, part_kv = K, (slice(None), slice(None), slice(0, H // K)), \
            (slice(None), slice(None), slice(0, 1))
    qp, dop = q[part_q], do[part_q]
    kp, vp = k[part_kv], v[part_kv]
    errs = check_flash_train(torch, (o[part_q], grads[0][part_q], grads[1][part_kv],
                                     grads[2][part_kv]), qp, kp, vp, dop, True, window)
    del grads
    torch.cuda.empty_cache()
    fwd = lambda: fa.flash_attention_train_fwd(q, k, v, True, window)  # noqa: E731
    bwd = lambda: fa.flash_attention_train_bwd(q, k, v, o, do, lse, True, window)  # noqa: E731
    tc = lambda f: time_cuda(f, reps=5, warmup=1, batch=FLASH_TRAIN_BATCH)  # noqa: E731
    lib_fwd_ms = lib_both_ms = None
    if library:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True, scale=1.0)
        lib_both = lambda: torch.autograd.backward(sdpa(), dot)  # noqa: E731
        with torch.no_grad():
            f_turns = [tc(f) for f in (fwd, sdpa, sdpa, fwd)]
            b_turns = [tc(bwd)]
        lb_turns = [tc(lib_both), tc(lib_both)]
        b_turns.append(tc(bwd))
        lib_fwd_ms, lib_both_ms = (f_turns[1] + f_turns[2]) / 2, sum(lb_turns) / 2
        del qt, kt, vt
    else:
        with torch.no_grad():
            f_turns = [tc(fwd), tc(fwd)]
            b_turns = [tc(bwd), tc(bwd)]
        f_turns = [f_turns[0], None, None, f_turns[1]]
        lb_turns = None
    torch.cuda.empty_cache()

    def plain_both():
        leaves = [t.detach().requires_grad_() for t in (qp, kp, vp)]
        fa.flash_attention_train_torch(*leaves, causal=True, window=window).backward(dop)

    with torch.no_grad():
        plain_fwd_ms = parts * time_cuda(
            lambda: fa.flash_attention_train_torch(qp, kp, vp, causal=True, window=window),
            reps=3, warmup=1)
    plain_both_ms = parts * time_cuda(plain_both, reps=3, warmup=1)
    torch.cuda.empty_cache()
    W = S_ if window is None else window
    unit = 2 * hd * B * H * sum(min(i + 1, W) for i in range(S_))  # one product's pairs
    fwd_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    fwd_bound, fwd_by = bound(fwd_bytes, 2 * unit, BF16_FLOPS)
    bwd_bound, bwd_by = bound(2 * fwd_bytes + 2 * q.numel(), 5 * unit, BF16_FLOPS)
    fwd_ms, bwd_ms = (f_turns[0] + f_turns[3]) / 2, (b_turns[0] + b_turns[1]) / 2
    res = dict(B=B, S=S_, H=H, K=K, hd=hd, window=window, ms=fwd_ms + bwd_ms, fwd_ms=fwd_ms,
               bwd_ms=bwd_ms, fwd_turns_ms=f_turns, bwd_turns_ms=b_turns,
               library_ms=lib_both_ms, library_fwd_ms=lib_fwd_ms,
               library_bwd_ms=None if lib_both_ms is None else lib_both_ms - lib_fwd_ms,
               library_both_turns_ms=lb_turns, plain_ms=plain_both_ms,
               plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_both_ms - plain_fwd_ms,
               bound_ms=fwd_bound + bwd_bound, fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
               bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, rel_err=errs,
               fwd_TFLOPs=2 * unit / fwd_ms / 1e9, bwd_TFLOPs=5 * unit / bwd_ms / 1e9)
    lib = ("no library call (SDPA's fused backends take no window)" if lib_both_ms is None else
           f"scaled_dot_product_attention forward {lib_fwd_ms:.3f} ms ({f_turns[1]:.3f}, "
           f"{f_turns[2]:.3f}), forward + backward {lib_both_ms:.3f} ms ({lb_turns[0]:.3f}, "
           f"{lb_turns[1]:.3f}), kernels / library forward + backward "
           f"{res['ms'] / lib_both_ms:.3f}")
    log(f"time flash_attention_train B={B} S={S_} H={H} K={K} hd={hd} window={window} bf16 "
        f"causal: forward + backward {res['ms']:.3f} ms (bound {res['bound_ms']:.3f}); forward "
        f"{fwd_ms:.3f} ms ({f_turns[0]:.3f}, {f_turns[3]:.3f}; {res['fwd_TFLOPs']:.1f} TFLOP/s "
        f"of the least {2 * unit / 1e9:.1f} GFLOP; bound {fwd_bound:.3f} ms by {fwd_by}, "
        f"{fwd_bound / fwd_ms:.1%} of it), backward {bwd_ms:.3f} ms ({b_turns[0]:.3f}, "
        f"{b_turns[1]:.3f}; {res['bwd_TFLOPs']:.1f} TFLOP/s of the least {5 * unit / 1e9:.1f} "
        f"GFLOP; bound {bwd_bound:.3f} ms by {bwd_by}, {bwd_bound / bwd_ms:.1%} of it); {lib}; "
        f"plain forward {plain_fwd_ms:.1f} ms, forward + backward {plain_both_ms:.1f} ms "
        f"(1/{parts} of the work, times {parts}); relative errors ok: {errs}")
    return res


def time_flash_family(torch) -> list[dict]:
    """Phase 4, flash attention at the families' prefill shapes
    (FLASH_FAMILY), bf16, causal, timed as :func:`time_flash` times (turns
    of FLASH_BATCH launches with the library call).  A window's bound
    counts only the pairs inside it: 4 * hd * B * H * sum_i min(i + 1, W)
    operations.  The library call takes the window as a boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    out = []
    for B, S_, H, K, hd, window in FLASH_FAMILY:
        q, k, v = flash_inputs(torch, B, S_, H, K, hd, torch.bfloat16, 98)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            i = torch.arange(S_, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        ref = fa.flash_attention_torch(q, k, v, causal=True, window=window)
        err = float((kern().float() - ref.float()).abs().max())
        lib_err = float((lib().transpose(1, 2).float() - ref.float()).abs().max())
        del ref
        turns = [time_cuda(f, batch=FLASH_BATCH) for f in (kern, lib, lib, kern)]
        plain_ms = time_cuda(lambda: fa.flash_attention_torch(q, k, v, causal=True, window=window),
                             reps=3, warmup=1)
        W = S_ if window is None else window
        pairs = sum(min(i + 1, W) for i in range(S_))
        flops = 4 * hd * B * H * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
        ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        out.append(dict(B=B, S=S_, H=H, K=K, hd=hd, window=window, ms=ms, library_ms=library_ms,
                        plain_ms=plain_ms, turns_ms=turns, bound_ms=bound_ms, bound_by=bound_by,
                        max_abs_err=err, library_max_abs_err=lib_err, flops=flops,
                        nbytes=nbytes))
        log(f"time flash_attention family B={B} S={S_} H={H} K={K} hd={hd} window={window} bf16 "
            f"causal: kernel {ms:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}; "
            f"{flops / ms / 1e9:.2f} TFLOP/s of the least {flops / 1e9:.3f} GFLOP; bound "
            f"{bound_ms:.4f} ms by {bound_by}, {bound_ms / ms:.1%} of it), "
            f"scaled_dot_product_attention {library_ms:.4f} ms ({turns[1]:.4f}, {turns[2]:.4f}; "
            f"its max_abs_err {lib_err:.3e}), kernel / library {ms / library_ms:.2f}; plain "
            f"{plain_ms:.4f} ms, kernel max_abs_err {err:.3e}")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def greedy_trace(torch, model, params, tokens, steps: int, cache_len: int, extra=None):
    """LMServer.generate's loop (no EOS, no budgets) with each step's top-2
    logit gap and max|logit| kept: tokens, gaps, maxima as (B, steps)
    numpy arrays.  Token i is the argmax of the i-th logits.  ``extra``:
    more prefill inputs (a vision model's patches)."""
    toks, gaps, tops = [], [], []
    logits, cache = model.prefill(params, {"tokens": tokens, **(extra or {})},
                                  cache_len=cache_len)
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


def tokens_agree(label: str, got, ref, gaps, tops, limit: float = NEAR_TIE) -> dict:
    """``got`` against ``ref`` row by row: equal, or parting first where the
    reference's top-2 gap is at most ``limit`` x its max|logit| (a near-tie
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
            f"top-2 gap there {gaps[b, i]:.3e} = {rel:.3e} of max|logit| (limit {limit:g}) "
            f"{'ok (near-tie)' if rel <= limit else 'FAIL'}")
        if rel > limit:
            raise AssertionError(f"{label}: row {b} parts at step {i} with no near-tie")
        parted.append(dict(row=b, step=i, rel_gap=rel))
    log(f"  {label}: {ref.shape[0] - len(parted)} of {ref.shape[0]} rows equal over "
        f"{ref.shape[1]} tokens")
    return dict(rows=int(ref.shape[0]), parted=parted)


def full_model(torch, arch: str, dtype: str | None = None, **impl):
    """The full-width model (at ``DEPTH``'s depth where memory cuts it)
    from seed 0, in the config's dtype (or ``dtype``), on the card; its
    parameter count checked against ``PARAMS``.  Returns (cfg, model,
    params, info): the count, the init's seconds and peak memory, and the
    depth cut's note."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = get_config(arch)
    cut = ""
    if arch in DEPTH:
        cut = f"reduced: depth {DEPTH[arch]}/{cfg.n_layers}, memory"
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, **impl)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    info = dict(n_params=model.param_count(params), init_s=time.perf_counter() - t0,
                init_peak_gib=torch.cuda.max_memory_allocated() / 2**30, cut=cut or None)
    log(f"{arch}{f' ({cut})' if cut else ''}: {info['n_params']} parameters ({cfg.dtype}) from "
        f"seed 0 in {info['init_s']:.2f} s, peak memory of the init {info['init_peak_gib']:.2f} GiB")
    if info["n_params"] != PARAMS[arch]:
        raise AssertionError(f"{arch}: {info['n_params']} parameters, expected {PARAMS[arch]}")
    return cfg, model, params, info


def serve_path(torch, arch: str, gen: dict = GEN, engine: bool = True) -> dict:
    """Phases 7 and 10 (a)-(c): serving at full width, random bf16 weights
    from seed 0.  ``LMServer.generate`` on ``gen``'s B prompts of S tokens
    (behind a vision model's patch embeddings, a seeded normal x 0.02),
    then, with ``engine``, ``ServingEngine.run`` on the trace of
    examples/serve_lm.py at real prompt lengths, with every kernel's launch
    count set to 0 just before each and read just after.  Each prefill
    kernel (flash attention, the SSD scan) launches once per layer that
    runs it and prefill call and never in decode; every call's logits are
    finite; every request completes with tokens in [0, vocab).  With
    ``engine``, one more generate prefill, profiled outside the counted
    windows, gives the device's busy time against the prefill's wall time."""
    import numpy as np

    from repro_torch.approx.deadline import SLOPolicy
    from repro_torch.core.straggler import FixedDelayStragglers
    from repro_torch.serve import ReplicaPool, Request, ServingEngine
    from repro_torch.train.serve import LMServer

    cfg, model, params, info = full_model(torch, arch)
    name = f"{arch} ({info['cut']})" if info["cut"] else arch
    per_prefill = {"flash_attention": sum(spec.mixer == "attn" for spec in model.plan),
                   "ssd_scan": sum(spec.mixer == "mamba" for spec in model.plan)}
    counters = launch_counters()
    server = LMServer(model)
    calls = {"prefill": [], "decode": [], "prefill_launches": 0, "decode_launches": 0}
    finite: list[bool] = []

    def checked(fn):
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            finite.append(bool(torch.isfinite(logits.float()).all()))
            return logits, cache
        return wrapped

    server._prefill = timed(torch, checked(server._prefill), calls, "prefill", counters)
    server._decode = timed(torch, checked(server._decode), calls, "decode", counters)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (gen["B"], gen["S"])).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = (rng.standard_normal((gen["B"], cfg.n_patches, cfg.d_model))
                            * 0.02).astype(np.float32)

    def check(label, want_prefills, toks, peak, wall):
        launches = {name: fn.launches for name, fn in counters.items()}
        want = {k: per_prefill.get(k, 0) * want_prefills for k in counters}
        in_range = bool(((toks >= 0) & (toks < cfg.vocab)).all())
        ok = (launches == want and len(calls["prefill"]) == want_prefills and in_range
              and calls["decode_launches"] == 0 and all(finite))
        log(f"serve {name} {label}: {len(calls['prefill'])} prefill calls, launches {launches} "
            f"(expected {want}), kernel launches during decode {calls['decode_launches']}, "
            f"every call's logits finite {all(finite)}, tokens in [0, {cfg.vocab}) {in_range}, "
            f"peak memory {peak / 2**30:.2f} GiB, {wall:.2f} s wall {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"serve {arch} {label}: launches, logits or tokens wrong")
        return launches

    # LMServer.generate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    gen_toks = server.generate(params, batch, gen["new"], cache_len=gen["cache_len"])
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated()
    gen_launches = check("LMServer.generate", 1, gen_toks, gen_peak, gen_wall)
    if gen_toks.shape != (gen["B"], gen["new"]):
        raise AssertionError(f"generate returned {gen_toks.shape}")
    gen_prefill_ms = calls["prefill"][0] * 1e3
    gen_decode_ms = statistics.median(calls["decode"]) * 1e3
    log(f"serve {name} generate B={gen['B']} S={gen['S']}"
        f"{' + ' + str(cfg.n_patches) + ' patches' if 'patches' in batch else ''} "
        f"new={gen['new']} cache_len {gen['cache_len']}"
        f"{' window ' + str(cfg.window) if cfg.window else ''}: prefill {gen_prefill_ms:.2f} ms, "
        f"decode step median {gen_decode_ms:.2f} ms over {len(calls['decode'])}, "
        f"{gen_toks.size / gen_wall:.1f} generated tokens per wall second")
    res = dict(
        init=info,
        generate=dict(launches=gen_launches, prefill_ms=gen_prefill_ms,
                      decode_step_ms=gen_decode_ms, tokens_per_wall_s=gen_toks.size / gen_wall,
                      wall_s=gen_wall, peak_gib=gen_peak / 2**30),
        gen=gen, gen_tokens=gen_toks, batch=batch)
    if not engine:
        del server, model, params
        torch.cuda.empty_cache()
        return res
    # the same prefill once more under torch.profiler, outside the counted
    # windows: the device's busy time and the prefill kernel's part of it,
    # against the unprofiled prefill's wall time
    kernel = "flash_attention" if per_prefill["flash_attention"] else "ssd_scan"
    dev_batch = {k: torch.as_tensor(v, device=params["embed"].device) for k, v in batch.items()}
    with torch.inference_mode():
        split = device_split(torch, lambda: model.prefill(
            params, dev_batch, cache_len=gen["cache_len"]), 1)
    busy = sum(split.values())
    # the kernels' device names: flash_bf16_kernel, ssd_scan_*_kernel
    kernel_ms = sum(v for k, v in split.items() if k.startswith(kernel.split("_")[0]))
    log(f"serve {arch} generate prefill under torch.profiler: device busy {busy:.2f} ms, "
        f"{busy / gen_prefill_ms:.1%} of the unprofiled prefill's {gen_prefill_ms:.2f} ms wall; "
        f"{kernel} {kernel_ms:.2f} ms of it ({kernel_ms / busy:.1%}); the largest: "
        + ", ".join(f"{k} {v:.2f} ms"
                    for k, v in sorted(split.items(), key=lambda kv: -kv[1])[:5]))
    res["generate"].update(prefill_device_busy_ms=busy, prefill_kernel_device_ms=kernel_ms)

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
    eng = ServingEngine(server, params, n_slots=tr["n_slots"], cache_len=tr["cache_len"],
                        replicas=pool, decode_dt=None)
    calls.update(prefill=[], decode=[], prefill_launches=0, decode_launches=0)
    # the engine's batched decode step, timed and counted alike
    eng.batch._step = timed(torch, eng.batch._step, calls, "decode", counters)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    comps, metrics = eng.run(reqs)
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
    res["engine"] = e = dict(
        launches=eng_launches, prefill_calls=len(calls["prefill"]),
        prefill_ms_median=statistics.median(calls["prefill"]) * 1e3,
        decode_step_ms_median=statistics.median(calls["decode"]) * 1e3,
        decode_steps=len(calls["decode"]), tokens=int(all_toks.size),
        tokens_per_wall_s=all_toks.size / eng_wall, wall_s=eng_wall,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        ttft_p50_s=summ["ttft_p50_s"], ttft_p99_s=summ["ttft_p99_s"],
        ttft_wait_for_all_p50_s=float(np.percentile(ttft_all, 50)),
        ttft_wait_for_all_p99_s=float(np.percentile(ttft_all, 99)),
        prompt_tokens=int(sum(len(r.tokens) for r in reqs)))
    log(f"serve {arch} ServingEngine: {tr['n']} requests ({e['prompt_tokens']} prompt tokens, "
        f"{e['tokens']} generated) in {eng_wall:.2f} s wall: prefill per request median "
        f"{e['prefill_ms_median']:.2f} ms, decode step median {e['decode_step_ms_median']:.2f} ms "
        f"over {e['decode_steps']} steps of {tr['n_slots']} slots, {e['tokens_per_wall_s']:.1f} "
        f"generated tokens per wall second; TTFT on the virtual clock p50 {e['ttft_p50_s']:.3f} s "
        f"p99 {e['ttft_p99_s']:.3f} s against wait-for-all p50 {e['ttft_wait_for_all_p50_s']:.3f} "
        f"s p99 {e['ttft_wait_for_all_p99_s']:.3f} s; peak memory {e['peak_gib']:.2f} GiB; "
        "device busy share not measured (CUDA events give elapsed time, not busy time, and no "
        "profiled step is added)")
    del eng, server, model, params
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


def serve_cross_check(torch, arch: str, served: dict, f32: bool = True) -> dict:
    """Phases 8 and 10 (a)-(c): the kernels on the serving path against the
    plain versions (``attn_impl`` and ``ssd_impl="torch"``) on the weights
    :func:`serve_path` served, with TF32 off.  In bf16, printed, not held
    (the kernels keep p in f32 where the plain path rounds it, and in a MoE
    one ulp of a hidden state can flip an expert): the last-position logits
    and the served generate tokens against the plain path's, beside the
    plain path against itself with every embedding entry one bf16 spacing
    up; held: every logit finite.  With ``f32``, the model in f32 at full
    width through :func:`f32_serve_check`, on the trace of
    tests/test_serving.py scaled to 256-512 tokens, and both bf16 paths'
    logits and tokens against the f32 plain model's."""
    from repro_torch.models.lm import build_model
    from repro_torch.train.serve import LMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = served["gen"]
    new, L = g["new"], g["cache_len"] or g["S"] + g["new"]
    cfg, kernel, params, _ = full_model(torch, arch)
    plain = build_model(cfg, attn_impl="torch", ssd_impl="torch")
    dev = params["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in served["batch"].items()}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    lk16, _ = kernel.prefill(params, batch, cache_len=L)
    lt16, _ = plain.prefill(params, batch, cache_len=L)
    finite = bool(torch.isfinite(lk16.float()).all() and torch.isfinite(lt16.float()).all())
    bf16_rel = rel(lk16, lt16)
    # the plain path against itself with every embedding entry moved by one
    # bf16 spacing: how far one ulp at the input carries through the depth
    nudged = dict(params, embed=(params["embed"].view(torch.int16) + 1).view(torch.bfloat16))
    lu16, _ = plain.prefill(nudged, batch, cache_len=L)
    ulp_rel = rel(lu16, lt16)
    del nudged, lu16
    plain_toks = LMServer(plain).generate(params, batch, new, cache_len=g["cache_len"])
    agree = float((plain_toks == served["gen_tokens"]).mean())
    rows_equal = int((plain_toks == served["gen_tokens"]).all(1).sum())
    log(f"cross-check serve {arch} bf16 (reported, not held): last-position logits through the "
        f"kernels vs the plain versions max|diff|/max|logit| {bf16_rel:.3e}, beside the plain "
        f"path against itself with the embedding one bf16 ulp up {ulp_rel:.3e}; generate tokens "
        f"agree in {agree:.1%} of {plain_toks.size}, {rows_equal} of {plain_toks.shape[0]} rows "
        f"equal; every logit finite {finite} (held)")
    if not finite:
        raise AssertionError(f"{arch}: non-finite bf16 prefill logits")
    out = dict(bf16_logit_rel=bf16_rel, bf16_token_agreement=agree, bf16_rows_equal=rows_equal,
               bf16_one_ulp_logit_rel=ulp_rel)
    del kernel, plain
    if f32:
        params = {k: v.float() for k, v in params.items()}
        res32, lt, ref = f32_serve_check(
            torch, f"cross-check serve {arch} f32", dataclasses.replace(cfg, dtype="float32"),
            params, batch, new, L, [32 * n for n in (8, 14, 11, 9, 16)])
        # both bf16 paths against the f32 model: a kernel fault would put
        # the kernel's path further from f32 than the plain one
        to_f32 = dict(kernel_logit_rel=rel(lk16, lt), plain_logit_rel=rel(lt16, lt),
                      kernel_token_agreement=float((served["gen_tokens"] == ref).mean()),
                      plain_token_agreement=float((plain_toks == ref).mean()))
        log(f"cross-check serve {arch} bf16 against f32 plain (reported, not held): "
            f"last-position logits max|diff|/max|logit| kernel path "
            f"{to_f32['kernel_logit_rel']:.3e}, plain path {to_f32['plain_logit_rel']:.3e}; "
            f"generate tokens agree kernel path {to_f32['kernel_token_agreement']:.1%}, plain "
            f"path {to_f32['plain_token_agreement']:.1%} of {ref.size}")
        out.update(bf16_vs_f32=to_f32, **{f"f32_{k}": v for k, v in res32.items()})
    del params, lk16, lt16
    torch.cuda.empty_cache()
    return out


def f32_serve_check(torch, label: str, cfg, params, batch: dict, new: int, L: int, lens):
    """The held f32 serving checks, TF32 off: prefill through the kernels
    against the plain versions, its last-position logits within 1e-4 of
    max|logit| and each cache leaf within 1e-4 of its max (the SSD state
    1e-3, as the full-layer scan check), layer 0's leaves that no kernel
    touched (k and v, or the conv inputs) equal; ``generate``'s tokens
    equal; and given ``lens`` (the engine is tokens-only),
    ``ServingEngine``'s continuous batch of prompts of those lengths equal
    to sequential B=1 decode; tokens under the near-tie rule.  Returns
    (results, the plain prefill's logits, the plain generate tokens)."""
    import numpy as np

    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.train.serve import LMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="torch", ssd_impl="torch")
    dev = batch["tokens"].device
    lk, ck = kernel.prefill(params, batch, cache_len=L)
    lt, ct = plain.prefill(params, batch, cache_len=L)
    logit_rel = float((lk - lt).abs().max() / lt.abs().max())
    untouched = [n for n in ("layers.0.k", "layers.0.v", "layers.0.conv") if n in ct]
    first_equal = all(torch.equal(ck[n][0], ct[n][0]) for n in untouched)
    leaf_rel = {n: float((ck[n] - ct[n]).abs().max() / ct[n].abs().max().clamp(min=1e-30))
                for n in ct if n != "pos"}
    leaf_ok = all(v <= (1e-3 if n.endswith(".h") else 1e-4) for n, v in leaf_rel.items())
    ok = (logit_rel <= 1e-4 and bool(untouched) and first_equal and leaf_ok
          and torch.equal(ck["pos"], ct["pos"]))
    B, S_ = batch["tokens"].shape
    log(f"{label} prefill B={B} S={S_}{' + patches' if 'patches' in batch else ''}: "
        f"last-position logits max|diff|/max|logit| {logit_rel:.3e} (limit 1e-4); layer 0's "
        f"{', '.join(untouched)} (no kernel before them) equal {first_equal}; each cache leaf's "
        "max|diff|/max: " + ", ".join(f"{n} {v:.2e}" for n, v in leaf_rel.items())
        + f" (limits 1e-4, the SSD state 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: prefill through the kernels disagrees with plain")
    del lk, ck, ct
    got = LMServer(kernel).generate(params, batch, new, cache_len=L)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    ref, gaps, tops = greedy_trace(torch, plain, params, batch["tokens"], new, L, extra)
    res = dict(logit_rel=logit_rel, cache_leaf_rel=leaf_rel,
               generate=tokens_agree(f"{label} generate, kernels vs plain", got, ref, gaps, tops))
    if lens:
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                        max_new_tokens=7, arrival_t=0.02 * i) for i, n in enumerate(lens)]
        comps, _ = ServingEngine(LMServer(kernel), params, n_slots=2, cache_len=max(lens) + 8,
                                 decode_dt=0.01).run(reqs)
        res["continuous_vs_sequential"] = []
        for c, r in zip(comps, reqs):
            one, gaps, tops = greedy_trace(torch, kernel, params,
                                           torch.as_tensor(r.tokens[None], device=dev), 7,
                                           max(lens) + 8)
            res["continuous_vs_sequential"].append(tokens_agree(
                f"{label} continuous batch vs sequential, request {c.rid} "
                f"({len(r.tokens)} tokens)", c.tokens[None], one, gaps, tops))
    return res, lt, ref


def reduced_f32_check(torch, arch: str) -> dict:
    """Phase 10 (f): the reduced config in f32 on the card through
    :func:`f32_serve_check`: 4 prompts of 40 tokens (past mixtral's reduced
    window of 16; behind internvl2's patches), 8 new, and, but for
    internvl2, the continuous batch."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = get_config(arch).reduced()
    dev = torch.device("cuda")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(2)
    B, S_, new = 4, 40, 8
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32),
                                       device=dev)}
    lens = (20, 40, 28, 33, 17)
    if cfg.frontend == "vision":
        batch["patches"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_patches, cfg.d_model)) * 0.02, dtype=torch.float32,
            device=dev)
        lens = None
    L = S_ + new + (cfg.n_patches if lens is None else 0)
    res, _, _ = f32_serve_check(torch, f"family f32 {arch} (reduced)", cfg, params, batch, new,
                                L, lens)
    del params
    torch.cuda.empty_cache()
    return res


def jamba_path(torch, plain_launches) -> dict:
    """Phase 10 (d): the reduced jamba (a period of 8 mixing mamba,
    attention, dense and MoE layers) in bf16 on the card: ``generate``
    (prefill and 8 decode steps) with the SSD scan launched once per mamba
    layer and flash attention once per attention layer of the prefill call,
    none in decode; against the same model with ``ssd_impl="torch",
    attn_impl="torch"``, the prefill's last-position logits within
    BF16_LOGIT_LIMIT of max|logit| and the tokens equal under the near-tie
    rule at BF16_NEAR_TIE.  Then one ``fused`` coded training step through
    the launcher (``--reduced``, f32) held to a CPU replay, with
    ``LM._losses`` observed, not replaced: beside the step's weighted call
    the same model's sequence losses of the same weights and batch, whose
    weighted sum is the step's loss, are each the plain model's
    cross-entropy of the same batch plus ``aux_coef`` x the MoE
    load-balance term, which is finite and positive."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, build_model
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.train.serve import LMServer

    g = JAMBA_GEN
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), dtype="bfloat16")
    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    mamba_layers = sum(spec.mixer == "mamba" for spec in model.plan)
    attn_layers = sum(spec.mixer == "attn" for spec in model.plan)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (g["B"], g["S"])).astype(np.int32)
    counters = launch_counters()
    server = LMServer(model)
    calls = {"prefill": [], "decode": [], "prefill_launches": 0, "decode_launches": 0}
    server._prefill = timed(torch, server._prefill, calls, "prefill", counters)
    server._decode = timed(torch, server._decode, calls, "decode", counters)
    for fn in counters.values():
        fn.launches = 0
    toks = server.generate(params, {"tokens": prompts}, g["new"])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 0 for name in counters}
    want.update(ssd_scan=mamba_layers, flash_attention=attn_layers)
    in_range = bool(((toks >= 0) & (toks < cfg.vocab)).all())
    ok = launches == want and calls["decode_launches"] == 0 and in_range
    log(f"family {JAMBA} (reduced config, bf16: {cfg.n_layers} layers, {mamba_layers} mamba, "
        f"{attn_layers} attention) generate B={g['B']} S={g['S']} new={g['new']}: launches "
        f"{launches} (expected {want}), kernel launches during decode "
        f"{calls['decode_launches']}, tokens in [0, {cfg.vocab}) {in_range} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("jamba generate: launches or tokens wrong")
    plain = build_model(cfg, ssd_impl="torch", attn_impl="torch")
    dprompts = torch.as_tensor(prompts, device=dev)
    ref, gaps, tops = greedy_trace(torch, plain, params, dprompts, g["new"], g["S"] + g["new"])
    lk, _ = model.prefill(params, {"tokens": dprompts}, cache_len=g["S"] + g["new"])
    lt, _ = plain.prefill(params, {"tokens": dprompts}, cache_len=g["S"] + g["new"])
    logit_rel = float((lk.float() - lt.float()).abs().max() / lt.float().abs().max())
    ok = logit_rel <= BF16_LOGIT_LIMIT
    log(f"family {JAMBA} bf16 prefill logits through the kernels vs the plain versions "
        f"max|diff|/max|logit| {logit_rel:.3e} (limit {BF16_LOGIT_LIMIT:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("jamba bf16 prefill through the kernels disagrees with plain")
    agree = tokens_agree(f"family {JAMBA} bf16 generate, kernels vs plain", toks, ref, gaps, tops,
                         limit=BF16_NEAR_TIE)
    del server, model, plain, params
    torch.cuda.empty_cache()

    # one fused coded training step, held to the CPU replay by main_path;
    # the step's own loss split into cross-entropy and the MoE term
    red = get_config(JAMBA).reduced()
    n_red = build_model(red).param_count(build_model(red).init(torch.Generator().manual_seed(0),
                                                               "cpu"))
    plain32 = build_model(red, ssd_impl="torch", attn_impl="torch")
    ce32 = build_model(dataclasses.replace(red, aux_coef=0.0), ssd_impl="torch",
                       attn_impl="torch")
    # seq_losses and weighted_loss both run LM._losses (weight None or the
    # batch's).  The weighted call on the card runs as the program has it;
    # beside it, the same model's sequence losses of the same weights and
    # batch are read untraced and without grad, their kernel launches
    # taken off the counters main_path holds to the step's
    losses, seen = LM._losses, []
    counted = launch_counters()

    def observed(self, params, batch, weight):
        out = losses(self, params, batch, weight)
        if weight is not None and out.device.type == dev.type:  # the step on the card
            launched = {name: fn.launches for name, fn in counted.items()}
            tracer, self.tracer = self.tracer, NULL_TRACER
            try:
                with torch.no_grad():
                    p = {k: v.detach() for k, v in params.items()}
                    seq = losses(self, p, batch, None)
                    seen.append(dict(loss=float((seq * weight).sum()), seq=seq,
                                     ce=ce32.seq_losses(p, batch),
                                     aux=float(plain32.forward(p, batch)[1])))
            finally:
                self.tracer = tracer
                for name, fn in counted.items():
                    fn.launches = launched[name]
        return out

    fused = lambda n: {**plain_launches(0), "ssd_scan": n * mamba_layers}  # noqa: E731
    LM._losses = observed
    try:
        step = main_path(torch, "jamba fused", JAMBA_ARGS, fused, n_params_want=n_red, steps=1)
    finally:
        LM._losses = losses
    if len(seen) != 1:
        raise AssertionError(f"jamba: the step made {len(seen)} weighted loss calls on the card")
    s, loss = seen[0], step["losses"][0]
    gap = float((s["seq"] - s["ce"] - red.aux_coef * s["aux"]).abs().max())
    limit = 1e-4 * float(s["seq"].abs().max())
    ok = (abs(s["loss"] - loss) <= 1e-6 * abs(loss) and math.isfinite(s["aux"]) and s["aux"] > 0
          and gap <= limit)
    log(f"family {JAMBA} fused step: loss {loss:.6f}, the weighted sum of the sequence losses "
        f"at the step's weights {s['loss']:.6f}; each sequence's loss minus the plain model's "
        f"cross-entropy against aux_coef x aux = {red.aux_coef} x {s['aux']:.4f}: max|diff| "
        f"{gap:.3e} (limit 1e-4 x max|loss| = {limit:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("jamba: the step's loss is not cross-entropy plus the MoE term")
    torch.cuda.empty_cache()
    return dict(launches=launches, prefill_logit_rel_bf16=logit_rel, tokens=agree,
                fused_step=step, aux=s["aux"], aux_gap=gap)


def torchrun(torch, label: str, target: list[str], timeout: int = GROUP_TIMEOUT_S) -> str:
    """Phase 11's subprocess: ``python -m torch.distributed.run --standalone
    --nproc-per-node M`` of ``target`` (``-m module ...`` or a script), the
    ranks sharing the card over gloo, after this process emptied its CUDA
    cache.  Any rank's failure fails the phase.  Returns rank 0's stdout
    (the other ranks print nothing)."""
    import gc

    gc.collect()  # earlier phases' engines sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"{label}: this process holds {held / 2**30:.3f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved on the card")
    # each target starts its own arguments with "--", which ends torchrun's
    # options: its argparse (Python 3.12.3) would take the launcher's --s
    # and --m for abbreviations of its own
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(M), *target]
    log(f"{label}: " + " ".join(cmd[1:]))
    env = {**__import__("os").environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log("  | " + line[:400])
    if proc.returncode != 0:
        # the ranks' own tracebacks (torchrun prefixes them), else the tail
        lines = proc.stderr.splitlines()
        for line in [x for x in lines if x.startswith("[rank")][:100] or lines[-60:]:
            log("  ! " + line)
        raise AssertionError(f"{label}: torchrun exited {proc.returncode}")
    log(f"{label}: {M} ranks done in {wall:.2f} s wall (start-up, build lookup and init "
        "included)")
    return proc.stdout


def _summary(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def _step_records(path: Path) -> list[dict]:
    from repro_torch.launch import obs_report

    return [r["args"] for r in obs_report.load_records(str(path))
            if r["kind"] == "event" and r["name"] == "train.step"]


def _log_ranks(label: str, summary: dict) -> None:
    for r in summary["ranks"]:
        log(f"  {label} rank {r['rank']} ({r['device']}, member {r['member']}): launches "
            f"{r['launches']}, peak {r['peak_gib']} GiB, step median "
            f"{r['step_s_median']:.4f} s, params sha256 {r['params_sha256'][:16]}")


def group_path(torch, faults: dict) -> dict:
    """Phase 11, the spmd backend across processes: M ranks of
    ``repro_torch.launch.train`` on the one card over gloo, one rank a
    coded worker: (a) the main path at full width; (b) the int8 wire under
    phase 9's faults, m 4 -> 3 -> 2 through two group rebuilds; (c) the f32
    cross-check of one decoded gradient against the single-process spmd
    path (:func:`group_cross_check`)."""
    import shutil

    from repro_torch.launch.train import main as train_main

    out = {}
    try:
        # (a) the main path
        log("control-plane replay of the group main path (reduced width, CPU):")
        expect = train_main([*SLICE_ARGS, "--reduced", "--device", "cpu"])["history"]
        logf = GROUP_DIR / "main.jsonl"
        stdout = torchrun(torch, "group (a)", ["-m", "--", "repro_torch.launch.train", *SLICE_ARGS,
                                              "--device", "cuda", "--log-jsonl", str(logf)])
        summary, recs = _summary(stdout), _step_records(logf)
        _log_ranks("group (a)", summary)
        if summary["world_size"] != M or summary["transport"] != "gloo" or \
                summary["n_params"] != D_FULL or len(recs) != STEPS:
            raise AssertionError(f"group (a): {summary['world_size']} ranks over "
                                 f"{summary['transport']}, {summary['n_params']} params, "
                                 f"{len(recs)} steps")
        for i, (h, e) in enumerate(zip(recs, expect)):
            if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
                raise AssertionError(f"group (a) step {i}: non-finite loss or grad norm")
            for key, theirs in (("n_used", "n_used"), ("n_stragglers", "n_stragglers"),
                                ("sim_iter_time", "sim_iter_time"),
                                ("residual", "decode_residual"),
                                ("exact_fraction", "exact_fraction"), ("skipped", "skipped")):
                if float(h[key]) != float(e[theirs]):
                    raise AssertionError(f"group (a) step {i}: {key} {h[key]} != "
                                         f"control-plane replay {e[theirs]}")
        want = {"coded_reduce": STEPS, "coded_encode_int8": 0, "coded_decode_int8": 0,
                "ssd_scan": 0, "flash_attention": 0}
        for r in summary["ranks"]:
            if r["launches"] != want:
                raise AssertionError(f"group (a) rank {r['rank']}: launches {r['launches']} "
                                     f"!= {want} (1 coded_reduce a step)")
        if not summary["replicas_bit_equal"]:
            raise AssertionError("group (a): the ranks' params are not bit-equal")
        out["main"] = dict(
            steps=STEPS, losses=[h["loss"] for h in recs],
            step_s_median=summary["ranks"][0]["step_s_median"],
            peak_gib=[r["peak_gib"] for r in summary["ranks"]], wall_s=summary["wall_s"],
            launches=summary["ranks"][0]["launches"])
        log(f"group (a) ok: {M} ranks, {D_FULL} parameters, decode metrics == CPU replay, "
            f"losses {out['main']['losses']}, 1 coded_reduce a rank a step, params bit-equal "
            f"on every rank; step median {out['main']['step_s_median']:.4f} s, peaks (GiB) "
            f"{out['main']['peak_gib']}")

        # (b) the int8 wire under phase 9's faults
        logf = GROUP_DIR / "faults.jsonl"
        stdout = torchrun(torch, "group (b)", ["-m", "--", "repro_torch.launch.train", *FAULT_ARGS,
                                              "--device", "cuda", "--audit-rebuilds",
                                              "--log-jsonl", str(logf)])
        summary = _summary(stdout)
        from repro_torch.launch import obs_report

        att = _attempts(obs_report.load_records(str(logf)))
        recs = _step_records(logf)
        _log_ranks("group (b)", summary)
        rank0 = summary["ranks"][0]
        moves = [rb for rb in rank0["rebuilds"] if rb["m_before"] != rb["m_after"]]
        for rb in moves:
            log(f"  group (b) rebuild: m {rb['m_before']} -> {rb['m_after']}, err rows carried "
                f"{rb['err_rows_carried']} zeroed {rb['err_rows_zeroed']}, {rb['ms']:.1f} ms, "
                f"group rebuilt {rb['mesh_rebuilt']}")
        for a in rank0["row_audits"]:
            log(f"  group (b) row audit at m {a['m_before']} -> {a['m_after']}: moved (old rank, "
                f"new rank) {a['moved']}, carried {len(a['carried'])}, zeroed {a['zeroed']}, "
                f"bit-equal {a['ok']}")
        if [(rb["m_before"], rb["m_after"]) for rb in moves] != [(4, 3), (3, 2)]:
            raise AssertionError(f"group (b): rebuilds {moves}, expected m 4 -> 3 -> 2")
        audits = rank0["row_audits"]
        if len(audits) != 2 or not all(a["ok"] for a in audits) or \
                any(rb["err_rows_carried"] != rb["m_after"] for rb in moves):
            raise AssertionError(f"group (b): carried rows not bit-equal: {audits}")
        if att != faults["attempts"] or len(recs) != FAULT_STEPS:
            raise AssertionError(f"group (b): attempts {att} != phase 9's {faults['attempts']}")
        for i, (h, e) in enumerate(zip(recs, faults["trajectory"])):
            for key in TRAJECTORY:
                got = h.get("residual" if key == "decode_residual" else key, 0.0)
                if float(got) != float(e.get(key, 0.0)):
                    raise AssertionError(f"group (b) step {i}: {key} {got} != phase 9 / CPU "
                                         f"replay {e.get(key)}")
            if not (math.isfinite(h["loss"]) or h["skipped_nonfinite"]):
                raise AssertionError(f"group (b) step {i}: non-finite and not skipped")
        if summary["resilience"] != faults["resilience"] or summary["m_final"] != faults["m_final"]:
            raise AssertionError(f"group (b): {summary['resilience']} m_final "
                                 f"{summary['m_final']} != phase 9's")
        for r in summary["ranks"]:
            live = sum(n for n, m in att if r["rank"] < m)  # attempts this rank took part in
            want = {"coded_reduce": live, "coded_encode_int8": live, "coded_decode_int8": live,
                    "ssd_scan": 0, "flash_attention": 0}
            if r["launches"] != want:
                raise AssertionError(f"group (b) rank {r['rank']}: launches {r['launches']} "
                                     f"!= {want} (1 encode + 1 decode an attempt)")
        if not summary["replicas_bit_equal"]:
            raise AssertionError("group (b): the live ranks' params are not bit-equal")
        out["faults"] = dict(
            attempts=att, m=[m for _, m in att], rebuilds=moves, row_audits=audits,
            step_s_median=rank0["step_s_median"], peak_gib=[r["peak_gib"] for r in summary["ranks"]],
            launches={r["rank"]: r["launches"] for r in summary["ranks"]},
            wall_s=summary["wall_s"])
        log(f"group (b) ok: m {out['faults']['m']} through 2 group rebuilds, trajectory == phase "
            f"9 and the CPU replay, 1 encode + 1 decode a live rank an attempt, carried rows "
            f"bit-equal, live params bit-equal")

        # (c) the f32 cross-check against the single-process spmd path
        out["cross_check"] = group_cross_check(torch)
    finally:
        shutil.rmtree(GROUP_DIR, ignore_errors=True)
    return out


def _cross_check_inputs(torch, dev):
    """Phase 6's f32 inputs: the full-width model in f32, random weights from
    seed 0, heter_aware s=1 m=M, worker 1 faulted, micro-batches of 2 x 64."""
    from repro_torch.configs import CodingConfig, get_config
    from repro_torch.core.codec import Codec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    model = build_model(cfg)
    codec = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1)
    outcome = codec.decode_outcome([w for w in range(M) if w != 1])
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticData(cfg, k=codec.k, part_mb=2, seq_len=64, seed=0).batch(0)
    return model, codec, outcome, params, batch


def _flat(torch, g: dict):
    return torch.cat([v.reshape(-1).float() for v in g.values()])


def group_cross_check(torch) -> dict:
    """Phase 11 (c): one decoded gradient at full width in f32, TF32 off,
    through M ranks (:func:`group_cross_check_rank`) against the
    single-process spmd path on the same inputs, saved under build/ by
    phase 6's :func:`cross_check`.  Uncompressed: relative L2 <= 1e-5 (only the
    summation order differs).  The int8 wire: bit-equal wherever the
    gathered q and scale * a_w equal the single-process ones, elsewhere
    within one wire step, max_w |a_w * scale_w|."""
    torchrun(torch, "group (c)", ["--", str(ROOT / "chip_smoke.py"), "--group-cross-check",
                                  str(GROUP_DIR)])
    res = json.loads((GROUP_DIR / "cross_check.json").read_text())
    log(f"group (c): uncompressed, {M} ranks vs one process: relative L2 {res['rel_l2']:.3e} "
        f"(limit 1e-5); int8 wire: gathered q equal on {res['q_equal_share']:.6f} of the "
        f"elements, scale*a_w equal {res['ws_equal']}, {res['bit_equal_share']:.6f} of the "
        f"decoded elements bit-equal, max |diff| {res['max_abs_diff']:.3e} where q differ "
        f"(one wire step {res['wire_step']:.3e})")
    if not res["ok"]:
        raise AssertionError(f"group (c) cross-check failed: {res}")
    log("group (c) ok")
    return res


def group_cross_check_rank(out_dir: str) -> int:
    """One rank of phase 11 (c), started by ``torch.distributed.run``."""
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import init_coded_group, remesh_for_m
    from repro_torch.train.engine import StepEngine

    world = init_coded_group("cuda")
    group = remesh_for_m(world, M)
    model, codec, outcome, params, batch = _cross_check_inputs(torch, group.device)
    res: dict = {}
    ok = True
    for name, kw in (("plain", {}), ("wire", dict(compress=True, wire_kernel=True))):
        eng = StepEngine(model, TrainConfig(), codec, backend="spmd", group=group, **kw)
        eng.wire_out = {}
        flat = _flat(torch, eng.gradients(params, batch, outcome))
        if group.rank == 0:
            emu = torch.load(Path(out_dir) / f"emulated_{'spmd' if name == 'plain' else 'wire_on'}.pt")
            ref = emu["decoded"].to(flat.device)
            if name == "plain":
                rel = float((flat.double() - ref.double()).norm() / ref.double().norm())
                res["rel_l2"] = rel
                ok = ok and rel <= 1e-5
            else:
                q, ws = eng.wire_out["q"], eng.wire_out["ws"]
                q_eq = (q == emu["q"].to(q.device)).all(0)
                ws_eq = bool(torch.equal(ws, emu["ws"].to(ws.device)))
                bits = flat.view(torch.int32) == ref.view(torch.int32)
                step = float(ws.abs().max())
                same_wire = q_eq if ws_eq else torch.zeros_like(q_eq)
                diff = (flat - ref).abs()
                off = diff[~same_wire]
                res.update(
                    q_equal_share=float(q_eq.float().mean()), ws_equal=ws_eq,
                    bit_equal_share=float(bits.float().mean()), wire_step=step,
                    max_abs_diff=float(off.max()) if off.numel() else 0.0,
                    bit_equal_where_wire_equal=bool(bits[same_wire].all()))
                ok = ok and res["bit_equal_where_wire_equal"] and res["max_abs_diff"] <= step
        del eng, flat
        torch.cuda.empty_cache()
    if group.rank == 0:
        res["ok"] = bool(ok)
        (Path(out_dir) / "cross_check.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def _fused_run(torch, arch: str, B: int, S: int, steps: int, remat: str | None = None,
               accum: int = 1, profile: bool = False, small_state: bool = False) -> dict:
    """Phase 12: ``make_fused_train_step`` on ``arch`` at full width, bf16,
    random weights from seed 0, a ones-weighted batch of B sequences of S
    random tokens from seed 1 (int32, as the dry run's stand-ins); the state
    bytes (params, optimizer state, batch) from ``memory_allocated`` before
    and after they are placed, the peak, each step's host-clock time (ending
    in a synchronize) and the kernels' launches over the steps.
    ``small_state``: the dry run's policy for a replicated model past 5e8
    parameters (bf16 moments, no f32 master).  ``profile`` runs one more
    step under ``torch.profiler``."""
    import gc

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adam import adamw_init
    from repro_torch.train.steps import make_fused_train_step

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, remat=remat or cfg.remat)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = (adamw_init(params, state_dtype=torch.bfloat16, keep_master=False) if small_state
           else adamw_init(params))
    tok = torch.randint(0, cfg.vocab, (B, S), device="cuda", dtype=torch.int32,
                        generator=torch.Generator(device="cuda").manual_seed(1))
    batch = {"tokens": tok, "labels": tok.clone(),
             "weight": torch.ones(B, dtype=torch.float32, device="cuda")}
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - base
    # the bytes asked for, before the allocator rounds each block up (a
    # large block keeps up to 1 MiB of its segment's tail)
    state_req = torch.cuda.memory_stats()["requested_bytes.all.current"] - base_req
    n_params = sum(p.numel() for p in params.values())
    step_fn = make_fused_train_step(model, TrainConfig(), accum_steps=accum)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, mets = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch, i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mets.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    label = f"{arch} B={B} S={S} remat={cfg.remat} accum={accum}"
    out = dict(label=label, n_params=n_params, state_bytes=state, state_requested=state_req,
               base_bytes=base,
               peak_gib=peak / 2**30, step_s=times, median_s=statistics.median(times[1:]),
               metrics=mets, launches=launches)
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in mets):
        raise AssertionError(f"{label}: non-finite loss or grad norm {mets}")
    log(f"fused step {label}: {n_params} parameters, state {state} B allocated "
        f"({state_req} B requested), peak {peak / 2**30:.2f} "
        f"GiB (held before: {base / 2**30:.3f} GiB), steps {[round(t, 4) for t in times]} s, "
        f"median of 1-{steps - 1} {out['median_s']:.4f} s, first loss {mets[0]['loss']:.6f} "
        f"grad_norm {mets[0]['grad_norm']:.6f}, launches {launches}")
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(params, opt, batch, steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups: dict[str, float] = {}
        top: list[tuple[float, int, str]] = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
                continue
            name = ev.key.lower()
            grp = ("ssd_scan" if "ssd_scan" in name else "matmul (cuBLAS)" if any(
                t in name for t in ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas"))
                else "other kernels")
            groups[grp] = groups.get(grp, 0.0) + ev.self_device_time_total / 1e3
            top.append((ev.self_device_time_total / 1e3, int(ev.count), ev.key[:80]))
        busy = sum(groups.values())
        top = sorted(top, reverse=True)[:6]
        out["profile"] = {"wall_ms": wall_ms, "busy_ms": busy, **groups, "largest": top}
        log(f"profile of one {label} step: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms"
            + (f" (idle share {1 - busy / wall_ms:.1%}); " if busy else " (not measured); ")
            + ", ".join(f"{g} {v:.1f} ms" for g, v in groups.items()))
        for ms, count, key in top:
            log(f"    {ms:9.2f} ms {count:6d}x {key}")
    del params, opt, batch, step_fn, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dry_subprocess(label: str, args: list[str]) -> str:
    """One dry-run tool in a process of its own (a fake process group is
    per process); its output logged, any failure the phase's."""
    import os

    cmd = [sys.executable, "-m", *args]
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=DRY_TIMEOUT_S)
    if proc.returncode != 0:
        for line in (proc.stdout + proc.stderr).splitlines()[-40:]:
            log("  ! " + line[:300])
        raise AssertionError(f"{label}: {' '.join(args)} exited {proc.returncode}")
    log(f"{label}: {' '.join(args)} done in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def large_model_path(torch) -> dict:
    """Phase 12: (a) llama3.2-1b's fused step at full width, seq 4096: B = 1
    with remat "none" and "full" (the same first loss and grad norm; both
    peaks, remat's below), B = 4 with remat and accumulation 1 and 2 (every
    step's loss to rtol 1e-3, the first grad norm to 1e-4, the later ones
    to 1e-3); (b) the dry run of the B = 4 cell on a one-rank
    mesh in a subprocess: its state bytes within 1 MiB of what the state
    asked the card's allocator for, its counted FLOPs over the measured step as achieved
    TFLOP/s and share of 989.4, t_compute over the step; (c) mamba2-370m's
    fused step with remat, ``ssd_scan`` twice a layer a step (the checkpoint
    recomputes the forward); (d) ``kernel_credit`` on JAX's cells, four
    processes at once, one row each of the dry run and of the credit."""
    import shutil

    shutil.rmtree(DRY_DIR, ignore_errors=True)
    DRY_DIR.mkdir(parents=True)
    # (d) first, in the background: the dry runs need the CPU, not the card
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    credit_procs = {
        cell: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.kernel_credit", "--cells", cell, "--out",
             str(DRY_DIR / f"{cell.replace(':', '__')}.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in DRY_CELLS}
    # phase 13 (d) in the same pool: the decode cells over a KV cache
    # sharded on the sequence, one dry-run process each
    decode_procs = {
        cell: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
             cell[1], "--mesh", cell[2], "--out", str(DRY_DIR / "decode")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in REPAIRED_CELLS}
    t_credit = time.perf_counter()
    out: dict = {}
    try:
        none1 = _fused_run(torch, LLAMA, 1, LLAMA_SEQ, LLAMA_STEPS, remat="none",
                           small_state=True)
        full1 = _fused_run(torch, LLAMA, 1, LLAMA_SEQ, LLAMA_STEPS, remat="full",
                           small_state=True)
        for r in (none1, full1):
            if r["n_params"] != LLAMA_PARAMS:
                raise AssertionError(f"{r['label']}: {r['n_params']} parameters")
        a, b = none1["metrics"][0], full1["metrics"][0]
        bit_equal = a == b
        for key in ("loss", "grad_norm"):
            if not math.isclose(a[key], b[key], rel_tol=1e-4):
                raise AssertionError(f"remat none vs full at B=1: {key} {a[key]} vs {b[key]}")
        if not full1["peak_gib"] < none1["peak_gib"]:
            raise AssertionError(f"remat's peak {full1['peak_gib']:.2f} GiB is not below "
                                 f"none's {none1['peak_gib']:.2f}")
        log(f"phase 12 (a) B=1: remat none vs full: loss {a['loss']!r} / {b['loss']!r}, grad "
            f"norm {a['grad_norm']!r} / {b['grad_norm']!r} (bit-equal: {bit_equal}); peak "
            f"{none1['peak_gib']:.2f} / {full1['peak_gib']:.2f} GiB; median step "
            f"{none1['median_s']:.4f} / {full1['median_s']:.4f} s")
        acc1 = _fused_run(torch, LLAMA, 4, LLAMA_SEQ, LLAMA_STEPS, accum=1, small_state=True,
                          profile=True)
        acc2 = _fused_run(torch, LLAMA, 4, LLAMA_SEQ, LLAMA_STEPS, accum=2, small_state=True)
        # step 0's loss is taken before any update, so only its grad norm
        # reads the accumulation (bf16 grads of the whole batch against f32
        # sums of two chunks': 7.4e-6 apart on an H100); lr(0) is
        # 0, so steps 2 and 3 are the first taken after accumulated updates
        for i, (m1, m2) in enumerate(zip(acc1["metrics"], acc2["metrics"])):
            for key, rtol in (("loss", 1e-3), ("grad_norm", 1e-4 if i == 0 else 1e-3)):
                if not math.isclose(m1[key], m2[key], rel_tol=rtol):
                    raise AssertionError(f"B=4 accumulation 1 vs 2, step {i}: {key} "
                                         f"{m1[key]} vs {m2[key]} (rtol {rtol})")
        log(f"phase 12 (a) B=4 remat: accum 1 vs 2 over {LLAMA_STEPS} steps: losses "
            f"{[m['loss'] for m in acc1['metrics']]} / {[m['loss'] for m in acc2['metrics']]} "
            f"(rtol 1e-3), grad norms {[m['grad_norm'] for m in acc1['metrics']]} / "
            f"{[m['grad_norm'] for m in acc2['metrics']]} (rtol 1e-4 at step 0, 1e-3 after); "
            f"peak {acc1['peak_gib']:.2f} / {acc2['peak_gib']:.2f} GiB; median step "
            f"{acc1['median_s']:.4f} / {acc2['median_s']:.4f} s")
        out["a"] = {"none_B1": none1, "full_B1": full1, "accum1_B4": acc1, "accum2_B4": acc2,
                    "remat_bit_equal": bit_equal}

        # (b) the same B = 4 cell, dry-run on a one-rank mesh
        _dry_subprocess("phase 12 (b)", [
            "repro_torch.launch.dryrun", "--arch", LLAMA, "--shape", "train_4k",
            "--mesh-shape", "1,1", "--global-batch", "2", "--variant", "dp_all",
            "--out", str(DRY_DIR / "one_rank")])
        row = json.loads(next((DRY_DIR / "one_rank").glob("*.json")).read_text())
        if row["coded_tokens"] != 4 * LLAMA_SEQ:
            raise AssertionError(f"dry run's batch is {row['coded_tokens']} tokens, not 4 x "
                                 f"{LLAMA_SEQ}")
        # held to the bytes the step's state asked the allocator for; what
        # it allocated is printed beside (each large block rounded up)
        diff = row["state_bytes_per_chip"] - acc1["state_requested"]
        if abs(diff) > MIB:
            raise AssertionError(f"state bytes predicted {row['state_bytes_per_chip']} vs "
                                 f"requested {acc1['state_requested']}: {diff} B apart")
        step = acc1["median_s"]
        achieved = row["flops_per_chip"] / step
        out["b"] = {"state_predicted": row["state_bytes_per_chip"],
                    "state_requested": acc1["state_requested"],
                    "state_allocated": acc1["state_bytes"], "diff_bytes": diff,
                    "flops": row["flops_per_chip"], "mm_flops_by_dtype": row["mm_flops_by_dtype"],
                    "bytes": row["bytes_per_chip"], "t_compute_s": row["t_compute_s"],
                    "t_memory_s": row["t_memory_s"], "bottleneck": row["bottleneck"],
                    "step_s": step, "achieved_tflops": achieved / 1e12,
                    "share_of_peak": achieved / BF16_FLOPS,
                    "t_compute_over_step": row["t_compute_s"] / step,
                    "t_memory_over_step": row["t_memory_s"] / step}
        log(f"phase 12 (b) dry run of {LLAMA} B=4 S={LLAMA_SEQ} on one rank: state "
            f"{row['state_bytes_per_chip']} B predicted, {acc1['state_requested']} B requested "
            f"({diff:+d} B), {acc1['state_bytes']} B allocated; {row['flops_per_chip']:.4e} FLOPs (matmuls by dtype "
            f"{row['mm_flops_by_dtype']}), {row['bytes_per_chip']:.4e} B; measured step "
            f"{step:.4f} s: {achieved / 1e12:.1f} TFLOP/s achieved, "
            f"{achieved / BF16_FLOPS:.1%} of 989.4; t_compute {row['t_compute_s']:.4f} s "
            f"({row['t_compute_s'] / step:.1%} of the step), t_memory {row['t_memory_s']:.4f} s, "
            f"bottleneck {row['bottleneck']}")

        # (c) mamba2 through the fused step with remat: the SSD kernel twice
        # a layer a step (forward, and the checkpoint's recompute)
        mr = _fused_run(torch, MAMBA, MAMBA_REMAT["B"], MAMBA_REMAT["S"], MAMBA_REMAT["steps"],
                        profile=True)
        want = MAMBA_REMAT["steps"] * 2 * MAMBA_LAYERS
        if mr["launches"]["ssd_scan"] != want:
            raise AssertionError(f"mamba2 remat: ssd_scan {mr['launches']['ssd_scan']} launches, "
                                 f"expected {want}")
        log(f"phase 12 (c) mamba2 fused step with remat: ssd_scan {want} launches in "
            f"{MAMBA_REMAT['steps']} steps (2 x {MAMBA_LAYERS} a step), peak "
            f"{mr['peak_gib']:.2f} GiB, median step {mr['median_s']:.4f} s")
        out["c"] = mr
    finally:
        # (d) the dry-run rows and the kernel credit of JAX's cells
        logs = {cell: p.communicate(timeout=DRY_TIMEOUT_S)[0]
                for cell, p in (*credit_procs.items(), *decode_procs.items())}
    log(f"phase 12 (d): kernel_credit on {len(DRY_CELLS)} cells, in parallel, "
        f"{time.perf_counter() - t_credit:.1f} s")
    rows = {}
    for cell, p in credit_procs.items():
        if p.returncode != 0:
            for line in logs[cell].splitlines()[-40:]:
                log("  ! " + line[:300])
            raise AssertionError(f"phase 12 (d): kernel_credit {cell} exited {p.returncode}")
        rec = json.loads((DRY_DIR / f"{cell.replace(':', '__')}.json").read_text())[0]
        r = rec["dryrun_row"]
        rows[cell] = {"state_bytes_per_chip": r["state_bytes_per_chip"],
                      "fits_h100_state": r["fits_h100_state"], "bottleneck": r["bottleneck"],
                      "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
                      "t_collective_s": r["t_collective_s"], "coll": r["coll_breakdown"],
                      "useful_ratio": r["useful_ratio"],
                      "score_share": rec["score_share"],
                      "t_memory_kernelized_s": rec["t_memory_kernelized_s"],
                      "step_time_kernelized_s": rec["step_time_kernelized_s"],
                      "mfu_kernelized": rec["mfu_kernelized"]}
        log(f"phase 12 (d) {cell}: " + json.dumps(rows[cell]))
    out["d"] = rows
    decode_rows = {}
    for cell, p in decode_procs.items():
        if p.returncode != 0:
            for line in logs[cell].splitlines()[-40:]:
                log("  ! " + line[:300])
            raise AssertionError(f"phase 13 (d): dry run {cell} exited {p.returncode}")
        r = json.loads((DRY_DIR / "decode" / f"{'__'.join(cell)}.json").read_text())
        if not r["coll_breakdown"].get("all-reduce", 0) > 0:
            raise AssertionError(f"phase 13 (d): {cell} counts no all-reduce for its softmax")
        decode_rows["|".join(cell)] = {
            k: r[k] for k in ("mesh", "state_bytes_per_chip", "fits_h100_state", "bottleneck",
                              "t_compute_s", "t_memory_s", "t_collective_s", "coll_breakdown",
                              "flops_per_chip", "bytes_per_chip", "compile_s")}
        log(f"phase 13 (d) dry run {' x '.join(cell)}: " + json.dumps(decode_rows["|".join(cell)]))
    out["decode_cells"] = decode_rows
    return out


# phase 13, the last modules: the engine's host pack at phase 1's shapes,
# the coded_reduce launch-shape tuner at smollm's wire, the ported examples,
# and the dry run's decode cells over a sequence-sharded KV cache
HOST_PACK = dict(part_mb=2, seq=64, steps=3)
EXAMPLES = ROOT / "examples" / "torch"
EXAMPLE_ENV = {"quickstart": {}, "train_coded": {"SMOKE": "1"}, "serve_lm": {},
               "elastic_restart": {}}
EXAMPLE_TIMEOUT_S = 420
REPAIRED_CELLS = (("chatglm3-6b", "decode_32k", "single"), ("mixtral-8x7b", "long_500k", "single"),
                  ("jamba-1.5-large-398b", "long_500k", "multi"))
# launch-shape checks off the main path's shapes: ragged D (the VEC = 1
# branch, and past every block cap's grid, so the grid-stride loop turns)
# and a base 4 bytes off 16-byte alignment
TUNE_CHECKS = (("f32 ragged", "float32", 5, 1_000_003, 0), ("f32 unaligned", "float32", 5,
               1 << 22, 1), ("bf16 ragged", "bfloat16", 4, 1_000_001, 0),
               ("int8 ragged", "int8", 4, 1_000_005, 0), ("int8 aligned", "int8", 4, 1 << 24, 0))


def host_pack_path(torch) -> dict:
    """Phase 13 (a): full-width smollm-360m through ``StepEngine`` on
    ``fused`` at phase 1's shapes (heter_aware, m 4, s 1, part_mb 2, seq 64),
    three steps with ``host_pack=True`` and three with the device pack from
    the same weights and batches, one straggler a step: the losses and grad
    norms equal at rtol 1e-6 (whether bit-equal is printed), the median
    ``phase.pack+upload`` against the device pack's ``phase.upload``, and
    each step's host-clock time (ending in a synchronize)."""
    import gc

    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.core.codec import Codec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim.adam import adamw_init
    from repro_torch.train.engine import StepEngine, TrainerState

    cfg = get_config(ARCH)
    model = build_model(cfg)
    codec = Codec.from_config(CodingConfig(scheme="heter_aware", s=S), m=M, rng=1)
    data = SyntheticData(cfg, k=codec.k, part_mb=HOST_PACK["part_mb"], seq_len=HOST_PACK["seq"])
    steps = HOST_PACK["steps"]
    batches = [data.batch(i) for i in range(steps)]
    outcomes = [codec.decode_outcome([w for w in range(M) if w != i % M]) for i in range(steps)]
    runs = {}
    for host_pack in (True, False):
        eng = StepEngine(model, TrainConfig(), codec, backend="fused", device="cuda",
                         host_pack=host_pack)
        eng.tracer = Tracer()
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        state = TrainerState(params=params, opt=adamw_init(params), step=0)
        times, mets = [], []
        for batch, outcome in zip(batches, outcomes):
            t0 = time.perf_counter()
            state, met = eng.step(state, batch, outcome)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({"loss": met["loss"], "grad_norm": met["grad_norm"]})
        name = "phase.pack+upload" if host_pack else "phase.upload"
        spans = eng.tracer.records(kind="span", name=name)
        if len(spans) != steps:
            raise AssertionError(f"host_pack={host_pack}: {len(spans)} {name} spans")
        fused = eng.tracer.records(kind="span", name="phase.fused")
        runs[host_pack] = {"metrics": mets, "step_s": times,
                           "upload_ms": [1e3 * (r["t1"] - r["t0"]) for r in spans],
                           "fused_ms": [1e3 * (r["t1"] - r["t0"]) for r in fused]}
        del eng, params, state
        gc.collect()
        torch.cuda.empty_cache()
    host, dev = runs[True], runs[False]
    for i, (a, b) in enumerate(zip(host["metrics"], dev["metrics"])):
        for key in ("loss", "grad_norm"):
            if not math.isclose(a[key], b[key], rel_tol=1e-6):
                raise AssertionError(f"host pack vs device pack, step {i}: {key} {a[key]!r} "
                                     f"vs {b[key]!r} (rtol 1e-6)")
    bit_equal = host["metrics"] == dev["metrics"]
    out = {"host_pack": host, "device_pack": dev, "bit_equal": bit_equal,
           "upload_median_ms": {"host": statistics.median(host["upload_ms"]),
                                "device": statistics.median(dev["upload_ms"])}}
    log(f"phase 13 (a) {ARCH} fused, host pack vs device pack over {steps} steps: losses "
        f"{[m['loss'] for m in host['metrics']]} / {[m['loss'] for m in dev['metrics']]}, grad "
        f"norms {[m['grad_norm'] for m in host['metrics']]} / "
        f"{[m['grad_norm'] for m in dev['metrics']]} (rtol 1e-6; bit-equal: {bit_equal}); "
        f"median phase.pack+upload {out['upload_median_ms']['host']:.3f} ms vs phase.upload "
        f"{out['upload_median_ms']['device']:.3f} ms; steps (s) "
        f"{[round(t, 4) for t in host['step_s']]} / {[round(t, 4) for t in dev['step_s']]}")
    return out


def tuner_path(torch, cr, n_slots: int) -> dict:
    """Phase 13 (b): ``ops.coded_reduce(impl="best")`` at smollm's wire,
    (n_slots, D) and (m, D) f32 and (m, D) int8 -> f32, D = 361,821,120,
    driven from a cold tuner with the counts at 0 (each first call probes
    ``best_launch``'s 12 shapes: 2 + 4 x 3 launches each).  At each: the
    pick bit-equal to the default launch (``torch.equal``), its time beside
    the default's (in turns), ``torch.mv``'s (f32) and the plain version's,
    and ``best_reduce_schedule``'s pick with its time.  Then every candidate
    shape held bit-equal to the default at ragged D, a misaligned base and
    int8, bf16 (TUNE_CHECKS)."""
    from repro_torch.kernels import autotune, ops

    dev = torch.device("cuda")
    shapes = ((n_slots, "float32", "encode (P = n_slots)"), (M, "float32", "decode (P = m)"),
              (M, "int8", "int8 wire decode (P = m)"))
    stacks = []
    for P, dt, label in shapes:
        gen = torch.Generator(device=dev).manual_seed(100 + P)
        if dt == "int8":
            g = torch.randint(-127, 128, (P, D_FULL), generator=gen, device=dev, dtype=torch.int8)
        else:
            g = torch.randn(P, D_FULL, generator=gen, device=dev)
        stacks.append((g, torch.randn(P, generator=gen, device=dev), label))
    cr.coded_reduce.launches = cr.coded_reduce.shaped_launches = 0
    outs = [ops.coded_reduce(g, w, impl="best", out_dtype=torch.float32) for g, w, _ in stacks]
    torch.cuda.synchronize()
    launches, shaped = cr.coded_reduce.launches, cr.coded_reduce.shaped_launches
    n_shapes = len(cr.THREADS) * len(cr.BLOCK_CAPS)
    want = len(stacks) * (n_shapes * (2 + 4 * 3) + 1)
    if not launches == shaped == want:
        raise AssertionError(f"impl='best': {launches} launches ({shaped} shaped), expected "
                             f"{want}: each shape's probe and its one launch")
    rows = []
    for (g, w, label), got in zip(stacks, outs):
        P, D = g.shape
        pick = autotune.best_launch(P, D, dev, g.dtype)
        default = cr.coded_reduce(g, w, torch.float32)
        if not torch.equal(got, default):
            raise AssertionError(f"{label}: impl='best' at {pick} is not bit-equal to the "
                                 f"default launch {cr.DEFAULT_LAUNCH}")
        ref = cr.coded_reduce_torch(g, w, torch.float32)
        err = float((got - ref).abs().max())
        if not err <= 1e-5 * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"{label}: kernel vs plain max_abs_err {err}")
        del ref, default
        out = torch.empty(D, device=dev)
        run_best = lambda: cr.coded_reduce(g, w, torch.float32, out=out, launch=pick)  # noqa: E731
        run_def = lambda: cr.coded_reduce(g, w, torch.float32, out=out)  # noqa: E731
        turns = [time_cuda(f) for f in (run_def, run_best, run_best, run_def)]
        def_ms, best_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = time_cuda(lambda: cr.coded_reduce_torch(g, w, torch.float32), reps=5,
                             warmup=1)
        lib_ms = (time_cuda(lambda: torch.mv(g.t(), w)) if g.dtype == torch.float32 else None)
        sched, sched_ms = None, None
        if g.dtype == torch.float32:
            sched = autotune.best_reduce_schedule(P, D, dev)
            sched_ms = time_cuda(lambda: autotune.library_reduce(g, w))
        nbytes = P * D * g.element_size() + D * 4
        bound_ms, bound_by = bound(nbytes, 2 * P * D)
        probe = autotune.PROBE_US[("launch", dev.index or 0, P, D, str(g.dtype))]
        row = dict(label=label, P=P, D=D, dtype=str(g.dtype).removeprefix("torch."),
                   pick=list(pick), default=list(cr.DEFAULT_LAUNCH), ms=best_ms,
                   default_ms=def_ms, turns_ms=turns, plain_ms=plain_ms, library_ms=lib_ms,
                   schedule=sched, schedule_ms=sched_ms, bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=err, probe_us=probe)
        rows.append(row)
        log(f"phase 13 (b) coded_reduce impl='best' {label} {row['dtype']} P={P} D={D}: pick "
            f"{pick} (default {cr.DEFAULT_LAUNCH}), bit-equal to the default; {best_ms:.4f} ms "
            f"vs default {def_ms:.4f} ms (turns {[round(t, 4) for t in turns]}), bound "
            f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / best_ms:.1%} of it), plain "
            f"{plain_ms:.4f} ms, torch.mv {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            + (f"best_reduce_schedule {sched} {sched_ms:.4f} ms (probe us "
               f"{autotune.PROBE_US[('reduce_schedule', 'cuda', dev.index or 0, P, D)]}); "
               if sched else "no library schedule for int8; ")
            + "launch probe us " + ", ".join(f"{k} {v:.1f}" for k, v in probe.items()))
        del out
    del stacks, outs
    torch.cuda.empty_cache()
    checks = 0
    for label, dt, P, D, offset in TUNE_CHECKS:
        gen = torch.Generator(device=dev).manual_seed(D)
        dtype = getattr(torch, dt)
        n = P * D + offset
        if dtype == torch.int8:
            buf = torch.randint(-127, 128, (n,), generator=gen, device=dev, dtype=dtype)
        else:
            buf = torch.randn(n, generator=gen, device=dev).to(dtype)
        g = buf[offset:].view(P, D)
        w = torch.randn(P, generator=gen, device=dev)
        want_out = cr.coded_reduce(g, w, torch.float32)
        for threads in cr.THREADS:
            for blocks in cr.BLOCK_CAPS:
                got = cr.coded_reduce(g, w, torch.float32, launch=(blocks, threads))
                if not torch.equal(got, want_out):
                    raise AssertionError(f"{label} P={P} D={D}: launch ({blocks}, {threads}) "
                                         "is not bit-equal to the default")
                checks += 1
        torch.cuda.synchronize()
        log(f"phase 13 (b) {label} {dt} P={P} D={D} base +{offset * buf.element_size()} B: all "
            f"{n_shapes} launch shapes bit-equal to the default")
        del buf, g, want_out
    return {"rows": rows, "launches": launches, "checks_bit_equal": checks}


def examples_path(torch) -> dict:
    """Phase 13 (c): the four ``examples/torch/*.py`` on the card, each in a
    process of its own, all started together; each must exit 0 (their own
    checks assert), its wall time printed."""
    import os
    import shutil

    shutil.rmtree(ROOT / "build" / "examples", ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(EXAMPLES / f"{name}.py")], cwd=ROOT,
                                    env={**env, **extra}, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, extra in EXAMPLE_ENV.items()}
    out, failed = {}, []
    try:
        for name, proc in procs.items():
            text = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)[0]
            out[name] = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                         "tail": text.strip().splitlines()[-3:]}
            if proc.returncode != 0:
                failed.append(name)
                for line in text.splitlines()[-40:]:
                    log("  ! " + line[:300])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, rec in out.items():
        log(f"phase 13 (c) examples/torch/{name}.py: exit {rec['rc']}, done {rec['wall_s']:.1f} s "
            f"after the start; last lines {rec['tail']}")
    if failed:
        raise AssertionError(f"phase 13 (c): {failed} failed on the card")
    shutil.rmtree(ROOT / "build" / "examples", ignore_errors=True)
    return out


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
        f"{torch.cuda.device_count()} device(s), total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B (the dry run's CARD_BYTES)")
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
    tssd_bwd = time_ssd_bwd(torch)
    tflash = time_flash(torch)
    auto = autotune.wire_kernel_default("cuda")
    probe = next(v for k, v in autotune.PROBE_US.items() if k[0] == "wire_kernel")
    log(f"wire_kernel_default on this card: {auto} (probe at f32 (8, 65536): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in probe.items()) + ")")

    # 5. the main paths, 6. the f32 cross-checks
    plain_launches = lambda n: {  # noqa: E731
        "coded_reduce": n * (M + 1), "coded_encode_int8": 0, "coded_decode_int8": 0,
        "ssd_scan": 0, "flash_attention": 0, **NO_TRAIN}
    # smollm's steps: m * n_slots gradients and one loss forward each
    smollm_launches = lambda n: {  # noqa: E731
        **plain_launches(n), **smollm_train(n * M * n_slots, n)}
    wire_launches = lambda n: {  # noqa: E731
        "coded_reduce": n, "coded_encode_int8": n * M, "coded_decode_int8": n, "ssd_scan": 0,
        "flash_attention": 0, **smollm_train(n * M * n_slots, n)}
    # a step's forward passes: two per worker slot (m * n_slots gradients,
    # each forward run again by remat's recompute) and one more for the
    # step's loss at the decoded weights (no grad: no remat)
    passes = 2 * M * n_slots + 1
    mamba_launches = lambda n: {  # noqa: E731
        "coded_reduce": n * (M + 1), "coded_encode_int8": 0, "coded_decode_int8": 0,
        "ssd_scan": n * passes * MAMBA_LAYERS, "flash_attention": 0, **NO_TRAIN,
        "ssd_scan_bwd": n * M * n_slots * MAMBA_LAYERS}
    run = main_path(torch, "spmd", SLICE_ARGS, smollm_launches)
    wire_run = main_path(torch, "spmd --compress", WIRE_ARGS, wire_launches,
                         on_step=check_err_after_step(torch))
    import shutil

    shutil.rmtree(GROUP_DIR, ignore_errors=True)
    GROUP_DIR.mkdir(parents=True)
    xc = cross_check(torch, ARCH, seq_len=64, part_mb=2, wire=True, save=GROUP_DIR)
    log(f"mamba2 main path: {passes} forward passes a step (m * n_slots = {M * n_slots} "
        f"gradients, each recomputed under remat, + 1 loss), so ssd_scan "
        f"{passes * MAMBA_LAYERS} launches a step")
    # unprofiled: the profiled mamba2 step is phase 12 (c)'s fused step (a
    # profiled trainer step here cost 163 s of the time limit)
    mamba_run = main_path(torch, "mamba2 spmd", MAMBA_ARGS, mamba_launches,
                          n_params_want=D_MAMBA)
    # seq 512 in micro-batches of 1: two chunks, so the carried state runs
    mxc = {**cross_check(torch, MAMBA, seq_len=MAMBA_SEQ, part_mb=1, wire=False),
           **mamba_kernel_check(torch)}

    # 7. serving at full width, 8. its f32 cross-checks
    serve = {}
    for arch in (ARCH, MAMBA):
        serve[arch] = serve_path(torch, arch)
        serve[arch]["cross_check"] = serve_cross_check(torch, arch, serve[arch])
        del serve[arch]["gen_tokens"], serve[arch]["batch"]

    # 9. the fault-tolerant trainer
    faults = fault_path(torch)

    # 10. the model families: (a)-(c) full-width serving, (d) the reduced
    # jamba, (e) hubert-xlarge's coded training, (f) the f32 checks
    fam = {}
    for arch, gen in FAMILY_GEN.items():
        fam[arch] = serve_path(torch, arch, gen, engine=False)
        fam[arch]["cross_check"] = serve_cross_check(torch, arch, fam[arch], f32=False)
        del fam[arch]["gen_tokens"], fam[arch]["batch"]
    jamba = jamba_path(torch, plain_launches)
    hubert = main_path(torch, "hubert-xlarge spmd", HUBERT_ARGS, plain_launches,
                       n_params_want=FAMILY_PARAMS["hubert-xlarge"])
    # coded_reduce at hubert's wire, past 2^31 elements a stack, held to
    # its plain version as at smollm's
    hubert_reduce = [time_kernel(torch, cr, P, FAMILY_PARAMS["hubert-xlarge"], f"hubert {label}")
                     for P, label in ((n_slots, "encode (P = n_slots)"), (M, "decode (P = m)"))]
    fam_f32 = {arch: reduced_f32_check(torch, arch)
               for arch in ("moonshot-v1-16b-a3b", "mixtral-8x7b", "internvl2-2b", JAMBA)}

    # 11. the spmd backend across processes: M ranks on the card over gloo
    group = group_path(torch, faults)

    # 12. the large-model training levers: remat, accumulation, the dry
    # run (its pool also runs 13 (d), the sharded-KV decode cells)
    large = large_model_path(torch)

    # 13. the last modules: (b) the launch-shape tuner alone on the card,
    # (a) the host pack, (c) the examples
    t13 = time.perf_counter()
    tuned = tuner_path(torch, cr, n_slots)
    hpack = host_pack_path(torch)
    examples = examples_path(torch)
    log(f"phase 13 (a)-(c) took {time.perf_counter() - t13:.1f} s")
    best = tuned["rows"][0]

    # the kernels line, then the card
    kernels = [{
        "name": "coded_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce.py:150",
        "launches": run["launches"]["coded_reduce"],
        "max_abs_err": max(t["max_abs_err"] for t in (enc, dec, *hubert_reduce)),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "shape": f"f32 ({enc['P']}, {enc['D']}) -> ({enc['D']},), the per-worker encode",
        "decode": {k: dec[k] for k in ("P", "D", "ms", "plain_ms", "bound_ms", "library_ms",
                                        "max_abs_err")},
        "launches_compressed_path": wire_run["launches"]["coded_reduce"],
        "launches_fault_path": faults["launches"]["coded_reduce"],
        "launches_resume": faults["resume_launches"]["coded_reduce"],
        "launches_hubert": hubert["launches"]["coded_reduce"],
        "launches_group_rank0": group["main"]["launches"]["coded_reduce"],
        "hubert_shapes": [{k: t[k] for k in ("P", "D", "ms", "plain_ms", "bound_ms",
                                             "library_ms", "max_abs_err")}
                          for t in hubert_reduce],
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
        "launches_group_faults": {r: la["coded_encode_int8"]
                                  for r, la in group["faults"]["launches"].items()},
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
        "launches_group_faults": {r: la["coded_decode_int8"]
                                  for r, la in group["faults"]["launches"].items()},
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
        "launches_jamba": {"generate": jamba["launches"]["ssd_scan"],
                           "fused_step": jamba["fused_step"]["launches"]["ssd_scan"]},
        "checks": ssd_check,
        "backward": dict(tssd_bwd, launches=mamba_run["launches"]["ssd_scan_bwd"],
                         route="wgmma, five launches a call (chunk, state, dx, dB/dC, "
                               "reduce passes), bf16 B/C; f32 B/C the plain backward"),
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": sum(serve[ARCH][k]["launches"]["flash_attention"]
                        for k in ("generate", "engine")),
        "launches_serving": {k: serve[ARCH][k]["launches"]["flash_attention"]
                             for k in ("generate", "engine")},
        "launches_families": {**{a: fam[a]["generate"]["launches"]["flash_attention"]
                                 for a in fam},
                              JAMBA: jamba["launches"]["flash_attention"]},
        "max_abs_err": max(*(t["max_abs_err"]
                             for t in tflash["shapes"] + tflash["family_shapes"]),
                           flash_check["worst_small"], *flash_check["full"].values()),
        "ms": tflash["ms"], "plain_ms": tflash["plain_ms"], "bound_ms": tflash["bound_ms"],
        "bound_by": tflash["bound_by"], "library_ms": tflash["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "shape": f"q ({tflash['B']}, {tflash['S']}, {tflash['H']}, {tflash['hd']}) bf16, k/v "
                 f"({tflash['B']}, {tflash['S']}, {tflash['K']}, {tflash['hd']}) bf16, causal",
        "shapes": [{k: t[k] for k in ("B", "S", "ms", "library_ms", "plain_ms", "bound_ms",
                                      "turns_ms", "single_launch_ms", "library_single_launch_ms",
                                      "max_abs_err")} for t in tflash["shapes"]]
        + [{k: t[k] for k in ("B", "S", "H", "K", "hd", "window", "ms", "library_ms", "plain_ms",
                              "bound_ms", "bound_by", "turns_ms", "max_abs_err")}
           for t in tflash["family_shapes"]],
        "route_by_dtype": {"bf16": "wgmma fed by TMA, P.V split bf16 hi + lo",
                           "f32": "f32 FMAs on the CUDA cores"},
        "hgmma_instructions": hgmma,
        "checks": flash_check,
    }, {
        "name": "flash_attention_train",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "none: the JAX trainer differentiates its plain attention "
                    "(src/repro/models/attention.py:62)",
        "launches": run["launches"]["flash_attention_train_fwd"],
        "launches_bwd": run["launches"]["flash_attention_train_bwd"],
        "launches_compressed_path": {k: wire_run["launches"][k] for k in
                                     ("flash_attention_train_fwd", "flash_attention_train_bwd")},
        "max_rel_err": max(e["to_plain"] for t in [tflash["train"], *tflash["train_family"]]
                           for e in t["rel_err"].values()),
        "rel_err_limit": FLASH_TRAIN_TOL,
        **{key: tflash["train"][key] for key in (
            "ms", "fwd_ms", "bwd_ms", "plain_ms", "plain_fwd_ms", "plain_bwd_ms", "bound_ms",
            "fwd_bound_ms", "bwd_bound_ms", "library_ms", "library_fwd_ms", "library_bwd_ms")},
        "ms_is": "forward + backward, beside library_ms, plain_ms and bound_ms of the same",
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True), forward + backward",
        "shape": "q ({0}, {1}, {2}, {4}) bf16 scaled, k/v ({0}, {1}, {3}, {4}) bf16, "
                 "causal".format(*FLASH_TRAIN),
        "timing": tflash["train"],
        "family_shapes": [{k: t[k] for k in ("B", "S", "H", "K", "hd", "window", "ms", "fwd_ms",
                                             "bwd_ms", "plain_ms", "bound_ms", "rel_err")}
                          for t in tflash["train_family"]],
    }, {
        "name": "coded_reduce_best",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce.py:150",
        "launches": tuned["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in tuned["rows"]),
        "ms": best["ms"], "plain_ms": best["plain_ms"], "bound_ms": best["bound_ms"],
        "bound_by": best["bound_by"], "library_ms": best["library_ms"],
        "shape": f"ops.coded_reduce(impl='best'): f32 ({best['P']}, {best['D']}) -> "
                 f"({best['D']},) at best_launch's {tuple(best['pick'])}, default "
                 f"{tuple(best['default'])} {best['default_ms']:.4f} ms",
        "launches_note": "the first call at each of the 3 shapes probes best_launch's 12 "
                         "launch shapes (14 launches each), then launches once",
        "shapes": [{k: r[k] for k in ("label", "P", "D", "dtype", "pick", "ms", "default_ms",
                                      "plain_ms", "library_ms", "schedule", "schedule_ms",
                                      "bound_ms", "max_abs_err")} for r in tuned["rows"]],
        "checks_bit_equal": tuned["checks_bit_equal"],
    }]
    log(f"summary: spmd step {run['step_s']:.4f} s (median), peak {run['peak_gib']:.2f} GiB, "
        f"losses {run['losses']}; spmd --compress step {wire_run['step_s']:.4f} s, "
        f"peak {wire_run['peak_gib']:.2f} GiB, losses {wire_run['losses']}; cross-check {xc}")
    log(f"summary: mamba2 spmd step {mamba_run['step_s']:.4f} s (median), peak "
        f"{mamba_run['peak_gib']:.2f} GiB, losses {mamba_run['losses']}, launches "
        f"{mamba_run['launches']}; cross-check {mxc}")
    for arch in (ARCH, MAMBA):
        log(f"summary: serve {arch} {json.dumps(serve[arch], default=str)}")
    log(f"summary: fault path {json.dumps(faults, default=str)}")
    for arch, res in {**fam, JAMBA: jamba}.items():
        log(f"summary: family {arch} {json.dumps(res, default=str)}")
    log(f"summary: hubert-xlarge spmd step {hubert['step_s']:.4f} s (median), peak "
        f"{hubert['peak_gib']:.2f} GiB, losses {hubert['losses']}, launches {hubert['launches']}")
    log(f"summary: family f32 checks {json.dumps(fam_f32, default=str)}")
    log(f"summary: group {json.dumps(group, default=str)}")
    log(f"summary: large-model levers {json.dumps(large, default=str)}")
    log(f"summary: last modules {json.dumps({'tuner': tuned, 'host_pack': hpack, 'examples': examples}, default=str)}")
    log(f"summary: chip_smoke took {time.perf_counter() - _T0:.1f} s to its summary")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--group-cross-check"]:
        sys.exit(group_cross_check_rank(sys.argv[2]))
    sys.exit(main())
