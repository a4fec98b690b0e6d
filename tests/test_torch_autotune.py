"""The port's ``kernels/autotune.py`` and ``ops.coded_reduce(impl="best")``
against the JAX package's, on the CPU.

- ``ops.coded_reduce(g, w, impl="best")`` equals JAX's
  ``ops.coded_reduce(..., impl="best")`` (its autotuned XLA schedule off a
  TPU) at P = 8, D = 5000, at the tolerance of tests/test_kernels.py's
  ``impl="best"`` check (rtol 1e-5, atol 1e-4), and equals the plain
  version at the same tolerance for f32, bf16 and int8 stacks.
- Every schedule of ``SCHEDULES`` (``unroll`` included) equals
  ``coded_reduce_torch``; ``best_reduce_schedule`` probes ``unroll`` only
  at P <= 64, caches per (device, P, D) with the probe's timings in
  ``PROBE_US`` (a second call adds no entry), and records an ``autotune``
  instant on the installed tracer.
- ``interleaved_best_us`` times a CPU candidate by the host clock.
- ``best_launch`` on a CPU device returns None at once, with no probe;
  ``wire_kernel_default`` answers False there.
- ``impl="best"`` is ``coded_reduce``'s only: the other ops reject it.
- The kernel wrapper refuses a launch shape it has no instantiation for.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.coded_reduce import (
    BLOCK_CAPS,
    DEFAULT_LAUNCH,
    THREADS,
    coded_reduce,
    coded_reduce_torch,
)
from repro_torch.obs.trace import Tracer, set_tracer

torch.set_num_threads(2)


def _stack(P, D, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(P, D)).astype(np.float32), r.normal(size=(P,)).astype(np.float32)


def test_best_equals_jax_best():
    g, w = _stack(8, 5000)
    got = ops.coded_reduce(torch.from_numpy(g), torch.from_numpy(w), impl="best")
    want = np.asarray(jops.coded_reduce(jnp.asarray(g), jnp.asarray(w), impl="best"))
    assert got.dtype == torch.float32 and got.shape == (5000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_best_equals_plain_version(dtype):
    g, w = _stack(5, 3001, seed=1)
    gt = torch.from_numpy(g)
    gt = (gt * 40).round().clamp(-127, 127).to(torch.int8) if dtype == "int8" \
        else gt.to(getattr(torch, dtype))
    wt = torch.from_numpy(w)
    out = torch.float32
    got = ops.coded_reduce(gt, wt, impl="best", out_dtype=out)
    want = coded_reduce_torch(gt, wt, out)
    assert got.dtype == out
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # the default out dtype is the stack's, as JAX's xla_reduce casts to g.dtype
    if dtype != "int8":
        assert ops.coded_reduce(gt, wt, impl="best").dtype == gt.dtype


@pytest.mark.parametrize("P", [1, 5, 64, 65])
def test_every_schedule_equals_the_plain_version(P):
    g, w = _stack(P, 777, seed=P)
    gt, wt = torch.from_numpy(g), torch.from_numpy(w)
    want = coded_reduce_torch(gt, wt)
    for name, fn in autotune.SCHEDULES.items():
        torch.testing.assert_close(fn(wt, gt), want, rtol=1e-5, atol=1e-4, msg=name)
    choice = autotune.best_reduce_schedule(P, 777, "cpu")
    probe = autotune.PROBE_US[("reduce_schedule", "cpu", None, P, 777)]
    assert set(probe) == set(autotune.SCHEDULES) - ({"unroll"} if P > 64 else set())
    assert choice == min(probe, key=probe.get)
    torch.testing.assert_close(autotune.library_reduce(gt, wt), want, rtol=1e-5, atol=1e-4)


def test_reduce_schedule_is_cached_per_shape():
    shape = (3, 4099)
    autotune.best_reduce_schedule(*shape, "cpu")
    n = len(autotune.PROBE_US)
    first = autotune.PROBE_US[("reduce_schedule", "cpu", None, *shape)]
    for _ in range(3):
        autotune.best_reduce_schedule(*shape, "cpu")
        ops.coded_reduce(torch.ones(shape), torch.ones(shape[0]), impl="best")
    assert len(autotune.PROBE_US) == n
    assert autotune.PROBE_US[("reduce_schedule", "cpu", None, *shape)] is first
    autotune.best_reduce_schedule(3, 4100, "cpu")
    assert len(autotune.PROBE_US) == n + 1


def test_probe_records_an_autotune_instant():
    tracer = Tracer()
    set_tracer(tracer)
    try:
        choice = autotune.best_reduce_schedule(7, 1234, "cpu")
    finally:
        set_tracer(None)
    rec = tracer.records(kind="instant", name="autotune")
    assert len(rec) == 1
    assert rec[0]["args"]["question"] == "reduce_schedule P=7 D=1234"
    assert rec[0]["args"]["choice"] == choice
    assert {f"us_{k}" for k in autotune.SCHEDULES} <= set(rec[0]["args"])


def test_interleaved_best_us_times_a_cpu_candidate_by_the_host_clock():
    def slow():
        time.sleep(0.002)
        return torch.zeros(1)

    times = autotune.interleaved_best_us({"slow": slow, "fast": lambda: torch.zeros(1)},
                                        rounds=2, iters=2, warmup=1)
    assert times["slow"] >= 1900.0
    assert times["fast"] < times["slow"]


def test_best_launch_on_a_cpu_device_is_none_at_once():
    n = len(autotune.PROBE_US)
    t0 = time.perf_counter()
    assert autotune.best_launch(5, 361_821_120, "cpu") is None
    assert autotune.best_launch(4, 1 << 20, torch.device("cpu"), torch.int8) is None
    assert time.perf_counter() - t0 < 0.05
    assert len(autotune.PROBE_US) == n
    assert autotune.wire_kernel_default("cpu") is False


def test_launch_candidates_hold_the_default():
    assert DEFAULT_LAUNCH == (132 * 16, 256)
    assert DEFAULT_LAUNCH[1] in THREADS and DEFAULT_LAUNCH[0] in BLOCK_CAPS
    assert len(THREADS) * len(BLOCK_CAPS) == 12


@pytest.mark.parametrize("launch", [(2112, 64), (2112, 1024), (0, 256), (2112,)])
def test_kernel_wrapper_refuses_a_launch_it_has_no_instantiation_for(launch):
    with pytest.raises(ValueError, match="launch must be"):
        coded_reduce(torch.ones(2, 8), torch.ones(2), launch=launch)


@pytest.mark.parametrize("op", ["coded_encode_int8", "coded_decode_int8", "flash_attention",
                                "ssd_scan"])
def test_best_is_coded_reduce_only(op):
    x = torch.zeros(1, 4, 2, 8)
    args = {
        "coded_encode_int8": (torch.zeros(2, 8), torch.ones(2), torch.zeros(8)),
        "coded_decode_int8": (torch.zeros(2, 8, dtype=torch.int8), torch.ones(2)),
        "flash_attention": (x, x, x),
        "ssd_scan": (x, torch.zeros(1, 4, 2), torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8)),
    }[op]
    with pytest.raises(ValueError, match="coded_reduce's only"):
        getattr(ops, op)(*args, impl="best")
