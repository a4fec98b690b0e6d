"""The port's CUDA kernels against their plain PyTorch versions and the
wire format's bit oracle, on the card: coded_reduce, the int8 wire encode
and decode, the SSD scan (with its autograd Function), flash attention
(prefill's forward, and training's forward and backward under autograd);
and a reduced serving run whose prefill launches the kernels; every
launch shape of coded_reduce and ``impl="best"``'s tuned one bit-equal to
the default launch; the model's device regions (CUDA events placed on the
host clock); and two ``torch.distributed`` ranks sharing the card over
gloo, whose decoded
gradient is held to the single-process spmd path's (the ranks are
subprocesses of this file: ``python tests/test_torch_gpu.py OUT_DIR``).

Marked ``gpu``: they skip with a reason where no CUDA card is present.  On
the H100 run them with ``python -m pytest -m gpu tests/test_torch_gpu.py``
(this file imports neither ``jax`` nor the JAX package, so it runs where
only the port's dependencies are installed).
"""

import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, wire
from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_torch


def _np(x):
    return x.float().cpu().numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100 with: python -m pytest -m gpu tests/")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 5, 130])
@pytest.mark.parametrize("D", [1, 4095, 1_000_003, 4096])
@pytest.mark.parametrize("case", ["f32", "bf16", "bf16->f32", "int8->f32"])
def test_cuda_kernel_matches_plain(cuda_device, P, D, case):
    r = np.random.default_rng(P * 7 + D)
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32)).to(cuda_device)
    if case == "int8->f32":
        g = torch.from_numpy(r.integers(-127, 128, size=(P, D)).astype(np.int8))
        out_dtype, tol = torch.float32, 1e-5
    else:
        g = torch.from_numpy(r.normal(size=(P, D)).astype(np.float32))
        g = g.to(torch.float32 if case == "f32" else torch.bfloat16)
        out_dtype = torch.bfloat16 if case == "bf16" else torch.float32
        tol = 5e-2 if case == "bf16" else 1e-5
    g = g.to(cuda_device)
    before = coded_reduce.launches
    out = coded_reduce(g, w, out_dtype)
    torch.cuda.synchronize()
    assert coded_reduce.launches == before + 1
    expect = coded_reduce_torch(g, w, out_dtype)
    scale = max(1.0, float(expect.float().abs().max()))
    np.testing.assert_allclose(_np(out.cpu()), _np(expect.cpu()), atol=tol * scale, rtol=tol)


@pytest.mark.gpu
def test_cuda_nan_weight_poisons(cuda_device):
    g = torch.ones(3, 4096, device=cuda_device)
    w = torch.tensor([0.0, float("nan"), 1.0], device=cuda_device)
    assert torch.isnan(coded_reduce(g, w)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32", "bf16->f32", "int8->f32"])
@pytest.mark.parametrize("D,offset", [(1_000_003, 0), (1 << 20, 0), (1 << 20, 1), (77, 0)])
def test_cuda_every_launch_shape_bit_equal_to_the_default(cuda_device, case, D, offset):
    """The launch shape moves no value: each column is summed by one thread
    in row order, so every (max_blocks, threads) gives the default's bits,
    also where the block cap makes the grid-stride loop turn (ragged D,
    VEC = 1), at a base 4 bytes off 16-byte alignment and at a tiny D."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels.coded_reduce import BLOCK_CAPS, THREADS

    P = 5
    r = np.random.default_rng(D + offset)
    if case == "int8->f32":
        buf = torch.from_numpy(r.integers(-127, 128, size=(P * D + offset,)).astype(np.int8))
    else:
        buf = torch.from_numpy(r.normal(size=(P * D + offset,)).astype(np.float32))
        buf = buf.to(torch.float32 if case == "f32" else torch.bfloat16)
    g = buf.to(cuda_device)[offset:].view(P, D)
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32)).to(cuda_device)
    want = coded_reduce(g, w, torch.float32)
    for threads in THREADS:
        for blocks in BLOCK_CAPS:
            got = coded_reduce(g, w, torch.float32, launch=(blocks, threads))
            assert torch.equal(got, want), (blocks, threads)
    before = (coded_reduce.launches, coded_reduce.shaped_launches)
    got = ops.coded_reduce(g, w, impl="best", out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    pick = autotune.best_launch(P, D, cuda_device, g.dtype)
    assert pick[1] in THREADS and pick[0] in BLOCK_CAPS
    assert coded_reduce.shaped_launches > before[1]
    assert coded_reduce.launches - before[0] == coded_reduce.shaped_launches - before[1]


@pytest.mark.gpu
def test_cuda_best_reduce_schedule_probes_the_card(cuda_device):
    from repro_torch.kernels import autotune

    choice = autotune.best_reduce_schedule(6, 1 << 16, cuda_device)
    key = ("reduce_schedule", "cuda", torch.cuda.current_device(), 6, 1 << 16)
    assert choice in autotune.PROBE_US[key] and set(autotune.PROBE_US[key]) == set(
        autotune.SCHEDULES)
    g = torch.randn(6, 1 << 16, device=cuda_device)
    w = torch.randn(6, device=cuda_device)
    torch.testing.assert_close(autotune.library_reduce(g, w), coded_reduce_torch(g, w),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_cuda_device_regions_land_in_their_step(cuda_device):
    """The model's device regions on the card under full remat: CUDA events
    anchored at the step's closing synchronize, placed on the host clock, every region
    in each of its passes, inside its step, one at a time (one stream), the
    backward in reverse layer order; the losses equal an untraced run's."""
    import dataclasses

    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model
    from repro_torch.obs import Tracer
    from repro_torch.train.trainer import CodedTrainer

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), remat="full")
    losses, params = {}, {}
    for traced in (False, True):
        tracer = Tracer() if traced else None
        tr = CodedTrainer(build_model(cfg), CodingConfig(scheme="heter_aware", s=1),
                          TrainConfig(), m=4, part_mb=2, device=cuda_device, trace=tracer)
        data = SyntheticData(cfg, k=tr.k, part_mb=2, seq_len=64, seed=0)
        state, losses[traced] = tr.init_state(0), []
        for i in range(2):
            state, met = tr.step(state, data.batch(i))
            losses[traced].append(met["loss"])
        params[traced] = state.params
    assert losses[True] == losses[False]
    for k, v in params[True].items():
        torch.testing.assert_close(v, params[False][k], rtol=1e-5, atol=1e-6)
    spans = tracer.records("span")
    steps = {r["args"]["step"]: r for r in spans if r["name"] == "step"}
    dev = [r for r in spans if r["name"].startswith("device.")]
    assert {r["tid"] for r in dev} == {2}
    for step, outer in steps.items():
        mine = sorted((r for r in dev if r["args"]["step"] == step), key=lambda r: r["t0"])
        passes = {(r["name"], r["args"]["pass"], r["args"].get("layer")) for r in mine}
        assert len(mine) == len(passes) == 4 + 2 * 3 * cfg.n_layers
        # the anchor's wake-up: a region may end a few microseconds after the clock read
        assert all(outer["t0"] <= r["t0"] <= r["t1"] <= outer["t1"] + 1e-3 for r in mine)
        assert all(a["t1"] <= b["t0"] + 1e-6 for a, b in zip(mine, mine[1:]))
        bwd = [r["args"]["layer"] for r in mine
               if r["name"] == "device.mixer" and r["args"]["pass"] == "bwd"]
        assert bwd == sorted(bwd, reverse=True) and len(bwd) == cfg.n_layers


def _poison_inputs(case, D, dev):
    r = np.random.default_rng(D)
    if case == "int8->f32":
        g = torch.from_numpy(r.integers(-127, 128, size=(4, D)).astype(np.int8))
    else:
        g = torch.from_numpy(r.normal(size=(4, D)).astype(np.float32))
        g = g.to(torch.bfloat16 if case == "bf16->f32" else torch.float32)
    g[2] = 0  # the poisoned row is all zeros: 0 * NaN must still be NaN
    return g.to(dev)


def _decode(case, g, w):
    if case == "int8->f32":  # the trainer's int8 decode: ws = a * scale
        return wire.coded_decode_int8(g, w)
    return coded_reduce(g, w, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [4096, 4095, 1 << 20])
@pytest.mark.parametrize("case", ["f32", "bf16->f32", "int8->f32"])
def test_cuda_poisoned_decode_coefficient_gives_nan_everywhere_it_multiplies(cuda_device, case, D):
    """The trainer's poisoned-payload contract on the decode kernels: a NaN
    coefficient beside a zero one gives NaN in every output (it multiplies
    every column), the same weights with the NaN zeroed give none."""
    g = _poison_inputs(case, D, cuda_device)
    w = torch.tensor([0.5, 0.0, float("nan"), -1.0], device=cuda_device)
    assert torch.isnan(_decode(case, g, w)).all()
    w[2] = 0.0
    assert torch.isfinite(_decode(case, g, w)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32", "bf16->f32"])
def test_cuda_nan_payload_poisons_exactly_its_column(cuda_device, case):
    """A NaN in one coded value reaches exactly its output column, also
    where its row's weight is zero (rows are multiplied in, never skipped)."""
    D = 4099
    g = _poison_inputs(case, D, cuda_device)
    g[1, 1234] = float("nan")
    w = torch.tensor([0.5, 0.0, 2.0, -1.0], device=cuda_device)
    bad = torch.isnan(coded_reduce(g, w, torch.float32)).nonzero().flatten().tolist()
    assert bad == [1234]


@pytest.mark.gpu
@pytest.mark.parametrize("backend,compress", [("fused", False), ("spmd", False), ("spmd", True)],
                         ids=["fused", "spmd", "spmd-compress"])
def test_cuda_poisoned_engine_step_leaves_state_bit_unchanged(cuda_device, backend, compress):
    """One full engine step on the card with a NaN decode coefficient: the
    decode kernels run and go non-finite, and params, moments, master
    weights and the optimizer's step stay bit for bit as they were."""
    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model
    from repro_torch.train.trainer import CodedTrainer

    model = build_model(get_config("smollm-360m").reduced())
    tr = CodedTrainer(model, CodingConfig(scheme="heter_aware", s=1, compress=compress,
                                          wire_kernel=compress),
                      TrainConfig(lr=1e-3, warmup_steps=1, total_steps=4), m=4, part_mb=2,
                      backend=backend, device=cuda_device)
    data = SyntheticData(model.cfg, k=tr.k, part_mb=2, seq_len=16, seed=0)
    state, met = tr.step(tr.init_state(0), data.batch(0))
    assert np.isfinite(met["loss"])
    snap = {name: {k: v.clone() for k, v in tree.items()} for name, tree in
            (("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu),
             ("master", state.opt.master or {}))}
    opt_step = state.opt.step
    dec = tr.codec.decode_outcome(list(range(tr.m)))
    poisoned = tr._poison_outcome(dec, tuple(tr._used_workers(dec)[:1]))
    before = coded_reduce.launches
    after, met = tr.engine.step(state, data.batch(1), poisoned)
    torch.cuda.synchronize()
    assert not np.isfinite(met["grad_norm"])
    assert (coded_reduce.launches > before) == (backend == "spmd")
    trees = {"params": after.params, "mu": after.opt.mu, "nu": after.opt.nu,
             "master": after.opt.master or {}}
    for name, tree in snap.items():
        for k, v in tree.items():
            assert torch.equal(trees[name][k].view(torch.uint8), v.view(torch.uint8)), (name, k)
    assert after.opt.step == opt_step


def _reduce_f32(g, w):
    """The kernel's own reduce (coded_reduce.cu, f32 out): the oracle's
    accumulation order then matches the encode kernel's bit for bit."""
    return coded_reduce(g, w, torch.float32)


def _wire_inputs(P, D, dtype, seed, dev, err_scale=1e-3):
    r = np.random.default_rng(seed)
    g = torch.from_numpy(r.normal(size=(P, D)).astype(np.float32)).to(dtype).to(dev)
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32)).to(dev)
    err = torch.from_numpy(r.normal(scale=err_scale, size=(D,)).astype(np.float32)).to(dev)
    return g, w, err


def _assert_encode_bit_equal(g, w, err, out_err=None):
    before = wire.coded_encode_int8.launches
    oq, oscale, onew = ref.encode_int8_oracle_np(g, w, err, reduce_fn=_reduce_f32)
    q, scale, new_err = wire.coded_encode_int8(g, w, err, out_err=out_err)
    torch.cuda.synchronize()
    assert wire.coded_encode_int8.launches == before + 1
    np.testing.assert_array_equal(q.cpu().numpy(), oq)
    assert scale.cpu().numpy().tobytes() == np.float32(oscale).tobytes()
    got = new_err.cpu().numpy()
    assert got.tobytes() == onew.tobytes(), np.flatnonzero(got.view(np.int32) != onew.view(np.int32))[:8]
    return q, scale, new_err


# the sweep of tests/test_wire_kernels.py: ragged and tile-crossing D,
# P across 128, and its edge shapes
_WIRE_SHAPES = [(1, 1), (1, 7), (2, 129), (5, 4095), (7, 511), (8, 512), (8, 513),
                (20, 4097), (128, 128), (130, 1025), (33, 4200), (5, 1 << 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("P,D", _WIRE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_encode_bit_equal_to_oracle(cuda_device, P, D, dtype):
    _assert_encode_bit_equal(*_wire_inputs(P, D, dtype, P * 1000 + D, cuda_device))


@pytest.mark.gpu
def test_cuda_encode_zero_chain_and_in_place(cuda_device):
    """The EPS floor; a 6-step error-feedback chain bit-equal at every step;
    out_err=err in place gives the out-of-place bits."""
    z = torch.zeros(4, 100, device=cuda_device)
    q, _, _ = _assert_encode_bit_equal(z, torch.zeros(4, device=cuda_device),
                                       torch.zeros(100, device=cuda_device))
    assert not q.any()
    r = np.random.default_rng(3)
    w = torch.from_numpy(r.normal(size=(6,)).astype(np.float32)).to(cuda_device)
    err = torch.zeros(777, device=cuda_device)
    for _ in range(6):
        g = torch.from_numpy(r.normal(size=(6, 777)).astype(np.float32)).to(cuda_device)
        _, _, err = _assert_encode_bit_equal(g, w, err)
    g, w, err = _wire_inputs(5, 1 << 16, torch.float32, 4, cuda_device)
    q0, s0, e0 = wire.coded_encode_int8(g, w, err)
    q1, s1, e1 = wire.coded_encode_int8(g, w, err, out_err=err)
    torch.cuda.synchronize()
    assert e1 is err and torch.equal(q0, q1) and torch.equal(s0, s1)
    assert e0.cpu().numpy().tobytes() == err.cpu().numpy().tobytes()


@pytest.mark.gpu
def test_cuda_encode_nan_gives_nan_scale(cuda_device):
    g, w, err = _wire_inputs(3, 4096, torch.float32, 2, cuda_device)
    g[1, 1234] = float("nan")
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    assert torch.isnan(scale) and torch.isnan(new_err).all()
    out = wire.coded_decode_int8(q[None], scale[None] * 0.0)
    assert torch.isnan(out).all()


@pytest.mark.gpu
def test_cuda_encode_constants_have_the_format_bits(cuda_device):
    eps, inv = wire.kernel_constants()
    assert inv.tobytes() == np.float32(1.0 / 127.0).tobytes()
    assert eps.tobytes() == np.float32(1e-12).tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("m,D", [(1, 1), (4, 4095), (4, 1 << 20), (10, 1500)])
def test_cuda_decode_matches_plain(cuda_device, m, D):
    r = np.random.default_rng(m + D)
    q = torch.from_numpy(r.integers(-127, 128, size=(m, D)).astype(np.int8)).to(cuda_device)
    ws = torch.from_numpy((r.normal(size=(m,)) * 1e-2).astype(np.float32)).to(cuda_device)
    before = wire.coded_decode_int8.launches
    out = wire.coded_decode_int8(q, ws)
    torch.cuda.synchronize()
    assert wire.coded_decode_int8.launches == before + 1
    expect = wire.coded_decode_int8_torch(q, ws)
    scale = max(1.0, float(expect.abs().max()))
    np.testing.assert_allclose(out.cpu().numpy(), expect.cpu().numpy(), rtol=0, atol=1e-5 * scale)


class _Source:
    def batch(self, step):
        r = np.random.default_rng(step)
        return {"tokens": r.integers(0, 1000, size=(4, 2, 4096)).astype(np.int32),
                "x": r.normal(size=(4, 2, 4096)).astype(np.float32)}


@pytest.mark.gpu
def test_cuda_prefetch_side_stream_copies_arrive(cuda_device):
    """Batches copied on the prefetcher's side stream are complete when the
    consumer's stream reads them (it waits on the copy's event)."""
    from repro_torch.train.prefetch import DevicePrefetcher

    src = _Source()
    for step, batch in DevicePrefetcher(src, 0, 6, device=cuda_device):
        for key, x in src.batch(step).items():
            assert batch[key].device.type == "cuda"
            # read on the current stream, where the consumer computes
            np.testing.assert_array_equal((batch[key] * 1).cpu().numpy(), x)


def _ssd_inputs(B, S, H, G, P, N, bc_dtype, dev, seed, model_dA=False):
    """x·dt, dA, B, C on the card.  ``model_dA``: dt and A as mamba2-370m's
    layer draws them at init, so cumsum(dA) over 256 rows reaches hundreds
    below zero; else the draws of tests/test_kernels.py."""
    r = np.random.default_rng(seed)
    if model_dA:
        dt0 = np.exp(r.uniform(size=H) * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
        dt = np.logaddexp(r.normal(size=(B, S, H)) + dt0 + np.log(-np.expm1(-dt0)), 0.0)
        A = -np.arange(1, H + 1, dtype=np.float64)
    else:
        dt = r.uniform(0.01, 0.2, size=(B, S, H))
        A = -r.uniform(0.3, 2.0, size=(H,))
    x = r.normal(size=(B, S, H, P)) * dt[..., None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return (t(x), t(dt * A), t(r.normal(size=(B, S, G, N))).to(bc_dtype),
            t(r.normal(size=(B, S, G, N))).to(bc_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,G,P,N", [(32, 2, 1, 8, 16), (64, 4, 2, 16, 32), (64, 4, 4, 8, 8),
                                       (96, 8, 2, 32, 16), (130, 2, 1, 64, 128)])
@pytest.mark.parametrize("bc", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_ssd_scan_matches_plain(cuda_device, S, H, G, P, N, bc):
    """The kernel (64-row tiles, a ragged last one where S % 64 != 0) against
    the plain chunked version, atol 1e-4 / rtol 1e-3 as tests/test_kernels.py."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    chunk = S // 2
    x, dA, Bm, Cm = _ssd_inputs(2, S, H, G, P, N, bc, cuda_device, S + G)
    before = ssd_scan.launches
    y, h = ssd_scan(x, dA, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, chunk)
    assert y.dtype == h.dtype == torch.float32 and y.shape == x.shape and h.shape == (2, H, P, N)
    torch.testing.assert_close(y, py, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(h, ph, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
def test_cuda_ssd_scan_masked_triangle_is_nan_free(cuda_device):
    """The full mamba2 layer (B=2, S=512, H=32, P=64, N=128, chunk 256) with
    the model's dA: exp above the diagonal would be +inf, so a mask applied
    after the exp gives NaN.  The kernel is finite and within 1e-3 of
    max|plain| (the decay is exp of a difference of cumulative sums that
    the two round in different orders)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    x, dA, Bm, Cm = _ssd_inputs(2, 512, 32, 1, 64, 128, torch.bfloat16, cuda_device, 0,
                                model_dA=True)
    assert float(dA.reshape(2, 2, 256, 32).cumsum(2).min()) < -300
    y, h = ssd_scan(x, dA, Bm, Cm, 256)
    torch.cuda.synchronize()
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert float((y - py).abs().max()) <= 1e-3 * float(py.abs().max())
    assert float((h - ph).abs().max()) <= 1e-3 * float(ph.abs().max())


@pytest.mark.gpu
def test_cuda_ssd_scan_fn_grads_match_plain(cuda_device):
    """Through ops.ssd_scan on the card: with f32 B/C (the CUDA-core forward,
    the plain version's backward) the gradients equal plain autograd's, bit
    for bit (the backward differentiates the same function of the same
    saved inputs); with bf16 B/C the backward kernels run (one counted
    call) and each gradient holds to f64 autograd as
    :func:`_hold_ssd_bwd` states."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd

    for bc in (torch.float32, torch.bfloat16):
        ins = _ssd_inputs(2, 128, 4, 2, 16, 32, bc, cuda_device, 3)
        gy = torch.randn(2, 128, 4, 16, device=cuda_device)
        grads = []
        before = ssd_scan_bwd.launches
        for impl in ("cuda", "torch"):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            y, _ = ops.ssd_scan(*leaves, chunk=64, impl=impl)
            grads.append(torch.autograd.grad((y * gy).sum(), leaves))
        kernel = bc == torch.bfloat16
        assert ssd_scan_bwd.launches == before + kernel
        assert ops.ssd_backward_impl(ins[0], ins[2]) == ("kernel" if kernel else "plain")
        for a, b, t in zip(*grads, ins):
            assert a.dtype == t.dtype
            if not kernel:
                torch.testing.assert_close(a, b, atol=0, rtol=0)
        if kernel:
            _hold_ssd_bwd(grads[0], *ins, gy, None, 64)


def _ssd_grads(x, dA, Bm, Cm, gy, gh, dtype, chunk):
    """Plain autograd of ``ssd_scan_torch`` in ``dtype``: f64 with B and C
    widened, or f32 with B and C as given (their gradients in their dtype,
    as the model's)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_torch

    wide = dtype == torch.float64
    ins = [t.detach().to(dtype if wide or i < 2 else t.dtype).requires_grad_(True)
           for i, t in enumerate((x, dA, Bm, Cm))]
    y, h = ssd_scan_torch(*ins, chunk)
    outs, gs = [y], [gy.to(y.dtype)]
    if gh is not None:
        outs.append(h)
        gs.append(gh.to(h.dtype))
    return torch.autograd.grad(outs, ins, gs)


def _hold_ssd_bwd(got, x, dA, Bm, Cm, gy, gh, chunk):
    """(dx, ddA, dB, dC) of the kernels held to f64 autograd of the plain
    version: each finite, in its input's dtype, and within max(2 x the f32
    plain backward's own error, 1e-4 x max|f64|).  Returns the kernel's
    errors over max|f64|."""
    ref = _ssd_grads(x, dA, Bm, Cm, gy, gh, torch.float64, chunk)
    plain = _ssd_grads(x, dA, Bm, Cm, gy, gh, torch.float32, chunk)
    rel = {}
    for name, k, p, r, t in zip(("dx", "ddA", "dB", "dC"), got, plain, ref, (x, dA, Bm, Cm)):
        assert k.dtype == p.dtype == t.dtype and k.shape == t.shape, name
        assert torch.isfinite(k).all(), name
        top = float(r.abs().max())
        err_k = float((k.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_k <= max(2 * err_p, 1e-4 * top), \
            f"{name}: kernel {err_k:.3e}, plain f32 {err_p:.3e}, max|f64| {top:.3e}"
        rel[name] = err_k / top
    return rel


def _ssd_bwd_run(B, S, H, G, P, N, seed, model_dA, with_gh, dev):
    """Inputs at these shapes, the forward kernel with its states, the
    gradient of y (and of h) drawn from ``seed``, and the backward kernels'
    gradients."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_with_states

    x, dA, Bm, Cm = _ssd_inputs(B, S, H, G, P, N, torch.bfloat16, dev, seed, model_dA=model_dA)
    r = np.random.default_rng(seed + 1)
    gy = torch.from_numpy(r.normal(size=(B, S, H, P)).astype(np.float32)).to(dev)
    gh = torch.from_numpy(r.normal(size=(B, H, P, N)).astype(np.float32)).to(dev) \
        if with_gh else None
    _, _, ws = ssd_scan_with_states(x, dA, Bm, Cm, S)
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dA, Bm, Cm, S, gy, gh, ws)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    return got, (x, dA, Bm, Cm, gy, gh)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,G,P,N,model_dA,with_gh", [
    (4, 2048, 32, 1, 64, 128, True, False),   # mamba2's layer, the benchmark's pass
    (2, 1024, 128, 1, 64, 128, True, False),  # granite's
    (2, 384, 8, 1, 64, 128, True, True),
    (2, 384, 8, 2, 64, 128, False, True),
    (2, 384, 8, 4, 64, 128, True, False),
    (2, 421, 8, 2, 64, 128, True, True),      # a ragged last chunk
    (2, 96, 2, 1, 8, 16, False, True),
    (1, 300, 4, 2, 72, 200, False, True),     # two boxes of P, two pairs of N
    (2, 130, 4, 4, 24, 48, True, False),
    (1, 200, 2, 1, 16, 20, False, True),      # N not a multiple of 8: scalar loads of B, C
    (1, 200, 2, 2, 16, 13, True, True),       # nor of 4: scalar loads of g, h_in too
], ids=["mamba2", "granite", "G1", "G2", "G4", "ragged", "P8-N16", "P72-N200", "P24-N48",
        "P16-N20", "P16-N13"])
def test_cuda_ssd_scan_bwd_matches_f64(cuda_device, B, S, H, G, P, N, model_dA, with_gh):
    """The backward kernels against f64 autograd of the plain version (one
    chunk of S where S is ragged, else 256 rows), with dA as the model draws
    it where marked and the gradient of h where marked: every gradient
    within max(2 x the f32 plain backward's own error, 1e-4 x max|f64|)."""
    got, (x, dA, Bm, Cm, gy, gh) = _ssd_bwd_run(B, S, H, G, P, N, S + 28 * G, model_dA,
                                                 with_gh, cuda_device)
    chunk = 256 if S % 256 == 0 else S
    rel = _hold_ssd_bwd(got, x, dA, Bm, Cm, gy, gh, chunk)
    print(f"\nssd_scan_bwd B={B} S={S} H={H} G={G} P={P} N={N}: error / max|f64| "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))


@pytest.mark.gpu
def test_cuda_ssd_scan_bwd_is_deterministic_and_nan_free(cuda_device):
    """mamba2's layer with the model's dA (exp above the diagonal would be
    +inf): two calls give equal bits in every gradient, none of them NaN or
    infinite (the masked triangle selects before its exp)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_with_states

    got, (x, dA, Bm, Cm, gy, gh) = _ssd_bwd_run(2, 512, 32, 1, 64, 128, 0, True, True,
                                                 cuda_device)
    assert float(dA.reshape(2, 4, 128, 32).cumsum(2).min()) < -100
    _, _, ws = ssd_scan_with_states(x, dA, Bm, Cm, 512)
    again = ssd_scan_bwd(x, dA, Bm, Cm, 512, gy, gh, ws)
    for a, b in zip(got, again):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_ssd_scan_bwd_rejects_what_it_does_not_take(cuda_device):
    """f32 B/C (their forward keeps no states), a workspace of other shapes,
    a gradient of y of another shape or dtype, CPU tensors: each raises
    before any launch."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_with_states

    x, dA, Bm, Cm = _ssd_inputs(1, 256, 4, 2, 64, 128, torch.bfloat16, cuda_device, 5)
    gy = torch.randn(1, 256, 4, 64, device=cuda_device)
    _, _, ws = ssd_scan_with_states(x, dA, Bm, Cm, 256)
    before = ssd_scan_bwd.launches
    with pytest.raises(TypeError, match="bf16"):
        ssd_scan_bwd(x, dA, Bm.float(), Cm.float(), 256, gy, None, ws)
    with pytest.raises(ValueError, match="workspace"):
        ssd_scan_bwd(x, dA, Bm, Cm, 256, gy, None, ws[:-16])
    with pytest.raises(ValueError, match="gy"):
        ssd_scan_bwd(x, dA, Bm, Cm, 256, gy.double(), None, ws)
    with pytest.raises(ValueError, match="gh"):
        ssd_scan_bwd(x, dA, Bm, Cm, 256, gy, gy, ws)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(x.cpu(), dA.cpu(), Bm.cpu(), Cm.cpu(), 256, gy.cpu(), None, ws.cpu())
    assert ssd_scan_bwd.launches == before


@pytest.mark.gpu
def test_cuda_ssd_scan_bwd_in_a_traced_lm_step(cuda_device):
    """A bf16 reduced mamba2 under full remat, two traced fused steps on the
    card: every SSD layer's spans say ``bwd_impl="kernel"``, the backward
    kernels run once a layer and step (one call a ``bwd`` pass), and no
    step's loss is non-finite."""
    import dataclasses

    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    from repro_torch.models.lm import build_model
    from repro_torch.obs import Tracer
    from repro_torch.train.trainer import CodedTrainer

    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), remat="full",
                              dtype="bfloat16")
    tracer = Tracer()
    tr = CodedTrainer(build_model(cfg), CodingConfig(scheme="heter_aware", s=1),
                      TrainConfig(), m=4, part_mb=2, device=cuda_device, trace=tracer)
    data = SyntheticData(cfg, k=tr.k, part_mb=2, seq_len=64, seed=0)
    state = tr.init_state(0)
    before = ssd_scan_bwd.launches
    steps = 2
    for i in range(steps):
        state, met = tr.step(state, data.batch(i))
        assert np.isfinite(met["loss"])
    spans = [r for r in tracer.records("span")
             if r["name"] == "device.mixer" and r["args"]["kind"] == "ssd"]
    passes = {p: sum(r["args"]["pass"] == p for r in spans) for p in ("fwd", "recompute", "bwd")}
    assert {r["args"]["bwd_impl"] for r in spans} == {"kernel"}
    assert passes == {p: steps * cfg.n_layers for p in passes}
    assert ssd_scan_bwd.launches - before == passes["bwd"]


@pytest.mark.gpu
def test_cuda_ssd_scan_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan

    x, dA, Bm, Cm = _ssd_inputs(1, 64, 2, 1, 8, 16, torch.float32, cuda_device, 1)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x.double(), dA, Bm, Cm, 32)
    with pytest.raises(TypeError, match="share a dtype"):
        ssd_scan(x, dA, Bm, Cm.bfloat16(), 32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_scan(x[..., :6].contiguous(), dA, Bm, Cm, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dA, Bm, Cm, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [384, 421], ids=["3-chunks", "ragged-4-chunks"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_cuda_ssd_scan_groups_share_scores_across_chunks(cuda_device, G, S):
    """H = 8 heads over G groups, so each group's C B^T (computed once per
    batch, group and 128-row chunk) serves 8 / G heads; S spans 3 chunks, or
    4 with a ragged last one (421 = 3 x 128 + 37).  P = 64, N = 128 as the
    model's, the draws of tests/test_kernels.py.  Hold: rtol 1e-3 over atol
    1e-4 x max|plain|.  The split bf16 operands keep each f32 value to
    2^-17, so the error grows with the sums (tens at N = 128), not with each
    output; the CPU emulation of the scheme at these very inputs holds the
    same (tests/test_torch_ssm.py).  A wrong group, chunk or pad is off by
    O(max)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    x, dA, Bm, Cm = _ssd_inputs(2, S, 8, G, 64, 128, torch.bfloat16, cuda_device, S + G)
    y, h = ssd_scan(x, dA, Bm, Cm, S)
    torch.cuda.synchronize()
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, S)
    torch.testing.assert_close(y, py, atol=1e-4 * float(py.abs().max()), rtol=1e-3)
    torch.testing.assert_close(h, ph, atol=1e-4 * float(ph.abs().max()), rtol=1e-3)


@pytest.mark.gpu
def test_cuda_ssd_scan_longest_prompt_matches_plain(cuda_device):
    """The engine's longest prompt, B=1, S=2048 (16 chunks of 128), at the
    full mamba2 layer with the model's dA and bf16 B/C: finite, and within
    1e-3 of max|plain| for y and h."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    x, dA, Bm, Cm = _ssd_inputs(1, 2048, 32, 1, 64, 128, torch.bfloat16, cuda_device, 4,
                                model_dA=True)
    y, h = ssd_scan(x, dA, Bm, Cm, 256)
    torch.cuda.synchronize()
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert float((y - py).abs().max()) <= 1e-3 * float(py.abs().max())
    assert float((h - ph).abs().max()) <= 1e-3 * float(ph.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("S,P,N", [(70, 8, 5), (200, 16, 100), (300, 72, 200)])
def test_cuda_ssd_scan_bf16_pads_any_state_and_head_size(cuda_device, S, P, N):
    """bf16 B/C at sizes off the model's: N odd (5: every load element by
    element), N = 100 (not a multiple of 8: B and C element by element, the
    state's boxes by 16 bytes) and 200 (four boxes of 64, the last ragged),
    P = 72 (two boxes of 64 columns of P, the second of 8); padded with
    zeros in shared memory.  atol 1e-4 / rtol 1e-3 as the JAX test."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    x, dA, Bm, Cm = _ssd_inputs(2, S, 4, 2, P, N, torch.bfloat16, cuda_device, N)
    y, h = ssd_scan(x, dA, Bm, Cm, S)
    torch.cuda.synchronize()
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, S)
    torch.testing.assert_close(y, py, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(h, ph, atol=1e-4, rtol=1e-3)


def _device_kernels(fn) -> list[str]:
    """Names of the device kernels that ``fn()`` ran, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        try:
            fn()
        finally:
            torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


_BF16_KERNELS = {"ssd_scan_chunk_kernel", "ssd_scan_state_kernel", "ssd_scan_output_kernel"}


@pytest.mark.gpu
def test_cuda_ssd_scan_dispatches_on_the_dtype_alone(cuda_device):
    """bf16 B/C runs the tensor-core kernel's three launches and not the
    CUDA-core kernel; f32 B/C the CUDA-core kernel alone; a launch the C
    entry refuses (f32 at N = 512: its tiles exceed a block's shared
    memory) raises and runs neither.  One wrapper call counts one."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    def ran(names):
        return {k for k in _BF16_KERNELS | {"ssd_scan_f32_kernel"} if any(k in n for n in names)}

    for bc, want in ((torch.bfloat16, _BF16_KERNELS), (torch.float32, {"ssd_scan_f32_kernel"})):
        x, dA, Bm, Cm = _ssd_inputs(1, 256, 4, 1, 64, 128, bc, cuda_device, 2)
        before = ssd_scan.launches
        names = _device_kernels(lambda: ssd_scan(x, dA, Bm, Cm, 128))
        assert ran(names) == want, names
        assert ssd_scan.launches == before + 1
    x, dA, Bm, Cm = _ssd_inputs(1, 64, 2, 1, 64, 512, torch.float32, cuda_device, 2)
    before = ssd_scan.launches

    def refused():
        with pytest.raises(RuntimeError, match="ssd_scan launch failed"):
            ssd_scan(x, dA, Bm, Cm, 64)

    names = _device_kernels(refused)
    assert ran(names) == set(), names
    assert ssd_scan.launches == before


# -- flash attention ---------------------------------------------------------

# (atol, rtol) of the JAX sweep's shapes: tests/test_kernels.py:123
_FLASH_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (3e-2, 3e-2)}
# (atol, rtol) beyond the JAX sweep's shapes: both sides compute in f32 and
# round once, so in bf16 they part by at most one spacing of the value
# (2^-7 of it); in f32 by a few spacings of summation order.
_FLASH_TOL_TIGHT = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2.0**-7)}


def _qkv(B, S, H, K, hd, dtype, dev, seed):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(B, S, n, hd)).astype(np.float32)).to(dtype).to(dev)
            for n in (H, K, K)]


def _flash_vs_plain(q, k, v, causal, window, tol=_FLASH_TOL):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_torch

    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    expect = flash_attention_torch(q, k, v, causal=causal, window=window)
    atol, rtol = tol[q.dtype]
    torch.testing.assert_close(out.float(), expect.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,K,hd", [(64, 4, 2, 32), (128, 6, 3, 32), (128, 8, 8, 64),
                                      (64, 5, 1, 16)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 32),
                                           (False, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda_device, S, H, K, hd, causal, window, dtype):
    """The JAX sweep's shapes, causal or not, window None or 32, at the JAX
    test's tolerances."""
    _flash_vs_plain(*_qkv(2, S, H, K, hd, dtype, cuda_device, S + H), causal, window)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 100, 1000, 2047])
@pytest.mark.parametrize("window", [None, 1, 5000])
def test_cuda_flash_attention_ragged_and_window_edges(cuda_device, S, window):
    """Ragged S at smollm-360m's heads (H=15, K=5, hd=64), bf16: a prompt
    shorter than one tile, ragged last tiles, a window of 1 (only the
    diagonal is live: out == v of the row's kv head) and one wider than S.
    NaN-free, within one bf16 spacing of the plain version."""
    q, k, v = _qkv(1, S, 15, 5, 64, torch.bfloat16, cuda_device, S)
    _flash_vs_plain(q, k, v, True, window, _FLASH_TOL_TIGHT)
    if window == 1:
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k, v, causal=True, window=1)
        torch.testing.assert_close(out, v.repeat_interleave(3, dim=2), atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_flash_attention_head_dim_128(cuda_device, dtype):
    _flash_vs_plain(*_qkv(2, 300, 8, 2, 128, dtype, cuda_device, 128), True, None,
                    _FLASH_TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["peaked", "zero_mean_v"])
def test_cuda_flash_attention_stress_at_long_prompt(cuda_device, kind):
    """S=2048 at smollm-360m's heads, bf16, within one bf16 spacing: q x 8
    peaks the softmax, so the running max moves by large steps and the
    rescaling of l and acc decides; v with its mean over S removed gives
    outputs near 0, where atol decides."""
    q, k, v = _qkv(1, 2048, 15, 5, 64, torch.float32, cuda_device, 2048)
    if kind == "peaked":
        q = q * 8
    else:
        v = v - v.mean(dim=1, keepdim=True)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    _flash_vs_plain(q, k, v, True, None, _FLASH_TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3, 5])
@pytest.mark.parametrize("window", [63, 64, 65, 129])
def test_cuda_flash_attention_gqa_windows_across_tile_edges(cuda_device, G, window):
    """GQA groups of G query heads per kv head, hd 64, bf16, causal, with
    windows on either side of the kernel's 64-row kv tiles, within one bf16
    spacing."""
    _flash_vs_plain(*_qkv(1, 300, 2 * G, 2, 64, torch.bfloat16, cuda_device, G + window),
                    True, window, _FLASH_TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_every_head_size_bf16(cuda_device, hd, causal):
    """Every head size in bf16 at a ragged S: each has its own swizzle
    (32, 64 or 128 bytes; hd 128 in two boxes), which TMA and the wgmma
    descriptors must agree on."""
    _flash_vs_plain(*_qkv(2, 333, 6, 2, hd, torch.bfloat16, cuda_device, hd), causal, None,
                    _FLASH_TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_cuda_flash_attention_refuses_misaligned_bases(cuda_device, which):
    """TMA reads from 16-byte aligned bases: a contiguous view at a storage
    offset of one element is refused before any launch."""
    from repro_torch.kernels.flash_attention import flash_attention

    qkv = dict(zip("qkv", _qkv(1, 64, 4, 2, 32, torch.bfloat16, cuda_device, 0)))
    t = qkv[which]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
    qkv[which] = flat[1:].view(t.shape).copy_(t)
    assert qkv[which].is_contiguous() and qkv[which].data_ptr() % 16
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(qkv["q"], qkv["k"], qkv["v"])
    assert flash_attention.launches == before


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _qkv(1, 64, 4, 2, 32, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="head size"):
        flash_attention(*_qkv(1, 64, 4, 2, 48, torch.float32, cuda_device, 0))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


# -- flash attention, training ---------------------------------------------------

_LOG2E = 1.4426950408889634


def _train_inputs(B, S, H, K, hd, dev, seed):
    """bf16 q (scaled by hd^-0.5 in bf16, as the model scales it), k, v and
    an output gradient do."""
    r = np.random.default_rng(seed)
    q, k, v, do = [torch.from_numpy(r.normal(size=(B, S, n, hd)).astype(np.float32))
                   .to(torch.bfloat16).to(dev) for n in (H, K, K, H)]
    return q * hd**-0.5, k, v, do


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _autograd(fn, q, k, v, do, dtype, **kw):
    leaves = [t.detach().to(dtype, copy=True).requires_grad_() for t in (q, k, v)]
    o = fn(*leaves, **kw)
    o.backward(do.to(dtype))
    return [o.detach()] + [t.grad for t in leaves]


def _train_vs_plain(q, k, v, do, causal, window):
    """The training kernels (one forward, one backward) against autograd of
    the plain version (the model's chain) on the same bf16 inputs, and of
    the same chain in f32 (no rounding anywhere).  o, dq, dk and dv each:
    the kernels' relative error (Frobenius) to f32 at most 1.1x the plain
    chain's plus 1e-5, since the kernels round no operand below the chain
    (P to bf16 as the model, dS split into hi + lo where the chain keeps
    f32; the chain rounds dP to bf16, which the kernels do not) and differ
    in summation order; and within 5e-3 of the plain chain's (each side
    about 2.3e-3 from f32, the outputs' bf16 rounding).  lse against the
    f32 log-sum-exp in log2 units, atol 1e-4: ex2.approx and the order of
    f32 sums move it by a few f32 spacings."""
    from repro_torch.kernels import flash_attention as fa

    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches)
    kern = _autograd(fa.flash_attention_train, q, k, v, do, torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = _autograd(fa.flash_attention_train_torch, q, k, v, do, torch.bfloat16, **kw)
    ref = _autograd(fa.flash_attention_train_torch, q, k, v, do, torch.float32, **kw)
    for name, a, p, r in zip(("o", "dq", "dk", "dv"), kern, plain, ref):
        assert a.dtype == torch.bfloat16 and a.shape == p.shape
        assert torch.isfinite(a.float()).all(), name
        ek, ep = _rel(a, r), _rel(p, r)
        assert ek <= 1.1 * ep + 1e-5, f"{name}: kernels {ek:.3e} from f32, plain chain {ep:.3e}"
        assert _rel(a, p) <= 5e-3, f"{name}: {_rel(a, p):.3e} from the plain chain"
    del plain, ref
    B, S, H, hd = q.shape
    K = k.shape[2]
    _, lse = fa.flash_attention_train_fwd(q, k, v, causal, window)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float().reshape(B, S, K, H // K, hd), k.float())
    i = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    expect = (torch.logsumexp(s, -1) * _LOG2E).reshape(B, H, S)
    torch.testing.assert_close(lse[..., :S], expect, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 2048, 15, 5, 64, True, None),     # smollm-360m's heads at its context
    (1, 512, 32, 8, 128, True, None),     # llama/mixtral/qwen-like 32/8 at hd 128
    (1, 4224, 32, 8, 128, True, 4096),    # mixtral's window, past one window
    (1, 700, 8, 2, 128, True, 129),       # a window across the 64- and 128-row tiles
    (2, 333, 6, 2, 32, False, None),      # not causal
    (1, 300, 4, 2, 64, False, 32),        # a window without the causal mask
    (1, 1000, 15, 5, 64, True, None),     # ragged S at smollm's heads
    (2, 200, 6, 2, 16, True, None),       # hd 16, ragged, a 32-byte swizzle
    (1, 77, 3, 3, 64, True, None),        # S under one tile, G = 1
], ids=["smollm-s2048", "h32k8-hd128", "mixtral-window", "window129", "not-causal",
        "window-not-causal", "ragged-s1000", "hd16", "s77-g1"])
def test_cuda_flash_attention_train_matches_plain(cuda_device, B, S, H, K, hd, causal, window):
    _train_vs_plain(*_train_inputs(B, S, H, K, hd, cuda_device, S + H + hd), causal, window)


@pytest.mark.gpu
def test_cuda_flash_attention_train_backward_is_deterministic(cuda_device):
    """No float atomics: two backward calls on the same inputs give the
    same bits (smollm-360m's heads, S 2048, causal)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _train_inputs(2, 2048, 15, 5, 64, cuda_device, 1)
    o, lse = fa.flash_attention_train_fwd(q, k, v, True, None)
    a = fa.flash_attention_train_bwd(q, k, v, o, do, lse, True, None)
    b = fa.flash_attention_train_bwd(q, k, v, o, do, lse, True, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_cuda_flash_attention_train_in_a_traced_lm_step(cuda_device):
    """A bf16 reduced smollm under full remat, two traced fused steps on the
    card: every attention layer's pass runs the kernels (the spans say
    ``impl="kernel"``), the forward launched twice a layer and step
    (forward and remat's recompute) and the backward once, and no step's
    loss is non-finite."""
    import dataclasses

    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.lm import build_model
    from repro_torch.obs import Tracer
    from repro_torch.train.trainer import CodedTrainer

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), remat="full",
                              dtype="bfloat16")
    tracer = Tracer()
    tr = CodedTrainer(build_model(cfg), CodingConfig(scheme="heter_aware", s=1),
                      TrainConfig(), m=4, part_mb=2, device=cuda_device, trace=tracer)
    data = SyntheticData(cfg, k=tr.k, part_mb=2, seq_len=64, seed=0)
    state = tr.init_state(0)
    fwd0, bwd0 = fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches
    steps = 2
    for i in range(steps):
        state, met = tr.step(state, data.batch(i))
        assert np.isfinite(met["loss"])
    fwd = fa.flash_attention_train_fwd.launches - fwd0
    bwd = fa.flash_attention_train_bwd.launches - bwd0
    spans = [r for r in tracer.records("span")
             if r["name"] == "device.mixer" and r["args"]["kind"] == "attn"]
    passes = {p: sum(r["args"]["pass"] == p for r in spans) for p in ("fwd", "recompute", "bwd")}
    assert {r["args"]["impl"] for r in spans} == {"kernel"}
    assert passes == {p: steps * cfg.n_layers for p in passes}
    assert (fwd, bwd) == (passes["fwd"] + passes["recompute"], passes["bwd"])


@pytest.mark.gpu
def test_cuda_flash_attention_train_refuses_before_any_launch(cuda_device):
    """f32, a head size the kernels lack, a view that is not contiguous and
    a base that is not 16-byte aligned raise before any launch."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _train_inputs(1, 64, 4, 2, 32, cuda_device, 0)
    before = (fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_train(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head size"):
        fa.flash_attention_train(*_train_inputs(1, 64, 4, 2, 80, cuda_device, 0)[:3])
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_train(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_train(flat[1:].view(q.shape).copy_(q), k, v)
    assert (fa.flash_attention_train_fwd.launches,
            fa.flash_attention_train_bwd.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_cuda_serving_engine_launches_the_prefill_kernel(cuda_device, arch):
    """A reduced ServingEngine run on the card: the prefill kernel launches
    once per layer and prefill call, never in decode, and every request
    completes with tokens in [0, vocab)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.train.serve import LMServer

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    counter = flash_attention if arch == "smollm-360m" else ssd_scan
    server = LMServer(model)
    r = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=r.integers(0, cfg.vocab, (int(n),)), max_new_tokens=5,
                    arrival_t=0.01 * i) for i, n in enumerate((9, 30, 17, 64))]
    before = counter.launches
    comps, _ = ServingEngine(server, params, n_slots=2, cache_len=80, decode_dt=0.01).run(reqs)
    torch.cuda.synchronize()
    assert counter.launches - before == cfg.n_layers * len(reqs)
    assert [len(c.tokens) for c in comps] == [5] * len(reqs)
    assert all(((c.tokens >= 0) & (c.tokens < cfg.vocab)).all() for c in comps)


# -- the model families ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,hd,window", [(4, 1024, 16, 16, 128, None),
                                               (1, 6144, 32, 8, 128, 4096),
                                               (4, 1024, 16, 8, 128, None)],
                         ids=["moonshot", "mixtral-window", "internvl2"])
def test_cuda_flash_attention_family_prefill_shapes(cuda_device, B, S, H, K, hd, window):
    """The families' prefill shapes in bf16, causal: hd 128 with G = 1
    (moonshot) and G = 2 (internvl2), and mixtral's window of 4096 over a
    6144-token prompt, within one bf16 spacing of the plain version."""
    _flash_vs_plain(*_qkv(B, S, H, K, hd, torch.bfloat16, cuda_device, S + H), True, window,
                    _FLASH_TOL_TIGHT)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x7b", "jamba-1.5-large-398b",
                                  "internvl2-2b"])
def test_cuda_family_prefill_through_the_kernels_matches_plain(cuda_device, arch):
    """The reduced MoE, sliding-window (a 40-token prompt past mixtral's
    reduced window of 16), hybrid and VLM prefills in f32 with TF32 off:
    through the kernels (flash once per attention layer, the SSD scan once
    per mamba layer) against ``attn_impl`` / ``ssd_impl="torch"``:
    last-position logits within 1e-4 of max|logit|, every cache leaf within
    1e-4 (the SSD state 1e-3) of its max."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.lm import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    kernel = build_model(cfg)
    plain = build_model(cfg, attn_impl="torch", ssd_impl="torch")
    params = kernel.init(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    r = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(r.integers(0, cfg.vocab, (2, 40)), device=cuda_device)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.as_tensor(r.normal(size=(2, cfg.n_patches, cfg.d_model)) * 0.02,
                                           dtype=torch.float32, device=cuda_device)
    L = 48 + cfg.n_patches
    before = (flash_attention.launches, ssd_scan.launches)
    lk, ck = kernel.prefill(params, batch, cache_len=L)
    torch.cuda.synchronize()
    attn = sum(s.mixer == "attn" for s in kernel.plan)
    assert (flash_attention.launches - before[0], ssd_scan.launches - before[1]) == (
        attn, cfg.n_layers - attn)
    lt, ct = plain.prefill(params, batch, cache_len=L)
    assert (flash_attention.launches - before[0], ssd_scan.launches - before[1]) == (
        attn, cfg.n_layers - attn)
    assert float((lk - lt).abs().max() / lt.abs().max()) <= 1e-4
    for name in ct:
        if name == "pos":
            assert torch.equal(ck[name], ct[name])
            continue
        lim = 1e-3 if name.endswith(".h") else 1e-4
        assert float((ck[name] - ct[name]).abs().max()) <= lim * float(ct[name].abs().max()), name


@pytest.mark.gpu
def test_cuda_stacked_init_draws_one_slab_at_a_time(cuda_device):
    """A stacked expert leaf of 1.5 G bf16 values (12 layers of moonshot's
    (64, 2048, 1408)) initializes with a peak of about one f32 slab above
    the leaf (0.74 GB), not the 6 GB f32 temporary of a whole-leaf draw,
    with the truncated normal's spread at n_experts^-1/2."""
    from repro_torch.models.moe import init_moe

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    p = init_moe(torch.Generator(device=cuda_device).manual_seed(0), 12, 2048, 64, 1408,
                 torch.bfloat16, cuda_device)
    torch.cuda.synchronize()
    leaves = sum(t.numel() * t.element_size() for t in p.values())
    extra = torch.cuda.max_memory_allocated(cuda_device) - base - leaves
    slab = 64 * 2048 * 1408 * 4
    assert extra <= 2 * slab, (extra, slab)
    std = float(p["w_gate"][3].float().std())
    assert abs(std - 0.8796 * 64**-0.5) <= 0.01 * 64**-0.5
    assert p["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the spmd backend across processes: two ranks on the one card
# ---------------------------------------------------------------------------

GROUP_M = 2


def _group_inputs(dev):
    """The reduced smollm-360m in f32, heter_aware s=1 m=2, all workers
    decoded, micro-batches of 2 x 16 tokens, weights from seed 0."""
    import dataclasses

    from repro_torch.configs import CodingConfig, get_config
    from repro_torch.core.codec import Codec
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.models.lm import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), dtype="float32")
    model = build_model(cfg)
    codec = Codec.from_config(CodingConfig(scheme="heter_aware", s=1), m=GROUP_M, rng=1)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticData(cfg, k=codec.k, part_mb=2, seq_len=16, seed=0).batch(0)
    return model, codec, codec.decode_outcome(range(GROUP_M)), params, batch


_GROUP_RUNS = (("plain", {}), ("wire", dict(compress=True, wire_kernel=True)))


def _group_rank(out_dir: str) -> None:
    """One rank: the group engine's decoded gradient and the int8 wire it
    read, saved by rank 0."""
    import os
    from pathlib import Path

    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import init_coded_group, remesh_for_m
    from repro_torch.train.engine import StepEngine

    world = init_coded_group("cuda", init_method=f"file://{os.environ['STORE']}")
    group = remesh_for_m(world, GROUP_M)
    model, codec, outcome, params, batch = _group_inputs(group.device)
    saved = {}
    for name, kw in _GROUP_RUNS:
        eng = StepEngine(model, TrainConfig(), codec, backend="spmd", group=group, **kw)
        eng.wire_out = {}
        g = eng.gradients(params, batch, outcome)
        saved[name] = {"decoded": torch.cat([v.reshape(-1) for v in g.values()]).cpu(),
                       **{k: v.cpu() for k, v in eng.wire_out.items()}}
    if group.rank == 0:
        torch.save(saved, Path(out_dir) / "group.pt")
    torch.distributed.destroy_process_group()


@pytest.mark.gpu
def test_cuda_two_ranks_on_the_card_match_the_emulated_spmd(cuda_device, tmp_path):
    """Uncompressed: relative L2 <= 1e-5 (only the summation order
    differs).  The int8 wire: bit-equal wherever the gathered q and
    scale * a_w equal the emulated path's, elsewhere within one wire step
    max_w |a_w * scale_w|."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs import TrainConfig
    from repro_torch.train.engine import StepEngine

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "WORLD_SIZE": str(GROUP_M),
           "LOCAL_WORLD_SIZE": str(GROUP_M), "STORE": str(tmp_path / "store")}
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp_path)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(GROUP_M)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    group = torch.load(tmp_path / "group.pt")
    model, codec, outcome, params, batch = _group_inputs(cuda_device)
    for name, kw in _GROUP_RUNS:
        eng = StepEngine(model, TrainConfig(), codec, backend="spmd", device=cuda_device, **kw)
        eng.wire_out = {}
        g = eng.gradients(params, batch, outcome)
        ref = torch.cat([v.reshape(-1) for v in g.values()]).cpu()
        got = group[name]["decoded"]
        if name == "plain":
            rel = float((got.double() - ref.double()).norm() / ref.double().norm())
            assert rel <= 1e-5, rel
            continue
        q, ws = group[name]["q"], group[name]["ws"]
        same = (q == eng.wire_out["q"].cpu()).all(0)
        if not torch.equal(ws, eng.wire_out["ws"].cpu()):
            same = torch.zeros_like(same)
        assert torch.equal(got[same].view(torch.int32), ref[same].view(torch.int32))
        off = (got - ref).abs()[~same]
        assert off.numel() == 0 or float(off.max()) <= float(ws.abs().max())


if __name__ == "__main__":
    _group_rank(sys.argv[1])


# -- granite-4.0-h-small at one layer's published widths (B 20, S 1024, bf16) ----


def _cuda_ms(fn, n=5):
    """Milliseconds a call of ``fn``: CUDA events around ``n`` calls, after
    one call to warm it."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _granite_moe(dev, seed=0):
    """One granite MoE layer's held share (9 of 72 experts, top 10, width
    768) at d 4096, the benchmark's distributions, and its input (20, 1024,
    4096) in bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d, E, n, ff = 4096, 72, 9, 768
    w = lambda *s, std: (torch.randn(s, generator=g, device=dev) * std)  # noqa: E731
    params = {"router": w(d, E, std=d**-0.5),
              "w_gate": w(n, d, ff, std=d**-0.5).bfloat16(),
              "w_up": w(n, d, ff, std=d**-0.5).bfloat16(),
              "w_down": w(n, ff, d, std=ff**-0.5 / 20**0.5).bfloat16()}
    return params, w(20, 1024, d, std=1.0).bfloat16()


def _moe_grads(params, x, impl, dy):
    from repro_torch.models.moe import moe_apply_dropless

    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    xx = x.detach().clone().requires_grad_()
    y, _, counts = moe_apply_dropless(leaves, xx, top_k=10, impl=impl)
    y.backward(dy)
    return [y.detach(), xx.grad] + [leaves[k].grad for k in sorted(leaves)], counts


@pytest.mark.gpu
def test_cuda_granite_moe_grouped_route_matches_the_loop(cuda_device):
    """The dropless route's grouped products (the main path) against the
    per-expert loop, on the same routed pairs: y and every gradient within
    5e-3 (Frobenius) of each other, the two differing only in the order of
    each product's bf16 sums; the held pairs counted as the routing's own
    top 10 give them.  Both timed, forward and backward (PERF.md)."""
    params, x = _granite_moe(cuda_device)
    dy = torch.randn_like(x)
    grouped, counts = _moe_grads(params, x, "grouped", dy)
    loop, counts_loop = _moe_grads(params, x, "loop", dy)
    ids = (x.float() @ params["router"]).topk(10, dim=-1).indices
    assert torch.equal(counts, torch.stack([(ids == e).sum() for e in range(9)]))
    assert torch.equal(counts, counts_loop)
    names = ["y", "x", "router", "w_down", "w_gate", "w_up"]
    for name, a, b in zip(names, grouped, loop):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= 5e-3, f"{name}: {_rel(a, b):.3e}"
    times = {impl: (_cuda_ms(lambda: _moe_grads(params, x, impl, dy)[0][0].sum()),) for impl
             in ("grouped", "loop")}
    print(f"\ngranite moe fwd+bwd ms: {times}, held pairs {int(counts.sum())}")


@pytest.mark.gpu
def test_cuda_granite_moe_grouped_route_takes_no_synchronize(cuda_device):
    """The grouped route's forward and backward under CUDA's sync debug mode
    "error": no call in them waits for the card."""
    from repro_torch.models.moe import moe_apply_dropless

    params, x = _granite_moe(cuda_device)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    x.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _, _ = moe_apply_dropless(leaves, x, top_k=10, impl="grouped")
        y.backward(torch.ones_like(y))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad.float()).all()


@pytest.mark.gpu
def test_cuda_granite_attention_through_the_training_kernels(cuda_device):
    """Granite's attention layer (hd 128, 32 / 8 heads, scores scaled by
    1/128, no positional embedding) through the training flash kernels
    against the model's own chain, forward and backward: the output and
    every gradient within 5e-3 (Frobenius), as the kernels' own tests hold
    them; each timed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import attention_forward

    g = torch.Generator(device=cuda_device).manual_seed(3)
    d, H, K, hd = 4096, 32, 8, 128
    w = lambda *s: (torch.randn(s, generator=g, device=cuda_device) * s[0] ** -0.5).bfloat16()  # noqa: E731
    params = {"wq": w(d, H * hd), "wk": w(d, K * hd), "wv": w(d, K * hd), "wo": w(H * hd, d)}
    x = torch.randn(20, 1024, d, generator=g, device=cuda_device).bfloat16()
    dy = torch.randn_like(x)
    pos = torch.arange(1024, device=cuda_device)

    def run(impl):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        xx = x.detach().clone().requires_grad_()
        out, _ = attention_forward(leaves, xx, pos, n_heads=H, n_kv=K, head_dim=hd,
                                   rotary_dim=0, rope_theta=10000.0, impl=impl, scale=1 / 128)
        out.backward(dy)
        return [out.detach(), xx.grad] + [leaves[k].grad for k in sorted(leaves)]

    before = fa.flash_attention_train_fwd.launches
    kern = run(None)
    assert fa.flash_attention_train_fwd.launches == before + 1
    plain = run("torch")
    for name, a, b in zip(["out", "x", "wk", "wo", "wq", "wv"], kern, plain):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) <= 5e-3, f"{name}: {_rel(a, b):.3e}"
    print(f"\ngranite attention fwd+bwd ms: kernels {_cuda_ms(lambda: run(None)):.3f}, "
          f"plain chain {_cuda_ms(lambda: run('torch'), n=2):.3f}")


@pytest.mark.gpu
def test_cuda_ssd_scan_granite_128_heads_matches_plain(cuda_device):
    """The scan at granite's layer (128 heads of 64, 1 group, state 128,
    chunk 256, bf16 B/C, dt and A as the model draws them) and the
    benchmark's pass (B 20, S 1024) against the plain chunked version:
    y and h within 1e-3 x the plain version's largest magnitude, the bound
    the kernel's bf16 hi + lo scheme keeps at mamba2's layer
    (tests/test_torch_ssm.py, ``-k precision``); each timed.  (Elementwise,
    atol 1e-4 / rtol 1e-3, 7 of the 168 M outputs are over, by 4.2e-4 at
    most.)"""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_torch

    x, dA, Bm, Cm = _ssd_inputs(20, 1024, 128, 1, 64, 128, torch.bfloat16, cuda_device, 7,
                                model_dA=True)
    y, h = ssd_scan(x, dA, Bm, Cm, 256)
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, 256)
    for got, want in ((y, py), (h, ph)):
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    del py, ph
    print(f"\ngranite ssd_scan ms: kernel {_cuda_ms(lambda: ssd_scan(x, dA, Bm, Cm, 256)):.4f}, "
          f"plain {_cuda_ms(lambda: ssd_scan_torch(x, dA, Bm, Cm, 256), n=2):.3f}")


# ---------------------------------------------------------------------------
# the SSD block's epilogue: the gate-norm kernel pair
# ---------------------------------------------------------------------------


def _gate_norm_inputs(B, S, H, P, GN, dev, seed):
    """y (f32), and xs and z as the strided views ``mamba_forward`` holds
    (xs a slice of the conv's (B, S, d + 2·GN) output, z of the projection's
    (B, S, 2·d + 2·GN + H)), D, norm (bf16) and a gradient of the output,
    from ``seed``, on the card."""
    d = H * P
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(B, S, 2 * d + 2 * GN + H, device=dev, generator=gen).to(torch.bfloat16)
    xbc = torch.randn(B, S, d + 2 * GN, device=dev, generator=gen).to(torch.bfloat16)
    y = torch.randn(B, S, H, P, device=dev, generator=gen)
    D = torch.rand(H, device=dev, generator=gen) + 0.5
    norm = (torch.rand(d, device=dev, generator=gen) + 0.5).to(torch.bfloat16)
    go = torch.randn(B, S, d, device=dev, generator=gen).to(torch.bfloat16)
    return y, xbc[..., :d].reshape(B, S, H, P), z[..., :d], D, norm, go


def _gate_norm_chain64(y, xs, z, D, norm, eps=1e-5):
    """The epilogue in f64 with no rounding: the gradients' reference."""
    B, S, H, P = xs.shape
    g = (y + D[None, None, :, None] * xs).reshape(B, S, H * P) * torch.nn.functional.silu(z)
    return g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps) * norm


def _bf16_ulp(v):
    """One bf16 spacing at each value of ``v`` (the smallest normal's below it)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,GN", [
    (3, 333, 32, 64, 128),    # mamba2's widths; 999 rows, two a block: a ragged last block
    (1, 257, 128, 64, 128),   # granite's, 512 threads a row
    (1, 129, 256, 64, 128),   # jamba's, 1024 threads a row
    (2, 37, 4, 64, 16),       # the reduced configs: z's rows 8-byte aligned, 8-byte loads
    (3, 41, 16, 24, 16),      # P 24
    (2, 19, 3, 5, 4),         # d 15: one element a load
], ids=["mamba2", "granite", "jamba", "reduced", "P24", "d15"])
def test_cuda_ssd_gate_norm_matches_the_chain(cuda_device, B, S, H, P, GN):
    """The kernel pair on the strided views against the plain chain on the
    card.  Forward: within one bf16 spacing of the chain's output, and
    bit-equal on at least 99 % of it (the row's sum of squares in another
    order moves r by an ulp).  Backward: dy, dxs, dz, dD and dnorm in their
    inputs' dtypes, each with a relative (Frobenius) error against f64
    autograd of the unrounded chain at most 1.1 x the bf16 chain's own
    + 1e-5, as the training flash kernels.  One counted launch each."""
    from repro_torch.kernels import ssd_gate_norm as gn

    y, xs, z, D, norm, go = _gate_norm_inputs(B, S, H, P, GN, cuda_device, B * S + H)
    before = (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches)
    out = gn.ssd_gate_norm(y, xs, z, D, norm)
    got = gn.ssd_gate_norm_bwd(go, y, xs, z, D, norm)
    torch.cuda.synchronize()
    assert (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = gn.ssd_gate_norm_torch(y, xs, z, D, norm)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape and out.is_contiguous()
    diff = (out.float() - want.float()).abs()
    assert bool((diff <= _bf16_ulp(want)).all()), float(diff.max())
    same = float((out == want).float().mean())
    assert same >= 0.99, f"only {same:.4%} of the output bit-equal to the chain"
    leaves = [t.clone().requires_grad_(True) for t in (y, xs, z, D, norm)]
    chain = torch.autograd.grad(gn.ssd_gate_norm_torch(*leaves), leaves, go)
    wide = [t.double().requires_grad_(True) for t in (y, xs, z, D, norm)]
    ref = torch.autograd.grad(_gate_norm_chain64(*wide), wide, go.double())
    errs = {}
    for name, k, c, r, t in zip(("dy", "dxs", "dz", "dD", "dnorm"), got, chain, ref,
                                (y, xs, z, D, norm)):
        assert k.dtype == t.dtype and k.shape == t.shape and torch.isfinite(k).all(), name
        ek = float((k.double() - r).norm() / r.norm())
        ec = float((c.double() - r).norm() / r.norm())
        assert ek <= 1.1 * ec + 1e-5, f"{name}: kernels {ek:.3e} from f64, plain chain {ec:.3e}"
        errs[name] = (ek, ec)
    print(f"\ngate_norm {B}x{S} H={H} P={P}: {same:.4%} of out bit-equal; relative error "
          "kernels / chain " + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items()))


@pytest.mark.gpu
def test_cuda_ssd_gate_norm_is_deterministic(cuda_device):
    """Two calls of each kernel at mamba2's widths give the same bits in
    every output (dnorm and dD summed without atomics)."""
    from repro_torch.kernels import ssd_gate_norm as gn

    y, xs, z, D, norm, go = _gate_norm_inputs(4, 512, 32, 64, 128, cuda_device, 5)
    assert torch.equal(gn.ssd_gate_norm(y, xs, z, D, norm), gn.ssd_gate_norm(y, xs, z, D, norm))
    for a, b in zip(gn.ssd_gate_norm_bwd(go, y, xs, z, D, norm),
                    gn.ssd_gate_norm_bwd(go, y, xs, z, D, norm)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_ssd_gate_norm_route_and_autograd(cuda_device):
    """``ops.ssd_gate_norm`` on the card: bf16 takes the kernels ("kernel",
    one forward and one backward launch under autograd, gradients equal to
    the kernel backward's); f32 and ``impl="torch"`` take the chain
    ("plain", no launch)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_gate_norm as gn

    y, xs, z, D, norm, go = _gate_norm_inputs(2, 64, 8, 64, 16, cuda_device, 6)
    assert ops.ssd_gate_norm_impl(xs) == "kernel"
    assert ops.ssd_gate_norm_impl(xs, impl="torch") == "plain"
    assert ops.ssd_gate_norm_impl(xs.float()) == "plain"
    leaves = [t.clone().requires_grad_(True) for t in (y, xs, z, D, norm)]
    before = (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches)
    grads = torch.autograd.grad(ops.ssd_gate_norm(*leaves), leaves, go)
    assert (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(grads, gn.ssd_gate_norm_bwd(go, y, xs, z, D, norm)):
        assert torch.equal(a, b)
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in (y, xs, z, D, norm)]
    before = (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches)
    out = ops.ssd_gate_norm(*f32)
    assert torch.equal(out, gn.ssd_gate_norm_torch(*f32))
    assert torch.equal(ops.ssd_gate_norm(y, xs, z, D, norm, impl="torch"),
                       gn.ssd_gate_norm_torch(y, xs, z, D, norm))
    assert (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches) == before


@pytest.mark.gpu
def test_cuda_ssd_gate_norm_refuses_before_any_launch(cuda_device):
    """f32 xs, a norm of the wrong width, columns that are not contiguous,
    a gradient of the wrong dtype, CPU tensors: each raises before any
    launch."""
    from repro_torch.kernels import ssd_gate_norm as gn

    y, xs, z, D, norm, go = _gate_norm_inputs(1, 16, 4, 16, 8, cuda_device, 7)
    before = (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches)
    with pytest.raises(TypeError, match="bfloat16"):
        gn.ssd_gate_norm(y, xs.float(), z, D, norm)
    with pytest.raises(ValueError, match="disagree"):
        gn.ssd_gate_norm(y, xs, z, D, norm[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        gn.ssd_gate_norm(y, xs.transpose(2, 3).contiguous().transpose(2, 3), z, D, norm)
    with pytest.raises(ValueError, match="go"):
        gn.ssd_gate_norm_bwd(go.float(), y, xs, z, D, norm)
    with pytest.raises(ValueError, match="CUDA"):
        gn.ssd_gate_norm(y.cpu(), xs.cpu(), z.cpu(), D.cpu(), norm.cpu())
    assert (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches) == before


@pytest.mark.gpu
def test_cuda_ssd_gate_norm_in_a_traced_lm_step(cuda_device):
    """A bf16 reduced mamba2 under full remat, two traced fused steps on the
    card: every SSD layer's spans say ``norm_impl="kernel"``, the forward
    kernel runs once a ``fwd`` and ``recompute`` pass and the backward
    once a ``bwd`` pass, and no step's loss is non-finite."""
    import dataclasses

    from repro_torch.configs import CodingConfig, TrainConfig, get_config
    from repro_torch.data.pipeline import SyntheticData
    from repro_torch.kernels import ssd_gate_norm as gn
    from repro_torch.models.lm import build_model
    from repro_torch.obs import Tracer
    from repro_torch.train.trainer import CodedTrainer

    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), remat="full",
                              dtype="bfloat16")
    tracer = Tracer()
    tr = CodedTrainer(build_model(cfg), CodingConfig(scheme="heter_aware", s=1),
                      TrainConfig(), m=4, part_mb=2, device=cuda_device, trace=tracer)
    data = SyntheticData(cfg, k=tr.k, part_mb=2, seq_len=64, seed=0)
    state = tr.init_state(0)
    before = (gn.ssd_gate_norm.launches, gn.ssd_gate_norm_bwd.launches)
    for i in range(2):
        state, met = tr.step(state, data.batch(i))
        assert np.isfinite(met["loss"])
    spans = [r for r in tracer.records("span")
             if r["name"] == "device.mixer" and r["args"]["kind"] == "ssd"]
    passes = {p: sum(r["args"]["pass"] == p for r in spans) for p in ("fwd", "recompute", "bwd")}
    assert {r["args"]["norm_impl"] for r in spans} == {"kernel"}
    assert passes["bwd"] == 2 * cfg.n_layers
    assert (gn.ssd_gate_norm.launches - before[0], gn.ssd_gate_norm_bwd.launches - before[1]) == (
        passes["fwd"] + passes["recompute"], passes["bwd"])
