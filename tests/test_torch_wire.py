"""The port's int8 wire against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions.  Held here:

  - the plain encode is BIT-equal to the JAX package's numpy oracle
    (``repro.kernels.ref.encode_int8_oracle_np``) when the oracle's reduce is
    the port's own plain ``coded_reduce`` (f32 out), over the sweep, edge
    shapes, zero input and error-feedback chains of tests/test_wire_kernels.py;
  - the port's copy of the oracle is bit-equal to the JAX one;
  - the plain encode and decode agree with the Pallas kernels in interpret
    mode (the reduce sums in another order there, hence the tolerances);
  - error feedback, NaN propagation, ``remap_err_rows``, the wrappers'
    argument checks and the format's constants;
  - the port's spmd engine with ``compress`` against the JAX spmd engine.

The JAX spmd backend needs m devices, so its side runs in a subprocess of
this file (``python tests/test_torch_wire.py OUT.npz``) with
``--xla_force_host_platform_device_count=4`` set before JAX starts.  The
CUDA kernels are held against the oracle on the card in
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # image without hypothesis: seeded-random fallback
    from _hypothesis_compat import given, settings, st

from repro.core.aggregator import remap_err_rows as jremap_err_rows
from repro.kernels import ref as jref
from repro.kernels import wire as jwire
from repro.kernels.coded_reduce import coded_reduce_pallas
from repro_torch.configs.base import TrainConfig
from repro_torch.core import Codec, get_scheme
from repro_torch.core.aggregator import remap_err_rows
from repro_torch.kernels import ops, wire
from repro_torch.kernels import ref as tref
from repro_torch.kernels.coded_reduce import coded_reduce
from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import StepEngine

torch.set_num_threads(2)

_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _port_reduce(g, w):
    """The port's plain reduce with an f32 result: the reduce the plain
    encode runs, so the oracle's accumulation order matches bit for bit."""
    return coded_reduce(g, w, torch.float32)


def _inputs(P, D, dt, seed, err_scale=1e-3):
    r = np.random.default_rng(seed)
    g = torch.from_numpy(r.normal(size=(P, D)).astype(np.float32)).to(_TDT[dt])
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32))
    err = torch.from_numpy(r.normal(scale=err_scale, size=(D,)).astype(np.float32))
    return g, w, err


def _assert_plain_bit_equal(g, w, err):
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    oq, oscale, onew = jref.encode_int8_oracle_np(g, w, err, reduce_fn=_port_reduce)
    assert q.dtype == torch.int8 and scale.shape == () and new_err.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), oq)
    assert scale.numpy().tobytes() == np.float32(oscale).tobytes(), (scale, oscale)
    assert new_err.numpy().tobytes() == onew.tobytes(), (
        np.flatnonzero(new_err.numpy().view(np.int32) != onew.view(np.int32))[:8])


# ---------------------------------------------------------------------------
# (a) the plain encode, bit-equal to the JAX oracle
# ---------------------------------------------------------------------------


@given(
    st.integers(1, 130),
    st.integers(1, 4200),
    st.sampled_from(["f32", "bf16"]),
    st.integers(0, 100),
)
@settings(max_examples=20, deadline=None)
def test_plain_encode_bit_equal_sweep(P, D, dt, seed):
    _assert_plain_bit_equal(*_inputs(P, D, dt, seed))


@pytest.mark.parametrize(
    "P,D",
    [(8, 512), (8, 513), (1, 1), (1, 7), (7, 511), (2, 129), (20, 4097),
     (128, 128), (130, 1025)],
)
def test_plain_encode_bit_equal_edge_shapes(P, D):
    _assert_plain_bit_equal(*_inputs(P, D, "f32", P * 1000 + D, err_scale=1e-2))


def test_plain_encode_bit_equal_zero_coded():
    """An all-zero coded tensor takes the EPS_SCALE floor."""
    g, w, err = torch.zeros(4, 100), torch.zeros(4), torch.zeros(100)
    _assert_plain_bit_equal(g, w, err)
    q, scale, _ = wire.coded_encode_int8(g, w, err)
    assert not q.any()
    assert scale.numpy().tobytes() == (np.float32(1e-12) * np.float32(1.0 / 127.0)).tobytes()


def test_plain_encode_error_feedback_chain_bit_equal():
    """Six encode steps threading new_err back in stay bit-identical to the
    oracle along the whole chain."""
    r = np.random.default_rng(3)
    P, D = 6, 777
    w = torch.from_numpy(r.normal(size=(P,)).astype(np.float32))
    err_k = torch.zeros(D)
    err_o = np.zeros((D,), np.float32)
    for step in range(6):
        g = torch.from_numpy(r.normal(size=(P, D)).astype(np.float32))
        q, _, err_k = wire.coded_encode_int8(g, w, err_k)
        oq, _, err_o = jref.encode_int8_oracle_np(g, w, err_o, reduce_fn=_port_reduce)
        np.testing.assert_array_equal(q.numpy(), oq, err_msg=f"step {step}")
        assert err_k.numpy().tobytes() == err_o.tobytes(), f"step {step}"


# ---------------------------------------------------------------------------
# (b) the port's oracle == the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,D,dt", [(1, 1, "f32"), (5, 4095, "f32"), (130, 1025, "bf16"),
                                    (3, 2048, "bf16")])
def test_port_oracle_bit_equal_to_jax_oracle(P, D, dt):
    g, w, err = _inputs(P, D, dt, 17 + P)
    ours = tref.encode_int8_oracle_np(g, w, err, reduce_fn=_port_reduce)
    theirs = jref.encode_int8_oracle_np(g, w, err, reduce_fn=_port_reduce)
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# (c), (d) against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _assert_residual_exact(q, scale, new_err, coded):
    """dequantize(q, scale) + new_err == coded to within new_err's one
    rounding: at most half an ulp of |new_err| <= scale / 2."""
    recon = q.astype(np.float64) * np.float64(scale) + new_err.astype(np.float64)
    assert np.all(np.abs(recon - coded.astype(np.float64)) <= np.spacing(np.float32(scale)))


@pytest.mark.parametrize("P,D,dt", [(4, 900, "f32"), (8, 513, "f32"), (130, 1025, "f32"),
                                    (6, 2000, "bf16")])
def test_plain_encode_matches_pallas_interpret(P, D, dt):
    """The Pallas reduce sums in another order (a dot), so coded differs by
    an ulp here and there: the scale agrees to rtol 1e-6, at most 1 % of the
    q entries move, by at most 1, and each side's residual is exact."""
    g, w, err = _inputs(P, D, dt, 40 + P)
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    gj = jnp.asarray(g.float().numpy(), _JDT[dt])
    wj, ej = jnp.asarray(w.numpy()), jnp.asarray(err.numpy())
    jq, js, je = (np.asarray(x) for x in jwire.coded_encode_int8_pallas(gj, wj, ej, interpret=True))
    np.testing.assert_allclose(float(scale), float(js), rtol=1e-6)
    dq = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert dq.max() <= 1 and np.mean(dq > 0) <= 0.01
    coded = (_port_reduce(g, w) + err).numpy()
    _assert_residual_exact(q.numpy(), scale.numpy(), new_err.numpy(), coded)
    jcoded = np.asarray(coded_reduce_pallas(gj, wj, interpret=True, out_dtype=jnp.float32)
                        ) + err.numpy()
    _assert_residual_exact(jq, js, je, jcoded.astype(np.float32))


def test_plain_decode_matches_pallas_interpret():
    """decode(stacked int8 wire) == Σ_w a_w·scale_w·q_w to f32 accuracy
    (the pattern of test_decode_roundtrip_matches_dequantized_truth)."""
    r = np.random.default_rng(5)
    m, P, D = 10, 3, 1500
    a = r.normal(size=(m,)).astype(np.float32)
    qs, ws = [], []
    truth = np.zeros((D,), np.float64)
    for i in range(m):
        g, w, _ = _inputs(P, D, "f32", 500 + i)
        q, scale, _ = wire.coded_encode_int8(g, w, torch.zeros(D))
        qs.append(q)
        ws.append(a[i] * scale.numpy())
        truth += np.float64(a[i] * scale.numpy()) * q.numpy().astype(np.float64)
    q_all = torch.stack(qs)
    ws_t = torch.from_numpy(np.asarray(ws, np.float32))
    out = wire.coded_decode_int8(q_all, ws_t)
    assert out.dtype == torch.float32 and out.shape == (D,)
    expect = np.asarray(jwire.coded_decode_int8_pallas(
        jnp.asarray(q_all.numpy()), jnp.asarray(ws_t.numpy()), interpret=True))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), truth, rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.coded_decode_int8(q_all, ws_t), out)


# ---------------------------------------------------------------------------
# (e) error feedback, (f) NaN
# ---------------------------------------------------------------------------


def test_error_feedback_reduces_quantization_bias():
    """With feedback on, the running mean of dequantized encodes converges
    to the true coded value: its bias falls below 0.2x the one-shot bias."""
    g, w, _ = _inputs(4, 2048, "f32", 9)
    true = _port_reduce(g, w).double().numpy()
    err = torch.zeros(2048)
    acc = np.zeros((2048,), np.float64)
    n = 20
    for _ in range(n):
        q, scale, err = wire.coded_encode_int8(g, w, err)
        acc += q.numpy().astype(np.float64) * float(scale)
    q1, s1, _ = wire.coded_encode_int8(g, w, torch.zeros(2048))
    bias_one = float(np.abs(q1.numpy().astype(np.float64) * float(s1) - true).mean())
    bias = float(np.abs(acc / n - true).mean())
    assert bias < 0.2 * bias_one, (bias, bias_one)


def test_nan_in_g_gives_nan_scale_and_decode():
    """A NaN anywhere in the coded gradient reaches the decode as a NaN
    scale, which poisons every decoded element (the trainer's non-finite
    guard relies on it)."""
    g, w, err = _inputs(3, 1000, "f32", 2)
    g[1, 517] = float("nan")
    q, scale, new_err = wire.coded_encode_int8(g, w, err)
    assert torch.isnan(scale) and torch.isnan(new_err).all()
    q_ok, s_ok, _ = wire.coded_encode_int8(*_inputs(3, 1000, "f32", 3))
    ws = torch.stack([s_ok * 0.5, scale * 0.0])  # even a zero decode weight
    out = wire.coded_decode_int8(torch.stack([q_ok, q]), ws)
    assert torch.isnan(out).all()


# ---------------------------------------------------------------------------
# (g) remap_err_rows, (h) wrapper checks, (i) constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("old_of_new", [[0, 2, None, 4], [None, None], [3, 1, 0, 2, 4],
                                        [4], [1, None, 3, None, 0, 2]])
def test_remap_err_rows_bit_equal_to_jax(old_of_new):
    err = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    ours = remap_err_rows(torch.from_numpy(err), old_of_new).numpy()
    theirs = np.asarray(jremap_err_rows(jnp.asarray(err), old_of_new))
    assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
    for i, o in enumerate(old_of_new):
        np.testing.assert_array_equal(ours[i], 0.0 if o is None else err[o])


def test_remap_err_rows_rejects_out_of_range():
    with pytest.raises(ValueError):
        remap_err_rows(torch.zeros(3, 2), [0, 4])
    with pytest.raises(ValueError):
        remap_err_rows(torch.zeros(3, 2), [-1])


def test_wrappers_reject_bad_arguments_and_count_no_launches_on_cpu():
    g, w, err = torch.zeros(3, 10), torch.zeros(3), torch.zeros(10)
    bad = [
        ((g, torch.zeros(4), err), {}, ValueError),
        ((torch.zeros(10), w, err), {}, ValueError),
        ((torch.zeros(0, 10), torch.zeros(0), err), {}, ValueError),
        ((g.double(), w, err), {}, TypeError),
        ((g, w, torch.zeros(9)), {}, ValueError),
        ((g, w, err.double()), {}, ValueError),
        ((g, w, err), {"out_err": torch.zeros(9)}, ValueError),
        ((g, w, err), {"out_q": torch.zeros(10)}, ValueError),
    ]
    buf = torch.zeros(20)
    bad.append(((g, w, buf[:10]), {"out_err": buf[5:15]}, ValueError))  # partial overlap
    for args, kw, exc in bad:
        with pytest.raises(exc):
            wire.coded_encode_int8(*args, **kw)
    for args, exc in [((torch.zeros(3, 10, dtype=torch.int8), torch.zeros(4)), ValueError),
                      ((torch.zeros(3, 10), torch.zeros(3)), TypeError),
                      ((torch.zeros(10, dtype=torch.int8), torch.zeros(1)), ValueError)]:
        with pytest.raises(exc):
            wire.coded_decode_int8(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ops.coded_encode_int8(g, w, err, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.coded_decode_int8(torch.zeros(3, 10, dtype=torch.int8), w, impl="cuda")
    # in place: out_err=err updates err itself, with the out-of-place bits
    g, w, err = _inputs(5, 333, "f32", 8)
    q0, s0, e0 = wire.coded_encode_int8(g, w, err)
    q_buf = torch.empty(333, dtype=torch.int8)
    q1, s1, e1 = wire.coded_encode_int8(g, w, err, out_err=err, out_q=q_buf)
    assert e1 is err and q1 is q_buf
    assert torch.equal(q0, q1) and torch.equal(s0, s1) and e0.numpy().tobytes() == err.numpy().tobytes()
    ops.coded_encode_int8(g, w, e0, impl="torch")
    assert wire.coded_encode_int8.launches == wire.coded_decode_int8.launches == 0
    assert coded_reduce.launches == 0


def test_format_constants_have_the_reference_bits():
    inv = np.float32(1.0 / 127.0)
    for c in (np.float32(wire.INV_127), np.float32(jwire.INV_127), tref._INV_127):
        assert c.tobytes() == inv.tobytes()
    for c in (np.float32(wire.EPS_SCALE), np.float32(jwire.EPS_SCALE), tref._EPS):
        assert c.tobytes() == np.float32(1e-12).tobytes()
    # the plain quantize multiplies by that constant
    x = torch.tensor([127.0, -3.0, 0.5])
    q, scale = tref.quantize_int8(x)
    assert scale.numpy().tobytes() == (np.float32(127.0) * inv).tobytes()
    assert q.tolist() == [127, -3, 0]  # 0.5 / scale rounds half to even


# ---------------------------------------------------------------------------
# the spmd engine with compress, against the JAX spmd engine
# ---------------------------------------------------------------------------

M, K = 4, 8
SPEEDS = [1.0, 2.0, 3.0, 2.0]
CALLS = 3


def _toy_params():
    r = np.random.default_rng(0)
    return {"w1": r.normal(size=(4, 16)).astype(np.float32),
            "w2": r.normal(size=(16, 1)).astype(np.float32)}


def _toy_batch(call):
    r = np.random.default_rng(100 + call)
    return {"x": r.normal(size=(K, 2, 4)).astype(np.float32),
            "y": r.normal(size=(K, 2)).astype(np.float32)}


def _codec(get_scheme_fn, codec_cls, scheme):
    return codec_cls(get_scheme_fn(scheme, m=M, k=K, s=1, c=SPEEDS, rng=0))


def _outcome(codec, kind):
    if kind == "exact":
        return codec.decode_outcome([0, 2, 3])
    support = (np.random.default_rng(7).uniform(size=(codec.m, codec.k)) < 0.6).astype(np.float64)
    return codec.decode_partial(support)


CASES = [("heter_aware", "exact"), ("partial_work", "partial")]


def _jax_side(out_path):
    """Runs in the subprocess, with 4 host devices: the JAX spmd engine's
    decoded gradients and error-feedback buffers, per case and call."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core import Codec as JCodec
    from repro.core import get_scheme as jget_scheme
    from repro.launch.mesh import make_auto_mesh
    from repro.train.elastic import ElasticController as JElastic
    from repro.train.engine import StepEngine as JStepEngine

    assert len(jax.devices()) >= M, jax.devices()

    class Toy:
        def weighted_loss(self, params, batch):
            pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
            return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])

    mesh = make_auto_mesh((M, 1), ("data", "model"))
    params = {k: jnp.asarray(v) for k, v in _toy_params().items()}
    out = {}
    for scheme, kind in CASES:
        for wk in (True, False):
            codec = _codec(jget_scheme, JCodec, scheme)
            eng = JStepEngine(Toy(), JTrainConfig(), codec, backend="spmd", mesh=mesh,
                              compress=True, wire_kernel=wk)
            outcome = _outcome(codec, kind)
            for call in range(CALLS):
                g = eng.gradients(params, _toy_batch(call), outcome)
                tag = f"{scheme}/{wk}/{call}"
                for key, v in g.items():
                    out[f"{tag}/{key}"] = np.asarray(v)
                out[f"{tag}/err"] = np.asarray(eng._err)
    # one membership transition (leave 1, then a joiner) between calls
    codec = _codec(jget_scheme, JCodec, "heter_aware")
    eng = JStepEngine(Toy(), JTrainConfig(), codec, backend="spmd", mesh=mesh,
                      compress=True, wire_kernel=True)
    ctl = JElastic(codec, true_speeds=SPEEDS, c_init=SPEEDS)
    ctl.pre_transition, ctl.on_transition = eng.check_membership, eng.note_membership
    for call in range(2):
        eng.gradients(params, _toy_batch(call), codec.decode_outcome(range(M)))
    ctl.remove_workers([1])
    ctl.add_workers([1.5], c_init=[1.5])
    eng.rebuild()  # carry the rows now, to record them before the step
    out["churn/err_prev"] = np.asarray(eng._err)
    g = eng.gradients(params, _toy_batch(2), codec.decode_outcome(range(codec.m)))
    for key, v in g.items():
        out[f"churn/{key}"] = np.asarray(v)
    out["churn/err"] = np.asarray(eng._err)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_spmd(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_spmd") / "grads.npz"
    root = Path(__file__).resolve().parents[1]
    # single-threaded XLA: the toy is tiny, and the suite's other workers
    # share the host's cores
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={M} "
                        "--xla_cpu_multi_thread_eigen=false",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=root,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return dict(f)


class _TToy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _port_engine(codec, wire_kernel):
    return StepEngine(_TToy(), TrainConfig(), codec, backend="spmd", device="cpu",
                      compress=True, wire_kernel=wire_kernel)


def _params():
    return {k: torch.from_numpy(v) for k, v in _toy_params().items()}


# The two frameworks differentiate the toy and sum the reduces in other
# orders, so each worker's coded gradient differs in its last bits.  Where a
# coded value sits at a rounding boundary of coded/scale, q rounds the other
# way in one framework: that element of the decoded gradient moves by
# (a_w/k)·scale_w and the worker's residual by scale_w the other way.  Error
# feedback keeps decoded + Σ_w (a_w/k)·(err_w − err_w before the call) equal
# to the uncompressed decode whichever way q rounds, so that sum is held at
# rtol 1e-4 / atol 2e-5 (the JAX package's own bound between its fused and
# unfused quantize, in its spmd test check_engine_spmd_wire), and the
# decoded gradient alone within the wire's compression tolerance, 0.05 of
# its max.
_RTOL, _ATOL = 1e-4, 2e-5
_KEYS = ("w1", "w2")  # the flat order of both packages' ravel


def _assert_same_wire(ours, theirs, a_over_k, msg):
    """``ours``/``theirs``: (decoded grads, err after, err before) of one call."""
    flat = [np.concatenate([np.asarray(g[k], np.float64).ravel() for k in _KEYS])
            for g, _, _ in (ours, theirs)]
    u = [f + a_over_k @ (np.asarray(e, np.float64) - np.asarray(e0, np.float64))
         for f, (_, e, e0) in zip(flat, (ours, theirs))]
    np.testing.assert_allclose(u[0], u[1], rtol=_RTOL, atol=_ATOL,
                               err_msg=f"{msg}: decoded + decoded residual")
    np.testing.assert_allclose(flat[0], flat[1], rtol=0, atol=0.05 * np.abs(flat[1]).max(),
                               err_msg=f"{msg}: decoded")


@pytest.mark.parametrize("wire_kernel", [True, False], ids=["wire_on", "wire_off"])
@pytest.mark.parametrize("scheme,kind", CASES)
def test_compressed_spmd_engine_matches_jax(jax_spmd, scheme, kind, wire_kernel):
    codec = _codec(get_scheme, Codec, scheme)
    eng = _port_engine(codec, wire_kernel)
    assert eng.wire_kernel is wire_kernel and eng.compress
    outcome = _outcome(codec, kind)
    assert (kind == "exact") == bool(outcome.exact)
    a_over_k = np.asarray(outcome.a, np.float64) / codec.k
    params = _params()
    prev = np.zeros((M, 4 * 16 + 16), np.float32)
    jprev = prev
    for call in range(CALLS):
        g = eng.gradients(params, _toy_batch(call), outcome)
        tag = f"{scheme}/{wire_kernel}/{call}"
        err = eng._err.numpy().copy()
        assert err.shape == prev.shape
        theirs = ({k: jax_spmd[f"{tag}/{k}"] for k in _KEYS}, jax_spmd[f"{tag}/err"], jprev)
        _assert_same_wire((g, err, prev), theirs, a_over_k, tag)
        prev, jprev = err, jax_spmd[f"{tag}/err"]
    assert float(eng._err.abs().max()) > 0


def test_membership_transition_carries_err_rows(jax_spmd):
    codec = _codec(get_scheme, Codec, "heter_aware")
    eng = _port_engine(codec, True)
    ctl = ElasticController(codec, true_speeds=SPEEDS, c_init=SPEEDS)
    ctl.pre_transition, ctl.on_transition = eng.check_membership, eng.note_membership
    params = _params()
    for call in range(2):
        eng.gradients(params, _toy_batch(call), codec.decode_outcome(range(M)))
    before = eng._err.clone()
    ctl.remove_workers([1])
    ctl.add_workers([1.5], c_init=[1.5])
    assert eng._row_map == [0, 2, 3, None] and codec.m == M
    eng._sync_err(eng._view.size)  # what the next spmd step does first
    after = eng._err.numpy().copy()
    for new, old in enumerate([0, 2, 3]):
        assert after[new].tobytes() == before[old].numpy().tobytes()
    assert not after[3].any() and not jax_spmd["churn/err_prev"][3].any()
    outcome = codec.decode_outcome(range(codec.m))
    g = eng.gradients(params, _toy_batch(2), outcome)
    theirs = ({k: jax_spmd[f"churn/{k}"] for k in _KEYS}, jax_spmd["churn/err"],
              jax_spmd["churn/err_prev"])
    _assert_same_wire((g, eng._err.numpy(), after), theirs,
                      np.asarray(outcome.a, np.float64) / codec.k, "churn")


def test_pure_rebalance_keeps_err_and_reset_zeroes_it():
    codec = _codec(get_scheme, Codec, "heter_aware")
    eng = _port_engine(codec, True)
    params = _params()
    eng.gradients(params, _toy_batch(0), codec.decode_outcome(range(M)))
    before = eng._err.clone()
    codec.rebalance(np.array([2.0, 1.0, 1.0, 3.0]))
    assert eng._err_version != codec.version
    eng._sync_err(eng._view.size)
    assert torch.equal(eng._err, before)
    eng.reset_error_feedback()
    assert not eng._err.any()


if __name__ == "__main__":
    _jax_side(sys.argv[1])
