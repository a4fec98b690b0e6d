"""The port's coded_reduce against the JAX package's kernel and oracle.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against ``coded_reduce_pallas`` in interpret mode and ``ref.coded_reduce_ref``
at the shapes and tolerances of tests/test_kernels.py (f32 1e-5, bf16 5e-2,
int8 input with f32 output).  The CUDA kernel itself is held against the
plain version in tests/test_torch_gpu.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.coded_reduce import coded_reduce_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_torch

torch.set_num_threads(2)

_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
_TOL = {"f32": 1e-5, "bf16": 5e-2}


def _inputs(P, D, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=(P, D)).astype(np.float32), r.normal(size=(P,)).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_pallas_and_ref(dt, seed):
    r = np.random.default_rng(100 + seed)
    P, D = int(r.integers(1, 13)), int(r.integers(1, 2001))
    g, w = _inputs(P, D, seed)
    gj, wj = jnp.asarray(g, _JDT[dt]), jnp.asarray(w)
    gt, wt = torch.from_numpy(g).to(_TDT[dt]), torch.from_numpy(w)
    out = coded_reduce(gt, wt)
    assert out.dtype == _TDT[dt] and out.shape == (D,)
    tol = _TOL[dt]
    for expect in (coded_reduce_pallas(gj, wj, interpret=True), jref.coded_reduce_ref(gj, wj)):
        np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tref.coded_reduce_ref(gt, wt)), _np(out), atol=tol, rtol=tol)


@pytest.mark.parametrize("P", [129, 200, 300])
def test_plain_large_P(P):
    g, w = _inputs(P, 1100, P)
    out = coded_reduce(torch.from_numpy(g), torch.from_numpy(w))
    expect = coded_reduce_pallas(jnp.asarray(g), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(_np(out), _np(expect), atol=1e-4, rtol=1e-4)


def test_plain_int8_input_f32_output():
    """The int8 wire decode: int8 payloads, f32 weights, f32 result."""
    r = np.random.default_rng(7)
    q = r.integers(-127, 128, size=(6, 1500)).astype(np.int8)
    ws = (r.normal(size=(6,)) * 1e-2).astype(np.float32)
    out = coded_reduce(torch.from_numpy(q), torch.from_numpy(ws), torch.float32)
    expect = coded_reduce_pallas(jnp.asarray(q), jnp.asarray(ws), interpret=True,
                                 out_dtype=jnp.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(expect), atol=1e-5, rtol=1e-5)


def test_plain_is_the_encode():
    """kernel(g, B_row) == the paper's encode of per-partition gradients."""
    from repro_torch.core import build_heter_aware

    sch = build_heter_aware(8, 1, [1, 2, 2, 3], rng=0)
    part_grads = np.random.default_rng(0).normal(size=(8, 300)).astype(np.float32)
    parts = list(sch.allocation.partitions[3])
    coded = coded_reduce(torch.from_numpy(part_grads[parts]),
                         torch.from_numpy(sch.B[3, parts].astype(np.float32)))
    np.testing.assert_allclose(_np(coded), sch.B[3] @ part_grads, atol=1e-4)


def test_dispatch_takes_plain_version_on_cpu():
    g, w = _inputs(5, 333, 1)
    gt, wt = torch.from_numpy(g), torch.from_numpy(w)
    before = coded_reduce.launches
    a = ops.coded_reduce(gt, wt)
    b = ops.coded_reduce(gt, wt, impl="torch")
    out = torch.empty(333)
    c = coded_reduce(gt, wt, out=out)
    assert c is out
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(a, coded_reduce_torch(gt, wt))
    assert coded_reduce.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.coded_reduce(gt, wt, impl="cuda")


def test_wrapper_rejects_bad_arguments():
    g = torch.zeros(3, 10)
    with pytest.raises(ValueError):
        coded_reduce(g, torch.zeros(4))
    with pytest.raises(ValueError):
        coded_reduce(torch.zeros(0, 10), torch.zeros(0))
    with pytest.raises(TypeError):
        coded_reduce(torch.zeros(3, 10, dtype=torch.int8), torch.zeros(3))  # int8 out
    with pytest.raises(TypeError):
        coded_reduce(torch.zeros(3, 10, dtype=torch.float64), torch.zeros(3))
    with pytest.raises(ValueError):
        coded_reduce(g, torch.zeros(3), out=torch.empty(9))


def test_nan_weight_poisons_only_its_products():
    """The poisoned-payload contract: a NaN weight gives NaN wherever it
    multiplies; no row is skipped for a zero weight."""
    g = torch.ones(3, 8)
    w = torch.tensor([0.0, float("nan"), 1.0])
    assert torch.isnan(coded_reduce(g, w)).all()
    g2 = torch.ones(2, 4)
    g2[0, 1] = float("inf")
    out = coded_reduce(g2, torch.tensor([0.0, 1.0]))
    assert torch.isnan(out[1]) and torch.isfinite(out[[0, 2, 3]]).all()
