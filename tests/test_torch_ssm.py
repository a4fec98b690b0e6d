"""The port's SSD scan and mamba2 block against the JAX package.

Inputs are made with numpy from a seed and fed to both sides.  On the CPU
the port's ``ssd_scan`` runs its plain version, the chunked algorithm
``ssd_scan_torch`` (re-exported as ``models.ssm.ssd_chunked``); it is held
against JAX ``ssd_chunked`` (rtol 1e-5, and atol 1e-6 of the largest
|value| for entries near zero: the same algorithm in f32), and against
the sequential oracles of both packages (the port's ``ssd_ref``, JAX's
``ssd_ref`` and ``ssd_sequential``) and the
interpret-mode Pallas kernel (atol 1e-4 / rtol 1e-3, the tolerance of
tests/test_kernels.py: a different summation order).  The CUDA kernel is
held against the plain version on the card, in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan, ssd_scan_torch
from repro_torch.models import ssm

torch.set_num_threads(2)

# (S, H, P, N) of tests/test_kernels.py:160, each with G in {1, 2, H}
_DIMS = [(32, 2, 8, 16), (64, 4, 16, 32), (64, 4, 8, 8)]
_SHAPES = sorted({(S, H, G, P, N) for S, H, P, N in _DIMS for G in (1, 2, H)})


def _inputs(B, S, H, G, P, N, seed, h0=False):
    """x·dt, dt·A, B, C (and h0) as numpy f32, the draws of tests/test_kernels.py."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, S, H, P)).astype(np.float32)
    dt = r.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32)
    A = -r.uniform(0.3, 2.0, size=(H,)).astype(np.float32)
    Bm = r.normal(size=(B, S, G, N)).astype(np.float32)
    Cm = r.normal(size=(B, S, G, N)).astype(np.float32)
    out = [x * dt[..., None], dt * A, Bm, Cm]
    if h0:
        out.append(r.normal(size=(B, H, P, N)).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("S,H,G,P,N", _SHAPES)
def test_plain_matches_jax_ssd_chunked(S, H, G, P, N, chunk, with_h0):
    arrs = _inputs(2, S, H, G, P, N, seed=S + H + G + chunk, h0=with_h0)
    jy, jh = jssm.ssd_chunked(*_j(arrs[:4]), chunk, *(_j(arrs[4:]) or [None]))
    for fn in (ssd_scan_torch, ssm.ssd_chunked):
        ty, th = fn(*_t(arrs[:4]), chunk, *(_t(arrs[4:]) or [None]))
        assert ty.dtype == th.dtype == torch.float32
        for t, j in ((ty, jy), (th, jh)):
            j = np.asarray(j)  # atol for entries near zero: 1e-6 of the largest
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6 * np.abs(j).max())
    # the sequential oracle from the same initial state, in both packages
    sy, sh = tref.ssd_ref(*_t(arrs[:4]), *(_t(arrs[4:]) or [None]))
    jsy, jsh = jssm.ssd_sequential(*_j(arrs[:4]), *(_j(arrs[4:]) or [None]))
    for t, j in ((sy, jsy), (sh, jsh), (sy, jy), (sh, jh)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("S,H,G,P,N", [(32, 2, 1, 8, 16), (64, 4, 2, 16, 32), (64, 4, 4, 8, 8)])
def test_plain_matches_sequential_oracles_and_pallas(S, H, G, P, N, seed):
    arrs = _inputs(2, S, H, G, P, N, seed)
    ty, th = ssd_scan(*_t(arrs), S // 4)  # the wrapper on CPU tensors: the plain version
    expects = [
        tref.ssd_ref(*_t(arrs)),
        jssm.ssd_sequential(*_j(arrs)),
        jref.ssd_ref(*_j(arrs)),
        jops.ssd_scan(*_j(arrs), chunk=S // 4, impl="pallas_interpret"),
    ]
    for ey, eh in expects:
        np.testing.assert_allclose(ty.numpy(), np.asarray(ey), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(th.numpy(), np.asarray(eh), atol=1e-4, rtol=1e-3)
    # the two sequential oracles are the same recurrence
    np.testing.assert_allclose(expects[0][0].numpy(), np.asarray(expects[2][0]), rtol=1e-5, atol=1e-6)


def test_model_drawn_dA_stays_finite_and_agrees():
    """dA as mamba2-370m draws it (A = -exp(log(1..32)), dt = softplus of a
    unit normal plus the init's dt_bias), chunk 256: cumsum(dA) falls to
    hundreds below zero, exp of the masked triangle would be +inf.  Both
    sides stay finite and agree within 1e-3 of max|y|: the decay is exp of
    a difference of cumulative sums, which the two frameworks round in
    different orders (the f32 spacing at |cumsum| = 800 is 6e-5)."""
    r = np.random.default_rng(7)
    B, S, H, G, P, N, chunk = 1, 512, 32, 1, 8, 16, 256
    dt0 = np.exp(r.uniform(size=H) * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(r.normal(size=(B, S, H)) + dt_bias, 0.0).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, H + 1, dtype=np.float32)))
    x = r.normal(size=(B, S, H, P)).astype(np.float32)
    arrs = [x * dt[..., None], (dt * A).astype(np.float32),
            r.normal(size=(B, S, G, N)).astype(np.float32),
            r.normal(size=(B, S, G, N)).astype(np.float32)]
    assert arrs[1].reshape(B, -1, chunk, H).cumsum(2).min() < -300
    ty, th = ssd_scan_torch(*_t(arrs), chunk)
    jy, jh = jssm.ssd_chunked(*_j(arrs), chunk)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    assert np.isfinite(np.asarray(jy)).all() and np.isfinite(np.asarray(jh)).all()
    for t, j in ((ty, jy), (th, jh)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-3 * np.abs(j).max()


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_causal_conv_matches_jax(with_state):
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 11, 24)).astype(np.float32)
    w = r.normal(size=(4, 24)).astype(np.float32)
    b = r.normal(size=(24,)).astype(np.float32)
    st = r.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    jo, jst = jssm._causal_conv(*_j([x, w, b]), None if st is None else jnp.asarray(st))
    to, tst = ssm._causal_conv(*_t([x, w, b]), None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("S", [16, 13], ids=["chunk-multiple", "padded"])
def test_mamba_forward_matches_jax(S):
    """The reduced mamba2 block (d_model 128, d_inner 256, 4 heads, N 16,
    chunk 8) at the JAX init's weights; S=13 takes the padding path."""
    cfg = jget_config("mamba2-370m").reduced()
    kw = dict(d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), cfg.d_model, conv_kernel=cfg.conv_kernel, **kw)
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jout, _ = jssm.mamba_forward(jp, jnp.asarray(x), chunk=cfg.ssm_chunk, **kw)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tout, cache = ssm.mamba_forward(tp, torch.from_numpy(x), chunk=cfg.ssm_chunk, **kw)
    assert tout.shape == (2, S, cfg.d_model) and cache is None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def test_init_mamba_matches_jax_layout_and_deterministic_leaves():
    cfg = get_config("mamba2-370m").reduced()
    kw = dict(d_inner=cfg.ssm_d_inner, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups, conv_kernel=cfg.conv_kernel)
    jp = jssm.init_mamba(jax.random.PRNGKey(0), cfg.d_model, **kw)
    tp = ssm.init_mamba(torch.Generator().manual_seed(0), 3, cfg.d_model, device="cpu", **kw)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.shape == (3, *jp[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jp[k].dtype), k
    for k in ("A_log", "D", "norm", "conv_b"):
        for row in tp[k]:
            np.testing.assert_array_equal(row.numpy(), np.asarray(jp[k]))
    sp = torch.nn.functional.softplus(tp["dt_bias"])  # the inverse softplus of dt
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5) and float(sp.max()) <= 0.1 * (1 + 1e-5)


def _grad_case(bc_dtype, seed=5):
    arrs = _inputs(2, 32, 4, 2, 8, 16, seed)
    x, dA, Bm, Cm = _t(arrs)
    return x, dA, Bm.to(bc_dtype), Cm.to(bc_dtype)


@pytest.mark.parametrize("use_h", [False, True], ids=["y-only", "y-and-h"])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_fn_matches_plain_autograd(bc_dtype, use_h):
    """SSDScanFn with its forward handed the plain version: y and the grads
    of x, dA, Bm and Cm equal plain autograd's (the backward recomputes the
    same plain function, so they are bit-equal on the CPU)."""
    r = np.random.default_rng(9)
    gy = torch.from_numpy(r.normal(size=(2, 32, 4, 8)).astype(np.float32))
    gh = torch.from_numpy(r.normal(size=(2, 4, 8, 16)).astype(np.float32))
    results = []
    for via_fn in (True, False):
        ins = [t.clone().requires_grad_(True) for t in _grad_case(bc_dtype)]
        if via_fn:
            y, h = SSDScanFn.apply(*ins, 8, ssd_scan_torch)
        else:
            y, h = ssd_scan_torch(*ins, 8)
        loss = (y * gy).sum() + ((h * gh).sum() if use_h else 0.0)
        grads = torch.autograd.grad(loss, ins)
        results.append((y.detach(), grads))
    (y1, g1), (y2, g2) = results
    assert torch.equal(y1, y2)
    for a, b, t in zip(g1, g2, _grad_case(bc_dtype)):
        assert a.dtype == t.dtype
        assert torch.equal(a, b)


def test_ops_ssd_scan_dispatch_on_cpu():
    x, dA, Bm, Cm = _grad_case(torch.float32)
    before = ssd_scan.launches
    y, h = ops.ssd_scan(x, dA, Bm, Cm, chunk=8)
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, 8)
    assert torch.equal(y, py) and torch.equal(h, ph)
    y, h = ops.ssd_scan(x, dA, Bm, Cm, chunk=8, impl="torch")
    assert torch.equal(y, py)
    assert ssd_scan.launches == before  # the plain version never counts
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(x, dA, Bm, Cm, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="divisible"):
        ssd_scan(x, dA, Bm, Cm, 7)
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_scan(x, dA[:, :16], Bm, Cm, 8)
