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
from repro_torch.kernels.ssd_scan import (
    SSDScanFn, ssd_scan, ssd_scan_bwd_torch, ssd_scan_torch,
)
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


def _with_saved(x, dA, Bm, Cm, chunk):
    """The plain forward, and one tensor more for its backward to keep."""
    y, h = ssd_scan_torch(x, dA, Bm, Cm, chunk)
    return y, h, torch.zeros(3)


@pytest.mark.parametrize("use_h", [False, True], ids=["gh-absent", "gh-present"])
@pytest.mark.parametrize("forward_fn", [ssd_scan_torch, _with_saved], ids=["plain", "saving"])
def test_ssd_scan_fn_with_the_plain_backward_fn_is_plain_autograd(forward_fn, use_h):
    """SSDScanFn handed ``backward_fn=ssd_scan_bwd_torch`` (and a forward
    that keeps a tensor of its own for the backward, or not): y and the
    grads of x, dA and the bf16 Bm and Cm bit-equal to plain autograd's,
    with the gradient of h present and absent."""
    r = np.random.default_rng(10)
    gy = torch.from_numpy(r.normal(size=(2, 32, 4, 8)).astype(np.float32))
    gh = torch.from_numpy(r.normal(size=(2, 4, 8, 16)).astype(np.float32))
    results = []
    for via_fn in (True, False):
        ins = [t.clone().requires_grad_(True) for t in _grad_case(torch.bfloat16)]
        if via_fn:
            y, h = SSDScanFn.apply(*ins, 8, forward_fn, ssd_scan_bwd_torch)
        else:
            y, h = ssd_scan_torch(*ins, 8)
        outs = [y, h] if use_h else [y]
        grads = torch.autograd.grad(outs, ins, [gy, gh][:len(outs)])
        results.append((y.detach(), grads))
    (y1, g1), (y2, g2) = results
    assert torch.equal(y1, y2)
    for a, b in zip(g1, g2):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ssd_backward_route_on_cpu_is_plain():
    """On the CPU, or with ``impl="torch"``, the scan's backward is autograd
    of the plain version whatever B and C's dtype (the card test
    ``test_cuda_ssd_scan_fn_grads_match_plain`` holds bf16 B and C on the
    card to the kernel backward)."""
    for bc in (torch.float32, torch.bfloat16):
        x, _, Bm, _ = _grad_case(bc)
        assert ops.ssd_backward_impl(x, Bm) == "plain"
        assert ops.ssd_backward_impl(x, Bm, impl="torch") == "plain"


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


def _emulate_tensor_core_ssd(x, dA, Bm, Cm, scheme, L=128):
    """The bf16 CUDA kernel's arithmetic (csrc/ssd_scan.cu) in PyTorch: chunks
    of L rows, a = cumsum(dA) over each; C B^T from the bf16 B and C (exact
    products, f32 sums); the local state (X tail)^T B, the readout C h_in^T
    and the intra-chunk (C B^T (.) decay) X with each f32 operand (X tail,
    h_in, C B^T (.) decay, X) split into bf16 hi + lo of the remainder
    (``"split"``: two products for the first two, hi.hi + hi.lo + lo.hi for
    the third) or rounded once to bf16 (``"bf16_once"``); the decays, the
    recurrence over the chunks and every sum in f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // L)
    x, dA, Bm, Cm = (torch.nn.functional.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, nc * L - S))
                     for t in (x, dA, Bm, Cm))

    def parts(t):
        hi = t.to(bf16).to(f32)
        return [hi, (t - hi).to(bf16).to(f32)] if scheme == "split" else [hi]

    xc = x.reshape(B, nc, L, H, P)
    a = torch.cumsum(dA.reshape(B, nc, L, H), dim=2).permute(0, 1, 3, 2)  # (B,nc,H,L)
    Bg, Cg = Bm.reshape(B, nc, L, G, N), Cm.reshape(B, nc, L, G, N)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cg, Bg).repeat_interleave(H // G, dim=2)
    tril = torch.ones(L, L, dtype=torch.bool).tril()
    diff = (a[..., :, None] - a[..., None, :]).masked_fill(~tril, float("-inf"))  # select, exp
    Ap, Xp = parts(CB * torch.exp(diff)), parts(xc)
    pairs = [(0, 0), (0, 1), (1, 0)] if scheme == "split" else [(0, 0)]
    y = sum(torch.einsum("bchls,bcshp->bclhp", Ap[i], Xp[j]) for i, j in pairs)
    tail = torch.exp(a[..., -1:] - a).permute(0, 1, 3, 2)[..., None]
    Bh, Ch = Bg.repeat_interleave(H // G, dim=3), Cg.repeat_interleave(H // G, dim=3)
    states = sum(torch.einsum("bclhp,bclhn->bchpn", t, Bh) for t in parts(xc * tail))
    decay = torch.exp(a[..., -1])  # (B,nc,H)
    h = torch.zeros(B, H, P, N)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)
    y_off = sum(torch.einsum("bclhn,bchpn->bclhp", Ch, t) for t in parts(h_in))
    y = y + y_off * torch.exp(a).permute(0, 1, 3, 2)[..., None]
    return y.reshape(B, nc * L, H, P)[:, :S], h


@pytest.mark.parametrize("scheme,within", [("split", True), ("bf16_once", False)])
def test_tensor_core_precision_scheme_holds_the_full_layer(scheme, within):
    """The bf16 SSD kernel's precision scheme against the plain version
    (chunk 256) at the full mamba2 layer (B=2, S=512, H=32, P=64, G=1,
    N=128; the whole training micro-batch, about 1 CPU second) with dA as
    the model draws it (cumsum over a 256-row chunk near -700), at
    chip_smoke's full-layer hold, 1e-3 x max|plain| for y and for h: with
    every f32 operand split into bf16 hi + lo no output is over it; rounded
    once to bf16, hundreds are (135 of y and 253 of h at this seed), which
    shows that the hold tells the two apart."""
    r = np.random.default_rng(16)
    B, S, H, G, P, N = 2, 512, 32, 1, 64, 128
    dt0 = np.exp(r.uniform(size=H) * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt = np.logaddexp(r.normal(size=(B, S, H)) + dt0 + np.log(-np.expm1(-dt0)), 0.0)
    A = -np.arange(1, H + 1, dtype=np.float64)
    x = torch.from_numpy((r.normal(size=(B, S, H, P)) * dt[..., None]).astype(np.float32))
    dA = torch.from_numpy((dt * A).astype(np.float32))
    Bm, Cm = (torch.from_numpy(r.normal(size=(B, S, G, N)).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    assert float(dA.reshape(B, -1, 256, H).cumsum(2).min()) < -300
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, 256)
    y, h = _emulate_tensor_core_ssd(x, dA, Bm, Cm, scheme)
    over = [int(((out - ref).abs() > 1e-3 * ref.abs().max()).sum())
            for out, ref in ((y, py), (h, ph))]
    assert (over == [0, 0]) == within, f"{scheme}: {over} of y and h over 1e-3 x max|plain|"
    if not within:
        assert min(over) > 0, f"{scheme}: {over}"


def _card_test_inputs(B, S, H, G, P, N, seed):
    """The draws of tests/test_torch_gpu.py's ``_ssd_inputs`` (those of
    tests/test_kernels.py), on the CPU, with B and C rounded to bf16."""
    r = np.random.default_rng(seed)
    dt = r.uniform(0.01, 0.2, size=(B, S, H))
    A = -r.uniform(0.3, 2.0, size=(H,))
    x = r.normal(size=(B, S, H, P)) * dt[..., None]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return (t(x), t(dt * A), t(r.normal(size=(B, S, G, N))).to(torch.bfloat16),
            t(r.normal(size=(B, S, G, N))).to(torch.bfloat16))


@pytest.mark.parametrize("S", [384, 421], ids=["3-chunks", "ragged-4-chunks"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_tensor_core_precision_scheme_within_the_group_tests_hold(G, S):
    """The split scheme's arithmetic at the inputs of the card test
    test_cuda_ssd_scan_groups_share_scores_across_chunks (H=8, P=64, N=128,
    the same seeds) against the plain version: within that test's hold,
    rtol 1e-3 over atol 1e-4 x max|plain|.  The split keeps each f32
    operand to 2^-17, so the error follows the size of the sums, which at
    N = 128 reach tens."""
    x, dA, Bm, Cm = _card_test_inputs(2, S, 8, G, 64, 128, S + G)
    py, ph = ssd_scan_torch(x, dA, Bm, Cm, S)
    y, h = _emulate_tensor_core_ssd(x, dA, Bm, Cm, "split")
    torch.testing.assert_close(y, py, atol=1e-4 * float(py.abs().max()), rtol=1e-3)
    torch.testing.assert_close(h, ph, atol=1e-4 * float(ph.abs().max()), rtol=1e-3)


def _emulate_tensor_core_ssd_bwd(x, dA, Bm, Cm, dy, gh, scheme, L=128):
    """The bf16 SSD backward kernels' arithmetic (csrc/ssd_scan.cu, the
    ``ssd_bwd_*`` kernels) in PyTorch: chunks of L rows, a = cumsum(dA); the
    states entering each chunk as the forward kernel keeps them
    (:func:`_emulate_tensor_core_ssd`'s split); B C^T exact; the state
    gradients (exp(a) dY)^T C and their reverse recurrence in f32; per
    (chunk, head) B g^T and C h_in^T (g, h_in split: two products) scaled by
    the tail and exp(a) after; X dY^T and M^T dY with M^T = B C^T (.) exp(a_i
    - a_j) selected to 0 where i < j (both operands split: hi.hi + hi.lo +
    lo.hi); da from T = D (.) M's row and column sums and the f32 row terms,
    reverse-cumsummed; per group W^T = sum_h D^T (.) L^T, dB = W^T C + sum_h
    tail (.) (X g), dC = W B + sum_h exp(a) (.) (dY h_in) (W split: two
    products; X, g, dY, h_in split: three), rounded once to bf16.
    ``"bf16_once"`` rounds each f32 operand once instead."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, -(-S // L)
    def pad(t):  # rows past S: x = 0 adds nothing, dA = 0 decays by 1
        return torch.nn.functional.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, nc * L - S))

    x, dA, Bm, Cm, dy = (pad(t) for t in (x, dA, Bm, Cm, dy))

    def parts(t):
        hi = t.to(bf16).to(f32)
        return [hi, (t - hi).to(bf16).to(f32)] if scheme == "split" else [hi]

    pairs = [(0, 0), (0, 1), (1, 0)] if scheme == "split" else [(0, 0)]

    def split2(eq, u, v):  # u f32, split; v exact in bf16
        return sum(torch.einsum(eq, t, v) for t in parts(u))

    def split3(eq, u, v):  # both f32, split
        U, V = parts(u), parts(v)
        return sum(torch.einsum(eq, U[i], V[j]) for i, j in pairs)

    def by_group(t):  # (B,nc,L,H,N) -> the sum over each group's heads
        return t.reshape(B, nc, L, G, rep, N).sum(4)

    xc, dyc = x.reshape(B, nc, L, H, P), dy.reshape(B, nc, L, H, P)
    a = torch.cumsum(dA.reshape(B, nc, L, H), dim=2)  # (B,nc,L,H)
    Bg, Cg = Bm.reshape(B, nc, L, G, N), Cm.reshape(B, nc, L, G, N)
    Bh, Ch = Bg.repeat_interleave(rep, 3), Cg.repeat_interleave(rep, 3)
    ea, tail = torch.exp(a), torch.exp(a[:, :, -1:] - a)
    decay = torch.exp(a[:, :, -1])  # (B,nc,H)
    # the states entering each chunk, as the forward kernel leaves them
    states = split2("bclhp,bclhn->bchpn", xc * tail[..., None], Bh)
    h, h_in = torch.zeros(B, H, P, N), []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, 1)  # (B,nc,H,P,N)
    # the chunk pass and the reverse recurrence: g, the gradient of the
    # state leaving each chunk
    dstate = split2("bclhp,bclhn->bchpn", dyc * ea[..., None], Ch)
    g, gs = (torch.zeros(B, H, P, N) if gh is None else gh.to(f32)), [None] * nc
    for c in range(nc - 1, -1, -1):
        gs[c] = g
        g = g * decay[:, c, :, None, None] + dstate[:, c]
    g = torch.stack(gs, 1)
    # the dx pass, rows j and columns i
    dxs = tail[..., None] * split2("bchpn,bcjhn->bcjhp", g, Bh)
    Z = split2("bchpn,bcihn->bcihp", h_in, Ch)
    Dt = split3("bcjhp,bcihp->bchji", xc, dyc)
    at = a.permute(0, 1, 3, 2)[..., None, :]  # a_i along the last dim
    upper = torch.ones(L, L, dtype=torch.bool).triu()  # i >= j
    Lt = torch.exp((at - at.transpose(-1, -2)).masked_fill(~upper, float("-inf")))
    Mt = torch.einsum("bcjgn,bcign->bcgji", Bg, Cg).repeat_interleave(rep, 2) * Lt
    dx = dxs + split3("bchji,bcihp->bcjhp", Mt, dyc)
    T = Dt * Mt
    da = (T.sum(-2) - T.sum(-1)).permute(0, 1, 3, 2) + ea * (dyc * Z).sum(-1) - (xc * dxs).sum(-1)
    da[:, :, -1] += (xc * dxs).sum((-1, -3)) + decay * (g * h_in).sum((-1, -2))
    ddA = torch.flip(torch.cumsum(torch.flip(da, [2]), 2), [2])
    # the dB / dC pass
    Wt = (Dt * Lt).reshape(B, nc, G, rep, L, L).sum(3)  # (B,nc,G,j,i)
    dB = split2("bcgji,bcign->bcjgn", Wt, Cg) + by_group(
        tail[..., None] * split3("bcjhp,bchpn->bcjhn", xc, g))
    dC = split2("bcgji,bcjgn->bcign", Wt, Bg) + by_group(
        ea[..., None] * split3("bcihp,bchpn->bcihn", dyc, h_in))
    cut = lambda t, shape: t.reshape(B, nc * L, *shape)[:, :S]  # noqa: E731
    return cut(dx, (H, P)), cut(ddA, (H,)), cut(dB, (G, N)).to(bf16), cut(dC, (G, N)).to(bf16)


def _ssd_grads(x, dA, Bm, Cm, dy, gh, dtype, chunk):
    """Autograd of the plain version in ``dtype``: f64 with B and C widened,
    or f32 with the bf16 B and C as given (their gradients in bf16)."""
    wide = dtype == torch.float64
    ins = [t.to(dtype if wide or i < 2 else t.dtype).detach().requires_grad_(True)
           for i, t in enumerate((x, dA, Bm, Cm))]
    y, h = ssd_scan_torch(*ins, chunk)
    outs, gs = [y], [dy.to(y.dtype)]
    if gh is not None:
        outs.append(h)
        gs.append(gh.to(h.dtype))
    return torch.autograd.grad(outs, ins, gs)


def _model_layer_inputs(B, S, H, G, P, N, seed):
    """x·dt, dA as mamba2's layer draws them (A = -(1..H)), bf16 B and C and
    the gradient of y, from ``seed``."""
    r = np.random.default_rng(seed)
    dt0 = np.exp(r.uniform(size=H) * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt = np.logaddexp(r.normal(size=(B, S, H)) + dt0 + np.log(-np.expm1(-dt0)), 0.0)
    A = -np.arange(1, H + 1, dtype=np.float64)
    x = torch.from_numpy((r.normal(size=(B, S, H, P)) * dt[..., None]).astype(np.float32))
    dA = torch.from_numpy((dt * A).astype(np.float32))
    Bm, Cm = (torch.from_numpy(r.normal(size=(B, S, G, N)).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    dy = torch.from_numpy(r.normal(size=(B, S, H, P)).astype(np.float32))
    return x, dA, Bm, Cm, dy


def _over_the_hold(got, x, dA, Bm, Cm, dy, gh, chunk):
    """The gradients of ``got`` (dx, ddA, dB, dC) over the card tests' hold:
    max(2 x the f32 plain backward's own error, 1e-4 x max|f64|) of f64
    autograd of the plain version."""
    ref = _ssd_grads(x, dA, Bm, Cm, dy, gh, torch.float64, chunk)
    plain = _ssd_grads(x, dA, Bm, Cm, dy, gh, torch.float32, chunk)
    over = []
    for name, k, p, r in zip(("dx", "ddA", "dB", "dC"), got, plain, ref):
        assert k.dtype == p.dtype and k.shape == p.shape
        err_p = float((p.double() - r).abs().max())
        if float((k.double() - r).abs().max()) > max(2 * err_p, 1e-4 * float(r.abs().max())):
            over.append(name)
    return over


@pytest.mark.parametrize("scheme,within", [("split", True), ("bf16_once", False)])
def test_tensor_core_backward_precision_holds_the_full_layer(scheme, within):
    """The SSD backward kernels' precision scheme against f64 autograd of the
    plain version (chunk 256) at the full mamba2 layer (B=2, S=512, H=32,
    P=64, G=1, N=128) with dA as the model draws it (cumsum over a chunk
    near -700), at the card tests' hold: every f32 operand split into bf16
    hi + lo keeps all four gradients within max(2 x the f32 plain
    backward's error, 1e-4 x max|f64|); rounded once to bf16, dx and ddA
    (and dC at this seed) are over it."""
    x, dA, Bm, Cm, dy = _model_layer_inputs(2, 512, 32, 1, 64, 128, 28)
    assert float(dA.reshape(2, -1, 256, 32).cumsum(2).min()) < -300
    got = _emulate_tensor_core_ssd_bwd(x, dA, Bm, Cm, dy, None, scheme)
    over = _over_the_hold(got, x, dA, Bm, Cm, dy, None, 256)
    assert (over == []) == within, f"{scheme}: {over} over the hold"
    if not within:
        assert {"dx", "ddA"} <= set(over), over


@pytest.mark.parametrize("with_gh", [False, True], ids=["gh-absent", "gh-present"])
def test_tensor_core_backward_precision_holds_granite_heads(with_gh):
    """The split scheme at granite's 128 heads (B=1, S=384: three kernel
    chunks, the last ragged against the plain version's one chunk of 384),
    with the model's dA, with and without a gradient of h: every gradient
    within the card tests' hold."""
    x, dA, Bm, Cm, dy = _model_layer_inputs(1, 384, 128, 1, 64, 128, 29)
    gh = torch.from_numpy(np.random.default_rng(30).normal(size=(1, 128, 64, 128))
                          .astype(np.float32)) if with_gh else None
    got = _emulate_tensor_core_ssd_bwd(x, dA, Bm, Cm, dy, gh, "split")
    assert _over_the_hold(got, x, dA, Bm, Cm, dy, gh, 384) == []
