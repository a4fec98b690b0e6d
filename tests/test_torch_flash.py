"""The port's flash attention against the JAX package: the plain version
``flash_attention_torch`` against interpret-mode Pallas
(``ops.flash_attention(impl="pallas_interpret")``) and ``ref.attention_ref``
over the sweep and tolerances of ``tests/test_kernels.py``; ragged S, a
window of 1 and a window wider than S against ``attention_ref`` only (the
Pallas kernel asks S % block == 0); the port's ``attention_ref``; the
model-level check; and the wrapper's and ``ops``' routing and refusals on
the CPU.  The training pair: its plain version bit-equal to the model's own
chain (forward and gradients), an emulation of the backward kernels'
rounding against f32 autograd, and the route (the CPU, ``attn_impl="torch"``
and a head size the kernels lack never launch).  The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

SWEEP = [(64, 4, 2, 32), (128, 6, 3, 32), (128, 8, 8, 64), (64, 5, 1, 16)]
_DT = {"f32": (np.float32, torch.float32, jnp.float32, 2e-3),
       "bf16": (np.float32, torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(S, H, K, hd, dtype, seed, B=2):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=(B, S, n, hd)).astype(np.float32) for n in (H, K, K)]
    _, tdt, jdt, tol = _DT[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    j = [jnp.asarray(a, jdt) for a in arrs]
    return t, j, tol


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dims", SWEEP, ids=lambda d: "S{}H{}K{}hd{}".format(*d))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_attention_ref(dims, causal, window, dtype):
    S, H, K, hd = dims
    (q, k, v), (jq, jk, jv), tol = _inputs(S, H, K, hd, dtype, seed=S + H)
    out = fa.flash_attention_torch(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    expect = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("dims", SWEEP, ids=lambda d: "S{}H{}K{}hd{}".format(*d))
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 32)])
def test_plain_matches_pallas_interpret(dims, causal, window):
    """Against the TPU kernel itself, interpreted, with 32-row blocks so
    its tile skip and its ``l == 0`` rule run (f32 and bf16 alternate)."""
    S, H, K, hd = dims
    dtype = "f32" if (S + H + (window or 0)) % 2 else "bf16"
    (q, k, v), (jq, jk, jv), tol = _inputs(S, H, K, hd, dtype, seed=7 * S + H)
    out = fa.flash_attention_torch(q, k, v, causal=causal, window=window)
    expect = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=32, block_k=32, impl="pallas_interpret")
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [1, 7, 100, 257])
@pytest.mark.parametrize("window", [None, 1, 16, 10_000])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_and_window_edges_match_attention_ref(S, window, dtype):
    """Any S (the CUDA kernel's contract; the Pallas kernel refuses ragged
    S above one block), a window of 1 (only the diagonal is live) and one
    wider than S (no effect): finite, and equal to ``attention_ref``."""
    (q, k, v), (jq, jk, jv), tol = _inputs(S, 6, 2, 32, dtype, seed=S, B=1)
    out = fa.flash_attention_torch(q, k, v, causal=True, window=window)
    assert torch.isfinite(out.float()).all()
    expect = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)
    if window == 1:  # each row attends to itself alone: the output is v
        np.testing.assert_allclose(_np(out), _np(v.repeat_interleave(3, dim=2)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 8)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_attention_ref_matches_jax(causal, window, dtype):
    (q, k, v), (jq, jk, jv), _ = _inputs(48, 4, 2, 16, dtype, seed=3)
    out = ref.attention_ref(q, k, v, causal=causal, window=window)
    expect = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_np(out), _np(expect), atol=tol, rtol=tol)


def test_flash_matches_model_attention():
    """The port's prefill attention through the kernel's plain version
    agrees with the JAX model's XLA attention path (the check of
    tests/test_kernels.py:128-151) and with the port's own model
    attention."""
    from repro.models.attention import attention_forward as jattn
    from repro.models.attention import init_attention
    from repro_torch.models.attention import attention_forward
    from repro_torch.models.lm import params_from_numpy

    d, H, K, hd, S, B = 64, 4, 2, 16, 64, 2
    jp = init_attention(jax.random.PRNGKey(0), d, H, K, hd, False, jnp.float32)
    x = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rotary_dim=hd, rope_theta=1e4, causal=True)
    jout, _ = jattn(jp, jnp.asarray(x), jnp.arange(S), q_chunk=16, **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    pos = torch.arange(S)
    flash, _ = attention_forward(tp, torch.from_numpy(x), pos, flash=True, **kw)
    model, _ = attention_forward(tp, torch.from_numpy(x), pos, **kw)
    np.testing.assert_allclose(flash.numpy(), np.asarray(jout), atol=2e-3)
    np.testing.assert_allclose(flash.numpy(), model.numpy(), atol=1e-5, rtol=1e-5)


def test_ops_routes_by_device_and_never_counts_the_plain_version():
    (q, k, v), _, _ = _inputs(32, 4, 2, 16, "f32", seed=0)
    before = fa.flash_attention.launches
    a = ops.flash_attention(q, k, v)
    b = ops.flash_attention(q, k, v, impl="torch")
    c = fa.flash_attention(q, k, v)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("case", ["hd", "dtype", "shape", "heads", "window", "ndim"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks run before the device is looked at, so they hold on the
    CPU as on the card."""
    (q, k, v), _, _ = _inputs(16, 4, 2, 16, "f32", seed=1)
    args, kw, err = (q, k, v), {}, ValueError
    if case == "hd":
        args = tuple(torch.zeros(1, 16, n, 24) for n in (4, 2, 2))
    elif case == "dtype":
        args, err = (q, k.to(torch.bfloat16), v), TypeError
    elif case == "shape":
        args = (q, k[:, :8], v[:, :8])
    elif case == "heads":
        args = (q[:, :, :3], k, v)
    elif case == "window":
        kw = {"window": 0}
    else:
        args = (q[0], k[0], v[0])
    with pytest.raises(err):
        fa.flash_attention(*args, **kw)


def _emulate_tensor_core_p(q, k, v, scheme):
    """The bf16 CUDA kernel's arithmetic in PyTorch, causal: f32 scores from
    the bf16 q and k, scaled after the product, an f32 softmax, and p
    rounded before P.V: ``"split"`` as the kernel does it (bf16 hi + bf16
    lo of the remainder, two products into one f32 sum), ``"bf16_once"`` as
    FlashAttention-3 does it; the output rounded to bf16."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    f32 = torch.float32
    qh = q.to(f32).reshape(B, S, K, H // K, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k.to(f32)) * (hd**-0.5)
    pos = torch.arange(S)
    s = torch.where(pos[None, :] <= pos[:, None], s, torch.full((), fa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    hi = p.to(torch.bfloat16).to(f32)
    parts = [hi, (p - hi).to(torch.bfloat16).to(f32)] if scheme == "split" else [hi]
    o = sum(torch.einsum("bkgqs,bskh->bqkgh", x, v.to(f32)) for x in parts)
    return (o / l.permute(0, 3, 1, 2, 4)).reshape(B, S, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("scheme,within", [("split", True), ("bf16_once", False)])
def test_tensor_core_precision_scheme_holds_one_bf16_spacing(scheme, within):
    """The bf16 kernel's precision scheme against the plain version at
    smollm-360m's heads (B=1, S=1024, H=15, K=5, hd=64, causal) at the
    card's hold, one bf16 spacing (atol 1e-4, rtol 2^-7): P.V on p split
    into bf16 hi + lo is within it everywhere; p rounded once to bf16 is
    not, which shows that the hold tells the two apart."""
    r = np.random.default_rng(15)
    q, k, v = [torch.from_numpy(r.normal(size=(1, 1024, n, 64)).astype(np.float32))
               .to(torch.bfloat16) for n in (15, 5, 5)]
    ref = fa.flash_attention_torch(q, k, v, causal=True).float()
    out = _emulate_tensor_core_p(q, k, v, scheme).float()
    over = int(((out - ref).abs() > 1e-4 + 2.0**-7 * ref.abs()).sum())
    assert (over == 0) == within, f"{scheme}: {over} of {ref.numel()} outputs over one spacing"
    if within:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=2.0**-7)


# -- training ------------------------------------------------------------------


def _model_attention(params, x, kw, core=None):
    """``attention_forward``'s training output, or the same projections
    and rope around ``core(q scaled, k, v)`` in place of its attention
    (``"sharded"``: the chain that DTensors run, on plain tensors)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope

    if core is None:
        return attn.attention_forward(params, x, torch.arange(x.shape[1]), **kw)[0]
    B, S, _ = x.shape
    H, K, hd = kw["n_heads"], kw["n_kv"], kw["head_dim"]
    q, k, v = attn._project_qkv(params, x, H, K, hd)
    pos = torch.arange(S).expand(B, S)
    q = apply_rope(q, pos, rotary_dim=kw["rotary_dim"], theta=kw["rope_theta"])
    k = apply_rope(k, pos, rotary_dim=kw["rotary_dim"], theta=kw["rope_theta"])
    if core == "sharded":
        return attn._sharded_chain(q, k, v, pos[0], n_kv=K, head_dim=hd, causal=kw["causal"],
                                   window=kw.get("window")) @ params["wo"]
    o = core(q * hd**-0.5, k, v, causal=kw["causal"], window=kw.get("window"))
    return o.reshape(B, S, H * hd) @ params["wo"]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_train_plain_is_bit_equal_to_the_model_chain(causal, window, dtype):
    """The model's training attention (which runs the training pair's
    plain version off the kernels), that plain version itself, through
    ``ops`` and through the CPU's ``flash_attention_train``, against the
    chain that DTensors run: the same output and the same gradients of x
    and of every weight, bit for bit, so the CPU's LM losses and gradients
    do not move from the model's own chain."""
    H, K, hd, d, S = 6, 2, 16, 32, 24
    r = np.random.default_rng(5)
    params = {n: torch.from_numpy(r.normal(size=shape).astype(np.float32) * d**-0.5).to(dtype)
              for n, shape in (("wq", (d, H * hd)), ("wk", (d, K * hd)), ("wv", (d, K * hd)),
                               ("wo", (H * hd, d)))}
    x = torch.from_numpy(r.normal(size=(2, S, d)).astype(np.float32)).to(dtype)
    kw = dict(n_heads=H, n_kv=K, head_dim=hd, rotary_dim=hd, rope_theta=1e4, causal=causal,
              window=window)
    outs, grads = [], []
    for core in ("sharded", None, fa.flash_attention_train_torch,
                 lambda *a, **k: ops.flash_attention_train(*a, **k, impl="torch"),
                 fa.flash_attention_train):
        leaves = {n: w.clone().requires_grad_() for n, w in params.items()}
        xi = x.clone().requires_grad_()
        out = _model_attention(leaves, xi, kw, core)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad] + [leaves[n].grad for n in sorted(leaves)])
    for out, g in zip(outs[1:], grads[1:]):
        assert torch.equal(out, outs[0])
        for a, b in zip(g, grads[0]):
            assert torch.equal(a, b)


def _emulate_train_backward(q, k, v, do, scheme):
    """The training backward kernels' arithmetic in f32, causal, before the
    outputs' rounding: P from the f32 scores, the forward's output rounded
    to bf16 (P unnormalised rounded once, as the forward's P.V), D =
    rowsum(dO o O), dS = P o (dP - D) entering dQ and dK split into bf16
    hi + lo (``"split"``, as the kernels) or rounded once (``"bf16_once"``)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.to(f32).reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(f32))
    pos = torch.arange(S)
    s = torch.where(pos[None, :] <= pos[:, None], s, torch.full((), fa.NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bqkgh", e.to(torch.bfloat16).to(f32), v.to(f32))
    o = (o / l.permute(0, 3, 1, 2, 4)).to(torch.bfloat16).to(f32)
    dog = do.to(f32).reshape(B, S, K, G, hd)
    D = (dog * o).sum(-1).permute(0, 2, 3, 1)[..., None]
    p = e / l
    ds = p * (torch.einsum("bqkgh,bskh->bkgqs", dog, v.to(f32)) - D)
    hi = ds.to(torch.bfloat16).to(f32)
    parts = [hi, (ds - hi).to(torch.bfloat16).to(f32)] if scheme == "split" else [hi]
    dq = sum(torch.einsum("bkgqs,bskh->bqkgh", x, k.to(f32)) for x in parts)
    dk = sum(torch.einsum("bkgqs,bqkgh->bskh", x, qg) for x in parts)
    return dq.reshape(B, S, H, hd), dk


@pytest.mark.parametrize("scheme,within", [("split", True), ("bf16_once", False)])
def test_train_backward_precision_scheme_holds_f32_autograd(scheme, within):
    """The training backward's precision scheme against f32 autograd of the
    plain version, at smollm-360m's heads (B=1, S=512, H=15, K=5, hd=64,
    causal): the relative error of dq and dk (Frobenius norm) within
    1.3e-3.  With dS split into bf16 hi + lo the error left is D's, from
    the bf16 output (about 9e-4 here); dS rounded once to bf16 adds 2^-9 of
    each entry, which a row's sum (0: the softmax's gradient) does not
    cancel, and reads about 1.9e-3, which shows the hold tells the two
    apart."""
    r = np.random.default_rng(15)
    q, k, v, do = [torch.from_numpy(r.normal(size=(1, 512, n, 64)).astype(np.float32))
                   .to(torch.bfloat16) for n in (15, 5, 5, 15)]
    q = q * 64**-0.5
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_train_torch(*leaves, causal=True).backward(do.float())
    dq, dk = _emulate_train_backward(q, k, v, do, scheme)
    for name, got, ref in (("dq", dq, leaves[0].grad), ("dk", dk, leaves[1].grad)):
        err = float((got - ref).norm() / ref.norm())
        assert (err <= 1.3e-3) == within, f"{scheme}: {name} relative error {err:.3e}"


def test_train_route_never_launches_off_the_kernels_inputs():
    """The route: CPU tensors, ``attn_impl="torch"``, f32 and a head size the
    kernels lack (hubert's 80) keep the model's chain; an LM training step
    on the CPU launches neither training kernel, and its mixer spans say
    ``impl="plain"``."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import train_kernel
    from repro_torch.models.lm import build_model
    from repro_torch.obs import Tracer

    x = torch.zeros(1, 2, 8, dtype=torch.bfloat16)
    assert not train_kernel(x, 64, None)
    assert not train_kernel(x, 64, "cuda")
    meta = torch.zeros(1, 2, 8, dtype=torch.bfloat16, device="meta")
    assert not train_kernel(meta, 64, None)
    before = (fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches)
    for arch, impl in (("smollm-360m", None), ("smollm-360m", "torch"), ("hubert-xlarge", None)):
        cfg = get_config(arch).reduced()
        cfg = type(cfg)(**{**cfg.__dict__, "dtype": "bfloat16", "n_layers": 2})
        model = build_model(cfg, attn_impl=impl)
        tracer = Tracer()
        model.tracer = tracer
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        leaves = {n: p.requires_grad_() for n, p in params.items()}
        if cfg.frontend == "audio":
            batch = {"frames": torch.randn(2, 8, cfg.d_model), "labels": torch.zeros(2, 8).long()}
        else:
            toks = torch.randint(0, cfg.vocab, (2, 8))
            batch = {"tokens": toks, "labels": toks}
        model.seq_losses(leaves, batch).sum().backward()
        tracer.sync_device()
        spans = [r for r in tracer.records("span") if r["name"] == "device.mixer"]
        assert spans and {r["args"]["impl"] for r in spans} == {"plain"}
    assert (fa.flash_attention_train_fwd.launches, fa.flash_attention_train_bwd.launches) == before
    q, k, v = _inputs(16, 4, 2, 16, "bf16", seed=2)[0]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention_train(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="head size"):
        fa.flash_attention_train(*(torch.zeros(1, 16, n, 80) for n in (4, 2, 2)))
