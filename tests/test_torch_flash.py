"""The port's flash attention against the JAX package: the plain version
``flash_attention_torch`` against interpret-mode Pallas
(``ops.flash_attention(impl="pallas_interpret")``) and ``ref.attention_ref``
over the sweep and tolerances of ``tests/test_kernels.py``; ragged S, a
window of 1 and a window wider than S against ``attention_ref`` only (the
Pallas kernel asks S % block == 0); the port's ``attention_ref``; the
model-level check; and the wrapper's and ``ops``' routing and refusals on
the CPU.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
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
