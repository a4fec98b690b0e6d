"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) at equal converted weights.

Both dispatch forms, f32 and bf16, capacity factors 8.0 (no token dropped,
the reduced configs' setting) and 1.25 (the full configs'; with T = 133,
not a multiple of 8, tokens are dropped in (t, k) priority order), and
(E, k) of (4, 2) and (8, 6): the output, the load-balance loss and the
gradients of x and of every weight.  Also: the routing (top-k ids, kept
pairs) equal to JAX's; the two port forms equal to each other in f32; a
batch routed row by row as JAX's ``vmap`` does; ``moe_capacity`` over a
sweep of T.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import params_from_numpy

torch.set_num_threads(2)

D, FF, T = 32, 48, 133
ROUTER_GAIN = 50.0
FORMS = {"dense": (jmoe.moe_apply_dense, tmoe.moe_apply_dense),
         "sort": (jmoe.moe_apply, tmoe.moe_apply)}
# (rtol, atol) of y and of the gradients, relative to each one's max|.|.  f32:
# summation order.  bf16: the dense form computes JAX's numbers (bf16 operands,
# f32 sums, h and the outputs rounded once), so at most one bf16 spacing (2^-8
# of the value) apart; the sort form rounds every product to bf16, where
# XLA's fused activation-times-product rounds once, so a few spacings.
TOL = {("dense", "float32"): (1e-5, 1e-6), ("sort", "float32"): (1e-5, 1e-6),
       ("dense", "bfloat16"): (2**-7, 2**-8), ("sort", "bfloat16"): (2**-5, 2**-6)}
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2**-4, 2**-5)}


def _setup(E, dtype, seed=0):
    """JAX's init with the router scaled by ROUTER_GAIN, and x: normal
    tokens around a common offset.  At init (router std 0.02) isotropic
    tokens load the experts evenly and none overflows; a sharper router and
    tokens that share a direction load them unevenly, as trained routers
    on real text do, so that cf 1.25 drops tokens."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, E, FF, jdt)
    jp["router"] = jp["router"] * ROUTER_GAIN
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    r = np.random.default_rng(seed)
    x = (r.normal(size=(T, D)) + r.normal(size=(D,))).astype(np.float32)
    return jp, tp, x


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_scaled(got, want, rtol, atol, what):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


def test_init_has_the_jax_layout_and_spread():
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 64, 8, 96, jnp.bfloat16)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), 2, 64, 8, 96, torch.bfloat16,
                       device="cpu")
    assert list(tp) == sorted(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == (2, *jp[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jp[k].dtype), k
        want = float(np.asarray(jp[k], np.float32).std())
        assert abs(float(v.float().std()) - want) <= 0.05 * want, k
    assert tp["router"].dtype == torch.float32


@pytest.mark.parametrize("n", [1, 7, 8, 37, 100, 1024, 6144])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 6), (64, 6), (8, 2)])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_capacity_matches_jax(n, E, k, cf):
    assert tmoe.moe_capacity(n, E, k, cf) == jmoe.moe_capacity(n, E, k, cf)


@pytest.mark.parametrize("E,k", [(4, 2), (8, 6)])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_routing_matches_jax(E, k, cf):
    """Top-k ids equal to ``jax.lax.top_k``'s; the kept (t, k) pairs are
    JAX's dense form's ``pos < C``; at cf 1.25 some pairs are dropped."""
    jp, tp, x = _setup(E, "float32", seed=E + k)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jids = jax.lax.top_k(probs, k)
    _, ids, rows, _, E_, C = tmoe._route(tp, torch.from_numpy(x)[None], k, cf)
    np.testing.assert_array_equal(ids[0].numpy(), np.asarray(jids))
    comb = np.asarray(jax.nn.one_hot(jids, E)).reshape(T * k, E)
    pos = ((np.cumsum(comb, 0) - comb) * comb).sum(-1)
    jkeep = pos < C
    np.testing.assert_array_equal((rows[0] < E_ * C).numpy(), jkeep)
    assert (not jkeep.all()) == (cf == 1.25)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 6)])
@pytest.mark.parametrize("form", list(FORMS))
def test_forward_and_grads_match_jax(form, E, k, cf, dtype):
    jfn, tfn = FORMS[form]
    jp, tp, x = _setup(E, dtype, seed=3 * E + k)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cot = np.random.default_rng(7).normal(size=(T, D)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jfn(p, xx, top_k=k, capacity_factor=cf)
        return jnp.sum(y.astype(jnp.float32) * cot) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x, jdt))
    leaves = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    tx = torch.from_numpy(x).to(tp["w_gate"].dtype).requires_grad_(True)
    ty, taux = tfn(leaves, tx[None], top_k=k, capacity_factor=cf)
    ty, taux = ty[0], taux[0]
    assert ty.dtype == tx.dtype and ty.shape == (T, D) and taux.dtype == torch.float32
    ((ty.float() * torch.from_numpy(cot)).sum() + 3.0 * taux).backward()
    _, _, rows, _, E_, C = tmoe._route(tp, tx.detach()[None], k, cf)
    assert bool((rows == E_ * C).any()) == (cf == 1.25)  # a dropped pair
    rtol, atol = TOL[(form, dtype)]
    _close_scaled(ty, jy, rtol, atol, "y")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)
    grtol, gatol = GRAD_TOL[dtype]
    _close_scaled(tx.grad, jgx, grtol, gatol, "grad x")
    for n, p in leaves.items():
        _close_scaled(p.grad, jgp[n], grtol, gatol, f"grad {n}")


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_the_two_forms_agree_in_f32(cf):
    _, tp, x = _setup(8, "float32", seed=11)
    a = tmoe.moe_apply_dense(tp, torch.from_numpy(x)[None], top_k=6, capacity_factor=cf)
    b = tmoe.moe_apply(tp, torch.from_numpy(x)[None], top_k=6, capacity_factor=cf)
    _close_scaled(a[0], b[0], 1e-5, 1e-6, "y")
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("form", list(FORMS))
def test_batch_rows_route_on_their_own(form):
    """A batch of rows gives each row what it gives alone, as JAX's vmap
    over rows: capacity from a row's T, aux per row."""
    jfn, tfn = FORMS[form]
    jp, tp, _ = _setup(4, "float32", seed=5)
    xb = np.random.default_rng(5).normal(size=(3, T, D)).astype(np.float32)
    ty, taux = tfn(tp, torch.from_numpy(xb), top_k=2, capacity_factor=1.25)
    jy, jaux = jax.vmap(lambda h: jfn(jp, h, top_k=2, capacity_factor=1.25))(jnp.asarray(xb))
    _close_scaled(ty, jy, 1e-5, 1e-6, "y")
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-6)
    for b in range(3):
        yb, ab = tfn(tp, torch.from_numpy(xb[b:b + 1]), top_k=2, capacity_factor=1.25)
        np.testing.assert_array_equal(yb[0].numpy(), ty[b].numpy())
        assert ab.item() == taux[b].item()


def test_gelu_is_the_tanh_approximation():
    """``act="gelu"`` is ``jax.nn.gelu``'s default (approximate=True)."""
    from repro_torch.models.layers import activation

    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        activation("relu")
