"""The port's dense LM and AdamW against the JAX package at equal weights.

``jax.random`` init cannot be replayed in torch, so the JAX parameters are
converted into the port (``params_from_numpy``) and both sides run the
same numpy batch, on the reduced f32 configs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import build_model as jbuild
from repro.optim.adam import adamw_init as jadamw_init
from repro.optim.adam import adamw_update as jadamw_update
from repro_torch.configs import get_config
from repro_torch.models.lm import build_model, flatten_tree, params_from_numpy, params_to_numpy
from repro_torch.optim.adam import adamw_init, adamw_update

torch.set_num_threads(2)

ARCHS = ["smollm-360m", "llama3.2-1b"]


def _batch(cfg, B=3, S=16, seed=0):
    r = np.random.default_rng(seed)
    tok = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": tok.copy(),
            "weight": r.uniform(0.1, 1.0, (B,)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_side(arch, seed):
    jm = jbuild(jget_config(arch).reduced())
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    return jm, jp, jax.jit(jax.value_and_grad(jm.weighted_loss))


def _setup(arch, seed=0):
    """(JAX model, JAX params, port model, converted port params)."""
    jm, jp, _ = _jax_side(arch, seed)
    tm = build_model(get_config(arch).reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_converter_round_trip_and_ravel_order():
    from jax.flatten_util import ravel_pytree

    _, jp, _, tp = _setup("smollm-360m")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    flat_t = torch.cat([p.reshape(-1) for p in tp.values()]).numpy()
    np.testing.assert_array_equal(flat_t, np.asarray(ravel_pytree(jp)[0]))
    assert list(flatten_tree(back)) == list(tp)


def test_port_init_has_the_jax_layout():
    """Same keys, shapes and dtypes as the JAX init (values differ: the two
    frameworks' random streams differ)."""
    for arch in ARCHS:
        _, jp, tm, tp = _setup(arch)
        own = tm.init(torch.Generator().manual_seed(0))
        assert list(own) == list(tp)
        for k in own:
            assert own[k].shape == tp[k].shape and own[k].dtype == tp[k].dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_weighted_loss_and_grads_match(arch):
    jm, jp, tm, tp = _setup(arch)
    b = _batch(tm.cfg)
    jl, jg = _jax_side(arch, 0)[2](jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = tm.weighted_loss(leaves, {k: torch.from_numpy(v) for k, v in b.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    for k, p in leaves.items():
        _close(p.grad, jflat[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_losses_match(arch):
    jm, jp, tm, tp = _setup(arch, seed=1)
    b = _batch(tm.cfg, B=2, S=24, seed=3)
    b["labels"][0, 5:9] = -1  # masked labels
    jl = jax.jit(jm.seq_losses)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl = tm.seq_losses(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(tl, jl, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-master"])
def test_one_adamw_step_matches(bf16):
    jm, jp, tm, tp = _setup("smollm-360m")
    b = _batch(tm.cfg)
    jg = _jax_side("smollm-360m", 0)[2](jp, {k: jnp.asarray(v) for k, v in b.items()})[1]
    if bf16:
        jp, jg = (jax.tree.map(lambda x: x.astype(jnp.bfloat16), t) for t in (jp, jg))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jflat_g = flatten_tree(jax.tree.map(np.asarray, jg))
    tg = params_from_numpy(jax.tree.map(np.asarray, jg))  # the same grads on both sides
    kw = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    jopt = jadamw_init(jp)
    topt = adamw_init(tp)
    assert (topt.master is None) == (jopt.master is None)
    jupdate = jax.jit(functools.partial(jadamw_update, **kw))
    jnew, jopt = jupdate(jp, jg, jopt)
    jnew, jopt = jupdate(jnew, jg, jopt)  # two steps: moments matter
    tnew, topt = adamw_update(tp, tg, topt, **kw)
    tnew, topt = adamw_update(tnew, tg, topt, **kw)
    assert topt.step == int(jopt.step) == 2
    jp_flat = flatten_tree(jax.tree.map(lambda x: np.asarray(x, np.float32), jnew))
    jmu = flatten_tree(jax.tree.map(np.asarray, jopt.mu))
    for k in tnew:
        # bf16 params: one bf16 ulp where the f32 masters round differently
        tol = 1e-2 if bf16 else 1e-5
        _close(tnew[k].float(), jp_flat[k], rtol=tol, atol=1e-6)
        _close(topt.mu[k], jmu[k], rtol=1e-5, atol=1e-7)
    assert set(jflat_g) == set(tnew)
    if bf16:
        jmaster = flatten_tree(jax.tree.map(np.asarray, jopt.master))
        for k in tnew:
            _close(topt.master[k], jmaster[k], rtol=1e-5, atol=1e-7)


def test_non_dense_family_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config("mamba2-370m").reduced())
