"""The port's ``train/steps.py`` and remat against the JAX package.

``make_fused_train_step`` runs 3 steps on the reduced f32 llama3.2-1b,
mamba2-370m and moonshot-v1-16b-a3b (MoE) from the same converted weights
and numpy batches as JAX's, with ``accum_steps`` 1 and 2: the loss, grad
norm, lr and every parameter after each step held at the tolerances of
``tests/test_torch_models.py`` and ``tests/test_torch_trainer.py``.  With
``remat="full"`` the port's gradients are bit-equal to its own without
remat, and allclose to JAX's checkpointed (``jax.checkpoint``) gradients.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.models.lm import build_model as jbuild
from repro.optim.adam import adamw_init as jadamw_init
from repro.train.steps import make_fused_train_step as jmake_step
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models.lm import build_model, flatten_tree, params_from_numpy
from repro_torch.optim.adam import adamw_init
from repro_torch.train.steps import make_fused_train_step

torch.set_num_threads(2)

ARCHS = ["llama3.2-1b", "mamba2-370m", "moonshot-v1-16b-a3b"]
# a short warmup so the 3 steps move the weights at a real lr
TC = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _batch(cfg, step, B=4, S=16):
    r = np.random.default_rng(100 + step)
    tok = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": tok.copy(),
            "weight": r.uniform(0.1, 1.0, (B,)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_run(arch, accum):
    cfg = jget_config(arch).reduced()
    jm = jbuild(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    step_fn = jax.jit(jmake_step(jm, JTrainConfig(**TC), accum_steps=accum))
    opt = jadamw_init(params)
    out = []
    for step in range(3):
        b = {k: jnp.asarray(v) for k, v in _batch(cfg, step).items()}
        params, opt, met = step_fn(params, opt, b, jnp.asarray(step, jnp.int32))
        out.append((flatten_tree(jax.tree.map(np.asarray, params)),
                    {k: float(v) for k, v in met.items()}))
    return init, out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_fused_train_step_matches_jax(arch, accum):
    init, jout = _jax_run(arch, accum)
    cfg = get_config(arch).reduced()
    tm = build_model(cfg)
    params = params_from_numpy(init, device="cpu")
    opt = adamw_init(params)
    step_fn = make_fused_train_step(tm, TrainConfig(**TC), accum_steps=accum)
    for step, (jp, jm) in enumerate(jout):
        b = {k: torch.from_numpy(v) for k, v in _batch(cfg, step).items()}
        params, opt, met = step_fn(params, opt, b, step)
        assert float(met["lr"]) == jm["lr"]
        np.testing.assert_allclose(float(met["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]), jm["grad_norm"], rtol=1e-4)
        for k, v in params.items():
            np.testing.assert_allclose(v.numpy(), jp[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert opt.step == 3


def test_accumulated_loss_equals_the_whole_batch():
    """accum 2 is the same objective as accum 1: the loss and grad norm
    after one step agree to f32 summation order."""
    cfg = get_config("llama3.2-1b").reduced()
    tm = build_model(cfg)
    init = tm.init(torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    mets = []
    for accum in (1, 2):
        params = {k: v.clone() for k, v in init.items()}
        _, _, met = make_fused_train_step(tm, TrainConfig(**TC), accum)(
            params, adamw_init(params), b, 0)
        mets.append(met)
    np.testing.assert_allclose(float(mets[1]["loss"]), float(mets[0]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(mets[1]["grad_norm"]), float(mets[0]["grad_norm"]),
                               rtol=1e-5)


def _remat_cfg(get, arch, remat):
    return dataclasses.replace(get(arch).reduced(), remat=remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bit_equal_and_match_jax_remat(arch):
    b = _batch(get_config(arch).reduced(), 0)
    jm = jbuild(_remat_cfg(jget_config, arch, "full"))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jl, jg = jax.jit(jax.value_and_grad(jm.weighted_loss))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    jg = flatten_tree(jax.tree.map(np.asarray, jg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    for remat in ("none", "full"):
        tm = build_model(_remat_cfg(get_config, arch, remat))
        leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        loss = tm.weighted_loss(leaves, tb)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(leaves.values())))
    assert torch.equal(out["none"][0], out["full"][0])
    for k, g0, g1 in zip(tp, out["none"][1], out["full"][1]):
        assert torch.equal(g0, g1), k
        np.testing.assert_allclose(g1.numpy(), jg[k], rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(out["full"][0]), float(jl), rtol=1e-5)


def test_remat_only_in_training():
    """The checkpoint wraps each repeat of a training forward with grad
    enabled, and nothing else: under no_grad the forward runs unwrapped."""
    from torch.utils import checkpoint as ckpt

    cfg = _remat_cfg(get_config, "llama3.2-1b", "full")
    tm = build_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    calls = []
    orig = ckpt.checkpoint

    def spy(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return orig(*a, **kw)

    import repro_torch.models.lm as lm_mod

    lm_mod.checkpoint, saved = spy, lm_mod.checkpoint
    try:
        with torch.no_grad():
            tm.weighted_loss(params, b)
        assert calls == []
        tm.weighted_loss(params, b)
        assert calls == [False] * tm.n_rep
    finally:
        lm_mod.checkpoint = saved
