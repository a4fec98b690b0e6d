"""The port's StepEngine backends against the JAX engine's.

Same parameters, batch and DecodeOutcome on both sides (exact with one
straggler, and partial work), for several schemes: the port's ``spmd``,
``fused`` and ``reference`` decoded gradients are allclose to the JAX
engine's ``fused`` and ``reference`` gradients (f32; sums in another
order, hence rtol 1e-5).  The pattern of tests/test_unified_step.py, with
a duck-typed toy model on both sides, plus the reduced smollm-360m on the
spmd path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.base import CodingConfig as JCodingConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.aggregator import fused_coded_value_and_grad as jfused_vg
from repro.core.codec import Codec as JCodec
from repro.train.engine import StepEngine as JStepEngine
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.aggregator import FlatView, fused_coded_value_and_grad
from repro_torch.core.codec import Codec
from repro_torch.kernels.coded_reduce import coded_reduce
from repro_torch.train.engine import StepEngine

torch.set_num_threads(2)

D_IN, H = 4, 8
SCHEMES = ["heter_aware", "cyclic", "group_based", "fractional_repetition", "partial_work"]


class _JToy:
    def init(self, rng):
        raise AssertionError("parameters come from numpy")

    def weighted_loss(self, params, batch):
        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])


class _TToy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _params(seed=0):
    r = np.random.default_rng(seed)
    return {"w1": r.normal(size=(D_IN, H)).astype(np.float32),
            "w2": r.normal(size=(H, 1)).astype(np.float32)}


def _batch(k, mb=2, seed=1):
    r = np.random.default_rng(seed)
    return {"x": r.normal(size=(k, mb, D_IN)).astype(np.float32),
            "y": r.normal(size=(k, mb)).astype(np.float32)}


def _codecs(scheme, m=4):
    coding = dict(scheme=scheme, s=1)
    jc = JCodec.from_config(JCodingConfig(**coding), m=m, c_init=[1.0, 2.0, 2.0, 3.0], rng=5)
    tc = Codec.from_config(CodingConfig(**coding), m=m, c_init=[1.0, 2.0, 2.0, 3.0], rng=5)
    np.testing.assert_array_equal(jc.plan.slot_pids, tc.plan.slot_pids)
    np.testing.assert_array_equal(jc.plan.slot_coeff, tc.plan.slot_coeff)
    return jc, tc


def _outcomes(jc, tc, kind):
    """The same DecodeOutcome built by each package's own codec."""
    if kind == "straggler":
        avail = [0, 2, 3]
        return jc.decode_outcome(avail), tc.decode_outcome(avail)
    r = np.random.default_rng(3)
    held = np.asarray(jc.code.B != 0, np.float64)
    sup = held * (r.uniform(size=held.shape) < 0.7)
    return jc.decode_partial(sup), tc.decode_partial(sup)


@functools.lru_cache(maxsize=None)
def _jax_grads(scheme, kind):
    jc, tc = _codecs(scheme)
    jo, to = _outcomes(jc, tc, kind)
    np.testing.assert_array_equal(jo.a, to.a)
    p, b = _params(), _batch(jc.k)
    out = {}
    for backend in ("fused", "reference"):
        eng = JStepEngine(_JToy(), JTrainConfig(), jc, backend=backend)
        g = eng.gradients(jax.tree.map(jnp.asarray, p), b, jo)
        out[backend] = jax.tree.map(np.asarray, g)
    return out


@pytest.mark.parametrize("kind", ["straggler", "partial"])
@pytest.mark.parametrize("backend", ["spmd", "fused", "reference"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_backend_matches_jax_engine(scheme, backend, kind):
    jc, tc = _codecs(scheme)
    _, to = _outcomes(jc, tc, kind)
    eng = StepEngine(_TToy(), TrainConfig(), tc, backend=backend, device="cpu")
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    g = eng.gradients(p, _batch(tc.k), to)
    for ref_backend, ref in _jax_grads(scheme, kind).items():
        for key in ref:
            np.testing.assert_allclose(
                g[key].numpy(), ref[key], rtol=1e-5, atol=1e-6,
                err_msg=f"{backend} vs JAX {ref_backend}: {key}",
            )


def test_spmd_makes_no_launches_on_cpu():
    jc, tc = _codecs("heter_aware")
    eng = StepEngine(_TToy(), TrainConfig(), tc, backend="spmd", device="cpu")
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    eng.gradients(p, _batch(tc.k), tc.decode_outcome([0, 1, 2]))
    assert coded_reduce.launches == 0


def test_fused_value_and_grad_matches_jax():
    jc, tc = _codecs("heter_aware")
    p, b = _params(), _batch(jc.k)
    w = jc.slot_weights(jc.decode_outcome([1, 2, 3]))
    jsb = jc.pack(jax.tree.map(jnp.asarray, b))
    jl, jg = jax.jit(jfused_vg(lambda pp, bb: _JToy().weighted_loss(
        pp, {**bb, "weight": jnp.full((bb["x"].shape[0],), 0.5, jnp.float32)})))(
        jax.tree.map(jnp.asarray, p), jsb, jnp.asarray(w))
    tsb = tc.pack({k: torch.from_numpy(v) for k, v in b.items()})

    def tloss(pp, bb):
        return _TToy().weighted_loss(pp, {**bb, "weight": torch.full((bb["x"].shape[0],), 0.5)})

    tl, tg = fused_coded_value_and_grad(tloss)(
        {k: torch.from_numpy(v) for k, v in p.items()}, tsb, torch.from_numpy(w))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in tg:
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_flat_view_unravel_follows_ravel_pytree(dtypes):
    """Unravel keeps the flat dtype when every leaf shares one dtype, and
    casts back per leaf otherwise — jax.flatten_util.ravel_pytree's rule."""
    shapes = {"a": (2, 3), "b": (4,)}
    jp = {k: jnp.ones(s, dt) for (k, s), dt in zip(shapes.items(), dtypes)}
    tp = {k: torch.ones(s, dtype=getattr(torch, dt)) for (k, s), dt in zip(shapes.items(), dtypes)}
    flat, unravel = ravel_pytree(jp)
    jout = unravel(flat.astype(jnp.float32))
    view = FlatView(tp)
    tout = view.unravel(torch.zeros(view.size, dtype=torch.float32))
    assert view.size == flat.size
    for k in shapes:
        assert str(tout[k].dtype).split(".")[-1] == str(jout[k].dtype)


def test_lm_spmd_matches_jax_fused():
    """The real model on the spmd path: reduced smollm-360m (f32), one
    straggler, against the JAX fused engine at equal weights."""
    from repro.configs import get_config as jget_config
    from repro.data.pipeline import SyntheticData as JData
    from repro.models.lm import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model, flatten_tree, params_from_numpy

    jc, tc = _codecs("heter_aware")
    jcfg = jget_config("smollm-360m").reduced()
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = JData(jcfg, k=jc.k, part_mb=2, seq_len=16, seed=0).batch(0)
    jo, to = _outcomes(jc, tc, "straggler")
    jg = JStepEngine(jm, JTrainConfig(), jc, backend="fused").gradients(jp, batch, jo)
    tm = build_model(get_config("smollm-360m").reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tg = StepEngine(tm, TrainConfig(), tc, backend="spmd", device="cpu").gradients(tp, batch, to)
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    for key in tg:
        np.testing.assert_allclose(tg[key].numpy(), jflat[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
