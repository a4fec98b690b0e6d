"""The port's ``StepEngine(host_pack=True)`` against the JAX engine's host
pack and the port's own device pack.

The pattern of tests/test_device_path.py and tests/test_membership.py, on
the same toy model and the same numpy inputs in both packages:

- ``_flat_batch`` equals JAX's for every registered scheme, exactly on the
  gathered batch and within atol 1e-7 / rtol 1e-6 on the weights (both
  are numpy; the port's and JAX's plans are bit-equal), on exact and
  partial-work outcomes, and the device pack equals it at the same
  tolerance (the device twins' f32 formula may round the last bit
  differently from numpy's).
- Host-pack grads equal device-pack grads (atol 1e-6, rtol 1e-5: the same
  math on one device), JAX's host-pack grads and the reference backend's.
- A full step equals the device pack's and JAX's host-pack step (loss rel
  1e-6).
- The first step after churn agrees across ``dev``, ``host`` and ``ref``.
- The trace spans are JAX's: ``phase.pack+upload`` then ``phase.fused``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import Codec as JCodec
from repro.core import get_scheme as jget_scheme
from repro.obs.trace import Tracer as JTracer
from repro.optim.adam import adamw_init as jadamw_init
from repro.train.engine import StepEngine as JStepEngine
from repro.train.engine import TrainerState as JTrainerState
from repro_torch.configs.base import TrainConfig
from repro_torch.core import Codec, get_scheme, scheme_names
from repro_torch.core.aggregator import pack_flat_device, slot_weights_device
from repro_torch.obs.trace import Tracer
from repro_torch.optim.adam import adamw_init
from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import StepEngine, TrainerState

torch.set_num_threads(2)

_C4 = [1.0, 2.0, 3.0, 2.0]
SCHEMES = sorted(scheme_names())


class _JToy:
    def weighted_loss(self, params, batch):
        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])


class _TToy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _params(seed=2):
    r = np.random.default_rng(seed)
    return {"w1": r.normal(size=(4, 8)).astype(np.float32),
            "w2": r.normal(size=(8, 1)).astype(np.float32)}


def _tparams(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _partition_batch(k, mb=3, d=4, seed=0):
    r = np.random.default_rng(seed)
    return {
        "x": r.normal(size=(k, mb, d)).astype(np.float32),
        "y": r.normal(size=(k, mb)).astype(np.float32),
    }


def _codecs(name, seed=0):
    jc = JCodec(jget_scheme(name, m=4, k=8, s=1, c=_C4, rng=seed))
    tc = Codec(get_scheme(name, m=4, k=8, s=1, c=_C4, rng=seed))
    np.testing.assert_array_equal(jc.plan.slot_pids, tc.plan.slot_pids)
    np.testing.assert_array_equal(jc.plan.slot_coeff, tc.plan.slot_coeff)
    return jc, tc


def _engine(tc, backend="fused", host_pack=False):
    return StepEngine(_TToy(), TrainConfig(), tc, backend=backend, device="cpu",
                      host_pack=host_pack)


def _close(got: dict, want: dict, atol, rtol, msg=""):
    for key in want:
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else np.asarray(got[key])
        np.testing.assert_allclose(g, np.asarray(want[key]), atol=atol, rtol=rtol,
                                   err_msg=f"{msg}{key}")


def _decodes(codec):
    rng = np.random.default_rng(3)
    outcome = codec.decode_outcome(range(codec.m))
    support = (rng.uniform(size=(codec.m, codec.k)) < 0.7).astype(np.float64)
    return [(outcome.a, None), (outcome.a, support)]


@pytest.mark.parametrize("name", SCHEMES)
def test_flat_batch_equals_jax_host_pack(name):
    jc, tc = _codecs(name)
    jeng = JStepEngine(_JToy(), JTrainConfig(), jc, backend="fused", host_pack=True)
    teng = _engine(tc, host_pack=True)
    pb = _partition_batch(tc.k)
    for a, sup in _decodes(tc):
        want = jeng._flat_batch(pb, a, sup)
        got = teng._flat_batch(pb, a, sup)
        assert set(got) == set(want)
        for key in ("x", "y"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}/{key}")
        assert got["weight"].dtype == np.float32
        np.testing.assert_allclose(got["weight"], want["weight"], atol=1e-7, rtol=1e-6,
                                   err_msg=f"{name}/weight")


@pytest.mark.parametrize("name", SCHEMES)
def test_device_pack_matches_host_flat_batch(name):
    _, codec = _codecs(name)
    eng = _engine(codec, host_pack=True)
    pb = _partition_batch(codec.k)
    pids = torch.as_tensor(codec.plan.slot_pids, dtype=torch.long)
    for a, sup in _decodes(codec):
        host = eng._flat_batch(pb, a, sup)
        sup_dev = (torch.ones((codec.m, codec.k)) if sup is None
                   else torch.as_tensor(sup, dtype=torch.float32))
        w = slot_weights_device(
            torch.as_tensor(a, dtype=torch.float32), sup_dev,
            torch.as_tensor(codec.plan.slot_coeff), torch.as_tensor(codec.plan.slot_mask),
            pids, codec.k,
        )
        dev = pack_flat_device({k: torch.from_numpy(v) for k, v in pb.items()}, pids, w)
        assert set(dev) == set(host)
        _close(dev, host, atol=1e-7, rtol=1e-6, msg=f"{name}/")


@pytest.mark.parametrize("name", SCHEMES)
def test_host_pack_gradients_match_device_jax_and_reference(name):
    """Exact decode: the port's host-pack grads == its device-pack grads ==
    JAX's host-pack grads == the port's paper-protocol oracle."""
    jc, tc = _codecs(name)
    p = _params()
    pb = _partition_batch(tc.k, seed=5)
    outcome = tc.decode_outcome(range(tc.m))
    g_host = _engine(tc, host_pack=True).gradients(_tparams(p), pb, outcome)
    g_dev = _engine(tc).gradients(_tparams(p), pb, outcome)
    g_ref = _engine(tc, backend="reference").gradients(_tparams(p), pb, outcome)
    g_jax = JStepEngine(_JToy(), JTrainConfig(), jc, backend="fused", host_pack=True).gradients(
        jax.tree.map(jnp.asarray, p), pb, jc.decode_outcome(range(jc.m)))
    _close(g_host, g_dev, atol=1e-6, rtol=1e-5, msg="host vs dev: ")
    _close(g_host, g_jax, atol=1e-6, rtol=1e-5, msg="host vs JAX host: ")
    _close(g_dev, g_ref, atol=3e-5, rtol=3e-4, msg="dev vs ref: ")


@pytest.mark.parametrize("name", ["partial_work", "bernoulli", "heter_aware"])
@pytest.mark.parametrize("seed", [0, 7, 23])
def test_host_pack_gradients_match_on_inexact_outcomes(name, seed):
    rng = np.random.default_rng(seed)
    _, codec = _codecs(name, seed=seed % 3)
    support = (rng.uniform(size=(codec.m, codec.k)) < 0.6).astype(np.float64)
    outcome = codec.decode_partial(support)
    p = _params(seed)
    pb = _partition_batch(codec.k, seed=seed)
    g_dev = _engine(codec).gradients(_tparams(p), pb, outcome)
    g_host = _engine(codec, host_pack=True).gradients(_tparams(p), pb, outcome)
    g_ref = _engine(codec, backend="reference").gradients(_tparams(p), pb, outcome)
    _close(g_host, g_dev, atol=1e-6, rtol=1e-5)
    _close(g_dev, g_ref, atol=3e-5, rtol=3e-4)


def test_full_step_host_pack_equals_device_pack_and_jax():
    tc_cfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    jtc_cfg = JTrainConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    p = _params(4)
    runs = {}
    for hp in (False, True):
        _, codec = _codecs("heter_aware")
        eng = StepEngine(_TToy(), tc_cfg, codec, backend="fused", device="cpu", host_pack=hp)
        params = _tparams(p)
        st = TrainerState(params=params, opt=adamw_init(params), step=0)
        for i in range(3):
            st, met = eng.step(st, _partition_batch(codec.k, seed=i), codec.decode_vector([0, 2, 3]))
        runs[hp] = (st, met)
    jc, _ = _codecs("heter_aware")
    jeng = JStepEngine(_JToy(), jtc_cfg, jc, backend="fused", host_pack=True)
    jp = jax.tree.map(jnp.asarray, p)
    jst = JTrainerState(params=jp, opt=jadamw_init(jp), step=0)
    for i in range(3):
        jst, jmet = jeng.step(jst, _partition_batch(jc.k, seed=i), jc.decode_vector([0, 2, 3]))
    (dev_st, dev_met), (host_st, host_met) = runs[False], runs[True]
    assert host_met["loss"] == pytest.approx(dev_met["loss"], rel=1e-6)
    assert host_met["loss"] == pytest.approx(jmet["loss"], rel=1e-6)
    _close(host_st.params, dev_st.params, atol=1e-6, rtol=1e-6)
    _close(host_st.params, jst.params, atol=1e-6, rtol=1e-5)


def test_host_pack_trace_spans_equal_jax():
    """``phase.pack+upload`` on the host, then ``phase.fused``: the names
    and arguments of the JAX engine's spans."""
    jc, tc = _codecs("heter_aware")
    p = _params()
    pb = _partition_batch(tc.k)
    teng = _engine(tc, host_pack=True)
    teng.tracer = Tracer()
    params = _tparams(p)
    teng.step(TrainerState(params=params, opt=adamw_init(params), step=0), pb,
              tc.decode_vector([0, 2, 3]))
    jeng = JStepEngine(_JToy(), JTrainConfig(), jc, backend="fused", host_pack=True)
    jeng.tracer = JTracer()
    jp = jax.tree.map(jnp.asarray, p)
    jeng.step(JTrainerState(params=jp, opt=jadamw_init(jp), step=0), pb,
              jc.decode_vector([0, 2, 3]))
    got = [(r["name"], r["args"]) for r in teng.tracer.records(kind="span")]
    want = [(r["name"], r["args"]) for r in jeng.tracer.records(kind="span")]
    assert got == want == [("phase.pack+upload", {"where": "host"}),
                           ("phase.fused", {"phases": "fwd+bwd+decode+apply"})]


# per-scheme churn constraints of tests/test_membership.py
_S = {name: (0 if name == "naive" else 1) for name in SCHEMES}
_DELTA = {name: (2 if name == "fractional_repetition" else 1) for name in SCHEMES}
_MIN_M = {name: max(2, _S[name] + 2, _DELTA[name] * 2) for name in SCHEMES}


@pytest.mark.parametrize("name", SCHEMES)
def test_backends_grad_equal_on_first_post_churn_step(name):
    rng = np.random.default_rng(4)
    m = _MIN_M[name] + 2 * _DELTA[name]
    speeds = rng.uniform(1.0, 4.0, m)
    code = get_scheme(name, m=m, k=2 * m, s=_S[name], c=speeds,
                      rng=int(rng.integers(1 << 30)))
    codec = Codec(code)
    ctl = ElasticController(codec, true_speeds=speeds, c_init=speeds)
    engines = {"dev": _engine(codec), "host": _engine(codec, host_pack=True),
               "ref": _engine(codec, backend="reference")}
    p = _params(1)
    # warm the device-plan cache on the PRE-churn plan, then churn
    pb = _partition_batch(codec.k, mb=2, seed=1)
    engines["dev"].gradients(_tparams(p), pb, codec.decode_outcome(range(codec.m)))
    ctl.add_workers(rng.uniform(1.0, 4.0, _DELTA[name]))
    ctl.remove_workers(list(range(_DELTA[name])))
    pb = _partition_batch(codec.k, mb=2, seed=2)
    outcome = codec.decode_outcome(range(codec.m))
    g = {key: eng.gradients(_tparams(p), pb, outcome) for key, eng in engines.items()}
    _close(g["host"], g["dev"], atol=1e-6, rtol=1e-5)
    _close(g["dev"], g["ref"], atol=3e-5, rtol=3e-4)
