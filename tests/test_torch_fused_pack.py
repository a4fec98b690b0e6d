"""The port's fused step, packed on the device, against the JAX engine's
host pack and the port's own ``reference`` backend.

The JAX host pack is its engine's own pieces, called as its host-pack
branch calls them: ``_flat_batch`` (the numpy pack), ``_vg`` on the flat
batch (its gradients) and ``_make_fused_step_host`` (its AdamW step).

The pattern of tests/test_device_path.py and tests/test_membership.py, on
the same toy model and the same numpy inputs in both packages:

- ``pack_flat_device`` with ``slot_weights_device`` equals JAX's flat
  batch for every registered scheme, exactly on the gathered rows and
  within atol 1e-7 / rtol 1e-6 on the weights (the device twins' f32
  formula may round the last bit differently from numpy's), on exact and
  partial-work outcomes.
- ``StepEngine._device_batch`` spreads each partition's total evenly over
  its weighted copies: the rows are JAX's and so is each partition's
  summed weight (atol 1e-7 / rtol 1e-6), though a copy's own weight may
  differ.
- Device-pack grads equal JAX's host-pack grads (atol 1e-6, rtol 1e-5)
  and the reference backend's, on exact and inexact outcomes.
- Three AdamW steps equal JAX's host-pack steps (loss rel 1e-6).
- A traced step's ``phase.upload`` counts JAX's rows and weighted rows.
- The first step after churn agrees across ``dev`` and ``ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import Codec as JCodec
from repro.core import get_scheme as jget_scheme
from repro.optim.adam import adamw_init as jadamw_init
from repro.train.engine import StepEngine as JStepEngine
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


def _engine(tc, backend="fused"):
    return StepEngine(_TToy(), TrainConfig(), tc, backend=backend, device="cpu")


def _jax_engine(jc, tc=None):
    return JStepEngine(_JToy(), tc or JTrainConfig(), jc, backend="fused")


def _jax_host_batch(jeng, pb, a, support=None):
    return {k: jnp.asarray(v) for k, v in jeng._flat_batch(pb, a, support).items()}


def _jax_host_grads(jc, p, pb, outcome):
    """JAX's host-pack gradients: the flat batch packed in numpy, then the
    engine's value-and-grad of the weighted loss on it."""
    jeng = _jax_engine(jc)
    return jeng._vg(jax.tree.map(jnp.asarray, p),
                    _jax_host_batch(jeng, pb, outcome.a, outcome.support))[1]


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


def _tbatch(pb):
    return {k: torch.from_numpy(v) for k, v in pb.items()}


@pytest.mark.parametrize("name", SCHEMES)
def test_device_twins_equal_jax_host_flat_batch(name):
    jc, tc = _codecs(name)
    jeng = _jax_engine(jc)
    pb = _partition_batch(tc.k)
    pids = torch.as_tensor(tc.plan.slot_pids, dtype=torch.long)
    for a, sup in _decodes(tc):
        want = jeng._flat_batch(pb, a, sup)
        sup_dev = (torch.ones((tc.m, tc.k)) if sup is None
                   else torch.as_tensor(sup, dtype=torch.float32))
        w = slot_weights_device(
            torch.as_tensor(a, dtype=torch.float32), sup_dev,
            torch.as_tensor(tc.plan.slot_coeff), torch.as_tensor(tc.plan.slot_mask),
            pids, tc.k,
        )
        got = pack_flat_device(_tbatch(pb), pids, w)
        assert set(got) == set(want)
        for key in ("x", "y"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"{name}/{key}")
        assert got["weight"].dtype == torch.float32
        np.testing.assert_allclose(got["weight"].numpy(), want["weight"], atol=1e-7, rtol=1e-6,
                                   err_msg=f"{name}/weight")


@pytest.mark.parametrize("name", SCHEMES)
def test_spread_weights_keep_jax_partition_totals(name):
    jc, tc = _codecs(name)
    jeng = _jax_engine(jc)
    eng = _engine(tc)
    pb = _partition_batch(tc.k)
    mb = pb["y"].shape[1]
    row_pid = np.repeat(tc.plan.slot_pids.reshape(-1), mb)
    for a, sup in _decodes(tc):
        want = jeng._flat_batch(pb, a, sup)
        got = eng._device_batch(_tbatch(pb), a, sup)
        for key in ("x", "y"):
            np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=f"{name}/{key}")
        totals = np.bincount(row_pid, weights=got["weight"].double().numpy(), minlength=tc.k)
        want_totals = np.bincount(row_pid, weights=want["weight"].astype(np.float64),
                                  minlength=tc.k)
        np.testing.assert_allclose(totals, want_totals, atol=1e-7, rtol=1e-6,
                                   err_msg=f"{name}/partition totals")


@pytest.mark.parametrize("name", SCHEMES)
def test_device_pack_gradients_match_jax_and_reference(name):
    """Exact decode: the port's device-pack grads == JAX's host-pack grads
    == the port's paper-protocol oracle."""
    jc, tc = _codecs(name)
    p = _params()
    pb = _partition_batch(tc.k, seed=5)
    g_dev = _engine(tc).gradients(_tparams(p), pb, tc.decode_outcome(range(tc.m)))
    g_ref = _engine(tc, backend="reference").gradients(
        _tparams(p), pb, tc.decode_outcome(range(tc.m)))
    g_jax = _jax_host_grads(jc, p, pb, jc.decode_outcome(range(jc.m)))
    _close(g_dev, g_jax, atol=1e-6, rtol=1e-5, msg="dev vs JAX host: ")
    _close(g_dev, g_ref, atol=3e-5, rtol=3e-4, msg="dev vs ref: ")


@pytest.mark.parametrize("name", ["partial_work", "bernoulli", "heter_aware"])
@pytest.mark.parametrize("seed", [0, 7, 23])
def test_device_pack_gradients_match_on_inexact_outcomes(name, seed):
    rng = np.random.default_rng(seed)
    jc, codec = _codecs(name, seed=seed % 3)
    support = (rng.uniform(size=(codec.m, codec.k)) < 0.6).astype(np.float64)
    p = _params(seed)
    pb = _partition_batch(codec.k, seed=seed)
    outcome = codec.decode_partial(support)
    g_dev = _engine(codec).gradients(_tparams(p), pb, outcome)
    g_ref = _engine(codec, backend="reference").gradients(_tparams(p), pb, outcome)
    g_jax = _jax_host_grads(jc, p, pb, jc.decode_partial(support))
    _close(g_dev, g_jax, atol=1e-6, rtol=1e-5, msg="dev vs JAX host: ")
    _close(g_dev, g_ref, atol=3e-5, rtol=3e-4, msg="dev vs ref: ")


def test_full_step_device_pack_equals_jax():
    tc_cfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    jtc_cfg = JTrainConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    p = _params(4)
    jc, codec = _codecs("heter_aware")
    eng = StepEngine(_TToy(), tc_cfg, codec, backend="fused", device="cpu")
    params = _tparams(p)
    st = TrainerState(params=params, opt=adamw_init(params), step=0)
    jeng = _jax_engine(jc, jtc_cfg)
    jstep = jax.jit(jeng._make_fused_step_host())
    jparams = jax.tree.map(jnp.asarray, p)
    jopt = jadamw_init(jparams)
    for i in range(3):
        st, met = eng.step(st, _partition_batch(codec.k, seed=i), codec.decode_vector([0, 2, 3]))
        jbatch = _jax_host_batch(jeng, _partition_batch(jc.k, seed=i), jc.decode_vector([0, 2, 3]))
        jparams, jopt, jmet = jstep(jparams, jopt, jbatch, jnp.asarray(i))
        assert met["loss"] == pytest.approx(float(jmet["loss"]), rel=1e-6)
    _close(st.params, jparams, atol=1e-6, rtol=1e-5)


def test_upload_row_counts_equal_jax_flat_batch():
    """A traced fused step's ``phase.upload`` carries the pass's rows and
    those with a nonzero weight: JAX's flat batch's, on a decode that
    leaves a worker out."""
    jc, tc = _codecs("heter_aware")
    p = _params()
    pb = _partition_batch(tc.k)
    eng = _engine(tc)
    eng.tracer = Tracer()
    params = _tparams(p)
    eng.step(TrainerState(params=params, opt=adamw_init(params), step=0), pb,
             tc.decode_vector([0, 2, 3]))
    (upload,) = [r for r in eng.tracer.records(kind="span") if r["name"] == "phase.upload"]
    want = _jax_engine(jc)._flat_batch(pb, jc.decode_vector([0, 2, 3]))
    weighted = int(np.count_nonzero(want["weight"]))
    assert 0 < weighted < len(want["y"])
    assert (upload["args"]["rows"], upload["args"]["weighted_rows"]) == (len(want["y"]), weighted)


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
    engines = {"dev": _engine(codec), "ref": _engine(codec, backend="reference")}
    p = _params(1)
    # warm the device-plan cache on the PRE-churn plan, then churn
    pb = _partition_batch(codec.k, mb=2, seed=1)
    engines["dev"].gradients(_tparams(p), pb, codec.decode_outcome(range(codec.m)))
    ctl.add_workers(rng.uniform(1.0, 4.0, _DELTA[name]))
    ctl.remove_workers(list(range(_DELTA[name])))
    pb = _partition_batch(codec.k, mb=2, seed=2)
    outcome = codec.decode_outcome(range(codec.m))
    g = {key: eng.gradients(_tparams(p), pb, outcome) for key, eng in engines.items()}
    _close(g["dev"], g["ref"], atol=3e-5, rtol=3e-4)
