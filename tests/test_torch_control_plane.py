"""The port's numpy control plane is bit-equal to the JAX package's.

For every registered scheme family, several seeds and worker counts: the
B matrix, allocation counts and partitions, decode vectors and
DecodeOutcome residuals, the slot plan, ClusterSim.run statistics and the
synthetic data batches must be ``np.array_equal`` to ``repro``'s.
"""

import itertools

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import registry as jreg
from repro.core.aggregator import make_plan as jmake_plan
from repro.core.simulator import ClusterSim as JSim
from repro.core.straggler import FixedDelayStragglers as JDelay
from repro.core.straggler import TransientStragglers as JTransient
from repro.data.pipeline import SyntheticData as JData
from repro_torch.configs import get_config
from repro_torch.core import registry as treg
from repro_torch.core.aggregator import make_plan
from repro_torch.core.simulator import ClusterSim
from repro_torch.core.straggler import FixedDelayStragglers, TransientStragglers
from repro_torch.data.pipeline import SyntheticData

SCHEMES = sorted(jreg.scheme_names())
CASES = [(m, seed) for m in (4, 6) for seed in (0, 1)]


def _speeds(m, seed):
    return np.random.default_rng(100 + seed).uniform(1.0, 3.0, m)


def _pair(name, m, seed):
    c = _speeds(m, seed)
    kw = dict(m=m, k=2 * m, s=1, c=c, rng=seed)
    return jreg.get_scheme(name, **kw), treg.get_scheme(name, **kw)


def test_registry_lists_the_same_families():
    assert sorted(treg.scheme_names()) == SCHEMES
    assert len(SCHEMES) == 7
    assert treg._FAMILY_MODULES == ("repro_torch.core.schemes", "repro_torch.approx.schemes")


@pytest.mark.parametrize("m,seed", CASES)
@pytest.mark.parametrize("name", SCHEMES)
def test_code_allocation_and_plan_bit_equal(name, m, seed):
    j, t = _pair(name, m, seed)
    assert (t.m, t.k, t.s) == (j.m, j.k, j.s)
    np.testing.assert_array_equal(t.B, j.B)
    assert tuple(t.allocation.counts) == tuple(j.allocation.counts)
    assert [tuple(p) for p in t.allocation.partitions] == [tuple(p) for p in j.allocation.partitions]
    jp, tp = jmake_plan(j.scheme), make_plan(t.scheme)
    for field in ("slot_pids", "slot_mask", "slot_coeff"):
        np.testing.assert_array_equal(getattr(tp, field), getattr(jp, field))


@pytest.mark.parametrize("m,seed", CASES)
@pytest.mark.parametrize("name", SCHEMES)
def test_decode_vectors_and_outcomes_bit_equal(name, m, seed):
    j, t = _pair(name, m, seed)
    for r in range(1, m + 1):
        for avail in itertools.combinations(range(m), r):
            jo, to = j.decode_outcome(avail), t.decode_outcome(avail)
            np.testing.assert_array_equal(to.a, jo.a)
            assert to.exact == jo.exact and to.residual == jo.residual
    sup = np.asarray(j.B != 0, np.float64)
    sup *= np.random.default_rng(seed).uniform(size=sup.shape) < 0.6
    jo, to = j.decode_partial(sup), t.decode_partial(sup)
    np.testing.assert_array_equal(to.a, jo.a)
    assert to.residual == jo.residual and to.exact == jo.exact


@pytest.mark.parametrize("m,seed", CASES)
@pytest.mark.parametrize("name", SCHEMES)
def test_cluster_sim_run_bit_equal(name, m, seed):
    j, t = _pair(name, m, seed)
    c = _speeds(m, seed + 7)
    for jmodel, tmodel in ((JDelay(s=1, delay=np.inf), FixedDelayStragglers(s=1, delay=np.inf)),
                           (JTransient(), TransientStragglers())):
        jr = JSim(j, c, comm_time=0.01, wait_for_all=j.wait_for_all).run(jmodel, 40, rng=seed)
        tr = ClusterSim(t, c, comm_time=0.01, wait_for_all=t.wait_for_all).run(tmodel, 40, rng=seed)
        for field in ("mean_T", "p50_T", "p99_T", "resource_usage", "busy_usage", "failures"):
            a, b = getattr(tr, field), getattr(jr, field)
            assert a == b or (np.isnan(a) and np.isnan(b)), field
        for it_t, it_j in zip(tr.iters, jr.iters):
            np.testing.assert_array_equal(it_t.finish, it_j.finish)
            assert it_t.T == it_j.T


@pytest.mark.parametrize("arch", ["smollm-360m", "llama3.2-1b"])
def test_synthetic_data_bit_equal(arch):
    for reduced in (True, False):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert tcfg == tcfg.__class__(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
        for step in (0, 3):
            jb = JData(jcfg, k=8, part_mb=2, seq_len=64, seed=1).batch(step)
            tb = SyntheticData(tcfg, k=8, part_mb=2, seq_len=64, seed=1).batch(step)
            assert list(tb) == list(jb)
            for key in jb:
                assert tb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(tb[key], jb[key])
