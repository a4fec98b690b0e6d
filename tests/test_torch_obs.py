"""The port's tracing and forensics against the JAX package's.

Two traced runs of a toy model, each taken by the port's trainer and the
JAX trainer with the same seeds: a faulted run (m=5, equal speeds: a
corrupt worker repaired then convicted, a crash, a hang with re-admission,
a flaky worker) and an inexact run (two workers never arrive, a fixed
deadline, so every step decodes best-effort and stragglers are blamed).

Held:
  - tracing on and off give bit-equal params and metrics on ``fused``,
    ``spmd`` and ``spmd --compress``, and tracing off records nothing;
  - the ``train.step`` records equal the JAX trainer's on every key that
    does not come from the wall clock (loss, grad_norm and lr within rtol
    1e-4: two frameworks' float math), and so do the fault instants;
  - ``StragglerForensics.from_records`` over the port's log equals it over
    the JAX log, and the live ledger equals the offline rebuild;
  - the engine's phase spans (``phase.spmd.pack/grads/unravel`` with the
    kernels that ran) nest in their step, ``prefetch.upload`` lies on tid 1;
  - the port's ``obs_report`` equals the JAX one on the same log and prints
    the phase table and the fault section.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.approx.deadline import DeadlinePolicy as JDeadlinePolicy
from repro.configs.base import CodingConfig as JCodingConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.straggler import FixedDelayStragglers as JDelay
from repro.launch import obs_report as jobs_report
from repro.obs import StragglerForensics as JForensics
from repro.obs import Tracer as JTracer
from repro.optim.adam import adamw_init as jadamw_init
from repro.resilience import parse_fault_spec as jparse_fault_spec
from repro.train.engine import TrainerState as JTrainerState
from repro.train.trainer import CodedTrainer as JTrainer
from repro_torch.approx.deadline import DeadlinePolicy
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.launch import obs_report
from repro_torch.obs import NULL_TRACER, StragglerForensics, Tracer
from repro_torch.optim.adam import adamw_init
from repro_torch.resilience import parse_fault_spec
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)

M, STEPS = 5, 12
SPEC = "corrupt:0@1..3,crash:4@3,hang:2@5+4,flaky:1@0..30:0.3"
_TC = dict(lr=1e-2, warmup_steps=2, total_steps=40)
# record keys that come from the wall clock, and those that come from float math
WALL = ("t", "seq")
NUMERIC = ("loss", "grad_norm", "lr")


class _JToy:
    def weighted_loss(self, params, batch):
        import jax.numpy as jnp

        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])


class _TToy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _batch(k, step):
    r = np.random.default_rng(1000 + step)
    x = r.normal(size=(k, 2, 4)).astype(np.float32)
    return {"x": x, "y": np.tanh(x.sum(-1)).astype(np.float32)}


def _params_np():
    r = np.random.default_rng(0)
    return {"w1": (r.normal(size=(4, 8)) * 0.3).astype(np.float32),
            "w2": (r.normal(size=(8, 1)) * 0.3).astype(np.float32)}


def _kwargs(case, jax_side):
    """Trainer keyword arguments of one of the two runs, for either package."""
    if case == "faults":
        parse = jparse_fault_spec if jax_side else parse_fault_spec
        return dict(m=M, part_mb=2, true_speeds=np.ones(M), comm_time=0.01, rng=3,
                    faults=parse(SPEC), fault_seed=5)
    delay = JDelay if jax_side else FixedDelayStragglers
    policy = JDeadlinePolicy if jax_side else DeadlinePolicy
    return dict(m=M, part_mb=2, true_speeds=np.linspace(1.0, 3.0, M), rng=0,
                straggler_model=delay(s=2, delay=np.inf),
                deadline_policy=policy(mode="fixed_deadline", deadline_s=5.0))


def _port(case, trace=None, backend="spmd", compress=False):
    coding = CodingConfig(scheme="heter_aware", s=1, rebalance_every=3, compress=compress,
                          wire_kernel=compress)
    return CodedTrainer(_TToy(), coding, TrainConfig(**_TC), backend=backend, device="cpu",
                        trace=trace, **_kwargs(case, False))


def _run_port(tr, steps=STEPS):
    p = {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}
    state = TrainerState(p, adamw_init(p), 0)
    hist = []
    for _ in range(steps):
        state, met = tr.step(state, _batch(tr.k, state.step))
        hist.append(met)
    return state, hist


def _records(tracer):
    return [json.loads(line) for line in tracer.iter_jsonl()]


@pytest.fixture(scope="module", params=["faults", "inexact"])
def runs(request):
    """The port's (spmd) and the JAX trainer's (fused) traced runs of one case."""
    case = request.param
    ttr = _port(case, Tracer())
    _run_port(ttr)
    jtracer = JTracer()
    jtr = JTrainer(_JToy(), JCodingConfig(scheme="heter_aware", s=1, rebalance_every=3),
                   JTrainConfig(**_TC), trace=jtracer, **_kwargs(case, True))
    p = {k: jax.numpy.asarray(v) for k, v in _params_np().items()}
    state = JTrainerState(p, jadamw_init(p), 0)
    for _ in range(STEPS):
        state, _ = jtr.step(state, _batch(jtr.k, state.step))
    return case, ttr, jtr


# ---------------------------------------------------------------------------
# tracing off: nothing recorded, bit-equal numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,compress", [("fused", False), ("spmd", False), ("spmd", True)],
                         ids=["fused", "spmd", "spmd-compress"])
def test_tracing_off_records_nothing_and_is_bit_equal(backend, compress):
    t_off = _port("faults", None, backend, compress)
    t_on = _port("faults", Tracer(), backend, compress)
    assert t_off.tracer is NULL_TRACER and t_off.forensics is None
    assert t_off.engine.tracer is NULL_TRACER and t_off.elastic.tracer is NULL_TRACER
    s_off, m_off = _run_port(t_off)
    s_on, m_on = _run_port(t_on)
    assert json.dumps(m_off) == json.dumps(m_on)  # same keys, bit-equal floats (NaN too)
    for k in s_off.params:
        assert s_off.params[k].numpy().tobytes() == s_on.params[k].numpy().tobytes()
        assert s_off.opt.nu[k].numpy().tobytes() == s_on.opt.nu[k].numpy().tobytes()
    assert len(t_on.tracer) > 0 and t_on.forensics is not None


# ---------------------------------------------------------------------------
# the event log against the JAX trainer's
# ---------------------------------------------------------------------------


def _strip(rec):
    """A record without its wall-clock keys (a sim-clock record keeps its
    simulated time)."""
    wall = ("seq",) if rec["clock"] == "sim" else WALL
    return {k: v for k, v in rec.items() if k not in wall}


def test_train_step_records_equal_jax(runs):
    _, ttr, jtr = runs
    ours = ttr.tracer.records("event", "train.step")
    theirs = jtr.tracer.records("event", "train.step")
    assert len(ours) == len(theirs) == STEPS
    for a, b in zip(ours, theirs):
        a, b = _strip(a), _strip(b)
        a_args, b_args = a.pop("args"), b.pop("args")
        assert a == b
        assert a_args.keys() == b_args.keys()
        for key in a_args:
            if key in NUMERIC:
                np.testing.assert_allclose(a_args[key], b_args[key], rtol=1e-4, err_msg=key)
            else:
                assert a_args[key] == b_args[key], (key, a_args[key], b_args[key])


def test_fault_and_sim_instants_equal_jax(runs):
    """Every sim-clock record and every fault instant: same names, same
    simulated times, same arguments, in the same order."""
    _, ttr, jtr = runs

    def pick(tracer):
        return [_strip(r) for r in tracer.records()
                if r["clock"] == "sim" or r["name"].startswith(("fault.", "guard."))]

    ours, theirs = pick(ttr.tracer), pick(jtr.tracer)
    assert ours and ours == theirs


def test_forensics_from_records_equal_jax(runs):
    case, ttr, jtr = runs
    ours = StragglerForensics.from_records(_records(ttr.tracer))
    theirs = JForensics.from_records([json.loads(x) for x in jtr.tracer.iter_jsonl()])
    assert ours.steps == theirs.steps and ours.hurt_steps == theirs.hurt_steps
    assert len(ours.epochs) == len(theirs.epochs)  # archived per membership epoch
    assert ours.blame_table() == theirs.blame_table()
    assert ours.summary() == theirs.summary()
    assert ours.fault_report() == theirs.fault_report()
    if case == "inexact":
        assert ours.hurt_steps == STEPS and sum(r["blame"] for r in ours.blame_table()) > 0
    else:
        assert {c["worker"] for c in ours.fault_report()["convictions"]} == {0, 2, 4}
    # the live ledger and the offline rebuild agree
    live = ttr.forensics
    assert [r["blame"] for r in live.blame_table()] == [r["blame"] for r in ours.blame_table()]
    assert live.fault_report()["convictions"] == ours.fault_report()["convictions"]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True], ids=["spmd", "spmd-compress"])
def test_spmd_phase_spans_nest_in_their_step(compress):
    tracer = Tracer()
    tr = _port("faults", tracer, "spmd", compress)

    class Data:
        def batch(self, step):
            return _batch(tr.k, step)

    p = {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}
    tr.run(TrainerState(p, adamw_init(p), 0), Data(), 6)
    spans = tracer.records("span")
    steps = [r for r in spans if r["name"] == "step"]
    outer = [r for r in spans if r["name"] == "phase.pack+encode+wire+decode"]
    assert len(steps) == 6 and len(outer) >= 6  # one a gradient attempt, repairs included
    for name in ("phase.spmd.pack", "phase.spmd.grads", "phase.spmd.unravel", "phase.loss",
                 "phase.apply"):
        inner = [r for r in spans if r["name"] == name]
        assert len(inner) == len(outer), name
        for r in inner:
            assert any(s["t0"] - 1e-9 <= r["t0"] and r["t1"] <= s["t1"] + 1e-9 for s in steps)
    for r in (r for r in spans if r["name"].startswith("phase.spmd.")):
        assert any(o["t0"] - 1e-9 <= r["t0"] and r["t1"] <= o["t1"] + 1e-9 for o in outer)
    kernels = {r["args"]["kernels"] for r in spans if r["name"] == "phase.spmd.grads"}
    assert kernels == {"coded_encode_int8+coded_decode_int8" if compress else "coded_reduce"}
    uploads = [r for r in spans if r["name"] == "prefetch.upload"]
    assert [r["args"]["step"] for r in uploads] == list(range(6))
    assert {r["tid"] for r in uploads} == {1}
    assert len(tracer.records("instant", "guard.nonfinite")) == 2


def test_fused_phase_spans():
    tracer = Tracer()
    tr = _port("inexact", tracer, "fused")
    _run_port(tr, 3)
    names = [r["name"] for r in tracer.records("span") if r["clock"] == "wall"]
    assert names.count("phase.upload") == names.count("phase.fused") == names.count("step") == 3


def test_chrome_trace_is_strict_json(runs, tmp_path):
    _, ttr, _ = runs
    path = tmp_path / "trace.json"
    ttr.tracer.write_chrome(str(path))
    with open(path) as f:
        doc = json.loads(f.read(), parse_constant=lambda c: pytest.fail(f"constant {c}"))
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0.0 and math.isfinite(e["ts"])


# ---------------------------------------------------------------------------
# obs_report
# ---------------------------------------------------------------------------


def test_obs_report_equals_jax_on_the_ports_log(runs, tmp_path, capsys):
    case, ttr, _ = runs
    path = str(tmp_path / "run.jsonl")
    assert ttr.tracer.write_jsonl(path) == len(ttr.tracer)
    recs = obs_report.load_records(path)
    assert recs == jobs_report.load_records(path)
    assert obs_report.phase_table(recs) == jobs_report.phase_table(recs)
    assert obs_report.blame_report(recs, top_k=3) == jobs_report.blame_report(recs, top_k=3)
    assert obs_report.fault_section(recs) == jobs_report.fault_section(recs)
    obs_report.main([path, "--top-k", "3"])
    ours = capsys.readouterr().out
    jobs_report.main([path, "--top-k", "3"])
    assert ours == capsys.readouterr().out
    assert "span breakdown" in ours and "phase.spmd.grads" in ours
    if case == "faults":
        assert "== faults ==" in ours and "-- convictions --" in ours
