"""The port's fault layer against the JAX package's: the ``--faults`` grammar,
the supervisor, and the trainer's quarantine-and-repair / evict / re-admit
path over one fault schedule.

One schedule on a toy model, m=5, s=1, equal worker speeds (every worker
arrives at τ, so a quarantined worker can be re-decoded around): a corrupt
worker 0 (repaired twice, then convicted), a crash of worker 4 (convicted
on timeout, evicted), a hang of worker 2 (evicted, then re-admitted under
its identity) and a flaky worker 1 (retried uploads, never convicted).  The
port's trainer and the JAX trainer take the same steps with the same seeds
on ``fused``, ``spmd`` and ``spmd --compress``: the control-plane metrics
are equal each step, loss and grad_norm within rtol 1e-4, and the
supervisor's summary and the m trajectory are equal.

The JAX references: ``fused`` in process for the port's ``fused`` and
``spmd`` (the decoded gradient is the same); the JAX ``spmd`` backend with
the int8 wire for ``spmd --compress``, which needs m devices, so it runs in
a subprocess of this file (``python tests/test_torch_resilience.py OUT``)
with ``--xla_force_host_platform_device_count=5``.

Also: a poisoned ``engine.step`` leaves params and optimizer state
bit-unchanged on every backend, so a repair's second attempt starts from
the state the poisoned attempt saw (the port updates in place where the
JAX engine donates); and the supervisor's resilience patterns of
``tests/test_resilience.py`` on the port alone.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import CodingConfig as JCodingConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim.adam import adamw_init as jadamw_init
from repro.resilience import parse_fault_spec as jparse_fault_spec
from repro.resilience import standard_fault_mix as jstandard_fault_mix
from repro.train.engine import TrainerState as JTrainerState
from repro.train.trainer import CodedTrainer as JTrainer
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.simulator import FaultEvent, FaultSchedule
from repro_torch.optim.adam import adamw_init
from repro_torch.resilience import FaultSupervisor, parse_fault_spec, standard_fault_mix
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)

M, STEPS = 5, 14
SPEC = "corrupt:0@1..3,crash:4@3,hang:2@5+4,flaky:1@0..30:0.3"
FAULT_SEED = 5
EQUAL = ("sim_iter_time", "n_stragglers", "n_used", "decode_residual", "exact_fraction",
         "exact", "skipped", "skipped_nonfinite", "repaired", "membership_epoch", "m",
         "moved_partitions", "rebalanced")


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


def _common(m=M):
    return dict(m=m, part_mb=2, true_speeds=np.ones(m), comm_time=0.01, rng=3,
                fault_seed=FAULT_SEED)


_TC = dict(lr=1e-2, warmup_steps=2, total_steps=40)


def _port_trainer(backend, compress=False, spec=SPEC, **kw):
    return CodedTrainer(
        _TToy(), CodingConfig(scheme="heter_aware", s=1, rebalance_every=3,
                              compress=compress, wire_kernel=compress),
        TrainConfig(**_TC), faults=parse_fault_spec(spec), backend=backend,
        device="cpu", **{**_common(), **kw},
    )


def _port_state():
    p = {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}
    return TrainerState(p, adamw_init(p), 0)


def _run_jax(trainer, steps):
    import jax.numpy as jnp

    p = {k: jnp.asarray(v) for k, v in _params_np().items()}
    state = JTrainerState(p, jadamw_init(p), 0)
    hist, ms = [], []
    for _ in range(steps):
        state, met = trainer.step(state, _batch(trainer.k, state.step))
        hist.append({k: float(v) for k, v in met.items()})
        ms.append(trainer.m)
    return state, hist, ms


def _run_port(trainer, steps, state=None):
    state = state if state is not None else _port_state()
    hist, ms = [], []
    for _ in range(steps):
        state, met = trainer.step(state, _batch(trainer.k, state.step))
        hist.append(met)
        ms.append(trainer.m)
    return state, hist, ms


def _jax_side(out_path):
    """Runs in the subprocess, with M host devices: the JAX trainer on its
    spmd backend with the int8 wire (fused wire kernels) over SPEC."""
    from repro.launch.mesh import make_auto_mesh

    assert len(jax.devices()) >= M, jax.devices()
    mesh = make_auto_mesh((M, 1), ("data", "model"))
    tr = JTrainer(_JToy(), JCodingConfig(scheme="heter_aware", s=1, rebalance_every=3,
                                         compress=True, wire_kernel=True),
                  JTrainConfig(**_TC), faults=jparse_fault_spec(SPEC), backend="spmd",
                  mesh=mesh, **_common())
    state, hist, ms = _run_jax(tr, STEPS)
    with open(out_path, "w") as f:
        json.dump({"hist": hist, "ms": ms, "summary": tr.supervisor.summary(),
                   "params": {k: np.asarray(v).tolist() for k, v in state.params.items()}},
                  f)


@pytest.fixture(scope="module")
def jax_fused_run():
    tr = JTrainer(_JToy(), JCodingConfig(scheme="heter_aware", s=1, rebalance_every=3),
                  JTrainConfig(**_TC), faults=jparse_fault_spec(SPEC), **_common())
    state, hist, ms = _run_jax(tr, STEPS)
    return {"hist": hist, "ms": ms, "summary": tr.supervisor.summary(),
            "params": {k: np.asarray(v) for k, v in state.params.items()}}


@pytest.fixture(scope="module")
def jax_spmd_wire_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_spmd_faults") / "run.json"
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={M} "
                        "--xla_cpu_multi_thread_eigen=false",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    SPEC,
    "crash:3@40",
    "hang:1@20+10, flaky:2@0..100:0.3 ,corrupt:0@50..60",
    "corrupt:7@0..5:0.25",
    "",
])
def test_parse_fault_spec_equals_jax(spec):
    ours = parse_fault_spec(spec).events
    theirs = jparse_fault_spec(spec).events
    assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in theirs]


@pytest.mark.parametrize("spec", ["crash:x@1", "melt:0@1", "hang:1@2", "flaky:0@5..3:0.1"])
def test_parse_fault_spec_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jparse_fault_spec(spec)
    with pytest.raises(ValueError):
        parse_fault_spec(spec)


def test_standard_fault_mix_equals_jax():
    for m, kw in ((4, {}), (10, dict(crash_step=3, hang_step=9, hang_len=2))):
        ours = standard_fault_mix(m, **kw).events
        theirs = jstandard_fault_mix(m, **kw).events
        assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in theirs]


# ---------------------------------------------------------------------------
# the trainer over one fault schedule, against the JAX trainer
# ---------------------------------------------------------------------------


def _assert_same_run(ours, theirs, summary):
    t_state, t_hist, t_ms = ours
    assert t_ms == theirs["ms"]
    for step, (tm, jm) in enumerate(zip(t_hist, theirs["hist"], strict=True)):
        for key in EQUAL:
            assert tm.get(key) == jm.get(key), (step, key, tm.get(key), jm.get(key))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4, err_msg=f"{step} {key}")
    assert summary == theirs["summary"]
    for k, v in t_state.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(theirs["params"][k]), rtol=1e-4,
                                   atol=1e-6)


def _assert_schedule_exercised(trainer, hist, ms):
    sup = trainer.supervisor
    assert sum(h.get("repaired", 0.0) for h in hist) == 2 == sup.repaired_steps
    assert {(c["worker"], c["reason"]) for c in sup.convictions} == {
        (0, "corrupt"), (4, "timeout"), (2, "timeout")}
    assert [r["worker"] for r in sup.readmissions] == [2]
    assert sup.health[1].retries > 0 and sup.health[1].status == "healthy"
    assert min(ms) == 2 and ms[-1] == 3
    assert all(np.isfinite(h["loss"]) or h["skipped"] for h in hist)


@pytest.mark.parametrize("backend", ["fused", "spmd"])
def test_fault_schedule_matches_jax_trainer(jax_fused_run, backend):
    tr = _port_trainer(backend)
    run = _run_port(tr, STEPS)
    _assert_schedule_exercised(tr, run[1], run[2])
    _assert_same_run(run, jax_fused_run, tr.supervisor.summary())


def test_fault_schedule_on_the_int8_wire_matches_jax_spmd(jax_spmd_wire_run):
    tr = _port_trainer("spmd", compress=True)
    run = _run_port(tr, STEPS)
    _assert_schedule_exercised(tr, run[1], run[2])
    _assert_same_run(run, jax_spmd_wire_run, tr.supervisor.summary())
    assert tuple(tr.engine._err.shape) == (tr.m, 4 * 8 + 8)
    assert bool(torch.isfinite(tr.engine._err).all())


# ---------------------------------------------------------------------------
# a poisoned attempt leaves the state as it found it
# ---------------------------------------------------------------------------


def _snapshot(state):
    opt = state.opt
    return ({k: v.clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in opt.mu.items()},
            {k: v.clone() for k, v in opt.nu.items()}, opt.step, state.step)


def _assert_unchanged(state, snap):
    params, mu, nu, opt_step, step = snap
    for now, then in ((state.params, params), (state.opt.mu, mu), (state.opt.nu, nu)):
        for k in then:
            assert now[k].numpy().tobytes() == then[k].numpy().tobytes(), k
    assert state.opt.step == opt_step and state.step == step


@pytest.mark.parametrize("backend,compress", [("fused", False), ("spmd", False), ("spmd", True)],
                         ids=["fused", "spmd", "spmd-compress"])
def test_poisoned_engine_step_then_repair_starts_from_the_same_state(backend, compress):
    """A NaN decode coefficient skips the in-place update (params, moments
    and the optimizer's step bit-unchanged); the repair's attempt then gives
    bit for bit what a fresh engine gives from a copy of the state."""
    tr = _port_trainer(backend, compress, spec="")
    state = _port_state()
    state, _ = tr.step(state, _batch(tr.k, 0))  # moments non-zero
    snap = _snapshot(state)
    dec = tr.codec.decode_outcome(list(range(tr.m)))
    poisoned = CodedTrainer._poison_outcome(dec, tuple(CodedTrainer._used_workers(dec)[:1]))
    assert np.isnan(poisoned.a).any()
    batch = _batch(tr.k, 1)
    after, met = tr.engine.step(state, batch, poisoned)
    assert not np.isfinite(met["grad_norm"])
    _assert_unchanged(TrainerState(after.params, after.opt, state.step), snap)
    tr.engine.reset_error_feedback()
    repaired, met_r = tr.engine.step(TrainerState(after.params, after.opt, state.step),
                                     batch, dec)

    twin = _port_trainer(backend, compress, spec="")
    twin.engine._view = tr.engine._view
    if compress:  # what the guard leaves: the residuals zeroed at this codec version
        twin.engine._err = torch.zeros_like(tr.engine._err)
        twin.engine._err_version = twin.codec.version
    params, mu, nu, opt_step, step = snap  # taken before both attempts
    opt = adamw_init(params)
    opt.mu, opt.nu, opt.step = mu, nu, opt_step
    direct, met_d = twin.engine.step(TrainerState(params, opt, step), batch, dec)
    assert met_r == met_d
    for k in params:
        assert repaired.params[k].numpy().tobytes() == direct.params[k].numpy().tobytes()
        assert repaired.opt.nu[k].numpy().tobytes() == direct.opt.nu[k].numpy().tobytes()


def test_reference_backend_drops_a_nan_coefficient_as_jax_does():
    """The protocol oracle keeps only workers with |a_w| > 1e-12, and a NaN
    fails that test: both packages decode around a poisoned coefficient
    there instead of going non-finite (``protocol_reference``)."""
    from repro.train.engine import StepEngine as JStepEngine

    tr = _port_trainer("reference", spec="")
    dec = tr.codec.decode_outcome(list(range(tr.m)))
    poisoned = CodedTrainer._poison_outcome(dec, tuple(CodedTrainer._used_workers(dec)[:1]))
    ours = tr.engine.gradients(_port_state().params, _batch(tr.k, 1), poisoned)
    jtr = JTrainer(_JToy(), JCodingConfig(scheme="heter_aware", s=1, rebalance_every=3),
                   JTrainConfig(**_TC), faults=jparse_fault_spec(""), **_common())
    jeng = JStepEngine(_JToy(), JTrainConfig(**_TC), jtr.codec, backend="reference")
    jdec = jtr.codec.decode_outcome(list(range(jtr.m)))
    jpoisoned = JTrainer._poison_outcome(jdec, tuple(JTrainer._used_workers(jdec)[:1]))
    np.testing.assert_array_equal(jpoisoned.a, poisoned.a)
    theirs = jeng.gradients({k: jax.numpy.asarray(v) for k, v in _params_np().items()},
                            _batch(jtr.k, 1), jpoisoned)
    for k in ours:
        assert bool(torch.isfinite(ours[k]).all())
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the resilience patterns of tests/test_resilience.py, on the port
# ---------------------------------------------------------------------------


def _pattern_trainer(events, m=4, scheme="heter_aware", **kw):
    return CodedTrainer(
        _TToy(), CodingConfig(scheme=scheme, s=1, rebalance_every=3),
        TrainConfig(**_TC), faults=FaultSchedule(events), backend="spmd", device="cpu",
        m=m, part_mb=2, true_speeds=np.linspace(1.0, 2.0, m), comm_time=0.01, rng=3, **kw,
    )


def test_crash_is_convicted_and_evicted_via_elastic_path():
    tr = _pattern_trainer([FaultEvent(kind="crash", worker=3, step=4)])
    v0 = tr.codec.version
    state, hist, _ = _run_port(tr, 20)
    sup = tr.supervisor
    assert tr.m == 3 and tr.codec.version > v0
    assert [(c["worker"], c["reason"]) for c in sup.convictions] == [(3, "timeout")]
    assert sup.convictions[0]["step"] <= 4 + 8
    assert sup.health[3].status == "evicted" and np.isfinite(hist[-1]["loss"])
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_hang_recovers_and_is_readmitted_under_original_identity():
    tr = _pattern_trainer([FaultEvent(kind="hang", worker=1, step=4, duration=5)])
    _, _, ms = _run_port(tr, 24)
    sup = tr.supervisor
    assert min(ms) == 3 and tr.m == 4
    assert [r["worker"] for r in sup.readmissions] == [1]
    assert sup.health[1].status == "healthy" and 1 in tr.elastic.sim.orig_of_cur


def test_flaky_uploads_retry_without_conviction():
    tr = _pattern_trainer([FaultEvent(kind="flaky", worker=2, step=0, duration=30, prob=0.4)],
                          fault_seed=5)
    _run_port(tr, 24)
    sup = tr.supervisor
    assert not sup.convictions and tr.m == 4 and sup.health[2].retries > 0


def test_masking_degrades_gracefully_when_eviction_infeasible():
    tr = _pattern_trainer([FaultEvent(kind="crash", worker=1, step=2)], m=2, scheme="cyclic")
    state, _, _ = _run_port(tr, 12)
    sup = tr.supervisor
    assert tr.m == 2 and sup.convictions and not sup.evictions
    assert sup.masked_origs() == {1}
    assert all(torch.isfinite(v).all() for v in state.params.values())


def test_bare_supervisor_gets_an_empty_schedule():
    sup = FaultSupervisor()
    tr = CodedTrainer(_TToy(), CodingConfig(scheme="heter_aware", s=1), TrainConfig(**_TC),
                      m=4, part_mb=2, backend="fused", device="cpu", supervisor=sup)
    assert tr.supervisor is sup and tr.elastic.sim.schedule.events == ()
    _run_port(tr, 2)
    assert sup.summary()["convictions"] == 0


if __name__ == "__main__":
    _jax_side(sys.argv[1])
