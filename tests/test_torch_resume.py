"""The port's checkpoint and resume against the JAX package's.

  - Train N steps straight, or train k / save / load into a fresh trainer /
    train N−k: bit for bit the same params, moments and control-plane state
    (elastic rebalances, the straggler RNG), at k = 3 and 5, as
    ``tests/test_resume.py`` holds the JAX package.  The same on ``spmd
    --compress`` across a fault eviction: the error-feedback rows ride the
    checkpoint's extras and are carried through the eviction after a
    resume as in the straight run.
  - ``state_extras`` survives a JSON round trip.
  - The on-disk layout is the JAX package's: a checkpoint the port writes
    restores in ``repro`` and one ``repro`` writes restores in the port, a
    bf16 and an f32 leaf among them (the port writes bf16 as f32; a bf16
    leaf from JAX arrives as two raw bytes and is read by its bits).
  - The launcher's ``--faults``, ``--trace-out/--log-jsonl``,
    ``--ckpt-dir/--ckpt-every`` and ``--resume`` on the CPU, and a resume of
    the port's launcher from the JAX launcher's checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.optim.adam import adamw_init as jadamw_init
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    load_arrays,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.straggler import TransientStragglers
from repro_torch.optim.adam import adamw_init
from repro_torch.resilience import parse_fault_spec
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)


class _Toy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


class _Data:
    """batch(step) source, deterministic by step."""

    def __init__(self, k, mb=2, d=4):
        self.k, self.mb, self.d = k, mb, d

    def batch(self, step):
        r = np.random.default_rng(7000 + step)
        return {"x": r.normal(size=(self.k, self.mb, self.d)).astype(np.float32),
                "y": r.normal(size=(self.k, self.mb)).astype(np.float32)}


def _state():
    r = np.random.default_rng(0)
    p = {"w1": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
         "w2": torch.from_numpy(r.normal(size=(8, 1)).astype(np.float32))}
    return TrainerState(p, adamw_init(p), 0)


def _rebalancing_trainer():
    # rebalance_every=2 with heterogeneous truth against a uniform prior:
    # the run re-encodes B mid-flight, state a (params, opt)-only resume loses
    return CodedTrainer(
        _Toy(), CodingConfig(scheme="heter_aware", s=1, rebalance_every=2),
        TrainConfig(lr=1e-2, warmup_steps=2, total_steps=16), m=4, part_mb=2,
        straggler_model=TransientStragglers(p=0.3), true_speeds=np.array([1.0, 1.0, 4.0, 4.0]),
        comm_time=0.01, rng=3, backend="fused", device="cpu",
    )


def _evicting_wire_trainer():
    # equal speeds: a corrupt worker 1 is repaired at steps 1 and 2,
    # convicted at 2 and evicted at the top of step 3
    return CodedTrainer(
        _Toy(), CodingConfig(scheme="heter_aware", s=1, compress=True, wire_kernel=True),
        TrainConfig(lr=1e-2, warmup_steps=2, total_steps=16), m=4, part_mb=2,
        true_speeds=np.ones(4), comm_time=0.01, rng=3, backend="spmd", device="cpu",
        faults=parse_fault_spec("corrupt:1@1..3"), fault_seed=0,
    )


def _bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt.step == b.opt.step
    for tree in ("params",):
        for k in getattr(a, tree):
            assert _bits(getattr(a, tree)[k]) == _bits(getattr(b, tree)[k]), k
    for k in a.opt.mu:
        assert _bits(a.opt.mu[k]) == _bits(b.opt.mu[k]) and _bits(a.opt.nu[k]) == _bits(b.opt.nu[k])


@pytest.mark.parametrize("kind", ["rebalance", "wire-eviction"])
@pytest.mark.parametrize("split", [3, 5])
def test_resume_bitmatches_straight_run(tmp_path, split, kind):
    mk = _rebalancing_trainer if kind == "rebalance" else _evicting_wire_trainer
    N = 8
    tr_a = mk()
    s_a, _ = tr_a.run(_state(), _Data(tr_a.k), N)

    tr_b = mk()
    s_b, _ = tr_b.run(_state(), _Data(tr_b.k), split)
    save_checkpoint(str(tmp_path), split, {"params": s_b.params, "opt": s_b.opt},
                    meta=tr_b.state_extras())
    del tr_b, s_b

    tr_c = mk()
    init = _state()  # a fresh init, discarded
    restored, meta = restore_checkpoint(str(tmp_path), split,
                                        {"params": init.params, "opt": init.opt})
    tr_c.load_state_extras(meta)
    s_c = TrainerState(restored["params"], restored["opt"], split)
    s_c, _ = tr_c.run(s_c, _Data(tr_c.k), N, start=split)

    _assert_states_equal(s_a, s_c)
    np.testing.assert_array_equal(tr_a.elastic.estimator.c, tr_c.elastic.estimator.c)
    np.testing.assert_array_equal(tr_a.codec.code.B, tr_c.codec.code.B)
    assert tr_a.codec.version == tr_c.codec.version and tr_a.m == tr_c.m
    assert (tr_a._steps_taken, tr_a._exact_steps) == (tr_c._steps_taken, tr_c._exact_steps)
    p_a = tr_a.straggler_model.sample(tr_a.m, tr_a._rng)
    p_c = tr_c.straggler_model.sample(tr_c.m, tr_c._rng)
    np.testing.assert_array_equal(p_a.slowdown, p_c.slowdown)
    if kind == "rebalance":
        assert tr_a.codec.version > 0  # a rebalance really happened
    else:
        sup_a, sup_c = tr_a.supervisor, tr_c.supervisor
        assert tr_a.m == 3 and [e["worker"] for e in sup_a.evictions] == [1]
        assert sup_a.repaired_steps == 2
        assert sup_a.state_dict() == sup_c.state_dict()
        assert _bits(tr_a.engine._err) == _bits(tr_c.engine._err)
        assert tuple(tr_c.engine._err.shape) == (3, 4 * 8 + 8) and tr_c.engine._err.any()


def test_state_extras_json_roundtrip():
    tr = _evicting_wire_trainer()
    tr.run(_state(), _Data(tr.k), 5)
    extras = tr.state_extras()
    assert list(extras["engine"]) == ["err", "err_version", "err_width"]
    roundtripped = json.loads(json.dumps(extras))
    tr2 = _evicting_wire_trainer()
    tr2.load_state_extras(roundtripped)
    np.testing.assert_array_equal(tr.elastic.estimator.c, tr2.elastic.estimator.c)
    np.testing.assert_array_equal(tr.codec.code.B, tr2.codec.code.B)
    assert tr2.codec.version == tr.codec.version and tr2.m == tr.m == 3
    assert _bits(tr2.engine._err) == _bits(tr.engine._err)
    assert tr2.engine._err_version == tr.engine._err_version
    assert tr2.supervisor.state_dict() == tr.supervisor.state_dict()


# ---------------------------------------------------------------------------
# one on-disk layout for both packages, bf16 leaves included
# ---------------------------------------------------------------------------


def _mixed_np():
    """A nested JAX-style tree with one bf16 leaf (exact bf16 values) and
    two f32 ones; the port names its leaves by the dotted paths."""
    r = np.random.default_rng(4)
    wq = torch.from_numpy(r.normal(size=(3, 5)).astype(np.float32)).bfloat16()
    return {"blocks": ({"attn": {"wq": wq.float().numpy()}},),
            "final_norm": r.normal(size=(5,)).astype(np.float32),
            "A_log": r.normal(size=(2, 3)).astype(np.float32)}


def _jax_tree():
    t = _mixed_np()
    return {"blocks": ({"attn": {"wq": jnp.asarray(t["blocks"][0]["attn"]["wq"], jnp.bfloat16)}},),
            "final_norm": jnp.asarray(t["final_norm"]), "A_log": jnp.asarray(t["A_log"])}


def _port_tree():
    t = _mixed_np()
    return {"A_log": torch.from_numpy(t["A_log"]),
            "blocks.0.attn.wq": torch.from_numpy(t["blocks"][0]["attn"]["wq"]).bfloat16(),
            "final_norm": torch.from_numpy(t["final_norm"])}


def _port_opt(params):
    opt = adamw_init(params)
    for i, k in enumerate(params):  # non-zero moments, distinct per leaf
        opt.mu[k].fill_(0.25 * (i + 1))
        opt.nu[k].fill_(0.5 * (i + 1))
    opt.step = 7
    return opt


def test_port_checkpoint_restores_in_jax(tmp_path):
    params = _port_tree()
    opt = _port_opt(params)
    save_checkpoint(str(tmp_path), 7, {"params": params, "opt": opt}, meta={"m": 4})
    arrays, meta = load_arrays(str(tmp_path), 7)
    assert meta == {"m": 4} and arrays["params/blocks/0/attn/wq"].dtype == np.float32
    assert "opt/master/blocks/0/attn/wq" in arrays and arrays["opt/step"].dtype == np.int32
    jparams = _jax_tree()
    like = {"params": jparams, "opt": jadamw_init(jparams)}
    restored, jmeta = jrestore_checkpoint(str(tmp_path), 7, like)
    assert jmeta == {"m": 4} and int(restored["opt"].step) == 7
    jwq = restored["params"]["blocks"][0]["attn"]["wq"]
    assert jwq.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jwq, np.float32), params["blocks.0.attn.wq"].float())
    np.testing.assert_array_equal(np.asarray(restored["params"]["final_norm"]),
                                  params["final_norm"].numpy())
    for i, key in enumerate(("A_log", "blocks", "final_norm")):
        leaf = restored["opt"].mu[key]
        leaf = leaf[0]["attn"]["wq"] if key == "blocks" else leaf
        np.testing.assert_array_equal(np.asarray(leaf), 0.25 * (i + 1))
    np.testing.assert_array_equal(np.asarray(restored["opt"].master["blocks"][0]["attn"]["wq"]),
                                  params["blocks.0.attn.wq"].float())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jparams = _jax_tree()
    jopt = jadamw_init(jparams)
    jopt = jopt.__class__(step=jnp.asarray(5, jnp.int32),
                          mu=jax.tree.map(lambda x: x + 0.25, jopt.mu),
                          nu=jax.tree.map(lambda x: x + 0.5, jopt.nu), master=jopt.master)
    jsave_checkpoint(str(tmp_path), 5, {"params": jparams, "opt": jopt}, meta={"m": 3})
    arrays, _ = load_arrays(str(tmp_path), 5)
    raw = arrays["params/blocks/0/attn/wq"]
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2  # bf16 without a numpy dtype
    assert latest_step(str(tmp_path)) == 5
    params = {k: torch.zeros_like(v) for k, v in _port_tree().items()}
    like = {"params": params, "opt": adamw_init(params)}
    restored, meta = restore_checkpoint(str(tmp_path), 5, like)
    assert meta == {"m": 3} and restored["opt"].step == 5
    want = _port_tree()
    for k, v in want.items():
        got = restored["params"][k]
        assert got.dtype == v.dtype and _bits(got) == _bits(v), k
        assert bool((restored["opt"].mu[k] == 0.25).all())
        assert _bits(restored["opt"].master[k]) == _bits(v.float())
    # a bf16 leaf from JAX into an f32 target: exact, through its bits
    f32_like = {"params": {k: torch.zeros_like(v, dtype=torch.float32)
                           for k, v in params.items()}}
    got = restore_checkpoint(str(tmp_path), 5, f32_like)[0]["params"]["blocks.0.attn.wq"]
    assert _bits(got) == _bits(want["blocks.0.attn.wq"].float())


def test_async_checkpointer_snapshots_before_in_place_updates(tmp_path):
    """The step updates tensors in place, so ``save`` copies on the caller's
    thread: an update right after it does not reach the file.  Only the
    newest ``keep`` checkpoints stay."""
    params = {"w": torch.arange(6, dtype=torch.float32)}
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 5):
        ck.save(step, {"params": params})
        params["w"].add_(100.0)  # the next step, in place, while the writer runs
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    got = restore_checkpoint(str(tmp_path), 4, {"params": {"w": torch.zeros(6)}})[0]
    assert torch.equal(got["params"]["w"], torch.arange(6, dtype=torch.float32) + 300.0)


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------

_LAUNCH = ["--arch", "smollm-360m", "--reduced", "--backend", "spmd", "--scheme", "heter_aware",
           "--s", "1", "--m", "4", "--straggler", "none", "--speeds", "1,1,1,1",
           "--seq-len", "8", "--device", "cpu"]


def test_launcher_faults_trace_checkpoint_and_resume(tmp_path, capsys):
    from repro_torch.launch import obs_report
    from repro_torch.launch.train import main

    ck, log, trace = tmp_path / "ck", tmp_path / "run.jsonl", tmp_path / "run.trace.json"
    out = main([*_LAUNCH, "--compress", "--wire-kernel", "on", "--steps", "8",
                "--faults", "corrupt:1@1..3,crash:3@4", "--ckpt-dir", str(ck),
                "--ckpt-every", "4", "--log-jsonl", str(log), "--trace-out", str(trace)])
    text = capsys.readouterr().out
    summary = json.loads(text.strip().splitlines()[-1])
    assert summary == out["summary"] and summary["steps_run"] == 8
    assert summary["m_final"] == 2 and summary["resilience"]["repaired_steps"] == 2
    assert summary["resilience"]["evictions"] == 2
    hist = out["history"]
    assert [h.get("repaired", 0.0) for h in hist[:3]] == [0.0, 1.0, 1.0]
    assert all(np.isfinite(h["loss"]) and h["exact"] == 1.0 for h in hist)
    assert latest_step(str(ck)) == 8 and "event log" in text and "chrome trace" in text
    json.loads(trace.read_text())

    obs_report.main([str(log)])
    report = capsys.readouterr().out
    for want in ("phase.spmd.pack", "phase.spmd.grads", "phase.spmd.unravel", "== faults ==",
                 "-- convictions --"):
        assert want in report

    saved = {k: v.clone() for k, v in out["state"].params.items()}
    res = main([*_LAUNCH, "--steps", "10", "--ckpt-dir", str(ck), "--resume"])
    text = capsys.readouterr().out
    assert "resumed from step 8 (saved with m=4, now m=4)" in text
    assert res["summary"]["steps_run"] == 2 and len(res["history"]) == 2
    assert "resilience" not in res["summary"]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    # what the resume read is what the first run ended with
    like = {"params": {k: torch.zeros_like(v) for k, v in saved.items()}}
    back = restore_checkpoint(str(ck), 8, like)[0]["params"]
    assert all(_bits(back[k]) == _bits(saved[k]) for k in saved)


def test_port_launcher_resumes_from_the_jax_launchers_checkpoint(tmp_path, capsys):
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main

    common = ["--arch", "smollm-360m", "--reduced", "--scheme", "heter_aware", "--m", "4",
              "--seq-len", "8", "--ckpt-dir", str(tmp_path)]
    jmain([*common, "--steps", "2", "--ckpt-every", "2"])
    assert latest_step(str(tmp_path)) == 2
    capsys.readouterr()
    res = main([*common, "--steps", "3", "--resume", "--backend", "spmd", "--device", "cpu"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert res["summary"]["steps_run"] == 1 and np.isfinite(res["history"][0]["loss"])
