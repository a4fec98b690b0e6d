"""The port's CodedTrainer against the JAX package's, end to end.

Reduced smollm-360m, mamba2-370m, and the families moonshot-v1-16b-a3b
(MoE, its aux loss in every sequence's loss), hubert-xlarge (audio frames,
encoder-only) and internvl2-2b (vision patches; seq 16 is 8 patches and 8
tokens) (f32), heter_aware, m=4, one faulted
worker per step (``--straggler fault``), 4 steps, at equal converted
weights: the control plane metrics of every step are equal and the loss
agrees to rtol 1e-4.
The port runs its main path, the ``spmd`` backend; the JAX trainer runs
its default ``fused`` backend (its spmd backend needs m devices), or, for
moonshot's spmd run, its ``reference`` backend (the same per-slot losses).  Also:
the port's launcher runs to its JSON summary on the CPU, uncompressed, on
the int8 wire (``--compress --wire-kernel on``) and on mamba2; a non-finite compressed
decode zeroes the error feedback; and neither the port's modules,
``chip_smoke.py``, its main path, compressed or not, with faults, tracing,
checkpoints and a resume, ``obs_report``, nor its serving path
(``LMServer.generate``, ``ServingEngine.run``) load ``jax`` or ``repro``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import CodingConfig as JCodingConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core.straggler import FixedDelayStragglers as JDelay
from repro.data.pipeline import SyntheticData as JData
from repro.models.lm import build_model as jbuild
from repro.train.trainer import CodedTrainer as JTrainer
from repro_torch.configs import CodingConfig, TrainConfig, get_config
from repro_torch.core.straggler import FixedDelayStragglers
from repro_torch.data.pipeline import SyntheticData
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.optim.adam import adamw_init
from repro_torch.train.trainer import CodedTrainer, TrainerState

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
M, STEPS, SEQ = 4, 4, 16
EQUAL = ("sim_iter_time", "n_stragglers", "n_used", "decode_residual", "exact_fraction",
         "exact", "skipped")


def _trainer_kwargs():
    return dict(m=M, part_mb=2, true_speeds=np.linspace(1.0, 2.0, M), rng=0)


def _assert_trainer_matches_jax(arch, backend="spmd", jbackend="fused"):
    tc_kw = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS, seed=0)
    jcfg = jget_config(arch).reduced()
    jtr = JTrainer(jbuild(jcfg), JCodingConfig(scheme="heter_aware", s=1),
                   JTrainConfig(**tc_kw), straggler_model=JDelay(s=1, delay=np.inf),
                   backend=jbackend, **_trainer_kwargs())
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = CodedTrainer(build_model(get_config(arch).reduced()),
                       CodingConfig(scheme="heter_aware", s=1), TrainConfig(**tc_kw),
                       straggler_model=FixedDelayStragglers(s=1, delay=np.inf),
                       backend=backend, device="cpu", **_trainer_kwargs())
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    tstate = TrainerState(params=params, opt=adamw_init(params), step=0)
    jdata = JData(jcfg, k=jtr.k, part_mb=2, seq_len=SEQ, seed=0)
    tdata = SyntheticData(ttr.model.cfg, k=ttr.k, part_mb=2, seq_len=SEQ, seed=0)
    assert ttr.k == jtr.k and ttr.n_slots == jtr.n_slots
    for step in range(STEPS):
        jstate, jm = jtr.step(jstate, jdata.batch(step))
        tstate, tm = ttr.step(tstate, tdata.batch(step))
        for key in EQUAL:
            assert tm[key] == jm[key], (step, key, tm[key], jm[key])
        assert tm["n_stragglers"] == 1.0 and tm["skipped"] == 0.0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        assert tstate.step == jstate.step


def test_trainer_metrics_match_jax_trainer():
    _assert_trainer_matches_jax("smollm-360m")


def test_trainer_metrics_match_jax_trainer_mamba2():
    """The ssm family: mixed into the spmd wire as f32 (the reduced config
    is all f32), through ``ops.ssd_scan``'s plain version on the CPU; seq 16
    is two SSD chunks of 8, so the carried state runs."""
    _assert_trainer_matches_jax("mamba2-370m")


@pytest.mark.parametrize("arch,backend,jbackend", [
    ("moonshot-v1-16b-a3b", "fused", "fused"), ("moonshot-v1-16b-a3b", "spmd", "reference"),
    ("hubert-xlarge", "spmd", "fused"), ("internvl2-2b", "spmd", "fused")],
    ids=["moonshot-v1-16b-a3b-fused", "moonshot-v1-16b-a3b-spmd", "hubert-xlarge-spmd",
         "internvl2-2b-spmd"])
def test_trainer_metrics_match_jax_trainer_families(arch, backend, jbackend):
    """The frames and patches batches pass SyntheticData, the prefetcher
    and the spmd backend whole, in f32.  The MoE load-balance loss is a
    mean over the rows of the batch a loss sees, which the fused backend
    packs whole and the spmd and reference backends slot by slot, so with
    unequal slot weights the two kinds of backend give different gradients
    (in the JAX package too; ROADMAP Queue 3).  So moonshot is held on the
    port's fused backend against JAX's fused, and on the port's spmd
    backend, the launcher's main path, against JAX's reference backend,
    which runs the same slot-by-slot losses on one device."""
    _assert_trainer_matches_jax(arch, backend, jbackend)


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_launcher_runs_the_families_on_cpu(backend):
    """Every family through the launcher's other backends: a finite loss."""
    from repro_torch.launch.train import main

    for arch in ("moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "internvl2-2b",
                 "hubert-xlarge"):
        out = main(["--arch", arch, "--reduced", "--backend", backend, "--m", "4",
                    "--straggler", "fault", "--steps", "1", "--seq-len", "16",
                    "--device", "cpu"])
        assert np.isfinite(out["summary"]["final_loss"]), arch


class _JToy:
    def weighted_loss(self, params, batch):
        import jax.numpy as jnp

        pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])


class _TToy:
    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _toy_batch(k, step):
    r = np.random.default_rng(1000 + step)
    return {"x": r.normal(size=(k, 2, 4)).astype(np.float32),
            "y": r.normal(size=(k, 2)).astype(np.float32)}


def test_trainer_membership_churn_matches_jax_trainer():
    """Scheduled leave and join events drive the port's elastic controller
    and engine hooks through the same transitions as the JAX trainer's."""
    from repro.core.simulator import ChurnSchedule as JChurn
    from repro.core.simulator import MembershipEvent as JEvent
    from repro.train.engine import TrainerState as JState
    from repro.optim.adam import adamw_init as jadamw_init
    from repro_torch.core.simulator import ChurnSchedule, MembershipEvent

    events = [dict(step=2, leave=(1,)), dict(step=4, join_speeds=(1.5,))]
    tc_kw = dict(lr=1e-2, warmup_steps=2, total_steps=8)
    common = dict(m=M, part_mb=2, true_speeds=np.array([1.0, 2.0, 3.0, 4.0]), rng=3,
                  comm_time=0.01)
    jtr = JTrainer(_JToy(), JCodingConfig(scheme="heter_aware", s=1), JTrainConfig(**tc_kw),
                   straggler_model=JDelay(s=1, delay=2.0),
                   churn=JChurn([JEvent(**e) for e in events]), **common)
    ttr = CodedTrainer(_TToy(), CodingConfig(scheme="heter_aware", s=1), TrainConfig(**tc_kw),
                       straggler_model=FixedDelayStragglers(s=1, delay=2.0),
                       churn=ChurnSchedule([MembershipEvent(**e) for e in events]),
                       backend="spmd", device="cpu", **common)
    r = np.random.default_rng(0)
    p = {"w1": r.normal(size=(4, 8)).astype(np.float32),
         "w2": r.normal(size=(8, 1)).astype(np.float32)}
    jp = jax.tree.map(jax.numpy.asarray, p)
    jstate = JState(params=jp, opt=jadamw_init(jp), step=0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tstate = TrainerState(params=tp, opt=adamw_init(tp), step=0)
    for step in range(6):
        batch = _toy_batch(jtr.k, step)
        jstate, jm = jtr.step(jstate, batch)
        tstate, tm = ttr.step(tstate, batch)
        for key in (*EQUAL, "membership_epoch", "m", "moved_partitions"):
            assert tm.get(key) == jm.get(key), (step, key, tm.get(key), jm.get(key))
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert ttr.m == jtr.m == 4 and ttr.elastic.membership_epoch == 2


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "smollm-360m", "--reduced", "--backend", "spmd", "--m", "4",
                "--straggler", "fault", "--steps", "2", "--seq-len", "16", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == out["summary"]
    assert summary["steps_run"] == 2 and np.isfinite(summary["final_loss"])
    assert all(h["n_used"] >= 2 and h["exact"] == 1.0 for h in out["history"])


def test_launcher_runs_mamba2_on_cpu(capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "mamba2-370m", "--reduced", "--backend", "spmd", "--m", "4",
                "--straggler", "fault", "--steps", "2", "--seq-len", "20", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == out["summary"]
    assert summary["steps_run"] == 2 and np.isfinite(summary["final_loss"])
    assert all(h["n_used"] >= 2 and h["exact"] == 1.0 for h in out["history"])
    params = out["state"].params
    assert {k for k, v in params.items() if v.dtype != torch.float32} == set()
    assert "blocks.0.mamba.A_log" in params and "blocks.0.attn.wq" not in params


def test_launcher_runs_compressed_wire_on_cpu(capsys):
    from repro_torch.launch.train import main

    seen = []

    def on_step(trainer, step, state, metrics):
        err = trainer.engine._err
        seen.append((step, bool(torch.isfinite(err).all()), float(err.abs().max())))

    out = main(["--arch", "smollm-360m", "--reduced", "--backend", "spmd", "--m", "4",
                "--straggler", "fault", "--steps", "4", "--seq-len", "16", "--device", "cpu",
                "--compress", "--wire-kernel", "on"], on_step=on_step)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["compress"] is True and summary["wire_kernel"] is True
    assert summary["steps_run"] == 4 and len(out["history"]) == 4
    assert all(np.isfinite(h["loss"]) and h["exact"] == 1.0 for h in out["history"])
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert all(finite and mx > 0 for _, finite, mx in seen)
    n = out["trainer"].engine._view.size
    assert tuple(out["trainer"].engine._err.shape) == (M, n)


def test_nonfinite_compressed_decode_zeroes_error_feedback():
    """A NaN in the coded gradient reaches the decode as a NaN scale; the
    trainer's guard skips the step and zeroes every worker's residual."""
    tr = CodedTrainer(_TToy(), CodingConfig(scheme="heter_aware", s=1, compress=True,
                                            wire_kernel=True),
                      TrainConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                      straggler_model=FixedDelayStragglers(s=1, delay=np.inf),
                      backend="spmd", device="cpu", **_trainer_kwargs())
    r = np.random.default_rng(0)
    p = {"w1": torch.from_numpy(r.normal(size=(4, 8)).astype(np.float32)),
         "w2": torch.from_numpy(r.normal(size=(8, 1)).astype(np.float32))}
    state = TrainerState(params=p, opt=adamw_init(p), step=0)
    state, m0 = tr.step(state, _toy_batch(tr.k, 0))
    assert m0["skipped_nonfinite"] == 0.0 and float(tr.engine._err.abs().max()) > 0
    before = {k: v.clone() for k, v in state.params.items()}
    bad = _toy_batch(tr.k, 1)
    bad["x"][0, 0, 0] = np.nan
    state, m1 = tr.step(state, bad)
    assert m1["skipped_nonfinite"] == 1.0 and not np.isfinite(m1["loss"])
    assert state.step == 1 and not tr.engine._err.any()
    for k in before:
        assert torch.equal(state.params[k], before[k])


def test_launcher_without_a_card_exits_with_an_error(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(train.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])


def test_main_path_never_loads_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from repro_torch.launch.train import main\n"
        "args = ['--arch', 'smollm-360m', '--reduced', '--backend', 'spmd', '--m', '4',\n"
        "        '--straggler', 'fault', '--steps', '1', '--seq-len', '8', '--device', 'cpu']\n"
        "main(args)\n"
        "main(args + ['--compress', '--wire-kernel', 'on'])\n"
        "main(args + ['--compress', '--wire-kernel', 'auto'])\n"
        "main(['--arch', 'mamba2-370m'] + args[2:])\n"
        "main(['--arch', 'moonshot-v1-16b-a3b'] + args[2:])\n"
        "main(['--arch', 'internvl2-2b'] + args[2:-4] + ['--seq-len', '16', '--device', 'cpu'])\n"
        "import tempfile\n"
        "from repro_torch.launch import obs_report\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    main(args + ['--compress', '--wire-kernel', 'on', '--steps', '4',\n"
        "                 '--faults', 'corrupt:1@1..3,crash:3@2', '--speeds', '1,1,1,1',\n"
        "                 '--ckpt-dir', tmp + '/ck', '--ckpt-every', '2',\n"
        "                 '--trace-out', tmp + '/t.json', '--log-jsonl', tmp + '/t.jsonl'])\n"
        "    main(args + ['--steps', '5', '--ckpt-dir', tmp + '/ck', '--resume'])\n"
        "    obs_report.main([tmp + '/t.jsonl'])\n"
        "import numpy as np, torch\n"
        "import repro_torch.serve, repro_torch.train.serve\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.lm import build_model\n"
        "for arch in ('smollm-360m', 'mamba2-370m', 'mixtral-8x7b'):\n"
        "    model = build_model(get_config(arch).reduced())\n"
        "    params = model.init(torch.Generator().manual_seed(0), 'cpu')\n"
        "    server = repro_torch.train.serve.LMServer(model)\n"
        "    server.generate(params, {'tokens': np.ones((2, 5), np.int32)}, 3)\n"
        "    eng = repro_torch.serve.ServingEngine(server, params, n_slots=2, cache_len=16)\n"
        "    eng.run([repro_torch.serve.Request(rid=i, tokens=np.ones(4 + i, np.int32),\n"
        "                                       max_new_tokens=3) for i in range(3)])\n"
        "vlm = build_model(get_config('internvl2-2b').reduced())\n"
        "vp = vlm.init(torch.Generator().manual_seed(0), 'cpu')\n"
        "repro_torch.train.serve.LMServer(vlm).generate(\n"
        "    vp, {'tokens': np.ones((2, 5), np.int32),\n"
        "         'patches': np.zeros((2, 8, 128), np.float32)}, 3, cache_len=16)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
