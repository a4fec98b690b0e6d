"""The spmd backend across processes against the JAX package and the port's
emulated spmd path.

One ``torch.distributed`` rank a coded worker, gloo on the CPU: the ranks
are subprocesses of this file (``python tests/test_torch_distributed.py
SCENARIO OUT_DIR`` with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and a
``file://`` store under the test's ``tmp_path``, so parallel test workers
never share a port), each on one thread.  The ranks import neither ``jax``
nor the JAX package (this module imports them inside the tests only); they
write their results to ``OUT_DIR`` and the test holds them, in process,
against the JAX package and the emulated path:

  (i)   the group engine's gradients on the toy model of
        tests/spmd_driver.py (heter_aware m=4 k=8 s=1 c=[1,2,3,2], decode
        [0,2,3], and a partial-work outcome): JAX's ``reference`` backend
        at atol 1e-5, the emulated spmd at atol 1e-6, the same bits on
        every rank; a NaN coefficient poisons every rank;
  (ii)  the int8 wire: kernel on against off over two steps (rtol 1e-4,
        atol 2e-5), within 0.05 of JAX's reference, and the fused-kernel
        path bit-equal to the emulated one, error feedback included;
  (iii) the elastic rebuild at a world of 6: grow 4 -> 6 and shrink
        6 -> 5 (each ``EngineRebuild`` field as the JAX check asserts,
        gradients against JAX's reference and bit-equal to a fresh group
        engine), error-feedback rows carried bit-exactly with the joiner
        zeroed, a pure rebalance carrying every row, and a hang fault
        evicting and re-admitting through the trainer (its m sequence
        equal to the JAX trainer's, every member's params bit-equal);
  (iv)  the veto: at a world of 4, a grow to 5 raises ``match="devices"``
        with the codec untouched;
  (v)   the launcher under ``torch.distributed.run`` at 4 ranks on the
        reduced smollm-360m: rank 0's decode metrics equal the
        single-process run's, its losses at rtol 1e-5, the other ranks
        print nothing;
  (vi)  checkpoints: rank 0's checkpoint and the gathered ``state_dict``
        restore on every rank bit-equal, and the next step too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core import Codec, get_scheme
from repro_torch.core.simulator import FaultEvent, FaultSchedule
from repro_torch.launch import mesh
from repro_torch.optim.adam import adamw_init
from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import StepEngine, TrainerState
from repro_torch.train.trainer import CodedTrainer

ROOT = Path(__file__).resolve().parents[1]
C = [1.0, 2.0, 3.0, 2.0]
KEYS = ("w1", "w2")
RANK_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the rank side (no jax)
# ---------------------------------------------------------------------------


class _Toy:
    """tests/spmd_driver.py's ``_ToyModel`` in torch."""

    def weighted_loss(self, params, batch):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        return ((pred[:, 0] - batch["y"]) ** 2 * batch["weight"]).sum()


def _pdata(k: int, step: int, mb: int = 2) -> dict:
    """tests/spmd_driver.py's ``_pdata``."""
    r = np.random.default_rng(1000 + step)
    return {"x": r.normal(size=(k, mb, 4)).astype(np.float32),
            "y": r.normal(size=(k, mb)).astype(np.float32)}


def _codec(scheme="heter_aware", m=4, k=8, c=C):
    return Codec(get_scheme(scheme, m=m, k=k, s=1, c=c, rng=0))


def _np(g: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in g.items()}


class _Out:
    """One rank's results: arrays into rank{r}.npz, the rest into rank{r}.json."""

    def __init__(self, out: Path, rank: int):
        self.path, self.rank = out, rank
        self.arrays: dict[str, np.ndarray] = {}
        self.meta: dict = {}

    def grads(self, tag: str, g: dict | None) -> None:
        if g is not None:
            for k, v in _np(g).items():
                self.arrays[f"{tag}/{k}"] = v

    def close(self) -> None:
        np.savez(self.path / f"rank{self.rank}.npz", **self.arrays)
        (self.path / f"rank{self.rank}.json").write_text(json.dumps(self.meta))


def _rank_engine(world: mesh.CodedGroup, out: _Out, inp) -> None:
    """(i), (ii), poisoning, (iv) and (vi) at a world of 4."""
    rank = world.rank
    params = {k: torch.from_numpy(inp[k]) for k in KEYS}
    pb = {"x": inp["x"], "y": inp["y"]}
    g4 = mesh.remesh_for_m(world, 4)
    tc = TrainConfig()

    def decode(codec, kind):
        return (codec.decode_vector([0, 2, 3]) if kind == "exact"
                else codec.decode_partial(inp["support"]))

    for kind, scheme in (("exact", "heter_aware"), ("inexact", "partial_work")):
        # (i) uncompressed
        codec = _codec(scheme)
        dec = decode(codec, kind)
        out.grads(f"i/{kind}", StepEngine(_Toy(), tc, codec, backend="spmd", group=g4)
                  .gradients(params, pb, dec))
        if rank == 0:
            out.grads(f"i/{kind}/emulated", StepEngine(_Toy(), tc, codec, backend="spmd",
                                                       device="cpu").gradients(params, pb, dec))
        # (ii) the int8 wire, kernel on and off, two steps on one engine
        for wk in ("on", "off"):
            kw = dict(backend="spmd", compress=True, wire_kernel=wk == "on")
            eng = StepEngine(_Toy(), tc, codec, group=g4, **kw)
            emu = StepEngine(_Toy(), tc, codec, device="cpu", **kw) if rank == 0 else None
            for call in (1, 2):
                out.grads(f"ii/{kind}/{wk}/{call}", eng.gradients(params, pb, dec))
                out.arrays[f"ii/{kind}/{wk}/{call}/err"] = eng._err.numpy().copy()
                if emu is not None:
                    out.grads(f"ii/{kind}/{wk}/{call}/emulated", emu.gradients(params, pb, dec))
                    out.arrays[f"ii/{kind}/{wk}/{call}/emulated_err"] = emu._err.numpy().copy()

    # a NaN coefficient poisons every rank
    codec = _codec()
    a = codec.decode_vector([0, 2, 3]).copy()
    a[2] = np.nan
    for tag, kw in (("plain", {}), ("wire", dict(compress=True, wire_kernel=True))):
        out.grads(f"nan/{tag}", StepEngine(_Toy(), tc, codec, backend="spmd", group=g4, **kw)
                  .gradients(params, pb, a))

    # (iv) the veto, through the trainer
    tr = CodedTrainer(_Toy(), CodingConfig(scheme="heter_aware", s=1), tc, m=4, part_mb=2,
                      backend="spmd", group=g4, true_speeds=np.array(C), device="cpu")
    b0, epoch0 = tr.codec.code.B.copy(), tr.elastic.membership_epoch
    try:
        tr.add_workers([2.0])
        out.meta["veto"] = None
    except ValueError as e:
        out.meta["veto"] = str(e)
    out.meta["veto_untouched"] = bool(
        tr.m == 4 and tr.codec.m == 4 and np.array_equal(tr.codec.code.B, b0)
        and tr.elastic.membership_epoch == epoch0 and tr.elastic.estimator.c.shape == (4,))

    # (vi) checkpoints: rank 0 writes, every rank restores
    def trainer():
        return CodedTrainer(
            _Toy(), CodingConfig(scheme="heter_aware", s=1, compress=True, wire_kernel=True),
            TrainConfig(lr=1e-2, warmup_steps=2, total_steps=16), m=4, part_mb=2,
            backend="spmd", group=g4, true_speeds=np.array(C), comm_time=0.01, rng=3,
            device="cpu")

    tr = trainer()
    p0 = {k: v.clone() for k, v in params.items()}
    state = TrainerState(p0, adamw_init(p0), 0)
    for _ in range(3):
        state, _ = tr.step(state, _pdata(tr.k, state.step))
    extras = json.loads(json.dumps(tr.state_extras()))
    like = {"params": state.params, "opt": state.opt}
    ck = AsyncCheckpointer(str(out.path / "ck"), group=g4)
    ck.save(3, like)
    ck.wait()
    restored, _ = restore_checkpoint(str(out.path / "ck"), 3, like)
    same = all(torch.equal(restored["params"][k], state.params[k])
               and torch.equal(restored["opt"].mu[k], state.opt.mu[k])
               and torch.equal(restored["opt"].nu[k], state.opt.nu[k]) for k in KEYS)
    out.meta["ckpt_bit_equal"] = bool(same and restored["opt"].step == state.opt.step)
    out.arrays["vi/err"] = tr.engine._err.numpy().copy()
    if rank == 0:
        out.arrays["vi/gathered"] = np.asarray(extras["engine"]["err"], np.float32)
    tr2 = trainer()
    tr2.load_state_extras(extras)
    out.meta["vi_err_restored"] = bool(torch.equal(tr2.engine._err, tr.engine._err))
    st2 = TrainerState(restored["params"], restored["opt"], 3)
    state, _ = tr.step(state, _pdata(tr.k, 3))
    st2, _ = tr2.step(st2, _pdata(tr2.k, 3))
    out.meta["vi_next_step_bit_equal"] = all(
        torch.equal(state.params[k], st2.params[k]) for k in KEYS)
    out.grads("vi/params", state.params)


def _rank_elastic(world: mesh.CodedGroup, out: _Out, inp) -> None:
    """(iii) at a world of 6."""
    params = {k: torch.from_numpy(inp[k]) for k in KEYS}
    pb = _pdata(8, 0)
    tc = TrainConfig()

    def wire(ctl, eng):
        ctl.pre_transition = eng.check_membership
        ctl.on_transition = eng.note_membership

    def fresh_at(codec, m, **kw):
        return StepEngine(_Toy(), tc, codec, backend="spmd",
                          group=mesh.remesh_for_m(world, m), **kw)

    def report(eng):
        return dataclasses.asdict(eng.last_rebuild)

    # exactness across grow and shrink (uncompressed wire)
    codec = _codec()
    ctl = ElasticController(codec, true_speeds=np.array(C))
    eng = fresh_at(codec, 4)
    wire(ctl, eng)
    eng.gradients(params, pb, codec.decode_vector([0, 2, 3]))
    ctl.add_workers([2.5, 1.5])  # 4 -> 6, same engine
    a = codec.decode_vector(range(codec.m))
    out.grads("grow", eng.gradients(params, pb, a))
    out.meta["grow"] = report(eng)
    out.grads("grow/fresh", fresh_at(codec, 6).gradients(params, pb, a))
    ctl.remove_workers([1])  # 6 -> 5, same engine
    a = codec.decode_vector(range(codec.m))
    out.grads("shrink", eng.gradients(params, pb, a))
    out.meta["shrink"] = report(eng)
    out.grads("shrink/fresh", fresh_at(codec, 5).gradients(params, pb, a))

    # error-feedback carry on the compressed wire
    codec = _codec()
    ctl = ElasticController(codec, true_speeds=np.array(C))
    eng = fresh_at(codec, 4, compress=True, wire_kernel=False)
    wire(ctl, eng)
    eng.gradients(params, pb, codec.decode_vector([0, 2, 3]))
    if eng._err is not None:
        out.arrays["err0"] = eng._err.numpy().copy()
    ctl.add_workers([2.5])  # 4 -> 5
    out.meta["carry"] = dataclasses.asdict(eng.rebuild())
    err1 = None if eng._err is None else eng._err.clone()
    if err1 is not None:
        out.arrays["err1"] = err1.numpy().copy()
    a = codec.decode_vector(range(codec.m))
    pb2 = _pdata(8, 1)
    twin = fresh_at(codec, 5, compress=True, wire_kernel=False)
    twin._view = eng._view
    twin._err, twin._err_version = err1, codec.version
    cold = fresh_at(codec, 5, compress=True, wire_kernel=False)
    out.grads("carry", eng.gradients(params, pb2, a))
    out.grads("carry/twin", twin.gradients(params, pb2, a))
    out.grads("carry/cold", cold.gradients(params, pb2, a))
    if eng._err is not None:
        out.meta["carry_err_equal_twin"] = bool(torch.equal(eng._err, twin._err))

    # pure rebalance: the whole buffer carries
    err2 = None if eng._err is None else eng._err.clone()
    codec.rebalance(np.array([1.0, 1.0, 2.0, 3.0, 2.0]))
    out.meta["rebalance"] = dataclasses.asdict(eng.rebuild())
    out.meta["rebalance_err_kept"] = err2 is None or bool(torch.equal(eng._err, err2))
    a = codec.decode_vector(range(codec.m))
    pb3 = _pdata(8, 2)
    twin = fresh_at(codec, 5, compress=True, wire_kernel=False)
    twin._view = eng._view
    twin._err, twin._err_version = err2, codec.version
    out.grads("rebalance", eng.gradients(params, pb3, a))
    out.grads("rebalance/twin", twin.gradients(params, pb3, a))

    # a shrink moves rows between ranks: worker 1 leaves, 2..4 move down
    if eng._err is not None:
        out.arrays["err3"] = eng._err.numpy().copy()
    eng.audit_rows = True
    ctl.remove_workers([1])  # 5 -> 4
    out.meta["move"] = dataclasses.asdict(eng.rebuild())
    out.meta["move_audit"] = eng.row_audits
    if eng._err is not None:
        out.arrays["err4"] = eng._err.numpy().copy()

    # a hang fault evicts and re-admits through the trainer
    tr = CodedTrainer(
        _Toy(), CodingConfig(scheme="heter_aware", s=1, rebalance_every=3),
        TrainConfig(lr=1e-2, warmup_steps=2, total_steps=40), m=4, part_mb=2,
        backend="spmd", group=mesh.remesh_for_m(world, 4),
        true_speeds=np.linspace(1.0, 2.0, 4), comm_time=0.01, rng=3, device="cpu",
        faults=FaultSchedule([FaultEvent(kind="hang", worker=1, step=4, duration=5)]),
    )
    p0 = {k: v.clone() for k, v in params.items()}
    state = TrainerState(p0, adamw_init(p0), 0)
    m_seen = []
    for _ in range(24):
        state, _ = tr.step(state, _pdata(tr.k, state.step))
        m_seen.append(tr.m)
    sup = tr.supervisor
    out.meta["hang"] = dict(m_seen=m_seen, evictions=len(sup.evictions),
                            readmissions=len(sup.readmissions), member=tr.engine.group.member,
                            B=tr.codec.code.B.tolist())
    out.grads("hang/params", state.params)
    a = tr.codec.decode_vector(range(tr.m))
    out.grads("hang/grads", tr.engine.gradients(state.params, _pdata(tr.k, 99), a))


def _rank_main(scenario: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    world = mesh.init_coded_group("cpu", init_method=f"file://{os.environ['STORE']}")
    out = _Out(Path(out_dir), world.rank)
    inp = np.load(Path(out_dir) / "inputs.npz")
    {"engine": _rank_engine, "elastic": _rank_elastic}[scenario](world, out, inp)
    out.close()
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------


def _spawn(scenario: str, world: int, out: Path) -> list[tuple[dict, dict]]:
    """Run ``world`` ranks of ``scenario``; every rank's (arrays, meta)."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}", "WORLD_SIZE": str(world),
           "LOCAL_WORLD_SIZE": str(world), "STORE": str(out / "store"),
           "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, __file__, scenario, str(out)],
                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{log[-4000:]}"
    res = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        res.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return res


def _jax():
    import jax
    import jax.numpy as jnp

    class JToy:
        def init(self, rng):
            k1, k2 = jax.random.split(rng)
            return {"w1": jax.random.normal(k1, (4, 16), jnp.float32),
                    "w2": jax.random.normal(k2, (16, 1), jnp.float32)}

        def weighted_loss(self, params, batch):
            pred = jnp.tanh(batch["x"] @ params["w1"]) @ params["w2"]
            return jnp.sum((pred[:, 0] - batch["y"]) ** 2 * batch["weight"])

    return jax, JToy


def _jax_reference(codec, params, pb, a) -> dict:
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.train.engine import StepEngine as JStepEngine

    jax, JToy = _jax()
    params = {k: jax.numpy.asarray(v) for k, v in params.items()}
    g = JStepEngine(JToy(), JTrainConfig(), codec, backend="reference").gradients(params, pb, a)
    return {k: np.asarray(g[k]) for k in KEYS}


def _jcodec(scheme="heter_aware", m=4, k=8, c=C):
    from repro.core import Codec as JCodec
    from repro.core import get_scheme as jget_scheme

    return JCodec(jget_scheme(scheme, m=m, k=k, s=1, c=c, rng=0))


def _grads(arrays: dict, tag: str) -> dict:
    return {k: arrays[f"{tag}/{k}"] for k in KEYS}


def _bits_equal(a: dict, b: dict) -> bool:
    return all(a[k].tobytes() == b[k].tobytes() for k in KEYS)


def _close(a: dict, b: dict, **tol) -> None:
    for k in KEYS:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def jax_params():
    jax, JToy = _jax()
    p = JToy().init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def engine_run(tmp_path_factory, jax_params):
    """Four ranks through (i), (ii), the poisoning, (iv) and (vi)."""
    out = tmp_path_factory.mktemp("engine")
    r = np.random.default_rng(0)
    x = r.normal(size=(8, 2, 4)).astype(np.float32)
    y = r.normal(size=(8, 2)).astype(np.float32)
    support = (r.uniform(size=(4, 8)) < 0.6).astype(np.float64)
    np.savez(out / "inputs.npz", x=x, y=y, support=support, **jax_params)
    return dict(ranks=_spawn("engine", 4, out), pb={"x": x, "y": y}, support=support)


@pytest.fixture(scope="module")
def elastic_run(tmp_path_factory, jax_params):
    """Six ranks through (iii)."""
    out = tmp_path_factory.mktemp("elastic")
    np.savez(out / "inputs.npz", **jax_params)
    return _spawn("elastic", 6, out)


def _decode(jc, kind, support):
    if kind == "exact":
        return jc.decode_vector([0, 2, 3])
    return jc.decode_partial(support)


@pytest.mark.parametrize("kind", ["exact", "inexact"])
def test_group_gradients_match_jax_reference_and_emulated(engine_run, jax_params, kind):
    """(i): JAX's engine_spmd / engine_spmd_inexact on four ranks."""
    ranks = engine_run["ranks"]
    jc = _jcodec("heter_aware" if kind == "exact" else "partial_work")
    ref = _jax_reference(jc, jax_params, engine_run["pb"],
                         _decode(jc, kind, engine_run["support"]))
    g0 = _grads(ranks[0][0], f"i/{kind}")
    _close(g0, ref, atol=1e-5, rtol=0)
    _close(g0, _grads(ranks[0][0], f"i/{kind}/emulated"), atol=1e-6, rtol=0)
    for arrays, _ in ranks[1:]:
        assert _bits_equal(_grads(arrays, f"i/{kind}"), g0)


@pytest.mark.parametrize("kind", ["exact", "inexact"])
def test_group_wire_matches_unfused_jax_and_emulated(engine_run, jax_params, kind):
    """(ii): JAX's engine_spmd_wire on four ranks, two steps an engine."""
    ranks = engine_run["ranks"]
    arrays0 = ranks[0][0]
    for call in (1, 2):
        on, off = (_grads(arrays0, f"ii/{kind}/{wk}/{call}") for wk in ("on", "off"))
        _close(on, off, rtol=1e-4, atol=2e-5)
        # the fused-kernel path reads the same wire as the emulated one
        assert _bits_equal(on, _grads(arrays0, f"ii/{kind}/on/{call}/emulated"))
        for arrays, _ in ranks[1:]:
            assert _bits_equal(_grads(arrays, f"ii/{kind}/on/{call}"), on)
            assert _bits_equal(_grads(arrays, f"ii/{kind}/off/{call}"), off)
    # every rank's error-feedback row is the emulated buffer's row, bit for bit
    for w, (arrays, _) in enumerate(ranks):
        for call in (1, 2):
            emu = arrays0[f"ii/{kind}/on/{call}/emulated_err"][w]
            assert arrays[f"ii/{kind}/on/{call}/err"].tobytes() == emu.tobytes()
    assert np.abs(arrays0[f"ii/{kind}/on/2/err"]).max() > 0
    if kind == "exact":
        jc = _jcodec()
        ref = _jax_reference(jc, jax_params, engine_run["pb"], jc.decode_vector([0, 2, 3]))
        on = _grads(arrays0, "ii/exact/on/1")
        rel = max(float(np.max(np.abs(on[k] - ref[k])) / (np.max(np.abs(ref[k])) + 1e-9))
                  for k in KEYS)
        assert rel < 0.05, rel


@pytest.mark.parametrize("tag", ["plain", "wire"])
def test_nan_coefficient_poisons_every_rank(engine_run, tag):
    for arrays, _ in engine_run["ranks"]:
        assert all(np.isnan(arrays[f"nan/{tag}/{k}"]).all() for k in KEYS)


def test_grow_past_the_world_is_vetoed_before_any_mutation(engine_run):
    """(iv): tests/test_membership.py's veto, at a world of 4."""
    for _, meta in engine_run["ranks"]:
        assert meta["veto"] is not None and "devices" in meta["veto"]
        assert meta["veto"].startswith("spmd rebuild infeasible: m=5 needs 5 devices")
        assert meta["veto_untouched"]


def test_checkpoint_and_gathered_state_restore_bit_equal(engine_run):
    """(vi)."""
    ranks = engine_run["ranks"]
    gathered = ranks[0][0]["vi/gathered"]
    assert gathered.shape == (4, 4 * 16 + 16)
    for w, (arrays, meta) in enumerate(ranks):
        assert meta["ckpt_bit_equal"] and meta["vi_err_restored"]
        assert meta["vi_next_step_bit_equal"]
        assert arrays["vi/err"].tobytes() == gathered[w].tobytes()
        assert _bits_equal(_grads(arrays, "vi/params"), _grads(ranks[0][0], "vi/params"))


def test_elastic_grow_and_shrink_match_jax(elastic_run, jax_params):
    """(iii) (a)+(b): the same group engine through 4 -> 6 -> 5."""
    from repro.train.elastic import ElasticController as JElastic

    jc = _jcodec()
    ctl = JElastic(jc, true_speeds=np.array(C))
    pb = _pdata(8, 0)
    ctl.add_workers([2.5, 1.5])
    grow_ref = _jax_reference(jc, jax_params, pb, jc.decode_vector(range(jc.m)))
    ctl.remove_workers([1])
    shrink_ref = _jax_reference(jc, jax_params, pb, jc.decode_vector(range(jc.m)))
    arrays0, meta0 = elastic_run[0]
    g = meta0["grow"]
    assert (g["m_before"], g["m_after"], g["mesh_rebuilt"], g["program_rebuilt"],
            g["err_rows_carried"], g["err_rows_zeroed"]) == (4, 6, True, True, 4, 2)
    s = meta0["shrink"]
    assert (s["m_before"], s["m_after"], s["err_rows_carried"]) == (6, 5, 5)
    for tag, ref in (("grow", grow_ref), ("shrink", shrink_ref)):
        _close(_grads(arrays0, tag), ref, atol=1e-5, rtol=0)
        for arrays, meta in elastic_run:
            assert meta[tag] == {**meta0[tag], "ms": meta[tag]["ms"]}
            if f"{tag}/w1" in arrays:
                assert _bits_equal(_grads(arrays, tag), _grads(arrays0, tag))
                assert _bits_equal(_grads(arrays, tag), _grads(arrays, f"{tag}/fresh"))


def test_elastic_err_rows_carry_bit_exactly(elastic_run):
    """(iii) (c)+(d): survivors' rows carried, the joiner's zeroed, the next
    step bit-equal to a twin seeded with the carried rows and not to a cold
    one."""
    meta0 = elastic_run[0][1]
    assert (meta0["carry"]["err_rows_carried"], meta0["carry"]["err_rows_zeroed"]) == (4, 1)
    for r, (arrays, meta) in enumerate(elastic_run[:5]):
        if r < 4:
            assert arrays["err1"].tobytes() == arrays["err0"].tobytes()
        else:
            assert "err0" not in arrays and not arrays["err1"].any()
        assert _bits_equal(_grads(arrays, "carry"), _grads(arrays, "carry/twin"))
        assert not _bits_equal(_grads(arrays, "carry"), _grads(arrays, "carry/cold"))
        assert meta["carry_err_equal_twin"]
    assert "err1" not in elastic_run[5][0]


def test_elastic_pure_rebalance_carries_every_row(elastic_run):
    meta0 = elastic_run[0][1]
    rb = meta0["rebalance"]
    assert (rb["err_rows_carried"], rb["err_rows_zeroed"]) == (5, 0)
    assert not rb["mesh_rebuilt"] and not rb["program_rebuilt"]
    for arrays, meta in elastic_run[:5]:
        assert meta["rebalance_err_kept"]
        assert _bits_equal(_grads(arrays, "rebalance"), _grads(arrays, "rebalance/twin"))


def test_elastic_shrink_moves_rows_between_ranks(elastic_run):
    """Worker 1 leaves m=5: the rows of workers 2, 3, 4 move to ranks 1, 2,
    3 bit-exactly (point-to-point), rank 4 leaves the group, and the
    engine's own audit agrees."""
    meta0 = elastic_run[0][1]
    assert (meta0["move"]["m_before"], meta0["move"]["m_after"]) == (5, 4)
    assert meta0["move"]["err_rows_carried"] == 4 and meta0["move"]["mesh_rebuilt"]
    audit = meta0["move_audit"][-1]
    assert audit["ok"] and audit["moved"] == [[2, 1], [3, 2], [4, 3]]
    for new, old in enumerate([0, 2, 3, 4]):
        after, before = elastic_run[new][0]["err4"], elastic_run[old][0]["err3"]
        assert np.abs(before).max() > 0 and after.tobytes() == before.tobytes()
    assert "err4" not in elastic_run[4][0] and "err4" not in elastic_run[5][0]


def test_hang_fault_evicts_and_readmits_like_jax(elastic_run, jax_params):
    """(iii) the trainer: the m sequence of the JAX trainer (whose control
    plane does not depend on the backend), every member's params
    bit-equal, and the post-churn gradients against JAX's reference."""
    import jax.numpy as jnp
    from repro.configs.base import CodingConfig as JCodingConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.simulator import FaultEvent as JFaultEvent
    from repro.core.simulator import FaultSchedule as JFaultSchedule
    from repro.train.trainer import CodedTrainer as JTrainer

    _, JToy = _jax()
    jtr = JTrainer(
        JToy(), JCodingConfig(scheme="heter_aware", s=1, rebalance_every=3),
        JTrainConfig(lr=1e-2, warmup_steps=2, total_steps=40), m=4, part_mb=2,
        backend="fused", true_speeds=np.linspace(1.0, 2.0, 4), comm_time=0.01, rng=3,
        faults=JFaultSchedule([JFaultEvent(kind="hang", worker=1, step=4, duration=5)]),
    )
    from repro.train.engine import TrainerState as JTrainerState
    from repro.optim.adam import adamw_init as jadamw_init

    p = {k: jnp.asarray(v) for k, v in jax_params.items()}
    st = JTrainerState(params=p, opt=jadamw_init(p), step=0)
    jm = []
    for _ in range(24):
        st, _ = jtr.step(st, _pdata(jtr.k, st.step))
        jm.append(jtr.m)
    arrays0, meta0 = elastic_run[0]
    hang = meta0["hang"]
    assert hang["m_seen"] == jm and min(jm) == 3 and jm[-1] == 4
    assert hang["evictions"] == 1 and hang["readmissions"] == 1
    np.testing.assert_array_equal(np.asarray(hang["B"]), jtr.codec.code.B)
    for arrays, meta in elastic_run:
        assert meta["hang"]["m_seen"] == jm
        if meta["hang"]["member"]:
            assert _bits_equal(_grads(arrays, "hang/params"), _grads(arrays0, "hang/params"))
    final = _grads(arrays0, "hang/params")
    assert all(np.isfinite(v).all() for v in final.values())
    ref = _jax_reference(jtr.codec, final, _pdata(jtr.k, 99),
                         jtr.codec.decode_vector(range(jtr.m)))
    _close(_grads(arrays0, "hang/grads"), ref, atol=1e-5, rtol=0)


def test_launcher_under_torchrun_matches_single_process(tmp_path):
    """(v): four ranks of ``repro_torch.launch.train`` at the reduced
    smollm-360m, against the same command in one process."""
    from repro_torch.launch.obs_report import load_records
    from repro_torch.launch.train import main as train_main

    torch.set_num_threads(2)
    args = ["--arch", "smollm-360m", "--reduced", "--backend", "spmd", "--scheme",
            "heter_aware", "--s", "1", "--m", "4", "--straggler", "fault", "--steps", "4",
            "--device", "cpu"]
    single = train_main(args)["history"]
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "--log-dir", str(logs), "--redirects", "3",
           "-m", "--", "repro_torch.launch.train", *args,
           "--log-jsonl", str(tmp_path / "run.jsonl")]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    stdout = {int(p.parent.name): p.read_text() for p in logs.rglob("stdout.log")}
    assert sorted(stdout) == [0, 1, 2, 3]
    assert all(stdout[r] == "" for r in (1, 2, 3)), stdout
    summary = json.loads(stdout[0].strip().splitlines()[-1])
    assert summary["world_size"] == 4 and summary["transport"] == "gloo"
    assert summary["replicas_bit_equal"] and len(summary["ranks"]) == 4
    recs = [r for r in load_records(str(tmp_path / "run.jsonl"))
            if r["kind"] == "event" and r["name"] == "train.step"]
    assert len(recs) == len(single) == 4
    for rec, h in zip(recs, single):
        got = rec["args"]
        for key, theirs in (("n_used", "n_used"), ("n_stragglers", "n_stragglers"),
                            ("sim_iter_time", "sim_iter_time"), ("residual", "decode_residual"),
                            ("exact_fraction", "exact_fraction")):
            assert got[key] == h[theirs], key
        assert not got["skipped"]
        np.testing.assert_allclose(got["loss"], h["loss"], rtol=1e-5)


def test_mesh_helpers_without_a_world(monkeypatch):
    assert mesh.mesh_devices_for_m(5) == 5
    assert mesh.transport_for(torch.device("cpu"), 4)[0] == "gloo"
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.launched_by_torchrun()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert mesh.launched_by_torchrun()
    g = mesh.CodedGroup(m=4, pg=None, rank=2, world_size=4, transport="gloo",
                        device=torch.device("cpu"))
    assert mesh.coded_axis_size(g) == 4 and g.member
    with pytest.raises(ValueError, match="needs 5 ranks"):
        mesh.remesh_for_m(g, 5)
    with pytest.raises(ValueError, match="positive"):
        mesh.remesh_for_m(g, 0)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
