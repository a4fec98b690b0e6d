"""The port's layouts (``LM.param_specs`` / ``LM.fsdp_specs``,
``models/sharding.py``) against the JAX package, and a tensor-parallel
training step across processes against the single-process one.

- The specs of every parameter of all ten archs at their full configs,
  tensor-parallel at tp 2 and 16 and FSDP-extended at 16, equal JAX's
  ``PartitionSpec``s leaf for leaf (JAX's side is ``jax.eval_shape`` only).
- ``shard_batch`` is a no-op with no axes installed, on a plain tensor and
  on a dim the axes do not divide.
- Four gloo ranks, subprocesses of this file (``python
  tests/test_torch_sharding.py OUT_DIR`` with ``RANK``/``WORLD_SIZE`` and a
  ``file://`` store under the test's ``tmp_path``), form a (2, 2)
  ``("data", "model")`` mesh and run ``make_fused_train_step`` on the
  reduced llama3.2-1b with its params placed by ``param_specs`` (and by
  ``fsdp_specs`` with accumulation 2), on the reduced moonshot (MoE,
  experts over ``model``, accumulation 2) and on the reduced mamba2 (the
  SSD scan on each rank's rows), the batch over ``data``: the
  loss, grad norm and gradients equal the single-process step's at f32
  rtol 1e-5 (a gradient's near-zero entries within 1e-5 of its leaf's
  largest: the MoE sums reassociate), the counterpart of ``tests/spmd_driver.py::
  check_fused_sharded_equals_host``.  The parameters after the AdamW step
  are held at rtol 1e-5 where the gradient is past 1e-4 of its leaf's
  largest; where it is near zero the first step's m/sqrt(v) is the sign of
  noise, and the two may differ by up to 2·lr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 180
SCENARIOS = {  # name: (arch, layout, accum_steps)
    "llama_tp": ("llama3.2-1b", "tp", 1),
    "llama_fsdp": ("llama3.2-1b", "fsdp", 2),
    "moonshot_tp": ("moonshot-v1-16b-a3b", "tp", 2),
    "mamba2_tp": ("mamba2-370m", "tp", 1),
}
TC = dict(lr=3e-3, warmup_steps=2, total_steps=10)
STEP = 1  # lr 1.5e-3 (step 0 of the warmup has lr 0)


def _batch(cfg, B=4, S=16):
    r = np.random.default_rng(0)
    tok = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok.copy()),
            "weight": torch.from_numpy(r.uniform(0.1, 1.0, (B,)).astype(np.float32))}


def _run_step(arch: str, accum: int, place=None, mesh=None):
    """One fused step; returns (metrics, grads, params), full tensors."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adam import adamw_init
    from repro_torch.train import steps

    cfg = get_config(arch).reduced()
    tm = build_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    if place is not None:
        params, batch = place(tm, params, batch)
    seen = {}
    real = steps.adamw_update

    def spy(p, g, opt, **kw):
        seen.update(g)
        return real(p, g, opt, **kw)

    steps.adamw_update = spy
    try:
        step_fn = steps.make_fused_train_step(tm, TrainConfig(**TC), accum_steps=accum)
        params, _, met = step_fn(params, adamw_init(params), batch, STEP)
    finally:
        steps.adamw_update = real

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().numpy()

    return ({"loss": float(full(met["loss"])), "grad_norm": float(full(met["grad_norm"]))},
            {k: full(v) for k, v in seen.items()}, {k: full(v) for k, v in params.items()})


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _rank_main(out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import activation_axes, distribute, shard_batch

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=f"file://{os.environ['STORE']}", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    mesh = make_production_mesh(shape=(2, 2))
    meta = {}
    # shard_batch: the data axes get dim 0, 'model' is replicated, and an
    # indivisible dim is left alone
    x = distribute(torch.arange(8.0).reshape(4, 2), (None, "model"), mesh)
    with activation_axes(("data",), 2):
        y = shard_batch(x)
        z = shard_batch(distribute(torch.zeros(3, 2), (None, None), mesh))
    meta["shard_batch"] = [str(p) for p in y.placements]
    meta["shard_batch_equal"] = bool(torch.equal(y.full_tensor(), x.full_tensor()))
    meta["shard_batch_indivisible"] = [str(p) for p in z.placements]
    arrays = {}
    for name, (arch, layout, accum) in SCENARIOS.items():
        def place(tm, params, batch, layout=layout):
            specs = tm.param_specs("model", 2)
            if layout == "fsdp":
                specs = tm.fsdp_specs({k: tuple(v.shape) for k, v in params.items()}, specs,
                                      "data", 2)
            ps = {k: distribute(v, specs[k], mesh) for k, v in params.items()}
            bs = {k: distribute(v, ("data",) + (None,) * (v.ndim - 1), mesh)
                  for k, v in batch.items()}
            meta[f"{name}/placements"] = {k: [str(p) for p in v.placements]
                                          for k, v in ps.items()}
            return ps, bs

        with activation_axes(("data",), 2):
            met, grads, params = _run_step(arch, accum, place, mesh)
        meta[f"{name}/metrics"] = met
        arrays |= {f"{name}/grad/{k}": v for k, v in grads.items()}
        arrays |= {f"{name}/param/{k}": v for k, v in params.items()}
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(meta))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------


def _jax_specs(cfg, tp, fsdp):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.models.lm import build_model as jbuild

    jm = jbuild(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    specs = jm.param_specs(tp_axis="model", tp_size=tp)
    if fsdp:
        specs = jm.fsdp_specs(shapes, specs, fsdp_axis="data", fsdp_size=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]

    def key(path):
        return ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    return {key(path): tuple(spec) for path, spec in flat}, shapes


@pytest.mark.parametrize("layout", [(2, 0), (16, 0), (16, 16)], ids=["tp2", "tp16", "fsdp16"])
def test_param_specs_equal_jax(layout):
    from repro.configs import ARCHS
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model, flatten_tree

    tp, fsdp = layout
    for arch in ARCHS:
        jspecs, jshapes = _jax_specs(jget_config(arch), tp, fsdp)
        tm = build_model(get_config(arch))
        specs = tm.param_specs("model", tp)
        if fsdp:
            shapes = {k: tuple(v.shape) for k, v in flatten_tree(jshapes).items()}
            specs = tm.fsdp_specs(shapes, specs, "data", fsdp)
        assert list(specs) == list(jspecs), arch
        for k, v in specs.items():
            # JAX pads a spec with None up to the leaf's rank where it applies it
            want = jspecs[k] + (None,) * (len(v) - len(jspecs[k]))
            assert v == want, (arch, k, v, jspecs[k])


def test_shard_batch_no_op_rule():
    from repro_torch.models.sharding import activation_axes, shard_batch

    x = torch.ones(4, 3)
    assert shard_batch(x) is x  # no axes installed
    with activation_axes(("data",), 2):
        assert shard_batch(x) is x  # a plain tensor
    with activation_axes(("data", "pod"), 8):
        assert shard_batch(x) is x  # 4 rows do not divide over 8


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ranks")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}", "WORLD_SIZE": "4",
           "STORE": str(out / "store"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(out)],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
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
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    res = []
    for r in range(4):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        res.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return res


def test_shard_batch_redistributes_a_dtensor(rank_run):
    meta = rank_run[0][1]
    assert meta["shard_batch"] == ["S(0)", "R"]
    assert meta["shard_batch_equal"]
    assert meta["shard_batch_indivisible"] == ["R", "R"]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_step_equals_single_process(rank_run, name):
    arch, layout, accum = SCENARIOS[name]
    met, grads, params = _run_step(arch, accum)
    meta0 = rank_run[0][1]
    want = "S(0)" if layout == "fsdp" else "R"
    key = "blocks.0.mamba.in_proj" if arch.startswith("mamba") else "blocks.0.attn.wq"
    assert meta0[f"{name}/placements"][key] == [want, "S(2)"]
    for arrays, meta in rank_run:
        got = meta[f"{name}/metrics"]
        np.testing.assert_allclose(got["loss"], met["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], met["grad_norm"], rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(arrays[f"{name}/grad/{k}"], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max(), err_msg=k)
            live = np.abs(g) > 1e-4 * np.abs(g).max()
            p = arrays[f"{name}/param/{k}"]
            np.testing.assert_allclose(p[live], params[k][live], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
            assert np.abs(p - params[k]).max() <= 2 * TC["lr"] * 0.5 + 1e-6, k
        # every rank holds the same full tensors
        for k in grads:
            np.testing.assert_array_equal(arrays[f"{name}/param/{k}"],
                                          rank_run[0][0][f"{name}/param/{k}"])


if __name__ == "__main__":
    _rank_main(sys.argv[1])
