"""The port's dry run (``launch/dryrun.py``, ``roofline/``,
``launch/kernel_credit.py``) against the JAX package's.

- ``--list`` prints JAX's ``runnable_cells()``.
- One JAX subprocess of this file (``python tests/test_torch_dryrun.py jax
  OUT.json``, 512 forced host devices, as ``repro.launch.dryrun`` sets
  them) writes, for every runnable cell on the 16×16 and the 2×16×16 mesh,
  JAX's ``input_specs`` (each leaf's shape, dtype and spec) and the
  baseline's ``state_bytes_per_chip`` as ``_lower_cell_inner`` builds them
  (no compile); the small dry run of ``tests/spmd_driver.py::
  check_dryrun_small`` (the reduced llama's training step on a (4, 2) mesh,
  its HLO's per-device FLOPs by ``compute_cost``); and ``score_family`` /
  ``flash_hbm_bytes`` on probe inputs.  The port's stand-ins equal JAX's
  leaf for leaf; its state bytes equal JAX's, less the 4 bytes of JAX's
  int32 optimizer step for a training cell (a Python int in the port).
- The port runs the same small dry run on a fake (4, 2) world in a
  subprocess of this file (``python tests/test_torch_dryrun.py small
  OUT.json``): FLOPs per rank > 0, a bottleneck, collectives over both
  axes, and FLOPs within 10 % of JAX's.  The counts differ by design: the
  HLO walk counts each elementwise op of XLA's decompositions (a softmax is
  several), the op counter one op per eager kernel; on this cell the port
  counts 4.3 % fewer (157,264,935 against 164,405,024: a gap of -0.0434
  when this test was written), the matmuls being the same.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
SMALL = dict(B=8, S=32, mesh=(4, 2))
PROBE_KEYS = ["f32[4,32,4096,4096]", "bf16[8,512,4096]", "f32[2,4096,512]", "f32[4096,4096]",
              "bf16[3,4096,1000]", "s32[4096]", "pred[16,4096,4096]", "f32[7,1536,4096]"]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


def _run(args, out: Path) -> dict:
    proc = subprocess.run([sys.executable, __file__, *args, str(out)], env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# the subprocess sides
# ---------------------------------------------------------------------------


def _jax_side(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import SHAPES, TrainConfig, get_config, runnable_cells
    from repro.launch import dryrun as jd
    from repro.launch import kernel_credit as jkc
    from repro.launch.mesh import make_production_mesh
    from repro.models.lm import build_model
    from repro.models.sharding import activation_axes
    from repro.optim.adam import AdamWState, adamw_init
    from repro.roofline.hlo_cost import compute_cost
    from repro.train.steps import make_fused_train_step

    def leaves(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))[0]
        key = lambda path: ".".join(  # noqa: E731
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        return {key(path): [list(l.shape), str(l.dtype), [list(e) if isinstance(e, tuple) else e
                                                         for e in l.sharding.spec]]
                for path, l in flat}

    res = {"cells": {}}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, shape_name in runnable_cells():
            cfg, shape = get_config(arch), SHAPES[shape_name]
            model = build_model(cfg)
            spec = jd.input_specs(arch, shape_name, mesh)
            rec = {k: leaves(v) for k, v in spec.items() if k in ("batch", "cache")}
            if "tokens" in spec and shape.kind == "decode":
                rec["tokens"] = leaves({"t": spec["tokens"]})
            if shape.kind == "train":
                policy = jd._BIG.get(arch, jd._TRAIN_POLICY_DEFAULT)
                pshapes, pspecs = jd._param_specs(model, mesh, fsdp=True)
                params_in = jd._shard_tree(pshapes, pspecs, mesh)
                opt_shapes = jax.eval_shape(partial(adamw_init, state_dtype=policy["state_dtype"],
                                                    keep_master=policy["master"]), pshapes)
                opt_in = jd._shard_tree(opt_shapes, jd._opt_specs(opt_shapes, pspecs), mesh)
                rec["state"] = jd._sharded_bytes_per_chip(params_in, opt_in, spec["batch"])
            else:
                pshapes, pspecs = jd._param_specs(model, mesh, fsdp=arch in jd._BIG)
                params_in = jd._shard_tree(pshapes, pspecs, mesh)
                rec["state"] = jd._sharded_bytes_per_chip(
                    params_in, spec["batch"] if shape.kind == "prefill" else spec["cache"])
            res["cells"][f"{arch}|{shape_name}|{'multi' if multi else 'single'}"] = rec

    # tests/spmd_driver.py::check_dryrun_small, on the first 8 devices
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(SMALL["mesh"]),
                             ("data", "model"))
    sds = lambda s, p: jax.ShapeDtypeStruct(s.shape, s.dtype,  # noqa: E731
                                            sharding=NamedSharding(mesh, p))
    pshapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = model.param_specs(tp_axis="model", tp_size=SMALL["mesh"][1])
    params_in = jax.tree.map(sds, pshapes, pspecs,
                             is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    opt_shapes = jax.eval_shape(adamw_init, pshapes)
    opt_in = jax.tree.map(sds, opt_shapes, AdamWState(step=P(), mu=pspecs, nu=pspecs,
                                                      master=None),
                          is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    B, S = SMALL["B"], SMALL["S"]
    data = NamedSharding(mesh, P("data"))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32, sharding=data),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32, sharding=data),
             "weight": jax.ShapeDtypeStruct((B,), jnp.float32, sharding=data)}
    step_fn = make_fused_train_step(model, TrainConfig(), accum_steps=1)
    with activation_axes(("data",), SMALL["mesh"][0]), mesh:
        compiled = jax.jit(step_fn).lower(params_in, opt_in, batch,
                                          jax.ShapeDtypeStruct((), jnp.int32)).compile()
    res["small_flops"] = compute_cost(compiled.as_text()).flops
    res["score_family"] = {k: jkc.score_family(k, 4096) for k in PROBE_KEYS}
    res["flash_hbm_bytes"] = {a: jkc.flash_hbm_bytes(get_config(a), 12345.0)
                              for a, _ in runnable_cells()}
    Path(out).write_text(json.dumps(res))


def _small_side(out: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as td
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.models.sharding import activation_axes
    from repro_torch.roofline.analysis import analyze_cost

    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, ssd_impl="torch", attn_impl="torch")
    dims = SMALL["mesh"]
    td.fake_world(dims[0] * dims[1])
    mesh = make_production_mesh(shape=dims)
    sizes = {"data": dims[0], "model": dims[1]}
    params = td._param_leaves(model, sizes, fsdp=False)
    B, S = SMALL["B"], SMALL["S"]
    batch = {"tokens": td.Leaf((B, S), torch.int32, ("data",)),
             "labels": td.Leaf((B, S), torch.int32, ("data",)),
             "weight": td.Leaf((B,), torch.float32, ("data",))}
    with activation_axes(("data",), dims[0]):
        cost = td.train_step_cost(model, mesh, params, batch)
    rep = analyze_cost(cost, arch="llama-reduced", shape="tiny", mesh_name="4x2", chips=8,
                       model_flops=1.0)
    Path(out).write_text(json.dumps({"flops": cost.flops, "bottleneck": rep.bottleneck,
                                     "coll": cost.coll, "bytes": cost.bytes,
                                     "row": rep.row()}))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return _run(["jax"], tmp_path_factory.mktemp("dry") / "jax.json")


def test_list_equals_jax_runnable_cells():
    from repro.configs import runnable_cells

    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[:-1] == [f"{a} {s}" for a, s in runnable_cells()]


def _norm(spec):
    """A spec entry list as JAX prints it (a one-axis tuple is the axis)."""
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    out = [e[0] if isinstance(e, list) and len(e) == 1 else e for e in out]
    while out and out[-1] is None:
        out.pop()
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_input_specs_and_state_bytes_equal_jax(jax_side, mesh):
    from repro_torch.configs import SHAPES, runnable_cells
    from repro_torch.launch import dryrun as td

    sizes = ({"pod": 2, "data": 16, "model": 16} if mesh == "multi"
             else {"data": 16, "model": 16})
    cells = runnable_cells()
    assert len(cells) == len([k for k in jax_side["cells"] if k.endswith(f"|{mesh}")])
    for arch, shape_name in cells:
        want = jax_side["cells"][f"{arch}|{shape_name}|{mesh}"]
        spec = td.input_specs(arch, shape_name, sizes)
        for part in ("batch", "cache"):
            if part not in spec:
                assert part not in want
                continue
            got = {k: [list(l.shape), str(l.dtype).replace("torch.", ""), _norm(list(l.spec))]
                   for k, l in spec[part].items()}
            exp = {k: [s, dt, _norm(sp)] for k, (s, dt, sp) in want[part].items()}
            assert got == exp, (arch, shape_name, part)
        if SHAPES[shape_name].kind == "decode":
            t = spec["tokens"]
            s, dt, sp = want["tokens"]["t"]
            assert [list(t.shape), str(t.dtype).replace("torch.", ""), _norm(list(t.spec))] == \
                [s, dt, _norm(sp)]
        jax_step = 4 if SHAPES[shape_name].kind == "train" else 0
        assert td.state_bytes(arch, shape_name, sizes) == want["state"] - jax_step, \
            (arch, shape_name)


def test_small_dry_run_flops_match_jax(jax_side, tmp_path):
    got = _run(["small"], tmp_path / "small.json")
    assert got["flops"] > 0
    assert got["bottleneck"] in ("compute", "memory", "collective")
    assert {"all-reduce"} <= set(got["coll"])
    gap = got["flops"] / jax_side["small_flops"] - 1.0
    assert abs(gap) < 0.10, (got["flops"], jax_side["small_flops"], gap)


def test_kernel_credit_helpers_equal_jax(jax_side):
    from repro_torch.configs import get_config
    from repro_torch.launch.kernel_credit import flash_hbm_bytes, score_family

    assert {k: score_family(k, 4096) for k in PROBE_KEYS} == jax_side["score_family"]
    assert {a: flash_hbm_bytes(get_config(a), 12345.0)
            for a in jax_side["flash_hbm_bytes"]} == jax_side["flash_hbm_bytes"]


if __name__ == "__main__":
    {"jax": _jax_side, "small": _small_side}[sys.argv[1]](sys.argv[2])
