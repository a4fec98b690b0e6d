"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the port), and
the reference loads nothing of the port.  Each in a fresh interpreter."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from chipbench import manifest

ROOT = manifest.ROOT
ENV = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'src'}", "OMP_NUM_THREADS": "2"}


def _modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"],
                         capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = (
        "from chipbench import manifest, run\n"
        "d = manifest.HERE / 'tests' / 'data'\n"
        "rc = run.main(['--workload', 'tiny-ssm.heter.s32', '--seed', '5', '--seconds', '0.2',"
        " '--trace', '1'], bench=manifest.Bench(d / 'BENCHMARK.json', d), need_card=False,"
        " device='cpu')\n"
        "assert rc == 0\n"
        "import chipbench.control, chipbench.metrics.step_mfu, chipbench.metrics.ssd_scan_roofline\n"
    )
    top = _modules(code)
    assert "repro_torch" in top and "chipbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import torch\n"
        "from chipbench.reference import dense, ssm, train, common\n"
        "from chipbench import check, weights, synthetic, flops, peaks, manifest, devtrace\n"
        "b = manifest.Bench(manifest.HERE / 'tests/data/BENCHMARK.json', manifest.HERE / 'tests/data')\n"
        "cfg = b.config('tiny-ssm')['model']\n"
        "w = weights.make(ssm.leaves(cfg), {l.name: 'float32' for l in ssm.leaves(cfg)}, 1, 'cpu')\n"
        "rows = synthetic.SyntheticTokens(250, 2, 1, 16, 1).unique_rows(0)\n"
        "r = train.run(cfg, b.config('tiny-ssm')['train'], w, [rows], 'cpu')\n"
        "assert r.losses[0] > 0\n"
    )
    top = _modules(code)
    assert "repro_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
