"""The port's examples (``examples/torch/*.py``) run on the CPU.

Each runs with ``--device cpu`` in a subprocess and must exit 0 with its
own checks passing: ``quickstart`` (its allocation and ``C·B == 1`` lines
equal those of the JAX ``examples/quickstart.py``, run beside it, and the
decoded gradient equals the true one), ``train_coded`` with ``SMOKE=1``
(the launcher's 40 steps; its checkpoints land under
``build/examples/coded_ckpt``), ``serve_lm`` (every request completes) and
``elastic_restart`` (the restart on another cluster and the in-place
membership change, about 10 s on two CPU threads).  Without ``--device
cpu`` and without a card an example exits with an error; it never falls
back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
TIMEOUT_S = 600


def _run(script: Path, *args: str, **env) -> subprocess.CompletedProcess:
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                "OMP_NUM_THREADS": "2", **env}
    return subprocess.run([sys.executable, str(script), *args], env=full_env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def _ok(proc: subprocess.CompletedProcess) -> str:
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_prints_the_jax_example_lines():
    got = _ok(_run(EXAMPLES / "quickstart.py", "--device", "cpu")).splitlines()
    want = _ok(_run(ROOT / "examples" / "quickstart.py")).splitlines()
    for prefix in ("registered schemes:", "allocation n_i:", "C·B == 1:",
                   "iteration time with a fault every step:"):
        line = [x for x in got if x.startswith(prefix)]
        assert line and line == [x for x in want if x.startswith(prefix)], prefix
    assert "C·B == 1: True" in got
    assert "decoded grad == true grad (worker 3 dead): True" in got
    assert "device: cpu" in got


def test_train_coded_smoke_runs_on_the_cpu():
    out = _ok(_run(EXAMPLES / "train_coded.py", "--device", "cpu", SMOKE="1"))
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps_run"] == 40 and summary["device"] == "cpu"
    assert summary["m"] == 6 and summary["exact_fraction"] == 1.0
    ckpt = ROOT / "build" / "examples" / "coded_ckpt"
    assert (ckpt / "step_00000040").is_dir()


def test_serve_lm_runs_on_the_cpu():
    out = _ok(_run(EXAMPLES / "serve_lm.py", "--device", "cpu"))
    assert "arch=mamba2-370m" in out and "device=cpu" in out
    assert "requests=16" in out


def test_elastic_restart_runs_on_the_cpu():
    out = _ok(_run(EXAMPLES / "elastic_restart.py", "--device", "cpu"))
    assert "elastic restart OK" in out
    assert "in-place elastic membership OK on cpu" in out


@pytest.mark.parametrize("name", ["quickstart", "serve_lm", "elastic_restart", "train_coded"])
def test_example_refuses_a_missing_card(name):
    """Asked for the card (the default) where there is none, each example
    exits non-zero naming the problem, and runs nothing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    proc = _run(EXAMPLES / f"{name}.py")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
