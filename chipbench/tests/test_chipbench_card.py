"""The command as a check runs it.  Without enough cards it exits
non-zero and prints no result; on a card (``gpu``) a short run of each
cell prints a correct result line."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from chipbench import manifest

ROOT = manifest.ROOT
CELLS = [w["name"] for w in manifest.Bench().doc["workloads"]]


def _run(cwd, cell, seconds="2", trace="0"):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", cell, "--seed", "3000000123",
         "--seconds", seconds, "--trace", trace],
        capture_output=True, text=True, cwd=cwd, timeout=1200,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one passes")
    out = _run(ROOT, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench")
    out = _run(tmp_path, CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT, cell, seconds="5", trace="1")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
