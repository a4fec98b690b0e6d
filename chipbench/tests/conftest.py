"""Shared fixtures of the benchmark's CPU tests: a bench over the tiny
test cells (``tests/data``) and a CPU run of the harness on one of them."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from chipbench import manifest, run

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def bench() -> manifest.Bench:
    return manifest.Bench(DATA / "BENCHMARK.json", DATA)


def cpu_run(bench: manifest.Bench, workload: str, seed: int = 2147483713,
            seconds: float = 0.3, trace: int = 0) -> dict:
    """One run of the harness on the CPU, the look for a card skipped; its
    result line as a dict."""
    out = io.StringIO()
    torch.set_num_threads(2)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], bench=bench, need_card=False, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
