"""The control, kept at a size a test run holds: the reference computed
with every matmul in fp8 e4m3 (the step below the configurations' bf16)
is not correct under the limits of the real cells, at the tiny CPU shapes
of each cell's family, on three seeds."""

from __future__ import annotations

import pytest
import torch

from chipbench import check, manifest, run
from chipbench.reference.common import matmul_fp8
from chipbench.synthetic import SyntheticTokens

REAL = manifest.Bench()
CELLS = [(w["name"], REAL.config(w["config"])["model"]["family"]) for w in REAL.doc["workloads"]]
TINY = {"dense": "tiny-dense", "ssm": "tiny-ssm"}


@pytest.mark.parametrize("cell,family", CELLS, ids=[c for c, _ in CELLS])
@pytest.mark.parametrize("seed", [2147483801, 2147483802, 2147483803])
def test_fp8_control_is_not_correct(bench, cell, family, seed):
    torch.set_num_threads(2)
    cfg = bench.config(TINY[family])
    traffic = bench.traffic("heter-s32")
    data = SyntheticTokens(cfg["data_vocab"], traffic["k"], traffic["part_mb"],
                           traffic["seq_len"], seed)
    dev = torch.device("cpu")
    n = REAL.check(cell)["check_steps"]
    ref = run.reference_readings(bench, cfg, data, seed, dev, n)
    fp8 = run.reference_readings(bench, cfg, data, seed, dev, n, mm=matmul_fp8)
    within, rows = check.judge(check.compare(fp8, ref), REAL.check(cell)["limits"])
    assert not within, rows
