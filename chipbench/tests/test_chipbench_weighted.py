"""``weighted_seq_pct``'s count on a reduced trainer on the CPU under
``heter-s2048`` (its sequences shortened): every fused pass packs 40 rows
(5 slots a worker of 2 rows), and 16 or 24 of them carry a nonzero weight."""

from __future__ import annotations

import json

import torch

from chipbench import manifest, weights
from chipbench.program import Program
from chipbench.reference import family
from chipbench.run import _dtypes_of
from chipbench.synthetic import SyntheticTokens
from chipbench.tests.conftest import DATA


def test_heter_s2048_packs_40_rows_and_weights_16_to_24():
    bench = manifest.Bench(DATA / "BENCHMARK.json", DATA)
    cfg = bench.config("tiny-dense")
    traffic = json.loads((manifest.HERE / "traffic/heter-s2048.json").read_text())
    traffic["seq_len"] = 16
    dev = torch.device("cpu")
    prog = Program(cfg, traffic, bench.layout("dense"), 2147483777, dev, trace=True)
    served = weights.make(family("dense").leaves(cfg["model"]), _dtypes_of(cfg, bench),
                          2147483777, dev)
    state = prog.state(served)
    data = SyntheticTokens(cfg["data_vocab"], traffic["k"], traffic["part_mb"],
                           traffic["seq_len"], 2147483777)
    seen = set()
    for step in range(12):
        prog.reset_counters()
        state, _ = prog.step(state, data.batch(step))
        c = prog.counters()
        assert c["rows"] == 40
        assert 16 <= c["weighted_rows"] <= 24
        seen.add(c["weighted_rows"])
    prog.close()
    assert "weighted_loss" not in vars(prog.model)
    assert seen <= {16, 24}
