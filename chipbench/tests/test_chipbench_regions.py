"""The readers of the program's device regions, ``attention_roofline`` and
``mixer_device_ms``, against counts worked out by hand on made-up spans;
and, on the tiny cells, the program's own records against the harness's
wrappers: ``phase.upload``'s ``rows`` and ``weighted_rows`` give the same
``weighted_seq_pct``, and the SSD mixer spans' shapes the same
``ssd_scan`` bytes."""

from __future__ import annotations

import json
import types

import pytest
import torch

from chipbench import flops, manifest, weights
from chipbench.metrics import attention_roofline, mixer_device_ms
from chipbench.program import Program
from chipbench.reference import family
from chipbench.run import _dtypes_of
from chipbench.synthetic import SyntheticTokens
from chipbench.tests.conftest import DATA

SEED = 2147483791
# one attention span's shape: B 2, S 3, d 4, 2 heads and 1 KV head of 2
ATTN = dict(kind="attn", B=2, S=3, d_model=4, heads=2, kv_heads=1, head_dim=2, window=None)


def _ctx(spans, steps=(5, 6), bf16=1e3):
    return types.SimpleNamespace(spans=spans, window_steps=list(steps),
                                 peaks=None if bf16 is None else {"bf16_flops": bf16})


def _span(name, t0, t1, **args):
    return (name, t0, t1, args)


def test_attention_forward_flops_by_hand():
    # projections 2*3*4*(2*2*2 + 2*1*2) = 288 a row; the causal core keeps 6
    # (q, k) pairs, q.k and p.v 2*2 each over 2 heads: 4*2*2*6 = 96 a row
    assert attention_roofline.forward_flops(ATTN) == 2 * (288 + 96)


def test_attention_roofline_by_hand():
    spans = [
        _span("device.mixer", 0.0, 1.0, step=5, layer=0, **{"pass": "fwd"}, **ATTN),
        _span("device.mixer", 1.0, 2.0, step=5, layer=0, **{"pass": "recompute"}, **ATTN),
        _span("device.mixer", 2.0, 4.0, step=5, layer=0, **{"pass": "bwd"}, **ATTN),
        # not read: a step outside the window, an SSD mixer, an MLP, a host span
        _span("device.mixer", 9.0, 19.0, step=4, layer=0, **{"pass": "fwd"}, **ATTN),
        _span("device.mixer", 4.0, 5.0, step=6, layer=1, kind="ssd", **{"pass": "fwd"}),
        _span("device.mlp", 5.0, 6.0, step=6, layer=0, **{"pass": "fwd"}),
        _span("phase.fused", 0.0, 6.0, step=5),
    ]
    # 3 x 768 FLOPs of one forward over 4 s of attention spans, over 1e3 FLOP/s
    assert attention_roofline.read(_ctx(spans)) == pytest.approx(100.0 * 3 * 768 / 4.0 / 1e3)
    assert attention_roofline.read(_ctx(spans, bf16=None)) is None
    assert attention_roofline.read(_ctx(spans[4:])) is None
    assert attention_roofline.read(_ctx([])) is None


def test_mixer_device_ms_by_hand():
    spans = [
        _span("device.mixer", 0.0, 0.5, step=5, kind="attn"),
        _span("device.mixer", 1.0, 1.25, step=5, kind="attn"),
        _span("device.mixer", 2.0, 2.75, step=6, kind="ssd"),
        _span("device.mixer", 3.0, 13.0, step=4, kind="attn"),  # before the window
        _span("device.mlp", 4.0, 5.0, step=6),
        _span("step", 0.0, 5.0, step=5),
    ]
    assert mixer_device_ms.read(_ctx(spans)) == pytest.approx(1e3 * 1.5 / 2)
    assert mixer_device_ms.read(_ctx(spans[4:])) is None
    assert mixer_device_ms.read(_ctx(spans, steps=())) is None


@pytest.mark.parametrize("cfg_name,family_name", [("tiny-dense", "dense"), ("tiny-ssm", "ssm")])
def test_program_records_agree_with_the_harness_wrappers(cfg_name, family_name):
    torch.set_num_threads(2)
    bench = manifest.Bench(DATA / "BENCHMARK.json", DATA)
    cfg = bench.config(cfg_name)
    traffic = json.loads((DATA / "traffic/heter-s32.json").read_text())
    dev = torch.device("cpu")
    prog = Program(cfg, traffic, bench.layout(family_name), SEED, dev, trace=True)
    served = weights.make(family(family_name).leaves(cfg["model"]), _dtypes_of(cfg, bench), SEED,
                          dev)
    state = prog.state(served)
    data = SyntheticTokens(cfg["data_vocab"], traffic["k"], traffic["part_mb"],
                           traffic["seq_len"], SEED)
    for step in range(3):
        state, _ = prog.step(state, data.batch(step))
    counters = prog.counters()
    spans = prog.spans()
    prog.close()

    uploads = [a for name, _, _, a in spans if name == "phase.upload"]
    assert len(uploads) == 3
    assert sum(a["rows"] for a in uploads) == counters["rows"]
    assert sum(a["weighted_rows"] for a in uploads) == counters["weighted_rows"]

    mixers = [a for name, _, _, a in spans if name == "device.mixer"]
    n_layers = cfg["model"]["n_layers"]
    assert len(mixers) == 3 * 3 * n_layers  # fwd, recompute, bwd a layer a step
    calls = counters["ssd_calls"]
    if family_name == "dense":
        assert not calls and {a["kind"] for a in mixers} == {"attn"}
        return
    scans = [a for a in mixers if a["pass"] in ("fwd", "recompute")]
    assert len(scans) == len(calls) == 2 * 3 * n_layers

    def scan_bytes(a):
        S = -(-a["S"] // a["chunk"]) * a["chunk"]  # the scan pads to a chunk multiple
        return flops.ssd_scan_bytes(a["B"], S, a["H"], a["P"], a["G"], a["N"], a["bc_bytes"])

    assert sum(map(scan_bytes, scans)) == sum(flops.ssd_scan_bytes(*shape, bc)
                                              for _, shape, bc in calls)
