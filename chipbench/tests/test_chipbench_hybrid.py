"""The hybrid family (granite-4.0-h-small) in the harness, on the CPU: a
tiny granite-form cell (``tests/data/BENCHMARK-hybrid.json``: its period of
10, 3 of 8 experts held, a shared expert, NoPE, the multipliers) runs with
``correct`` true, and each planted fault makes it false; the three MoE
readers against hand counts; the configuration file against the model it
runs; and the reference loads nothing of the port."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from chipbench import check, manifest, run
from chipbench.metrics import moe_device_ms, moe_roofline, moe_step_mfu
from chipbench.reference.common import matmul_fp8
from chipbench.synthetic import SyntheticTokens
from chipbench.tests.conftest import DATA, cpu_run
from chipbench.tests.test_chipbench_faults import (_frozen, _half_batch, _skewed_decode,
                                                   _stale_params)
from chipbench.tests.test_chipbench_imports import _modules
from repro_torch.train import engine

CELL = "tiny-hybrid.heter.s32"
ROOT = manifest.ROOT


@pytest.fixture
def hybrid_bench() -> manifest.Bench:
    return manifest.Bench(DATA / "BENCHMARK-hybrid.json", DATA)


def test_sound_hybrid_run_is_correct_and_reads_the_moe(hybrid_bench):
    out = cpu_run(hybrid_bench, CELL, trace=1)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["loss_gap"]["value"] < 1e-5
    # on the CPU the regions read the host clock; the shares need a card's peak
    assert out["metrics"]["moe_device_ms"]["value"] > 0
    assert "moe_roofline" not in out["metrics"] and "moe_step_mfu" not in out["metrics"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "skewed_decode"])
def test_fault_in_a_hybrid_run_is_not_correct(hybrid_bench, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(engine.StepEngine, "_adamw", _frozen)
    else:
        wrap = _half_batch if fault == "half_batch" else _skewed_decode
        monkeypatch.setattr(engine, "slot_weights_device", wrap(engine.slot_weights_device))
    out = cpu_run(hybrid_bench, CELL)
    assert out["correct"] is False
    assert [n for n, c in out["checks"].items() if c["value"] > c["limit"]], out["checks"]


@pytest.mark.parametrize("seed", [2147483801, 2147483802, 2147483803])
def test_fp8_control_fails_the_granite_cell_limits(hybrid_bench, seed):
    """The reference with every matmul in fp8 e4m3 against the f32 one at
    the tiny hybrid's shapes is not correct under the granite cell's
    limits (``test_chipbench_control.py`` does this for the dense and SSM
    families)."""
    torch.set_num_threads(2)
    cfg = hybrid_bench.config("tiny-hybrid")
    traffic = hybrid_bench.traffic("heter-s32")
    data = SyntheticTokens(cfg["data_vocab"], traffic["k"], traffic["part_mb"],
                           traffic["seq_len"], seed)
    real = manifest.Bench().check("granite-4.0-h-small.heter-mb1.s1024")
    n, dev = real["check_steps"], torch.device("cpu")
    ref = run.reference_readings(hybrid_bench, cfg, data, seed, dev, n)
    fp8 = run.reference_readings(hybrid_bench, cfg, data, seed, dev, n, mm=matmul_fp8)
    within, rows = check.judge(check.compare(fp8, ref), real["limits"])
    assert not within, rows


def test_stale_served_leaf_in_a_hybrid_run_is_not_correct(tmp_path, monkeypatch):
    """Served in bf16 (so that AdamW keeps f32 masters), limits open but
    for ``stale_leaves``: served weights left behind the master fail."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    cfg = json.loads((data / "configs/tiny-hybrid.json").read_text())
    cfg["name"], cfg["model"]["dtype"] = "tiny-hybrid-bf16", "bfloat16"
    (data / "configs/tiny-hybrid-bf16.json").write_text(json.dumps(cfg))
    limits = json.loads((data / f"limits/{CELL}.json").read_text())
    limits["limits"].update(loss_gap=1.0, grad_gap=1.0, update_gap=1.0)
    (data / "limits/tiny-hybrid-bf16.heter.s32.json").write_text(json.dumps(limits))
    doc = json.loads((data / "BENCHMARK-hybrid.json").read_text())
    doc["configs"].append({"name": "tiny-hybrid-bf16", "source": "tests",
                           "file": "configs/tiny-hybrid-bf16.json", "reduced": [], "why": "tests"})
    doc["workloads"].append({"name": "tiny-hybrid-bf16.heter.s32", "config": "tiny-hybrid-bf16",
                             "traffic": "heter-s32", "chips": 1, "why": "tests"})
    (data / "BENCHMARK-hybrid.json").write_text(json.dumps(doc))
    bench = manifest.Bench(data / "BENCHMARK-hybrid.json", data)
    sound = cpu_run(bench, "tiny-hybrid-bf16.heter.s32")
    assert sound["correct"] is True and sound["checks"]["stale_leaves"]["value"] == 0
    monkeypatch.setattr(engine.StepEngine, "_adamw", _stale_params(engine.StepEngine._adamw))
    out = cpu_run(bench, "tiny-hybrid-bf16.heter.s32")
    assert out["correct"] is False and out["checks"]["stale_leaves"]["value"] > 0


# -- the readers against hand counts --------------------------------------------

MODEL = dict(family="hybrid", n_layers=2, d_model=2, vocab=3, n_heads=1, n_kv_heads=1,
             head_dim=2, attn_period=2, attn_offset=1, n_experts=4, shared_d_ff=3,
             conv_kernel=2, ssm_d_inner=4, ssm_heads=2, ssm_state=1, ssm_groups=1, ssm_chunk=2)
MOE = dict(kind="moe", B=2, S=4, d_model=2, experts=4, held=2, top_k=2, expert_d_ff=5,
           shared_d_ff=3)


def _ctx(spans, steps=(3, 4), window_s=2.0, peak=100.0):
    return run.Context(
        model=MODEL, traffic=dict(s=1, k=2, part_mb=1, seq_len=4), setup_s=0.0, t0=0.0,
        t1=window_s, steps=len(steps), window_steps=list(steps), tokens_per_step=8,
        peak_bytes=None, peaks=None if peak is None else {"bf16_flops": peak}, trace=None,
        spans=spans, counters={})


def _span(t0, t1, step, pass_, pairs=7, **kw):
    return ("device.mlp", t0, t1, {**MOE, "pass": pass_, "step": step, "pairs": pairs, **kw})


SPANS = [_span(0.0, 0.5, 3, "fwd"), _span(0.5, 0.75, 3, "recompute"), _span(0.75, 1.5, 3, "bwd"),
         _span(1.5, 1.75, 4, "fwd", pairs=3), _span(1.75, 2.0, 4, "bwd", pairs=3),
         ("device.mlp", 0.0, 9.0, {"kind": "dense", "step": 3, "pass": "fwd"}),
         _span(0.0, 9.0, 2, "fwd")]  # a checked step, before the window


def test_moe_device_ms_by_hand():
    # steps 3 and 4: 1.5 + 0.5 s of MoE spans over 2 steps
    assert moe_device_ms.read(_ctx(SPANS)) == pytest.approx(1000.0)
    assert moe_device_ms.read(_ctx(SPANS[5:])) is None


def test_moe_roofline_by_hand():
    # a forward span: router 2*8*2*4 = 128, held 6*2*5*pairs = 60 pairs, shared
    # 6*8*2*3 = 288; pairs 7 and 3 -> 836 and 596, x3 = 4296 over 2.0 s of
    # MoE spans, over a peak of 100
    assert moe_roofline.forward_flops({**MOE, "pairs": 7}) == 128 + 420 + 288
    assert moe_roofline.read(_ctx(SPANS)) == pytest.approx(100.0 * 4296 / 2.0 / 100.0)
    assert moe_roofline.read(_ctx([])) is None
    assert moe_roofline.read(_ctx(SPANS, peak=None)) is None  # no card


def test_moe_step_mfu_by_hand():
    # a row of S = 4 (the real rows: (s+1) k part_mb = 4): one Mamba2 layer as
    # flops.ssm_forward counts it without the head (S 4, chunk 2: in_proj
    # 2*4*2*(8+2+2) = 192, conv 2*4*6*2 = 96, C.B 12, y_diag 48, states and
    # readout 32 + 32, out_proj 64 -> 476); one attention layer: projections
    # 2*4*2*8 = 128, core 4*2*1*10 = 80; both layers' router 2*4*2*4 = 64 and
    # shared 6*4*2*3 = 144; the head 2*4*2*3 = 48
    row = 476 + 128 + 80 + 2 * (64 + 144) + 48
    assert moe_step_mfu.dense_part(MODEL, 4) == row
    # experts: 6*2*5 = 60 a pair, the pass's pairs scaled by 4 real rows of B 2
    expert = 60 * (7 + 3) * 4 / 2
    work = 3 * (2 * 4 * row + expert)
    assert moe_step_mfu.read(_ctx(SPANS)) == pytest.approx(100.0 * work / 2.0 / 100.0)
    assert moe_step_mfu.read(_ctx(SPANS[:3])) is None  # step 4 has no pairs: left out


# -- the configuration and the reference -----------------------------------------

WIDTH = re.compile(r"(^hidden|_hidden_size|intermediate|latent|state|proj|head|expan|_dim$"
                   r"|_rank$|per_tok)")


def test_granite_file_holds_the_catalog_numbers_but_the_reduced_keys():
    """The file's top-level keys (the published config.json's) agree with
    the model it runs; those it changes are the cut (``reduced``, none a
    width: ``num_hidden_layers`` counts layers) and keep their published
    values under ``published``."""
    doc = json.loads((ROOT / "chipbench/configs/granite-4.0-h-small.json").read_text())
    published = {**doc, **doc["published"]}
    assert set(doc["reduced"]) == {"num_hidden_layers", "layer_types", "num_local_experts",
                                   "vocab_size"}
    assert not any(WIDTH.search(k) for k in doc["reduced"])
    assert doc["num_hidden_layers"] == doc["model"]["n_layers"] == 10
    assert doc["num_local_experts"] == doc["model"]["experts_held"] == 9
    assert doc["vocab_size"] == doc["model"]["vocab"] == doc["data_vocab"] == 100352 // 8
    assert doc["layer_types"] == published["layer_types"][:10]
    m = doc["model"]
    assert (m["d_model"], m["n_heads"], m["n_kv_heads"], m["expert_d_ff"], m["shared_d_ff"],
            m["top_k"], m["n_experts"], m["ssm_heads"], m["ssm_state"]) == (
        doc["hidden_size"], doc["num_attention_heads"], doc["num_key_value_heads"],
        doc["intermediate_size"], doc["shared_intermediate_size"], doc["num_experts_per_tok"],
        published["num_local_experts"], doc["mamba_n_heads"], doc["mamba_d_state"])
    assert (m["attention_multiplier"], m["embedding_multiplier"], m["residual_multiplier"],
            m["logits_scaling"]) == (doc["attention_multiplier"], doc["embedding_multiplier"],
                                     doc["residual_multiplier"], doc["logits_scaling"])


def test_the_hybrid_reference_loads_nothing_of_the_port():
    code = (
        "import torch\n"
        "from chipbench.reference import hybrid, train\n"
        "from chipbench import weights, synthetic, manifest\n"
        "b = manifest.Bench(manifest.HERE / 'tests/data/BENCHMARK-hybrid.json',"
        " manifest.HERE / 'tests/data')\n"
        "c = b.config('tiny-hybrid')\n"
        "ls = hybrid.leaves(c['model'])\n"
        "w = weights.make(ls, {l.name: 'float32' for l in ls}, 1, 'cpu')\n"
        "rows = synthetic.SyntheticTokens(250, 2, 1, 16, 1).unique_rows(0)\n"
        "r = train.run(c['model'], c['train'], w, [rows], 'cpu')\n"
        "assert r.losses[0] > 0\n"
    )
    top = _modules(code)
    assert "repro_torch" not in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}
