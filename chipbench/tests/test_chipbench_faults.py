"""The comparison fails a broken timed path: each test drives a whole run
on the CPU (the look for a card skipped) with a fault planted in the port
underneath, and sees ``correct`` come out false; the same run unbroken
comes out true."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from chipbench import manifest
from chipbench.tests.conftest import DATA, cpu_run
from repro_torch.optim.adam import global_norm
from repro_torch.train import engine

CELLS = ["tiny-dense.heter.s32", "tiny-ssm.heter.s32"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    out = cpu_run(bench, cell, trace=1)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "update_gap", "stale_leaves",
                                  "failed_steps"}
    assert list(out)[-1] == "checks"


def _frozen(self, params, grads, opt, step):
    """A step that returns its state unchanged."""
    return params, opt, float(global_norm(grads)), float(self._lr(step))


def _half_batch(inner):
    """Half of each step's partitions left out, the mean taken over the rest."""
    def weights(a, support, coeff, mask, pids, k):
        return inner(a, support, coeff, mask, pids, k) * (pids < k // 2).float() * 2.0
    return weights


def _skewed_decode(inner):
    """One used worker's decode coefficient 10 % off where it is produced."""
    def weights(a, support, coeff, mask, pids, k):
        a = a.clone()
        a[int(torch.nonzero(a)[0])] *= 1.1
        return inner(a, support, coeff, mask, pids, k)
    return weights


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "skewed_decode"])
def test_fault_is_not_correct(bench, cell, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(engine.StepEngine, "_adamw", _frozen)
    else:
        wrap = _half_batch if fault == "half_batch" else _skewed_decode
        monkeypatch.setattr(engine, "slot_weights_device", wrap(engine.slot_weights_device))
    out = cpu_run(bench, cell)
    assert out["correct"] is False
    over = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over, out["checks"]


def _stale_params(inner):
    """AdamW moves the f32 master weights and leaves the served ones as
    they were."""
    def adamw(self, params, grads, opt, step):
        before = {k: p.detach().clone() for k, p in params.items()}
        params, opt, gnorm, lr = inner(self, params, grads, opt, step)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(before[k])
        return params, opt, gnorm, lr
    return adamw


def _bf16_bench(tmp_path: Path) -> manifest.Bench:
    """The tiny dense cell served in bf16, so that AdamW keeps f32 master
    weights; its limits left wide open but for ``stale_leaves``."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    cfg = json.loads((data / "configs/tiny-dense.json").read_text())
    cfg["name"], cfg["model"]["dtype"] = "tiny-dense-bf16", "bfloat16"
    (data / "configs/tiny-dense-bf16.json").write_text(json.dumps(cfg))
    limits = json.loads((data / "limits/tiny-dense.heter.s32.json").read_text())
    limits["limits"].update(loss_gap=1.0, grad_gap=1.0, update_gap=1.0)
    (data / "limits/tiny-dense-bf16.heter.s32.json").write_text(json.dumps(limits))
    doc = json.loads((data / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-dense-bf16", "source": "tests",
                           "file": "configs/tiny-dense-bf16.json", "reduced": [], "why": "tests"})
    doc["workloads"].append({"name": "tiny-dense-bf16.heter.s32", "config": "tiny-dense-bf16",
                             "traffic": "heter-s32", "chips": 1, "why": "tests"})
    (data / "BENCHMARK.json").write_text(json.dumps(doc))
    return manifest.Bench(data / "BENCHMARK.json", data)


@pytest.mark.parametrize("fault", [None, "params_stale"])
def test_served_leaves_stale_behind_the_master_is_not_correct(tmp_path, fault, monkeypatch):
    if fault:
        monkeypatch.setattr(engine.StepEngine, "_adamw", _stale_params(engine.StepEngine._adamw))
    out = cpu_run(_bf16_bench(tmp_path), "tiny-dense-bf16.heter.s32")
    stale = out["checks"]["stale_leaves"]
    assert stale["limit"] == 0
    if fault:
        assert out["correct"] is False and stale["value"] > 0
    else:
        assert out["correct"] is True and stale["value"] == 0
