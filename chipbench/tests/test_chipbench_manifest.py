"""BENCHMARK.json against the contract it is written to, every piece found
by name, and a new cell added as files only."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from chipbench import check, manifest
from chipbench.reference import family
from chipbench.tests.conftest import DATA, cpu_run

ROOT = manifest.ROOT
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|per_tok)")


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["chipbench"]
    assert 1 <= len(DOC["command"]) <= 32
    for word in DOC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert word.split("/")[0] in DOC["paths"]
    assert (ROOT / DOC["command"][1]).is_file()


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert NAME.match(entry["name"])
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("chipbench/")
    doc = json.loads(path.read_text())
    assert doc["name"] == entry["name"] and doc["source"] == entry["source"]
    assert doc["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    assert (ROOT / "chipbench/layouts" / f"{doc['model']['family']}.json").is_file()
    assert family(doc["model"]["family"]).leaves(doc["model"])
    assert any(w["config"] == entry["name"] for w in DOC["workloads"])
    for key in ("why", "source"):
        assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda e: e["name"])
def test_workload_found_by_name(cell):
    bench = manifest.Bench()
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert bench.config(cell["config"])["name"] == cell["config"]
    assert bench.traffic(cell["traffic"])["seq_len"] > 0
    checked = bench.check(cell["name"])
    assert set(checked["limits"]) == set(check.NUMBERS) and checked["check_steps"] >= 2
    for trace in (False, True):
        metrics = bench.metrics(cell["name"], trace)
        assert metrics
        for m in metrics:
            assert callable(bench.reader(m["name"]).read)
    names = {m["name"] for m in bench.metrics(cell["name"], False)}
    assert "setup_s" in names and len(names) >= 2


def test_cells_and_metrics_unique_and_well_formed():
    assert len({w["name"] for w in DOC["workloads"]}) == len(DOC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in DOC["workloads"]}) == len(DOC["workloads"])
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, len(DOC["workloads"]) // 4)
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"] for w in DOC["workloads"]}
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "chipbench/metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(DOC).encode()) <= 64 * 1024


def test_a_new_cell_is_files_only(tmp_path: Path):
    """A mix and a cell added as a data file, a limits file and manifest
    entries run end to end with no change to any file of the harness."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    mix = json.loads((data / "traffic/heter-s32.json").read_text())
    mix.update(seq_len=16, scheme="cyclic", k=4, part_mb=2)
    (data / "traffic/cyclic-s16.json").write_text(json.dumps(mix))
    (data / "limits/tiny-dense.cyclic.s16.json").write_text(
        (data / "limits/tiny-dense.heter.s32.json").read_text())
    doc = json.loads((data / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-dense.cyclic.s16", "config": "tiny-dense",
                             "traffic": "cyclic-s16", "chips": 1, "why": "a cell added as files"})
    (data / "BENCHMARK.json").write_text(json.dumps(doc))
    out = cpu_run(manifest.Bench(data / "BENCHMARK.json", data), "tiny-dense.cyclic.s16", trace=1)
    assert out["correct"] is True
    # cyclic at k = m = 4, s = 1: an exact plan of 2 slots a worker, 2 rows a slot
    assert out["metrics"]["weighted_seq_pct"]["value"] == pytest.approx(75.0)
