"""Finds every piece of a cell by its name in ``BENCHMARK.json``.

- a configuration: the ``file`` its ``configs`` entry names (relative to
  the manifest's directory);
- a traffic mix: ``traffic/<name>.json`` under the data directory;
- a cell's check: ``limits/<workload>.json`` under the data directory (how
  many first steps the reference follows, and each number's limit);
- a metric: its reader ``chipbench/metrics/<name>.py``, a module with
  ``read(ctx) -> float | None``;
- a family's parameter layout in the port: ``chipbench/layouts/<family>.json``.

So a later change adds a cell, a configuration, a mix or a metric by
adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    def __init__(self, manifest: Path | str = ROOT / "BENCHMARK.json", data: Path | str = HERE):
        self.path = Path(manifest)
        self.doc = _load(self.path)
        self.data = Path(data)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.doc[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in {self.path}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        doc = _load(self.path.parent / self._entry("configs", name)["file"])
        if doc["name"] != name:
            raise ValueError(f"configuration file of {name!r} names {doc['name']!r}")
        return doc

    def traffic(self, name: str) -> dict:
        return _load(self.data / "traffic" / f"{name}.json")

    def check(self, workload: str) -> dict:
        """``{"check_steps": n, "limits": {number: limit}, ...}``."""
        return _load(self.data / "limits" / f"{workload}.json")

    @staticmethod
    def layout(family: str) -> dict:
        return _load(HERE / "layouts" / f"{family}.json")["leaves"]

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: with ``trace`` the
        per-layer ones, else the end-to-end ones, each that lists the cell
        or, with no ``workloads`` key, every cell (a per-layer metric then
        every cell that reports the end-to-end metric it moves)."""
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in names else [])]

    @staticmethod
    def reader(metric: str):
        """The module that reads ``metric``: ``chipbench.metrics.<metric>``."""
        return importlib.import_module(f"chipbench.metrics.{metric}")
