"""A cell's files, found by the names in ``BENCHMARK.json``.

A configuration is its ``file``; a traffic mix is
``port_bench/traffic/<traffic>.json``, whose ``kind`` is the module
``port_bench/kinds/<kind>.py`` (``harness/mix``); the comparison settings
and limits of a cell are ``port_bench/cells/<cell>.json``; a metric's
reader is ``port_bench/metrics/<metric>.py``.  A later cell, mix, configuration or
metric is added as new files and entries, with no edit here."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """Everything a run of one cell reads, by name."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "port_bench"
        spec = _json(self.root / "BENCHMARK.json")
        matches = [w for w in spec["workloads"] if w["name"] == name]
        if not matches:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.entry = spec, matches[0]
        self.name = name
        cfg = next(c for c in spec["configs"] if c["name"] == self.entry["config"])
        self.config = _json(self.root / cfg["file"])
        self.traffic = _json(self.bench / "traffic" / f"{self.entry['traffic']}.json")
        self.settings = _json(self.bench / "cells" / f"{name}.json")
        self.chips = int(self.entry["chips"])

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports: the end-to-end ones without a
        trace, the per-layer ones with it; a metric with ``workloads``
        only in those cells."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def _module(self, folder: str, name: str):
        """The module of ``port_bench/<folder>/<name>.py`` in this checkout, by its path."""
        path = self.bench / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"port_bench_{folder}_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str):
        """The ``read(run)`` function of ``port_bench/metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def kind(self):
        """The module ``port_bench/kinds/<kind>.py`` of the cell's traffic
        (``harness/mix``)."""
        return self._module("kinds", self.traffic["kind"])
