"""``BENCHMARK.json`` and the data files it names, found by name.

Layout under the checkout's root (``root``):

* ``BENCHMARK.json``: metrics, configurations, cells;
* ``bench/configs/<config>.json``: a configuration's sizes, its engine
  settings (``engine``) and its source (the file ``BENCHMARK.json`` names);
* ``bench/traffic/<traffic>.json``: a traffic mix;
* ``bench/cells/<cell>.json``: what belongs to one cell alone (an
  open loop's rate, the decode path, engine settings that differ from the
  configuration's, the limits of its correctness check);
* ``bench/metrics/<metric>.py``: a metric's reader, ``read(ctx)``.

A later change adds a configuration, a mix, a cell or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

DIR = "bench"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Bench:
    """The benchmark rooted at ``root`` (a checkout)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")

    def _named(self, key: str, name: str) -> Dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def workload(self, name: str) -> Dict:
        return self._named("workloads", name)

    def config(self, name: str) -> Dict:
        return load_json(self.root / self._named("configs", name)["file"])

    def traffic(self, name: str) -> Dict:
        return load_json(self.root / DIR / "traffic" / f"{name}.json")

    def cell(self, name: str) -> Dict:
        path = self.root / DIR / "cells" / f"{name}.json"
        return load_json(path) if path.exists() else {}

    def metrics(self, workload: str, kind: str) -> List[Dict]:
        """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that the
        cell ``workload`` reports: those without a ``workloads`` list and
        those whose list names it."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[Any], Optional[float]]:
        path = self.root / DIR / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
