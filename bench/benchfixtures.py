"""Fixtures of the benchmark's tests (``bench/test_bench_*.py``), which
import them by name.  Not a ``conftest.py``: the repository's tests import
their own ``conftest`` module by name, which a second ``conftest.py`` would
shadow.  Every test here runs on the CPU.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


SMOKE_SIZES = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
                   engine={"slots": 4, "max_len": 96, "sync_every": 4})


@pytest.fixture
def smoke_root(tmp_path):
    """A checkout-shaped directory whose benchmark gains a configuration,
    a traffic mix, a cell and a per-layer metric by new files and new
    entries only: the repository's ``BENCHMARK.json`` with entries added,
    its data files copied, and the new files beside them.  The smoke
    configurations are the repository's at toy sizes, in float32, on the
    CPU (the program's plain kernel versions)."""
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(BENCH / d, root / "bench" / d)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    new_cells = []
    for fam, src in (("dense", "granite-8b"), ("moe", "mixtral-8x7b")):
        cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
        cfg.update(SMOKE_SIZES, name=f"smoke-{fam}")
        if fam == "moe":
            cfg["num_experts"] = 4
        (root / "bench/configs" / f"smoke-{fam}.json").write_text(
            json.dumps(cfg))
        spec["configs"].append({"name": f"smoke-{fam}", "source": "toy",
                                "file": f"bench/configs/smoke-{fam}.json",
                                "reduced": [], "why": "toy"})
    for tr in ("chat", "offline"):
        mix = json.loads((BENCH / "traffic" / f"{tr}.json").read_text())
        mix.update(prompt_max=40, output_max=24, ramp_s=0.5)
        (root / "bench/traffic" / f"smoke-{tr}.json").write_text(
            json.dumps(mix))
    for fam, tr in (("dense", "chat"), ("dense", "offline"),
                    ("moe", "offline")):
        cell = f"smoke-{fam}.smoke-{tr}"
        (root / "bench/cells" / f"{cell}.json").write_text(json.dumps(
            {"rate_per_s": 6.0, "limits": {"max_logit_gap": 1e-3}}))
        spec["workloads"].append({"name": cell, "config": f"smoke-{fam}",
                                  "traffic": f"smoke-{tr}", "chips": 1,
                                  "why": "toy"})
        new_cells.append(cell)
    (root / "bench/metrics/admitted_requests.py").write_text(
        "def read(run):\n"
        "    return float(sum(len(a.slots) for a in run.admissions_in(run.open_, run.close)))\n")
    spec["per_layer"].append({
        "name": "admitted_requests", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "engine admission",
        "moves": "tpot_p90_s", "workloads": new_cells})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and m["name"] != "admitted_requests":
            m["workloads"] = m["workloads"] + new_cells
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
