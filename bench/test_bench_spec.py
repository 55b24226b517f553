"""The benchmark's files, found by name, and its contract's shape."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from harness.spec import Bench
import run as R

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file_found(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("bench/")
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    for k in ("source", "assumed", "engine"):
        assert cfg[k]
    for k in entry["reduced"]:
        assert k in cfg["assumed"], k
        assert not k.endswith(("_dim", "_rank")) and k not in (
            "d_model", "d_ff", "head_dim", "experts_per_token")


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(wl):
    b = Bench(ROOT)
    assert NAME.match(wl["name"]) and wl["chips"] in (1, 4)
    assert len(wl["why"]) <= 200
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    b.config(wl["config"])
    tr = b.traffic(wl["traffic"])
    cell = b.cell(wl["name"])
    assert set(cell["limits"]) & {"max_logit_gap", "mean_logit_gap"}
    if tr["loop"] == "open":
        assert cell["rate_per_s"] > 0
    e2e = {m["name"] for m in b.metrics(wl["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert b.metrics(wl["name"], "per_layer")


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(m):
    cells = {w["name"] for w in SPEC["workloads"]}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", cells)) <= cells
    assert callable(Bench(ROOT).reader(m["name"]))
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        e2e = {e["name"]: e for e in SPEC["end_to_end"]}
        assert m["moves"] in e2e
        # every cell that lists this metric reports what it moves
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])


def test_import_check_compares_whole_top_level_names():
    assert R.forbidden_modules(["repro_torch", "repro_torch.models",
                                "jaxtyping", "flaxen.x", "numpy"]) == []
    assert R.forbidden_modules(["repro.core.graph", "jax.numpy", "flax",
                                "jaxlib"]) == ["flax", "jax", "jaxlib",
                                               "repro"]


def test_harness_sources_import_no_jax_or_reference_package():
    """No file of the benchmark imports JAX or the JAX package; the
    reference imports nothing of the program either."""
    pat = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][A-Za-z0-9_]*)", re.M)
    for path in (ROOT / "bench").rglob("*.py"):
        tops = set(pat.findall(path.read_text()))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
