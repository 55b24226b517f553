"""The port's Tessera examples run end to end on the CPU."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _run(script: str, *args: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), "--device",
         "cpu", *args], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_quickstart_torch():
    out = _run("quickstart_torch.py")
    assert out.count("disaggregated == single-device: OK") == 2
    assert "Plan[latency]" in out and "Plan[throughput]" in out


def test_serve_pipeline_torch():
    out = _run("serve_pipeline_torch.py")
    assert "'completed': 12" in out
    assert "CALIBRATION {" in out and "monitor: policy=" in out
    # the phase-split part: serial and streamed prefill -> decode pairs
    for kind in ("serial", "streamed"):
        assert f"{kind} handoff bit-identical to single engine: True" in out
        assert f"{kind}: decode-only engine: {{'completed': 6" in out


@pytest.mark.parametrize("policy", ["latency", "throughput"])
def test_serve_disaggregate_flag(policy, capsys):
    """``launch.serve --disaggregate`` plans the decode step for the GPU
    pair and serves every request through the executable."""
    from repro_torch.launch import serve
    summary = serve.main(["--smoke", "--device", "cpu", "--arch",
                          "llama3_8b", "--max-len", "40", "--disaggregate",
                          "--policy", policy])
    assert summary["completed"] == 8
    assert f"Plan[{policy}]" in capsys.readouterr().out


def test_serve_cluster_torch():
    out = _run("serve_cluster_torch.py")
    thr = {}
    for name in ("round_robin", "least_loaded", "jsed"):
        line = next(ln for ln in out.splitlines()
                    if ln.strip().startswith(name + ":"))
        thr[name] = float(line.split("thr=")[1].split()[0])
    assert thr["jsed"] > thr["round_robin"]
    assert thr["least_loaded"] > thr["round_robin"]
    assert "live pool: completed=4" in out and "routable=[False, True]" in out


def test_elastic_recovery_torch():
    out = _run("elastic_recovery_torch.py")
    assert "elastic re-plans: 2; logits identical throughout" in out
    assert "1 device :" in out and "dropped=0" in out
    assert "drain loss-free; replacement eligible after warm-up" in out


@pytest.mark.parametrize("spec_kw", [
    dict(groups=[["h100"], ["a100"]]),
    dict(groups=[["h100"], ["a100"]], pd=True),
    dict(groups=[["h100"], ["a100"]], pd=True, kv_chunks=4),
], ids=["pool", "serial_pair", "streamed_pair"])
def test_serve_deployment_flag(spec_kw, tmp_path, capsys):
    """``launch.serve --deployment SPEC_JSON`` launches the spec's engine
    topology on ``--device`` and serves every request."""
    from repro_torch.launch import serve
    from repro_torch.serving.spec import DeploymentSpec
    path = tmp_path / "spec.json"
    DeploymentSpec(arch="llama3_8b", engine={"slots": 2, "max_len": 64},
                   **spec_kw).save(path)
    out = serve.main(["--deployment", str(path), "--device", "cpu",
                      "--smoke", "--requests", "4", "--max-new", "6"])
    assert out["engine"]["completed"] == 4
    assert (out["wire_bytes"] > 0) == bool(spec_kw.get("pd"))
    assert (out["shards"] > 0) == (spec_kw.get("kv_chunks", 1) > 1)
    printed = capsys.readouterr().out
    assert f"deployment: pd={bool(spec_kw.get('pd'))}" in printed


def test_train_smoke_torch():
    """12 steps with int8 error feedback, a crash at step 8, a resume
    from the step-8 checkpoint in a fresh Trainer; the loss falls."""
    out = _run("train_smoke_torch.py", "--steps", "12")
    assert "simulated node failure at step 8" in out
    # the last line: "loss <first> -> <last> across a simulated crash"
    first, last = map(float, out.strip().splitlines()[-1].split()[1:4:2])
    assert last < first, out
