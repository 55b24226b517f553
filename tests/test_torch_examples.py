"""The port's Tessera examples run end to end on the CPU."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _run(script: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
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
