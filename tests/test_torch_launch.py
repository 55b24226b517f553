"""``python -m repro_torch.launch.serve`` runs on the CPU when asked to,
and the port's entry points refuse to run without CUDA unless the
caller names the CPU (they never fall back)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))


@pytest.mark.parametrize("argv", [
    ["--smoke", "--device", "cpu"],
    ["--smoke", "--device", "cpu", "--trace", "poisson", "--requests", "5",
     "--max-new", "4", "--sync-every", "1"],
    ["--smoke", "--device", "cpu", "--arch", "gemma_2b", "--slots", "2"],
    ["--smoke", "--device", "cpu", "--arch", "gpt_oss_20b", "--max-len",
     "40", "--trace", "poisson", "--requests", "3", "--max-new", "6"],
])
def test_serve_smoke_on_cpu(argv):
    out = serve.main(argv)
    n = int(argv[argv.index("--requests") + 1]) if "--requests" in argv \
        else 8
    assert out["completed"] == n and out["decode_steps"] > 0


def test_serve_module_entry_point():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "'completed': 3" in res.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke("llama3_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
