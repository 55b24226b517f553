"""The port imports without JAX and without the JAX package, and builds
no kernel at import time."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.moe_gmm import kernel as gmm
print(len(names), bad, {**fa._LIBS, **gmm._LIBS})
"""


def test_port_imports_no_jax_no_reference():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad, libs = out.stdout.strip().rsplit("\n", 1)[-1].split(" ", 2)
    assert int(n) >= 77, out.stdout      # every module, training's too
    assert bad == "[]" and libs == "{}", out.stdout


def test_chip_smoke_imports_no_jax_no_reference():
    """chip_smoke.py drives the port on the card without JAX."""
    import ast
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    tree = ast.parse(open(path).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "repro"}, mods
