"""Process-group helpers of the port's sharding and expert-parallel
tests.

Everything that initialises a ``torch.distributed`` process group or a
multi-device JAX backend runs in a fresh interpreter (``run``): a group
left initialised, or a JAX device count fixed at the backend's first
use, would leak into every later test file of the same pytest worker.
Inside that interpreter, ``gloo_world`` runs a function on N gloo ranks
(``torch.multiprocessing`` spawn, a ``file://`` store in a temporary
directory) and ``one_rank`` gives the interpreter itself a one-rank
gloo group; each destroys its group.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run(code: str, *, jax_devices: int = 0, timeout: float = 300):
    """Run ``code`` in a fresh interpreter with ``src/`` and ``tests/``
    on the path, ``JAX_PLATFORMS`` passed through and, with
    ``jax_devices``, that many JAX host devices.  ``code`` leaves its
    result in ``OUT`` (a path it pickles to); returns the unpickled
    result."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.pkl")
        prog = f"OUT = {out!r}\n" + textwrap.dedent(code)
        env = {"PYTHONPATH": os.pathsep.join([str(REPO / "src"),
                                              str(REPO / "tests")]),
               "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": os.environ.get("HOME", d),
               "TMPDIR": d,
               # without it jax probes other platforms for minutes
               "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
               "OMP_NUM_THREADS": "1"}
        if jax_devices:
            env["XLA_FLAGS"] = \
                f"--xla_force_host_platform_device_count={jax_devices}"
        r = subprocess.run([sys.executable, "-c", prog], cwd=d, env=env,
                           capture_output=True, text=True, timeout=timeout)
        assert r.returncode == 0, r.stdout[-4000:] + "\n" + r.stderr[-8000:]
        with open(out, "rb") as f:
            return pickle.load(f)


def save(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _rank_main(rank, fn, world, init, outdir, args):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    save(os.path.join(outdir, f"{rank}.pkl"), res)


def gloo_world(fn, world: int, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order.  ``fn`` must be importable by name
    (a module-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        mp.spawn(_rank_main, args=(fn, world, init, d, args), nprocs=world,
                 join=True)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


@contextlib.contextmanager
def one_rank():
    """A one-rank gloo group on an in-memory store (no port opened)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def checks(fns) -> dict:
    """Run each ``(name, fn)``; a check's result is what it returns, or
    the traceback of what it raised, so every test names its own
    failure."""
    import traceback
    out = {}
    for name, fn in fns:
        try:
            out[name] = ("ok", fn())
        except Exception:               # reported by the test that reads it
            out[name] = ("error", traceback.format_exc())
    return out


def result(results: dict, name: str):
    """The value of check ``name`` in ``results``; fails the calling test
    with the check's traceback if it raised."""
    status, value = results[name]
    assert status == "ok", value
    return value
