"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload granite-8b.chat --seed 7 --seconds 50 \
        --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``).  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the correctness check compared, with its limit
(also the last lines of standard error).

Exits 2 without a result when no CUDA device is present or fewer than the
cell asks for, and 3 when a JAX module was loaded in this process.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "bench"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def metrics(bench, workload: str, kind: str, run) -> dict:
    out = {}
    for m in bench.metrics(workload, kind):
        v = bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness.spec import Bench

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    # the program's kernel builds stay in the checkout (their fixed
    # _build/ folders); a Triton cache, should anything use one, too
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "bench" / "_cache" / "triton"))
    from harness import devtrace, serve

    device = torch.device("cuda", 0)
    out = serve.run(ROOT, args.workload, args.seed, args.seconds,
                    bool(args.trace), device, T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    run = out["run"]
    from harness import check
    checks = out["checks"]
    result = {
        "correct": check.passed(checks),
        "attempted": out["attempted"],
        "failed": 0,
        "metrics": metrics(bench, args.workload,
                           "per_layer" if args.trace else "end_to_end", run),
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips,
                   "memory_peak_bytes": out["peak"]},
        # the window's peak above; set-up's (the warm admission) apart
        "memory_peak_setup_bytes": out["peak_setup"],
    }
    if args.trace:
        lo, hi, _ = run.device_window
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = {
            "device_ops": devtrace.device_ops(run.kernels),
            "idle_gaps": devtrace.idle_gaps(run.merged, lo, hi, run.spans)}
    result["checks"] = checks
    print("set-up phases (s since start): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["phases"].items()), file=sys.stderr)
    from harness import readers
    lo, hi, steps = run.host_window
    print(f"host window {hi - lo:.1f} s: {len(steps)} decode steps, "
          f"{len(run.admissions_in(lo, hi))} admissions, decode step "
          f"{readers.decode_step_ms(run)} ms", file=sys.stderr)
    if args.trace:
        lo, hi, steps = run.device_window
        print(f"traced window {hi - lo:.1f} s: {len(steps)} decode steps",
              file=sys.stderr)
    print(f"reference check {out['reference_s']:.1f} s over "
          f"{out['requests_finished']} finished requests", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
