"""The correctness check's two readings for one cell, on the card.

    python3 bench/control.py --workload granite-8b.chat \
        --seeds 11 12 13 --seconds 20 [--control-seeds 11 12 13]

For each seed, one run of the cell (a short window at the cell's own
load), then the check's numbers: the program's widest logit gap (the
lower reading is the largest over a dozen seeds or more) and, on the
``--control-seeds``, the control's: the plain reference in fp8 put in the
program's place, the gap of the token it puts first at each compared
position (the upper reading is the smallest).  Prints one JSON line per
seed.  Every seed runs in this one process, so set-up is paid per seed
only for the weights and the warm admission.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT  # noqa: E402,F401  (puts src/ and bench/ on the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch
    from harness import serve

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = serve.run(ROOT, args.workload, seed, args.seconds, False, dev,
                        time.perf_counter(),
                        control=seed in args.control_seeds)
        row = {"workload": args.workload, "seed": seed,
               "finished": out["requests_finished"],
               "reference_s": out["reference_s"],
               "peak": out["peak"],
               **{k: v["value"] for k, v in out["checks"].items()}}
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
