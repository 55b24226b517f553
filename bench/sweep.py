"""The rate sweep of an open-loop cell, on the card.

    python3 bench/sweep.py --workload granite-8b.chat --rates 2 3 4 5 \
        --seconds 30 --seed 5

One run of the cell at each rate (the cell's ``rate_per_s`` replaced).
A rate is sustained when no backlog grows over the window: the requests
due but not admitted at the close are no more than at the opening (or 2),
and the requests admitted in the window keep up with those due in it.
Prints one JSON line per rate; the cell's rate is then 0.8 x the highest
rate sustained, written into ``bench/cells/<cell>.json``.
"""
from __future__ import annotations

import time

import argparse
import json
import sys

from run import ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from harness import readers, serve

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for rate in args.rates:
        out = serve.run(ROOT, args.workload, args.seed, args.seconds, False,
                        dev, time.perf_counter(),
                        cell_override={"rate_per_s": rate})
        run = out["run"]
        due = sum(run.in_window(t) for t in run.due.values())
        admitted = sum(len(a.slots) for a in run.admissions_in(run.open_, run.close))
        bl = out["backlog"]
        row = {"workload": args.workload, "rate": rate,
               "due": due, "admitted": admitted,
               "backlog_open": bl["open"], "backlog_close": bl["close"],
               "ttft_p90_s": readers.ttft_p90(run),
               "tpot_p90_s": readers.tpot_p90(run),
               "decode_step_ms": readers.decode_step_ms(run),
               "sustained": bl["close"] <= max(2, bl["open"])
               and admitted >= 0.95 * due,
               "correct": all(c["value"] <= c["limit"] for k, c in
                              out["checks"].items() if k != "compared_tokens")}
        print(json.dumps(row), flush=True)
        del out, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
