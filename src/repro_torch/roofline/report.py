"""Roofline report: three terms per (arch x shape) from dry-run records.

The port of ``repro/roofline/report.py``, with the device's terms as
arguments.  They default to the H100 (``core.costmodel.GPU_H100``):

  compute    = FLOPs per chip / 989 TFLOP/s (bf16 tensor cores)
  memory     = bytes per chip / 3.35 TB/s (HBM3)
  collective = per-chip collective traffic / 50 GB/s (one 400 Gb/s
               NIC per GPU: a 16-wide mesh axis leaves the 8-GPU node)

FLOPs and bytes are the dry run's per-chip counts (``launch/dryrun.py``:
the FLOPs of ``FlopCounterMode``'s formulas, K1-K5's included, and the
input plus output bytes of every op the eager step dispatches, with no
fusion to discount), from its 1-/2-unit extrapolation where the record
has one.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N_active for MoE —
the ratio MODEL_FLOPS / traced FLOPs measures how much of the traced
compute is "useful" (catching remat/dispatch/redundancy waste).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import repro_torch.configs as configs
from repro_torch.core.costmodel import GPU_H100
from repro_torch.models.config import SHAPES

CHIPS = 256
PEAK_FLOPS = GPU_H100.peak_flops
HBM_BW = GPU_H100.hbm_bw
LINK_BW = GPU_H100.link_bw

REPO = Path(__file__).resolve().parents[3]
DEFAULT_DIR = REPO / "experiments" / "dryrun_torch"

# what to try once a term dominates, for the H100
NOTES = {
    "collective": ("reshard/collective-bound: cut all-gather volume "
                   "(better weight layout, overlap, or compression)"),
    "memory_decode": ("HBM-bound (weight+KV streaming): quantize KV/"
                      "weights or raise batch to amortize reads"),
    "memory": "HBM-bound: improve fusion / remat policy to cut traffic",
    "compute": ("compute-bound: good — push tensor-core utilization "
                "(wgmma tiles in the hand-written kernels) and reduce "
                "non-GEMM flops"),
}


def terms_line(peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
               link_bw: float = LINK_BW) -> str:
    """The report's header: the terms its times are taken against."""
    return (f"terms: {peak_flops / 1e12:g} TFLOP/s, {hbm_bw / 1e9:g} GB/s "
            f"HBM, {link_bw / 1e9:g} GB/s link per chip")


def model_flops(arch: str, shape_name: str) -> float:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch            # one new token per request
    return 2.0 * n * tokens


def analyze_record(rec: dict, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Optional[dict]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    ext = rec.get("extrapolated")
    if ext:
        flops_pc = ext["flops"]
        bytes_pc = ext["bytes"]
        coll_pc = ext["collective_per_chip_bytes"]
    else:
        flops_pc = rec["cost"]["flops"]
        bytes_pc = rec["cost"]["bytes"]
        coll_pc = rec["collectives"]["per_chip_bytes"]
    chips = rec.get("devices", CHIPS)
    t_comp = flops_pc / peak_flops          # per-chip seconds
    t_mem = bytes_pc / hbm_bw
    t_coll = coll_pc / link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = flops_pc * chips
    ratio = mf / hlo_global if hlo_global else 0.0
    bound = max(terms.values())
    frac = (mf / chips / peak_flops) / bound if bound > 0 else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
        "dominant": dom, "model_flops": mf,
        "useful_ratio": ratio,
        "roofline_fraction": frac,        # useful-compute / bound time
        "hbm_per_chip": rec["memory"]["argument_bytes"] +
        rec["memory"]["temp_bytes"],
        "compile_s": rec.get("compile_s", 0.0),
    }


def fix_note(row: dict, notes: Optional[dict] = None) -> str:
    notes = NOTES if notes is None else notes
    d = row["dominant"]
    if d == "collective":
        return notes["collective"]
    if d == "memory":
        if row["shape"].startswith("decode") or \
                row["shape"].startswith("long"):
            return notes["memory_decode"]
        return notes["memory"]
    return notes["compute"]


def load_rows(d: Path, mesh: str = "pod1", **terms) -> List[dict]:
    rows = []
    for f in sorted(d.glob(f"*.{mesh}.json")):
        rec = json.loads(f.read_text())
        row = analyze_record(rec, **terms)
        if row:
            rows.append(row)
    return rows


def fmt_table(rows: List[dict], notes: Optional[dict] = None) -> str:
    hdr = ("| arch | shape | compute(ms) | memory(ms) | coll(ms) | "
           "dominant | MODEL/HLO | roofline frac | note |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['t_compute'] * 1e3:9.2f} | {r['t_memory'] * 1e3:9.2f} "
            f"| {r['t_collective'] * 1e3:9.2f} | {r['dominant']:10} "
            f"| {r['useful_ratio']:9.3f} | {r['roofline_fraction']:8.3f} "
            f"| {fix_note(r, notes)} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--csv", default=str(REPO / "experiments" /
                                         "roofline_torch.csv"))
    args = ap.parse_args()
    rows = load_rows(Path(args.dir), args.mesh)
    print(terms_line())
    print(fmt_table(rows))
    if not rows:
        return
    import csv
    Path(args.csv).parent.mkdir(parents=True, exist_ok=True)
    with open(args.csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"\nwrote {args.csv} ({len(rows)} cells)")


if __name__ == "__main__":
    main()
