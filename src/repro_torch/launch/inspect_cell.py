"""Hillclimb helper: trace one (arch x shape) cell (optionally its
unrolled 1/2-unit variant) and print the cost summary and the largest
collectives, each with the model function that issued it.

The port of ``repro/launch/inspect_cell.py``, from the dry run's trace
(``launch/dryrun.py``); it sets nothing at import.

Usage:
  python -m repro_torch.launch.inspect_cell --arch llama3_8b \
      --shape decode_32k [--units 1] [--top 25] [--mesh pod1] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.dryrun import (_unrolled_cfg, analyze_compiled,
                                       compile_cell, production_cfg)
from repro_torch.roofline.hlo import traffic


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--units", type=int, default=0,
                    help="0 = the full model; N = N layer units")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    multi = args.mesh == "pod2"
    with mesh_lib.fake_world(512 if multi else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi,
                                             device_type=args.device)
        cell = steps_lib.get_cell(args.arch, args.shape)
        if args.units:
            cell = dataclasses.replace(cell, cfg=production_cfg(
                _unrolled_cfg(cell.cfg, args.units)))
        tr, tensors, _ = compile_cell(cell, mesh, device=args.device,
                                      origins=True)

    a = analyze_compiled(tr, tensors)
    print("cost:", {k: f"{v:.3e}" for k, v in a["cost"].items()})
    print("coll:", {k: f"{v:.3e}" for k, v in
                    a["collectives"]["by_op"].items()})
    print("mem:", {k: f"{v / 1e9:.2f}GB" for k, v in a["memory"].items()})

    rows = sorted(tr.collectives, key=lambda c: -c.result_bytes)
    print(f"\ntop {args.top} collectives by result bytes:")
    for c in rows[:args.top]:
        print(f"  {c.result_bytes / 1e9:8.3f}GB {c.op:18} "
              f"n={c.group_size:<4d} traffic "
              f"{traffic(c.op, c.result_bytes, c.group_size) / 1e9:8.3f}GB"
              f"  {c.origin}")


if __name__ == "__main__":
    main()
