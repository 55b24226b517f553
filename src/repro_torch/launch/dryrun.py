"""Multi-pod dry run: trace every (arch x shape x mesh) cell.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell on 256 or 512 placeholder TPU devices; here each
cell's step is traced, in one process, on DTensors over a fake process
group of 256 or 512 ranks (``launch.mesh.fake_world``) under
``FakeTensorMode``: every tensor has its shape, dtype and device and
none has memory.  Importing this module sets nothing: the caller (or
``run_cell``) owns the process group, as the reference's caller owns
its device count.

Per cell this script:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod),
  2. places every input of ``steps.input_specs`` as a DTensor by the
     cell's rule table (``build_shardings``): each rank's local shard,
  3. runs the step under a dispatch mode that sees every op DTensor runs
     on the local shards, as the one rank of the trace (rank 0),
  4. records per chip: the FLOPs (the formulas of ``FlopCounterMode``,
     K1-K5's included), the bytes (input plus output bytes of every op,
     views moving nothing: the eager step's own traffic, with no fusion
     to discount), the collective traffic (``roofline.hlo``), and the
     memory: the arguments' local bytes, the outputs', those written in
     place (the cache; the parameters and the AdamW state), and the
     peak of the bytes the step allocates,
  5. (single-pod only) traces 1-unit and 2-unit variants and
     extrapolates c1 + (L-1)(c2-c1), the reference's record.  The port
     has no scan, so the full-depth trace is already exact and equals
     the extrapolation; ``report.analyze_record`` reads it.

``--device`` defaults to ``cuda`` (fake CUDA tensors, a mesh of CUDA
devices); a CPU-only torch cannot build a CUDA mesh, so CPU callers
pass ``--device cpu``.

Usage:
  python -m repro_torch.launch.dryrun --arch granite_8b --shape train_4k \
      --mesh pod1 --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all   # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as configs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import SHAPES
from repro_torch.roofline import hlo
from repro_torch.train import optim

REPO = Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO / "experiments" / "dryrun_torch"


# --------------------------------------------------------------------- #
def _named(mesh, spec: SH.PartitionSpec) -> SH.NamedSharding:
    return SH.NamedSharding(mesh, spec, SH.placements_for(spec, mesh))


def build_shardings(cell, specs, mesh):
    """(in_shardings, out_shardings) trees for the cell's step, leaves
    ``NamedSharding`` (mesh, spec, DTensor placements)."""
    rules = SH.TRAIN_RULES if cell.step_kind == "train" else SH.SERVE_RULES
    rep = _named(mesh, SH.P())

    def batch_shardings(bspecs):
        out = {}
        for k, v in bspecs.items():
            if k == "positions3":               # (3, B, S)
                logical = (None, "batch", None)
            elif v.ndim == 1:
                logical = ("batch",)
            elif k in ("tokens", "targets"):
                logical = ("batch", "seq" if cell.step_kind == "train"
                           else None)
            else:                                # (B, S|P, d)
                logical = ("batch",) + (None,) * (v.ndim - 1)
            out[k] = _named(mesh, SH.spec_for(v.shape, logical, mesh, rules))
        return out

    p_sh = SH.param_shardings(specs[0], mesh, rules)
    if cell.step_kind == "train":
        o_sh = optim.AdamWState(step=rep, mu=p_sh, nu=p_sh, master=p_sh)
        b_sh = batch_shardings(specs[2])
        in_sh = (p_sh, o_sh, b_sh)
        out_sh = (p_sh, o_sh, rep)
    else:
        c_sh = SH.tree_shardings(specs[1], SH.cache_logical_axes(specs[1]),
                                 mesh, rules)
        b_sh = batch_shardings(specs[2])
        in_sh = (p_sh, c_sh, b_sh)
        B = specs[2]["tokens"].shape[0]
        V = cell.cfg.vocab_size
        logits_sh = _named(mesh, SH.spec_for((B, V), ("batch", "vocab"),
                                             mesh, rules))
        out_sh = (logits_sh, c_sh)
    return in_sh, out_sh


def production_cfg(cfg):
    """Per-mesh model-impl switches: MoE uses the expert-local
    ``local_map`` path on production meshes — the sort-based ragged path
    would gather every token."""
    if cfg.family == "moe":
        return dataclasses.replace(cfg, moe_impl="ep")
    return cfg


# --------------------------------------------------------------------- #
# The trace
# --------------------------------------------------------------------- #
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::new_empty",
               "aten::new_empty_strided", "aten::empty_like",
               "aten::detach", "aten::alias", "aten::lift_fresh",
               "prim::device", "_c10d_functional::wait_tensor"}


# ops whose first argument is only written
_OVERWRITES = {"aten::copy_", "aten::fill_", "aten::zero_"}
# ops that write a part of their first argument, in place
_PART_WRITES = {"aten::index_put_", "aten::_index_put_impl_",
                "aten::index_copy_", "aten::scatter_", "aten::scatter_add_",
                "aten::masked_scatter_"}


# ops that read the rows of their first argument that their indices name
_GATHERS = {"aten::index", "aten::index_select", "aten::gather",
            "aten::embedding"}


def _traffic(name: str, args, ins, outs) -> float:
    """Input plus output bytes of one op.  An op writing its first
    argument in place moves it once (a copy's destination: written) or
    not at all (a partial write: the other inputs are read, and as many
    bytes written); a gather reads of its first argument only what it
    writes."""
    if name in _OVERWRITES:
        return float(sum(_nbytes(t) for t in ins))
    if name in _PART_WRITES:
        return 2.0 * sum(_nbytes(t) for t in ins if t is not args[0])
    if name in _GATHERS:
        return float(sum(_nbytes(t) for t in ins if t is not args[0])
                     + 2 * sum(_nbytes(t) for t in outs))
    return float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                   for t in outs))


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage()).cdata


def _origin() -> str:
    """The innermost model function on the stack, as file:line function."""
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch/models/" in fr.filename:
            return (f"{Path(fr.filename).name}:{fr.lineno} {fr.name}")
    return ""


class Trace(TorchDispatchMode):
    """Counts what one rank does: every op on local tensors (a DTensor op
    is handed back to DTensor, whose local ops come back here; the
    fake-tensor runs DTensor makes to propagate shapes are not counted).

    flops: ``torch.utils.flop_counter``'s formulas, K1-K5's included;
    bytes: input plus output bytes of each op (views, allocations and
    collectives move none); collectives: ``roofline.hlo.Collective``s;
    peak: the most bytes alive at once of the storages the step made."""

    def __init__(self, origins: bool = False) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[hlo.Collective] = []
        self.origins = origins
        self.args: set = set()
        self.read: set = set()
        self.live: Dict[int, Any] = {}
        self.live_bytes = 0
        self.peak = 0
        self._paused = 0

    @contextlib.contextmanager
    def active(self, args: Any):
        """Count inside; ``args`` are the step's inputs (their storages
        are not the step's allocations)."""
        from torch.distributed.tensor import DTensor
        self.args = {_key(t.to_local() if isinstance(t, DTensor) else t)
                     for t in _tensors(args)}
        prop = DTensor._op_dispatcher.sharding_propagator
        inner = prop._propagate_tensor_meta_non_cached

        def paused(*a, **kw):
            self._paused += 1
            try:
                return inner(*a, **kw)
            finally:
                self._paused -= 1
        prop._propagate_tensor_meta_non_cached = paused
        try:
            with self:
                yield self
        finally:
            del prop._propagate_tensor_meta_non_cached

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor)
               for t in pytree.tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        from torch.utils.flop_counter import flop_registry
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            try:
                n = f(*args, **kwargs, out_val=out)
            except TypeError:
                # an overload with a non-tensor positional argument
                # (bmm's out_dtype): the formula takes the tensors
                n = f(*(a for a in args if isinstance(a, torch.Tensor)),
                      out_val=out)
            self.flops += float(n)
        c = hlo.record(func, args, kwargs, out,
                       _origin() if self.origins else "")
        if c is not None:
            self.collectives.append(c)
        name = func.name().split(".")[0]
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if not func.is_view and name not in _NO_TRAFFIC:
            # an input read (a copy's destination is only written)
            dst = args[0] if name in _OVERWRITES else None
            self.read.update(k for k in map(_key, (t for t in ins
                                                   if t is not dst))
                             if k in self.args)
            if c is None and outs:
                self.bytes += _traffic(name, args, ins, outs)
        self._alloc(outs)
        return out

    def _alloc(self, outs: List[torch.Tensor]) -> None:
        """Each output holds its storage alive until its tensor dies (a
        finalizer on the tensor: a fake tensor's Python object lives as
        long as autograd keeps it): a storage is live while any tensor
        on it is."""
        for t in outs:
            st = t.untyped_storage()
            k = _key(t)
            if k in self.args:
                continue
            if k not in self.live:
                self.live[k] = [st.nbytes(), 0]
                self.live_bytes += st.nbytes()
                self.peak = max(self.peak, self.live_bytes)
            self.live[k][1] += 1
            weakref.finalize(t, self._release, k)

    def _release(self, k: int) -> None:
        entry = self.live[k]
        entry[1] -= 1
        if not entry[1]:
            self.live_bytes -= entry[0]
            del self.live[k]


def place_fake(specs: Any, shardings: Any, device: str) -> Any:
    """Each leaf of ``specs`` (``meta`` tensors) as a DTensor of this
    rank's local shard, made under the active ``FakeTensorMode``."""
    from repro_torch.distributed.local import local_box, wrap
    flat, spec = pytree.tree_flatten(specs)
    shs = pytree.tree_leaves(shardings,
                             is_leaf=lambda x: isinstance(x, SH.NamedSharding))
    out = []
    for t, s in zip(flat, shs):
        shape = local_box(t.shape, s.mesh, s.placements)[0]
        local = torch.zeros(shape, dtype=t.dtype, device=device)
        out.append(wrap(local, s.mesh, s.placements, t.shape))
    return pytree.tree_unflatten(out, spec)


def _settle(outs: Any, shardings: Any) -> Any:
    """Each output DTensor moved to its out-sharding (the reference's
    ``out_shardings``); in-place outputs already are."""
    from torch.distributed.tensor import DTensor
    flat, spec = pytree.tree_flatten(outs)
    shs = pytree.tree_leaves(shardings,
                             is_leaf=lambda x: isinstance(x, SH.NamedSharding))
    res = []
    for t, s in zip(flat, shs):
        if isinstance(t, DTensor) and tuple(t.placements) != s.placements:
            t = t.redistribute(s.mesh, s.placements)
        res.append(t)
    return pytree.tree_unflatten(res, spec)


def compile_cell(cell, mesh, remat: bool = True, device: str = "cuda",
                 batch: Optional[int] = None, seq: Optional[int] = None,
                 origins: bool = False):
    """Trace the cell's step on DTensors over ``mesh``.  Returns (the
    trace, the placed inputs' and outputs' local tensors, stats)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    cell = dataclasses.replace(cell, cfg=production_cfg(cell.cfg))
    step = steps_lib.make_step(cell, remat=remat)
    specs = steps_lib.input_specs(cell, batch=batch, seq=seq)
    in_sh, out_sh = build_shardings(cell, specs, mesh)
    t0 = time.perf_counter()
    tr = Trace(origins=origins)
    with FakeTensorMode(allow_non_fake_inputs=False), mesh_context(mesh):
        args = place_fake(specs, in_sh, device)
        with tr.active(args):
            outs = _settle(step(*args), out_sh)
        local = [t.to_local() if isinstance(t, DTensor) else t
                 for t in _tensors(args)]
        outs_local = [t.to_local() if isinstance(t, DTensor) else t
                      for t in _tensors(outs)]
    stats = {"compile_s": round(time.perf_counter() - t0, 2)}
    return tr, (local, outs_local), stats


def _unique_bytes(ts: List[torch.Tensor], keep=lambda k: True) -> int:
    seen: Dict[int, int] = {}
    for t in ts:
        k = _key(t)
        if keep(k):
            seen[k] = t.untyped_storage().nbytes()
    return sum(seen.values())


def analyze_compiled(tr: Trace, tensors) -> dict:
    """The record: ``argument_bytes`` counts the inputs the step reads
    (one it only overwrites, as a prefill does the whole cache, is an
    output alone: the reference's ``jit`` drops such an argument);
    ``input_bytes``, the port's own key, every input, read or not."""
    args, outs = tensors
    arg_keys = {_key(t) for t in args}
    total, by_op, counts = hlo.collective_bytes(tr.collectives)
    return {
        "memory": {
            "argument_bytes": _unique_bytes(args, lambda k: k in tr.read),
            "output_bytes": _unique_bytes(outs),
            "temp_bytes": tr.peak,
            "alias_bytes": _unique_bytes(outs, lambda k: k in arg_keys),
            "input_bytes": _unique_bytes(args),
        },
        "cost": {"flops": tr.flops, "bytes": tr.bytes},
        "collectives": {"per_chip_bytes": total, "by_op": by_op,
                        "counts": counts},
    }


def _unrolled_cfg(cfg, units: int):
    """Config with ``units`` structural layer units."""
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=units * cfg.hybrid_attn_every)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=units,
                                   encoder_layers=units)
    return dataclasses.replace(cfg, num_layers=units)


def _layer_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def extrapolate_roofline(cell, mesh, remat: bool = True,
                         device: str = "cuda") -> dict:
    """Trace 1-unit and 2-unit variants; extrapolate."""
    def one(units):
        cell_u = dataclasses.replace(
            cell, cfg=production_cfg(_unrolled_cfg(cell.cfg, units)))
        tr, tensors, _ = compile_cell(cell_u, mesh, remat=remat,
                                      device=device)
        a = analyze_compiled(tr, tensors)
        return (a["cost"]["flops"], a["cost"]["bytes"],
                a["collectives"]["per_chip_bytes"],
                a["collectives"]["by_op"])

    f1, b1, c1, ops1 = one(1)
    f2, b2, c2, ops2 = one(2)
    L = _layer_units(cell.cfg)
    ops = {k: ops1.get(k, 0.0) + (L - 1) * (ops2.get(k, 0.0) -
                                            ops1.get(k, 0.0))
           for k in set(ops1) | set(ops2)}
    return {
        "flops": f1 + (L - 1) * (f2 - f1),
        "bytes": b1 + (L - 1) * (b2 - b1),
        "collective_per_chip_bytes": c1 + (L - 1) * (c2 - c1),
        "collective_by_op": ops,
        "layer_units": L,
        "unit1": {"flops": f1, "bytes": b1, "coll": c1},
        "unit2": {"flops": f2, "bytes": b2, "coll": c2},
    }


# --------------------------------------------------------------------- #
def run_cell(arch: str, shape: str, mesh_name: str,
             with_extrapolation: bool = True, remat: bool = True,
             device: str = "cuda") -> dict:
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    defined, reason = steps_lib.cell_is_defined(arch, shape)
    if not defined:
        rec.update(skipped=True, skip_reason=reason)
        return rec
    multi = mesh_name == "pod2"
    with mesh_lib.fake_world(512 if multi else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi,
                                             device_type=device)
        cell = steps_lib.get_cell(arch, shape)
        tr, tensors, stats = compile_cell(cell, mesh, remat=remat,
                                          device=device)
        rec.update(stats)
        rec.update(analyze_compiled(tr, tensors))
        rec["devices"] = int(math.prod(mesh.shape))
        rec["ok"] = True
        if with_extrapolation and not multi:
            rec["extrapolated"] = extrapolate_roofline(
                cell, mesh, remat=remat, device=device)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod1", "pod2"], default="pod1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default=",".join(configs.ASSIGNED),
                    help="comma list for --all")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the traced tensors' device (cpu where torch "
                         "has no CUDA)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds a cell of --all may take (default: no "
                         "limit)")
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        # one subprocess per cell: isolates process groups and failures
        cells = [(a, s, m)
                 for a in args.archs.split(",")
                 for s in SHAPES
                 for m in ("pod1", "pod2")]
        failures = 0
        for a, s, m in cells:
            outfile = out_dir / f"{a}.{s}.{m}.json"
            if outfile.exists():
                print(f"[skip existing] {outfile.name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m,
                   "--out", str(out_dir), "--device", args.device]
            if args.no_extrapolate:
                cmd.append("--no-extrapolate")
            if args.no_remat:
                cmd.append("--no-remat")
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
            except subprocess.TimeoutExpired:
                r = subprocess.CompletedProcess(
                    cmd, 1, "", f"timed out after {args.timeout:g} s")
            dt = time.time() - t0
            ok = r.returncode == 0
            failures += 0 if ok else 1
            print(f"[{'ok' if ok else 'FAIL'}] {a} {s} {m} ({dt:.0f}s)",
                  flush=True)
            if not ok:
                (out_dir / f"{a}.{s}.{m}.err").write_text(
                    r.stdout + "\n" + r.stderr)
        return 1 if failures else 0

    assert args.arch and args.shape
    rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh}
    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       with_extrapolation=not args.no_extrapolate,
                       remat=not args.no_remat, device=args.device)
    except Exception:
        rec["ok"] = False
        rec["error"] = traceback.format_exc()
    outfile = Path(args.out) / \
        f"{args.arch}.{args.shape}.{args.mesh}.json"
    outfile.write_text(json.dumps(rec, indent=1))
    if rec.get("ok") or rec.get("skipped"):
        status = "SKIP" if rec.get("skipped") else "OK"
        print(f"[{status}] {args.arch} {args.shape} {args.mesh} "
              f"compile={rec.get('compile_s')}s "
              f"coll={rec.get('collectives', {}).get('per_chip_bytes', 0) / 1e6:.1f}MB")
        return 0
    print(rec.get("error", "unknown failure"))
    return 1


if __name__ == "__main__":
    sys.exit(main())
