"""Checkpointing: atomic, async, restart-safe — the port of
``repro/checkpoint/manager.py``, in the reference's file format, so
that a checkpoint crosses between the two packages in both directions.

Layout:  <dir>/step_<N>/   arrays.npz  manifest.json
Writes go to ``step_<N>.tmp`` and are renamed only after fsync — a
half-written checkpoint can never be mistaken for a complete one.
``save_async`` copies the state to host memory before it returns and
writes it on a background thread; ``latest_step``/``restore`` implement
auto-resume.

Keys are the reference's: the ``"/"``-joined path of each leaf, a
NamedTuple field as ``.<name>`` (``opt/.mu/embed/tok``, ``opt/.step``),
a ``None`` leaf absent.  The port's per-layer lists (``layers``,
``encoder``) are stacked into the reference's leading layer axis on save
(``params/layers/attn/wq`` of shape (L, ...)) and split again on restore
into the template's structure, dtype and device.  bf16 has no numpy
dtype: it is stored as its uint16 bits with a ``dtypes`` tag in the
manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor copied to host memory."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as numpy; a bf16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def _flatten(tree: Any, prefix: str = ""
             ) -> Dict[str, Tuple[np.ndarray, str]]:
    """{reference key: (array, dtype name)}; a list's elements are
    stacked along a new leading axis under the list's own key."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, key(k)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_flatten(v, key(f".{name}")))
        return out
    if isinstance(tree, list):
        parts = [_flatten(v, prefix) for v in tree]
        return {k: (np.stack([p[k][0] for p in parts]), parts[0][k][1])
                for k in parts[0]}
    return {prefix: (_to_numpy(tree), _dtype_name(tree))}


def _from_numpy(arr: np.ndarray, dtype_name: str,
                like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype and device."""
    arr = np.asarray(arr, order="C")       # a 0-d array stays 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten(template: Any, arrays: Dict[str, np.ndarray],
               dtypes: Dict[str, str], prefix: str = "",
               index: Tuple[int, ...] = ()) -> Any:
    """``template``'s structure filled from ``arrays``; a list takes
    element i from index i of its stacked leaves."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, arrays, dtypes, key(k), index)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(v, arrays, dtypes, key(f".{name}"), index)
            for name, v in zip(template._fields, template)))
    if isinstance(template, list):
        return [_unflatten(v, arrays, dtypes, prefix, index + (i,))
                for i, v in enumerate(template)]
    arr = arrays[prefix][index] if index else arrays[prefix]
    return _from_numpy(arr, dtypes.get(prefix, arr.dtype.name), template)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: Any,
             extra: Optional[Dict] = None) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _flatten(state)
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
        dtypes = {k: d for k, (_, d) in flat.items()}
        manifest = {"step": step, "time": time.time(),
                    "dtypes": dtypes, "extra": extra or {}}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict] = None) -> None:
        # copy to host memory before returning (an in-place optimizer
        # step would otherwise change the tensors under the writer)
        host = _host(state)
        self.wait()

        def work():
            try:
                self.save(step, host, extra)
            except BaseException as e:       # surfaced by wait()
                self._errors.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._errors:
            raise self._errors.pop()

    # ------------------------------------------------------------------ #
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, ``template``'s structure filled from the checkpoint,
        each tensor of its template leaf's dtype and device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as raw:
            arrays = dict(raw)
        return step, _unflatten(template, arrays, manifest["dtypes"])

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
