#!/usr/bin/env python3
"""K1 and K2 (the flash-attention kernels of the PyTorch port) built from
another checkout's sources beside this checkout's, on one CUDA card.

  python3 benchmarks/attention_ab_torch.py --other DIR

DIR is another checkout of the repo (say the parent commit, unpacked with
``git archive``); its ``src/repro_torch/kernels/flash_attention`` is
loaded as a module of its own, builds into its own ``_build/`` and keeps
its own wrappers.  Without a softcap, at the shapes of ``chip_smoke.py``
phase 2 (bf16, B 4: K1 at lengths 512 of 1024 slots; K2 causal at 4 x
512 (gpt-oss-20b's window 4096 at D 64), at one chunk (Sq 128 at
q_offset 384 over 512) and not causal at 1024 x 1024) for the heads of
llama3-8b (D 128), gpt-oss-20b (D 64), zamba2-7b (D 112) and gemma-2b
(D 256), it
  * compares the machine code of each kernel that both builds have
    (``cuobjdump -sass``, addresses and encodings left out; this
    checkout's no-softcap instantiation, ``Lb0E``, where it has one);
  * times each row with CUDA events (``chip_smoke.time_ms``) in the
    order other, this, this, other, so a drift of the card shows;
  * checks that the two builds' outputs are bitwise equal.
The last line is the card's name and power limit from nvidia-smi.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import re
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402

KERNELS = ("decode_mma_kernel", "decode_fma_kernel", "prefill_wgmma_kernel",
           "prefill_fma_kernel")


def load_other(root: Path):
    """The other checkout's ``flash_attention/kernel.py`` as a module of
    its own (its sources, its build directory, its wrappers)."""
    path = root / "src/repro_torch/kernels/flash_attention/kernel.py"
    spec = importlib.util.spec_from_file_location("fa_kernel_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def instructions(text: str):
    """Each kernel's SASS as its instructions alone, keyed by (kernel,
    head_dim, softcap flag or None)."""
    from repro_torch.kernels import nvcc
    out = {}
    for fn, body in nvcc.split_functions(text, "Function :").items():
        m = re.search(rf"({'|'.join(KERNELS)})ILi(\d+)E(?:Lb([01])E)?", fn)
        if m:
            lines = [re.sub(r"/\*[^*]*\*/", "", ln).strip()
                     for ln in body.splitlines()]
            out[m.group(1), int(m.group(2)), m.group(3)] = \
                [ln for ln in lines if ln]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import kernel as this
    other = load_other(args.other)
    nvcc.compile_all({**{"this " + n: j for n, j in this.build_jobs().items()},
                      **{"other " + n: j
                         for n, j in other.build_jobs().items()}})
    libs = {"this": this.build(), "other": other.build()}
    for name in this.SOURCES:
        a = instructions(nvcc._sass(libs["other"][name]))
        b = instructions(nvcc._sass(libs["this"][name]))
        for (kern, D, flag), ins in sorted(a.items()):
            mine = b.get((kern, D, "0" if flag is None else flag))
            same = mine == ins
            print(f"[sass] {kern}<{D}>: other {len(ins)} instructions, this "
                  f"{len(mine) if mine else 'none'}; "
                  + ("identical" if same else "DIFFERENT"), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    dt = torch.bfloat16
    rows = []
    for tag, attn, win in (("d128", CS.LLAMA_ATTN, None),
                           ("d64", CS.GPTOSS_ATTN, CS.GPTOSS_WINDOW),
                           ("d112", CS.ZAMBA_ATTN, None),
                           ("d256", CS.GEMMA_ATTN, None)):
        rows += [
            (f"K1 {tag} lengths 512", "flash_decode", {},
             [CS.decode_inputs(g, dt, [CS.PROMPT] * CS.B, attn)
              for _ in range(6)]),
            (f"K2 {tag} causal 512", "flash_prefill", {"window": win},
             [CS.prefill_inputs(g, dt, CS.PROMPT, attn) for _ in range(3)]),
            (f"K2 {tag} chunk 128 at 384", "flash_prefill",
             {"q_offset": CS.CHUNK_OFFSET},
             [CS.prefill_inputs(g, dt, CS.CHUNK_SQ, attn,
                                CS.CHUNK_OFFSET + CS.CHUNK_SQ)
              for _ in range(3)]),
            (f"K2 {tag} not causal 1024", "flash_prefill", {"causal": False},
             [CS.prefill_inputs(g, dt, 1024, attn) for _ in range(2)])]
    mods = {"this": this, "other": other}
    times = {r[0]: [] for r in rows}
    for side in ("other", "this", "this", "other"):
        for name, kname, kw, sets in rows:
            fn = getattr(mods[side], kname)
            times[name].append(CS.time_ms(lambda *a: fn(*a, **kw), sets))
    for name, kname, kw, sets in rows:
        equal = torch.equal(getattr(other, kname)(*sets[0], **kw),
                            getattr(this, kname)(*sets[0], **kw))
        t = times[name]
        print(f"[time] {name}: other {t[0]:.4f} / {t[3]:.4f} ms, this "
              f"{t[1]:.4f} / {t[2]:.4f} ms; outputs bitwise equal {equal}",
              flush=True)
    print(CS.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
