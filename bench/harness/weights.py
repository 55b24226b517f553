"""Weights drawn from the seed on the device, and the program's view of them.

The benchmark owns the weights: one ``torch.Generator`` on the device,
seeded with the run's seed, draws every leaf of every layer in one call per
kind, in the type the configuration serves in.  The reference reads these
tensors; the program gets views of the same tensors in its parameter
layout (``port_params``), and nothing it derives from them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float, str]]:
    """(name, shape, std, dtype) of each stacked leaf.  Weights are normal
    with std 1/sqrt(fan_in) (0.02 for the embeddings); norm scales are
    1 + N(0, 0.1^2), so that a norm that drops its scale shows."""
    L, d, V = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    H, Hkv, D, f = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"], \
        cfg["d_ff"]
    dt = cfg["dtype"]
    out = [("tok", (V, d), 0.02, dt), ("unembed", (d, V), 0.02, dt),
           ("final_norm", (d,), 0.1, dt), ("ln1", (L, d), 0.1, dt),
           ("ln2", (L, d), 0.1, dt),
           ("wq", (L, d, H, D), 1 / math.sqrt(d), dt),
           ("wk", (L, d, Hkv, D), 1 / math.sqrt(d), dt),
           ("wv", (L, d, Hkv, D), 1 / math.sqrt(d), dt),
           ("wo", (L, H, D, d), 1 / math.sqrt(H * D), dt)]
    if cfg["family"] == "moe":
        E = cfg["num_experts"]
        out += [("router", (L, d, E), 1 / math.sqrt(d), "float32"),
                ("w_gate", (L, E, d, f), 1 / math.sqrt(d), dt),
                ("w_up", (L, E, d, f), 1 / math.sqrt(d), dt),
                ("w_down", (L, E, f, d), 1 / math.sqrt(f), dt)]
    elif cfg["family"] == "dense":
        out += [("w_gate", (L, d, f), 1 / math.sqrt(d), dt),
                ("w_up", (L, d, f), 1 / math.sqrt(d), dt),
                ("w_down", (L, f, d), 1 / math.sqrt(f), dt)]
    else:
        raise ValueError(f"no weight layout for family {cfg['family']!r}")
    return out


NORMS = ("final_norm", "ln1", "ln2")


def make(cfg: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every leaf, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    w = {}
    for name, shape, std, dt in layout(cfg):
        t = torch.randn(shape, generator=g, device=device,
                        dtype=getattr(torch, dt)).mul_(std)
        w[name] = t.add_(1.0) if name in NORMS else t
    return w


def port_params(w: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, Any]:
    """The program's parameter tree (``repro_torch.models.model``'s
    layout: per-layer dicts) over views of ``w``."""
    ffn = "moe" if cfg["family"] == "moe" else "mlp"
    keys = ("router", "w_gate", "w_up", "w_down") if ffn == "moe" \
        else ("w_gate", "w_up", "w_down")
    layers = []
    for i in range(cfg["num_layers"]):
        layers.append({
            "ln1": {"scale": w["ln1"][i]},
            "attn": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
            "ln2": {"scale": w["ln2"][i]},
            ffn: {k: w[k][i] for k in keys}})
    return {"embed": {"tok": w["tok"], "unembed": w["unembed"]},
            "final_norm": {"scale": w["final_norm"]},
            "layers": layers}
