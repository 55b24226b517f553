"""Architecture registry: ``get(name)`` -> full config,
``get_smoke(name)`` -> reduced same-family config for CPU smoke tests."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "mixtral_8x7b", "dbrx_132b", "granite_8b", "qwen2_5_14b",
    "gemma_2b", "qwen3_1_7b", "zamba2_7b", "seamless_m4t_large_v2",
    "qwen2_vl_7b", "rwkv6_3b",
    # paper workloads
    "gpt_oss_20b", "llama3_8b",
]

ASSIGNED: List[str] = ARCHS[:10]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
