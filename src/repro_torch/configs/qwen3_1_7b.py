"""qwen3-1.7b [hf:Qwen/Qwen3; hf] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16)
