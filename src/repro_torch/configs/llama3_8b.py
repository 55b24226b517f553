"""llama3-8b [Meta Llama 3] — the paper's dense LLM workload.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=0)
