"""gpt-oss-20b [arXiv:2508.10925] — the paper's primary online workload.

MoE transformer: 24L d_model=2880 64H (GQA kv=8) d_ff=2880,
32 experts top-4, vocab ~201k (paper §V evaluates GPT-oss 20B heavily).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-oss-20b", family="moe",
    num_layers=24, d_model=2880, num_heads=64, num_kv_heads=8,
    d_ff=2880, vocab_size=201088, head_dim=64,
    num_experts=32, experts_per_token=4,
    sliding_window=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gptoss-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=64, vocab_size=256, num_experts=4,
    experts_per_token=2, sliding_window=16, head_dim=16)
