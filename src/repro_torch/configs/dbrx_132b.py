"""dbrx-132b [hf:databricks/dbrx-base; unverified] — fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, 16 experts top-4.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_token=4, rope_theta=5e5,
)

SMOKE = dataclasses.replace(
    CONFIG, name="dbrx-smoke", num_layers=2, d_model=96, num_heads=6,
    num_kv_heads=2, d_ff=96, vocab_size=256, num_experts=4,
    experts_per_token=2, head_dim=0)
