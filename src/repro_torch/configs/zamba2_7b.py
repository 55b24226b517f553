"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 + shared attention.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
One shared-weight attention+MLP block applied every 3 mamba layers
(approximation of the published interleaving; see DESIGN.md).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=3,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", num_layers=4, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
    ssm_head_dim=16, hybrid_attn_every=2, head_dim=0)
