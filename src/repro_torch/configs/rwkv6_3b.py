"""rwkv6-3b (Finch) [arXiv:2404.05892; hf] — attention-free, data-
dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=8960, vocab_size=65536, rwkv_head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, name="rwkv6-smoke", num_layers=2, d_model=64, num_heads=0,
    num_kv_heads=0, d_ff=128, vocab_size=256, rwkv_head_dim=16)
