"""gemma-2b [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    activation="geglu", tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=1, d_ff=128, vocab_size=256, head_dim=32)
