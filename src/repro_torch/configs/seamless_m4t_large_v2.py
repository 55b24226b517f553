"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec backbone.

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.  The audio/vision
modality frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings for the encoder.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
    head_dim=0)
