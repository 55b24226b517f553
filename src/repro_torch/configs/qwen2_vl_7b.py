"""qwen2-vl-7b [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution VLM.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Vision
frontend is a STUB: input_specs() provides precomputed patch embeddings
and 3D (t,h,w) M-RoPE position ids.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    mrope=True, mrope_sections=(16, 24, 24), qkv_bias=True,
    num_patches=256, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2vl-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, num_patches=8,
    mrope_sections=(4, 2, 2), head_dim=0)
