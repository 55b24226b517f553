"""Unified model configuration covering all assigned architectures.

One dataclass describes dense / MoE / SSM / RWKV / hybrid / enc-dec / VLM
families; ``src/repro_torch/configs/<id>.py`` instantiates the exact published
configurations and reduced smoke variants.

PyTorch counterpart of ``repro.models.config``: the fields are the
same, and ``torch_dtype`` takes the place of ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # attention options
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None    # SWA (mixtral)
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2.x
    mrope: bool = False                     # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    attn_logit_softcap: float = 0.0

    # mlp
    activation: str = "swiglu"              # swiglu | geglu
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "ragged"                # ragged | dense_einsum | ep
    moe_capacity_factor: float = 1.25       # ep dispatch capacity

    # ssm (mamba2) / rwkv6
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # hybrid (zamba2): one shared attention block applied every
    # ``hybrid_attn_every`` ssm layers (shared weights, paper's zamba2).
    hybrid_attn_every: int = 0

    # encoder-decoder (seamless)
    encoder_layers: int = 0

    # vlm: stubbed modality frontend; patch embeddings arrive precomputed
    num_patches: int = 0

    # numerics / embedding
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # -------------------------------------------------------------- #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_heads(self) -> int:
        """Query heads padded to a 16 multiple (the production mesh's
        model-axis size) so attention shards instead of replicating —
        without this, qwen2.5's 40 heads replicate 16-way (16x compute
        and activation memory).  Extra heads are zero-initialized
        (Megatron-style head padding); the forward output is EXACT
        because the padded wo rows are zero."""
        H = self.num_heads
        if H == 0 or H % 16 == 0:
            return H
        return H + (-H % 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so the unembedding shards over
        the model axis (Megatron-style).  Padded logit columns are masked
        to -inf in ``layers.unembed`` — loss and argmax are EXACT.
        Unpadded vocabs (all multiples of 256) are unchanged."""
        return self.vocab_size + (-self.vocab_size % 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.num_heads == 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    # -------------------------------------------------------------- #
    def param_count(self) -> float:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0.0
        if self.family in ("dense", "moe", "vlm", "encdec", "audio"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
            if self.family == "moe":
                mlp = 3 * d * f * self.num_experts
            else:
                mlp = 3 * d * f
            per_layer = attn + mlp + 2 * d
            n += per_layer * self.num_layers
            if self.family == "encdec":
                # decoder layers add cross-attention
                n += (attn + 3 * d * f + 3 * d) * self.num_layers \
                    + attn * self.num_layers
        elif self.family == "ssm":      # rwkv6
            per_layer = 4 * d * d + 2 * d * self.d_ff + 8 * d
            n += per_layer * self.num_layers
        elif self.family == "hybrid":   # zamba2
            di = self.d_inner
            mamba = d * 2 * di + di * d + di * (2 * self.ssm_state) \
                + 3 * di
            n += mamba * self.num_layers
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d + 3 * d * f
            n += attn            # shared block counted once
        return float(n)

    def active_param_count(self) -> float:
        """Active parameters per token (MoE uses top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        inactive = 3 * d * f * (self.num_experts - self.experts_per_token)
        return total - inactive * self.num_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES = {s.name: s for s in ALL_SHAPES}
