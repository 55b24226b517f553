"""Step-function constructors + input specs for every (arch x shape) cell
— the port of ``repro/launch/steps.py``.

``input_specs(cell)`` returns ``meta``-device stand-ins for every input
of the cell's step function (parameters, optimizer state, caches, token
batches, stubbed modality embeddings): the shapes and dtypes, with no
memory.  ``make_step`` returns the step function.

long_500k is only defined for sub-quadratic architectures (SWA ring /
SSM / hybrid); pure full-attention archs skip it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

import repro_torch.configs as configs
from repro_torch.distributed import local as LD
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig
from repro_torch.train import optim
from repro_torch.train.loop import value_and_grad

# Sub-quadratic serve paths for the 524k-token cell.
LONG_CONTEXT_ARCHS = {"mixtral_8x7b", "zamba2_7b", "rwkv6_3b",
                      "gpt_oss_20b"}
ENC_LEN_DEFAULT = 1024        # encoder frames for encdec serve cells
META = torch.device("meta")


def cell_is_defined(arch: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch: 524k decode requires a "
                       "sub-quadratic mechanism (DESIGN.md skip list)")
    return True, ""


@dataclasses.dataclass
class Cell:
    arch: str
    cfg: ModelConfig
    shape: ShapeConfig
    step_kind: str              # train | prefill | decode
    extras: Tuple[str, ...]     # extra batch inputs


def get_cell(arch: str, shape_name: str,
             smoke: bool = False) -> Cell:
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    shape = SHAPES[shape_name]
    extras = ()
    if cfg.family == "vlm":
        extras = ("patch_embeds", "positions3")
    elif cfg.family == "encdec":
        extras = ("enc_embeds",)
    return Cell(arch=arch, cfg=cfg, shape=shape, step_kind=shape.kind,
                extras=extras)


# --------------------------------------------------------------------- #
# Step functions
# --------------------------------------------------------------------- #
def _extras(cfg: ModelConfig, batch: Dict[str, Any],
            decode: bool = False) -> Dict[str, Any]:
    """The family's extra inputs of a step: a vlm's patch embeddings (not
    at decode: the frontend ran at prefill) and M-RoPE ids, an encdec's
    encoder input (not at decode)."""
    if cfg.family == "vlm":
        names = ("positions3",) if decode else ("patch_embeds", "positions3")
    elif cfg.family == "encdec" and not decode:
        names = ("enc_embeds",)
    else:
        names = ()
    return {n: batch[n] for n in names}


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig,
                    remat: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and its gradients, then ``optim.apply`` (in
    place)."""
    def train_step(params, opt_state, batch):
        kw = _extras(cfg, batch)
        # DTensor parameters: the backward and the update too mix them
        # with plain tensors as replicated ones
        with LD.sharded(params["embed"]):
            loss, grads = value_and_grad(
                lambda p: M.loss_fn(p, cfg, batch["tokens"],
                                    batch["targets"], remat=remat, **kw),
                params)
            new_params, new_opt = optim.apply(ocfg, grads, opt_state,
                                              params)
        return new_params, new_opt, loss
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, cache, batch):
        return M.prefill(params, cfg, batch["tokens"], cache,
                         **_extras(cfg, batch))
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, batch):
        return M.decode_step(params, cfg, batch["tokens"], cache,
                             batch["pos"], **_extras(cfg, batch, decode=True))
    return decode_step


def make_step(cell: Cell, ocfg: Optional[optim.AdamWConfig] = None,
              remat: bool = True) -> Callable:
    if cell.step_kind == "train":
        return make_train_step(cell.cfg, ocfg or optim.AdamWConfig(),
                               remat=remat)
    if cell.step_kind == "prefill":
        return make_prefill_step(cell.cfg)
    return make_decode_step(cell.cfg)


# --------------------------------------------------------------------- #
# Input specs (meta tensors, no allocation)
# --------------------------------------------------------------------- #
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cell: Cell, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    cfg = cell.cfg
    B = batch if batch is not None else cell.shape.global_batch
    S = seq if seq is not None else cell.shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cell.step_kind == "train":
        out["tokens"] = _spec((B, S), torch.int32)
        out["targets"] = _spec((B, S), torch.int32)
    elif cell.step_kind == "prefill":
        out["tokens"] = _spec((B, S), torch.int32)
    else:
        out["tokens"] = _spec((B, 1), torch.int32)
        out["pos"] = _spec((B,), torch.int32)
    if cfg.family == "vlm":
        if cell.step_kind != "decode":      # the frontend ran at prefill
            out["patch_embeds"] = _spec((B, cfg.num_patches, cfg.d_model),
                                        cfg.torch_dtype)
        s3 = S if cell.step_kind != "decode" else 1
        out["positions3"] = _spec((3, B, s3), torch.int32)
    if cfg.family == "encdec" and cell.step_kind != "decode":
        enc_len = min(S, ENC_LEN_DEFAULT) if cell.step_kind != "train" \
            else S
        out["enc_embeds"] = _spec((B, enc_len, cfg.d_model),
                                  cfg.torch_dtype)
    return out


def input_specs(cell: Cell, ocfg: Optional[optim.AdamWConfig] = None,
                batch: Optional[int] = None,
                seq: Optional[int] = None) -> Tuple:
    """Full argument spec tuple for the cell's step function: (params,
    optimizer state, batch) for a train cell, (params, cache, batch)
    otherwise, every tensor on ``meta``."""
    cfg = cell.cfg
    B = batch if batch is not None else cell.shape.global_batch
    S = seq if seq is not None else cell.shape.seq_len
    params = M.init_params(cfg, device=META)
    b = batch_specs(cell, batch=B, seq=S)
    if cell.step_kind == "train":
        return (params, optim.init(ocfg or optim.AdamWConfig(), params), b)
    enc_len = min(S, ENC_LEN_DEFAULT) if cfg.family == "encdec" else None
    cache = M.init_cache(cfg, B, max_len=S, device=META, enc_len=enc_len)
    return (params, cache, b)
