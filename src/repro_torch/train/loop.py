"""Training loop: train step, grad accumulation, checkpoints, recovery —
the port of ``repro/train/loop.py``.

One device, on the card unless ``device`` names another.  A step is
the reference's: the loss and its gradients (``torch.autograd.grad``
through the plain-PyTorch training forward, ``models.model.loss_fn``),
with ``accum > 1`` one gradient per microbatch of rows summed in fp32
and divided by ``accum``; then the error-feedback compression (the fp32
residual is always kept) and ``optim.apply``.  Every ``ckpt_every``
steps an asynchronous atomic checkpoint is written; ``resume`` restores
the latest complete one, and ``fail_at`` raises a simulated failure
after that step's checkpointing window.

The optimizer updates the state in place: ``run`` trains the state it
is given (a converted JAX state, for example) and returns it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim
from repro_torch.train.compress import (CompressionConfig,
                                        compress_decompress, init_residual)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    accum: int = 1                       # gradient accumulation
    compression: CompressionConfig = CompressionConfig("none")
    remat: bool = False
    seed: int = 0


def value_and_grad(loss: Any, params: Any, *args, **kw):
    """(loss(params, *args, **kw), its gradient tree, in the parameters'
    dtypes; zeros for a parameter the loss does not reach)."""
    leaves, spec = pytree.tree_flatten(params)
    ps = [p.detach().requires_grad_() for p in leaves]
    value = loss(pytree.tree_unflatten(ps, spec), *args, **kw)
    grads = torch.autograd.grad(value, ps, allow_unused=True,
                                materialize_grads=True)
    return value.detach(), pytree.tree_unflatten(list(grads), spec)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 ocfg: Optional[optim.AdamWConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ocfg = ocfg or optim.AdamWConfig(
            warmup_steps=max(tcfg.steps // 10, 1),
            total_steps=tcfg.steps)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
                     if tcfg.ckpt_dir else None)
        self.metrics: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ #
    def _micro_loss(self, params, tokens, targets):
        return M.loss_fn(params, self.cfg, tokens, targets,
                         remat=self.tcfg.remat)

    def loss_and_grads(self, params, batch: Dict[str, np.ndarray]):
        """The loss of ``batch`` ({"tokens", "targets"} (B, S) int32) and
        its gradients: with ``accum > 1`` the mean of the microbatches'
        gradients, summed in fp32."""
        tcfg = self.tcfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        targets = torch.as_tensor(batch["targets"], device=self.device)
        if tcfg.accum > 1:
            mb = tokens.shape[0] // tcfg.accum
            grads = pytree.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(tcfg.accum):
                rows = slice(i * mb, (i + 1) * mb)
                l, g = value_and_grad(self._micro_loss, params,
                                      tokens[rows], targets[rows])
                grads = pytree.tree_map(lambda a, b: a + b.float(),
                                        grads, g)
                loss = loss + l
            grads = pytree.tree_map(lambda g: g / tcfg.accum, grads)
            loss = loss / tcfg.accum
        else:
            loss, grads = value_and_grad(self._micro_loss, params, tokens,
                                         targets)
        return loss, grads

    def train_step(self, params, opt_state, residual,
                   batch: Dict[str, np.ndarray]):
        """One step on ``batch``.  Returns (params, opt_state, residual,
        loss), the state updated in place."""
        loss, grads = self.loss_and_grads(params, batch)
        # cross-node gradient compression (EF) before the all-reduce; on
        # one device this is the identity wire format
        grads, residual = compress_decompress(self.tcfg.compression, grads,
                                              residual)
        params, opt_state = optim.apply(self.ocfg, grads, opt_state, params)
        return params, opt_state, residual, loss

    # ------------------------------------------------------------------ #
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """Fresh parameters (from ``generator``, default: seeded with
        ``tcfg.seed`` on the device), optimizer state and residual."""
        g = generator if generator is not None else \
            default_generator(self.device, self.tcfg.seed)
        params = M.init_params(self.cfg, generator=g, device=self.device)
        return {"params": params, "opt": optim.init(self.ocfg, params),
                "residual": init_residual(params)}

    def run(self, batches, state=None, start_step: int = 0,
            fail_at: Optional[int] = None) -> Dict[str, Any]:
        """Train from ``start_step``.  ``fail_at`` raises a simulated
        hardware failure AFTER that step's checkpointing window — the
        fault-tolerance tests restart with ``resume()``."""
        if state is None:
            state = self.init_state()
        params, opt_state, residual = (state["params"], state["opt"],
                                       state["residual"])
        t0 = time.perf_counter()
        step = start_step
        for step in range(start_step, self.tcfg.steps):
            batch = batches.batch_at(step)
            params, opt_state, residual, loss = self.train_step(
                params, opt_state, residual, batch)
            if step % self.tcfg.log_every == 0 or \
                    step == self.tcfg.steps - 1:
                # float() waits for the step: "t" is its end
                self.metrics.append({"step": step,
                                     "loss": float(loss),
                                     "t": time.perf_counter() - t0})
            if self.ckpt and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save_async(
                    step + 1,
                    {"params": params, "opt": opt_state,
                     "residual": residual})
            if fail_at is not None and step + 1 == fail_at:
                if self.ckpt:
                    self.ckpt.wait()
                raise SimulatedFailure(step + 1)
        if self.ckpt:
            self.ckpt.wait()
        return {"params": params, "opt": opt_state, "residual": residual,
                "last_step": step}

    def resume(self, batches) -> Dict[str, Any]:
        """Auto-resume from the latest checkpoint and finish training."""
        if self.ckpt is None:
            raise ValueError("resume needs a TrainConfig.ckpt_dir")
        template = self.init_state()
        step, state = self.ckpt.restore(template)
        return self.run(batches, state=state, start_step=step)


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step
