"""Serving engine: sync-free continuous batching over slot-based KV caches
— the PyTorch counterpart of the fixed-slot part of
``repro/serving/engine.py``.

  * a fixed ``slots`` decode batch; idle slots are masked, arriving
    requests are admitted into free slots (continuous batching),
  * admissions are batched: the due arrivals that fit free slots go
    through one prefill per group, with the batch padded to a power of
    two.  Attention families (dense, moe) form ONE group, right-padded
    to a common length S (a multiple of 8) — exact under causal masking
    with per-row ``last_pos`` logit selection.  Recurrent families (ssm,
    hybrid) integrate every input token into their state, pads
    included, so their arrivals are grouped by exact prompt length and
    each group runs at S = that length, as the JAX engine's
    ``_admission_groups``,
  * the decode loop is sync-free: ``last_tok``/``pos``/``budget`` and the
    active mask live on the device, sampling and termination run in the
    same stream as the decode step, and the sampled tokens/done flags
    reach the host once per ``sync_every`` steps,
  * greedy (argmax, int32) or temperature sampling from a
    ``torch.Generator`` on the engine's device,
  * TTFT is stamped only after the device has finished the prefill.

Served: the dense, MoE, ssm (rwkv6) and hybrid (zamba2) families.
``decode_fn(params, cache, tokens, pos) -> (logits, cache)`` replaces the
model's decode step (e.g. a Tessera ``StagedExecutable``, or a function
choosing one by the online monitor's policy); ``prefill_fn(params,
cache, tokens) -> (logits, cache)`` replaces its prefill, one request
per admission at its exact length.  Out of this slice: paged KV, chunked
prefill, sessions and handoff.

Accounting note: completion times are observed at sync boundaries, so a
request's ``finished`` stamp can be up to ``sync_every - 1`` decode steps
late (``sync_every=1`` gives per-token accounting).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

# Families whose prefill is exact under right-padding (causal attention
# never reads positions past the query).  Recurrent state (ssm/hybrid)
# integrates every input token, so a padded row would corrupt it.
_PAD_SAFE_FAMILIES = ("dense", "moe")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    ttft: float = -1.0
    finished: float = -1.0


@dataclasses.dataclass
class EngineStats:
    completed: int = 0
    decode_steps: int = 0
    host_syncs: int = 0
    prefill_batches: int = 0
    ttft: List[float] = dataclasses.field(default_factory=list)
    tpot: List[float] = dataclasses.field(default_factory=list)
    latency_per_token: List[float] = dataclasses.field(
        default_factory=list)

    def summary(self) -> Dict[str, float]:
        return {
            "completed": self.completed,
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "prefill_batches": self.prefill_batches,
            "mean_ttft": float(np.mean(self.ttft)) if self.ttft else 0.0,
            "mean_tpot": float(np.mean(self.tpot)) if self.tpot else 0.0,
            "mean_norm_latency": float(np.mean(self.latency_per_token))
            if self.latency_per_token else 0.0,
        }


def _wait(device: torch.device) -> None:
    """Block until the device has finished the work queued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 decode_fn: Optional[Callable] = None,
                 prefill_fn: Optional[Callable] = None,
                 sync_every: int = 8, device: DeviceLike = None):
        L.check_supported(cfg)
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.sync_every = sync_every
        self._decode_custom = decode_fn
        self._prefill_custom = prefill_fn
        self.generator = default_generator(self.device, seed)
        self.stats = EngineStats()

        self.cache = M.init_cache(cfg, slots, max_len, device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        # Decode state is device-resident; the host sees it only at sync
        # boundaries.
        dev, i32 = self.device, torch.int32
        self.pos = torch.zeros(slots, dtype=i32, device=dev)      # next
        self.budget = torch.zeros(slots, dtype=i32, device=dev)   # left
        self.last_tok = torch.zeros(slots, dtype=i32, device=dev)
        self.active_mask = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._cols: List[torch.Tensor] = []   # (2, slots) per step
        # upper bound on decode steps any live slot can still take
        self._max_remaining = sync_every
        self._clock: Optional[Callable[[], float]] = None

    # ------------------------------------------------------------------ #
    def _now(self, now: Optional[float]) -> float:
        if self._clock is not None:
            return self._clock()
        return now if now is not None else 0.0

    def _any_active(self) -> bool:
        return any(r is not None for r in self.active)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits -> (B,) int32 tokens, on the device."""
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .to(torch.int32)

    def _step_fused(self) -> torch.Tensor:
        """One decode step plus sampling and termination, all queued on
        the device.  Returns ``packed`` (2, slots) int32: [emitted token
        or -1 for an idle slot; done flag]."""
        if self._decode_custom is not None:
            logits, self.cache = self._decode_custom(
                self.params, self.cache, self.last_tok[:, None], self.pos)
        else:
            logits, self.cache = M.decode_step(
                self.params, self.cfg, self.last_tok[:, None], self.cache,
                self.pos)
        tok = self._sample(logits)
        active = self.active_mask
        new_pos = torch.where(active, self.pos + 1, self.pos)
        new_budget = torch.where(active, self.budget - 1, self.budget)
        done = (new_budget <= 0) | (new_pos >= self.max_len - 1)
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        done = active & done
        new_active = active & ~done
        self.last_tok = torch.where(new_active, tok, self.last_tok)
        self.pos, self.budget, self.active_mask = \
            new_pos, new_budget, new_active
        emit = torch.where(active, tok, torch.full_like(tok, -1))
        return torch.stack([emit, done.to(torch.int32)])

    # ------------------------------------------------------------------ #
    # Admission: batched multi-request prefill
    # ------------------------------------------------------------------ #
    def admit_batch(self, reqs: Sequence[Request], now: float) -> int:
        """Admit up to len(free slots) requests through one padded
        prefill.  Returns the number admitted."""
        # settle any buffered window first: admission must see fresh
        # slot state
        self.sync(now)
        free = [s for s in range(self.slots) if self.active[s] is None]
        take = list(reqs[:len(free)])
        for r in take:
            if len(r.prompt) >= self.max_len:
                raise ValueError(f"request {r.rid}: prompt of "
                                 f"{len(r.prompt)} tokens does not fit "
                                 f"max_len {self.max_len}")
        pairs = list(zip(free, take))
        if not pairs:
            return 0
        for group in self._admission_groups(pairs):
            self._admit_group(group, now)
        self._recompute_remaining()
        return len(pairs)

    def _admission_groups(self, pairs: List[Tuple[int, Request]]
                          ) -> List[List[Tuple[int, Request]]]:
        """Partition admitted (slot, request) pairs into prefill groups:
        one padded batch for attention families, exact-length groups
        (in order of first arrival) for recurrent ones, one request each
        for an injected prefill."""
        if self._prefill_custom is not None:
            return [[p] for p in pairs]
        if self.cfg.family in _PAD_SAFE_FAMILIES:
            return [pairs]
        by_len: Dict[int, List[Tuple[int, Request]]] = {}
        for s, r in pairs:
            by_len.setdefault(len(r.prompt), []).append((s, r))
        return list(by_len.values())

    def _admit_group(self, group: List, now: float) -> None:
        slots_ = [s for s, _ in group]
        reqs = [r for _, r in group]
        G = len(reqs)
        lens = [len(r.prompt) for r in reqs]
        # bucketed admission shapes, as the JAX engine pads for its jit:
        # the batch to a power of two (pad rows are separate rows) and,
        # for attention families only, S to a multiple of 8; a recurrent
        # group has one exact length
        if self.cfg.family in _PAD_SAFE_FAMILIES \
                and self._prefill_custom is None:
            S = min(-(-max(lens) // 8) * 8, self.max_len - 1)
        else:
            S = max(lens)
        Gp = min(1 << (G - 1).bit_length(), self.slots)
        toks = np.zeros((Gp, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
        last = np.zeros(Gp, np.int32)
        last[:G] = np.asarray(lens) - 1
        dev = self.device
        # The group's cache holds only min(S, window) KV slots (not max_len):
        # slots past a row's prompt are never read before decode writes
        # them, since decode writes position pos before attending over
        # [0, pos] (or, in a ring buffer, over every slot only once
        # positions have wrapped, when all of them have been written).
        cache_g = M.init_cache(self.cfg, Gp, S, device=dev)
        if self._prefill_custom is not None:
            # one request at its exact length: its logits are the last
            # column's
            logits, cache_g = self._prefill_custom(
                self.params, cache_g, torch.from_numpy(toks).to(dev))
        else:
            logits, cache_g = M.prefill(
                self.params, self.cfg, torch.from_numpy(toks).to(dev),
                cache_g, last_pos=torch.from_numpy(last).to(dev))
        idx = torch.tensor(slots_, dtype=torch.long, device=dev)
        self._write_slots(idx, cache_g, G)
        # honest TTFT: the first token exists only once the device is done
        _wait(dev)
        t_ready = self._now(now)
        first = self._sample(logits).cpu().numpy()[:G]
        self.stats.prefill_batches += 1

        i32 = torch.int32
        self.pos[idx] = torch.tensor(lens, dtype=i32, device=dev)
        self.last_tok[idx] = torch.from_numpy(first).to(dev)
        budgets = [r.max_new_tokens - 1 for r in reqs]
        self.budget[idx] = torch.tensor(budgets, dtype=i32, device=dev)
        # a slot becomes live only if it still has budget AND the prefill
        # token was not EOS
        live = [b > 0 and not (self.eos_id is not None
                               and int(t) == self.eos_id)
                for b, t in zip(budgets, first)]
        self.active_mask[idx] = torch.tensor(live, device=dev)

        for i, (slot, req) in enumerate(group):
            req.ttft = t_ready
            req.output.append(int(first[i]))
            if live[i]:
                self.active[slot] = req
            else:
                # completes at prefill (budget spent or EOS sampled)
                self._finalize(req, t_ready)

    def _write_slots(self, idx: torch.Tensor, cache_g: Dict[str, Any],
                     rows: int) -> None:
        """Copy rows 0..rows of a group's prefill cache into engine slots
        ``idx``, one scatter per cache leaf.  KV leaves (L, B, T, ...)
        fill their first T slots; recurrent leaves have no T axis."""
        for part, leaves in cache_g.items():
            for name, grp in leaves.items():
                full = self.cache[part][name]
                if part == "kv":
                    full[:, idx, :grp.shape[2]] = grp[:, :rows]
                else:
                    full[:, idx] = grp[:, :rows]

    def warmup(self) -> None:
        """Run one prefill and one decode step so the first real request
        does not pay first-call costs (kernel build, allocator growth).
        Engine state is untouched: both probes run on caches of their
        own (a decode step advances every slot's recurrent state).  An
        injected ``decode_fn`` is warmed at the engine's cache shape (a
        traced step takes only the shapes it was traced at); an injected
        ``prefill_fn`` is not called (its shapes are the caller's)."""
        dev = self.device
        if self._prefill_custom is None:
            M.prefill(self.params, self.cfg,
                      torch.zeros((1, 8), dtype=torch.int32, device=dev),
                      M.init_cache(self.cfg, 1, 8, device=dev))
        if self._decode_custom is not None:
            self._decode_custom(
                self.params,
                M.init_cache(self.cfg, self.slots, self.max_len, device=dev),
                self.last_tok[:, None], torch.zeros_like(self.pos))
        else:
            M.decode_step(self.params, self.cfg, self.last_tok[:, None],
                          M.init_cache(self.cfg, self.slots, 8, device=dev),
                          torch.zeros_like(self.pos))
        _wait(dev)

    # ------------------------------------------------------------------ #
    # Sync-free decode loop
    # ------------------------------------------------------------------ #
    def step(self, now: float) -> None:
        """One decode step over all active slots (idle slots masked).
        Only queues work: tokens and done flags reach the host every
        ``sync_every`` steps."""
        if not self._any_active():
            return
        self._cols.append(self._step_fused())
        self.stats.decode_steps += 1
        # sync at the cadence, or as soon as every live slot must have
        # exhausted its budget (no masked tail steps at drain)
        if len(self._cols) >= min(self.sync_every, self._max_remaining):
            self.sync(now)

    def sync(self, now: float) -> None:
        """Fetch the buffered tokens/flags (one device-to-host copy for
        the window) and settle completions on the host."""
        if not self._cols:
            return
        cols = self._cols[0] if len(self._cols) == 1 else \
            torch.stack(self._cols, dim=2)
        window = cols.cpu().numpy().reshape(2, self.slots, -1)
        toks, dones = window[0], window[1]                 # (slots, k)
        self._cols = []
        self.stats.host_syncs += 1
        t_set = self._now(now)
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            for k in range(toks.shape[1]):
                t = int(toks[s, k])
                if t < 0:           # slot went idle earlier in the window
                    break
                req.output.append(t)
                if dones[s, k]:
                    self._finalize(req, t_set)
                    self.active[s] = None
                    break
        self._recompute_remaining()

    def _recompute_remaining(self) -> None:
        rem = [r.max_new_tokens - len(r.output)
               for r in self.active if r is not None]
        self._max_remaining = max(rem) if rem else self.sync_every

    def _finalize(self, req: Request, now: float) -> None:
        req.finished = now
        self.stats.completed += 1
        self.stats.ttft.append(req.ttft - req.arrival)
        self.stats.tpot.append(
            (now - req.ttft) / max(len(req.output) - 1, 1))
        self.stats.latency_per_token.append(
            (now - req.arrival) / max(len(req.output), 1))

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request]) -> EngineStats:
        """Process a workload to completion (arrival times honoured on a
        clock driven by wall time)."""
        t0 = time.perf_counter()
        self._clock = lambda: time.perf_counter() - t0
        try:
            pending = sorted(requests, key=lambda r: r.arrival)
            while pending or self._any_active():
                now = self._clock()
                if pending and pending[0].arrival <= now \
                        and None in self.active:
                    # admit every due arrival that fits (admit_batch
                    # settles the buffered window itself)
                    batch = []
                    nfree = self.active.count(None)
                    while (pending and len(batch) < nfree
                           and pending[0].arrival <= self._clock()):
                        batch.append(pending.pop(0))
                    if batch:
                        self.admit_batch(batch, self._clock())
                if not self._any_active():
                    if pending:
                        # idle until the next arrival: sleep, don't spin
                        delay = pending[0].arrival - self._clock()
                        if delay > 0:
                            time.sleep(delay)
                    continue
                self.step(self._clock())
            self.sync(self._clock())
        finally:
            self._clock = None
        return self.stats


# --------------------------------------------------------------------- #
def requests_from_trace(trace, vocab_size: int, *,
                        max_prompt: Optional[int] = None,
                        max_new: Optional[int] = None,
                        time_scale: float = 1.0,
                        seed: int = 0) -> List[Request]:
    """Materialize ``serving.workload`` trace entries as engine Requests
    (uniform random prompt ids at the trace's lengths, optionally clipped
    to ``max_prompt``/``max_new``, arrivals scaled by ``time_scale``) —
    the same requests as the JAX package's function for the same
    arguments."""
    rng = np.random.default_rng(seed)
    out = []
    for w in trace:
        p = w.prompt_tokens if max_prompt is None \
            else min(w.prompt_tokens, max_prompt)
        n = w.output_tokens if max_new is None \
            else min(w.output_tokens, max_new)
        out.append(Request(
            rid=w.rid,
            prompt=rng.integers(0, vocab_size, size=max(1, p))
            .astype(np.int32),
            max_new_tokens=max(1, n),
            arrival=w.arrival * time_scale))
    return out
