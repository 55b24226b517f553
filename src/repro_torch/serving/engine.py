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
  * TTFT is stamped only after the device has finished the prefill,
  * on a CUDA device, with the model's own decode step and greedy
    sampling over a plain (not DTensor) cache and no device mesh, the
    whole fused step runs as one CUDA graph: the first such step runs
    eagerly and captures it, each later one replays it
    (``graph_captures`` / ``graph_steps``),
  * paged KV residency (``kv_block_tokens``, ``kv_pool_blocks``, ``spill``,
    ``preempt_priority``; ``serving/kvpool.py``): sessions reserve blocks
    of a shared pool, not slots, so more sessions are resident than there
    are slots.  They time-slice through the slots at sync boundaries
    (park / activate, round robin by ``sync_every`` steps), a request of
    higher ``priority`` preempts a lower one, and idle parked sessions
    spill to CPU tensors and come back on activation,
  * chunked admission (``prefill_chunk``): a long prompt is prefilled in
    chunks at growing offsets, with one decode step of the live slots
    between chunks,
  * prefill/decode handoff through ``engine.sessions`` (and the
    ``prefill_handoff{,_stream}`` / ``admit_handoff{,_stream}`` /
    ``export_sessions`` / ``import_session`` methods over it): a prefill
    engine exports a session's state, whole or as (layer, chunk) shards
    while later chunks still run, and a decode engine imports it into a
    slot and continues with the same greedy tokens; ``serve_pd`` runs the
    reference deployment spec's prefill -> decode loop over a pair of
    engines.

With ``kv_block_tokens`` and ``prefill_chunk`` None the engine is the
fixed-slot engine: the same launches, and no host sync in a decode step.
Every state mover writes the engine's cache in place, so its tensors keep
their storage for the engine's lifetime.

Served: the dense, MoE, ssm (rwkv6) and hybrid (zamba2) families.
``decode_fn(params, cache, tokens, pos) -> (logits, cache)`` replaces the
model's decode step (e.g. a Tessera ``StagedExecutable``, or a function
choosing one by the online monitor's policy); ``prefill_fn(params,
cache, tokens) -> (logits, cache)`` replaces its prefill, one request
per admission at its exact length.

Accounting note: completion times are observed at sync boundaries, so a
request's ``finished`` stamp can be up to ``sync_every - 1`` decode steps
late (``sync_every=1`` gives per-token accounting).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.distributed import local as LD
from repro_torch.distributed.context import current_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import trace as _trace
from repro_torch.serving.kvpool import (PagedKvCache, SessionManager,
                                        SessionState)

# Families whose prefill is exact under right-padding (causal attention
# never reads positions past the query).  Recurrent state (ssm/hybrid)
# integrates every input token, so a padded row would corrupt it.
_PAD_SAFE_FAMILIES = ("dense", "moe")
# The families the engine serves: the decoder-only ones without M-RoPE,
# as the reference engine's assertion says (encdec needs encoder inputs
# per request, vlm patch embeddings and M-RoPE ids).
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the engine does
    not serve."""
    L.check_supported(cfg)
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the engine serves the decoder-only families "
            f"{', '.join(SERVED_FAMILIES)}, not {cfg.family!r} (as the "
            "reference's)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0
    priority: int = 0                   # preemption rank (higher wins)
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
    graph_captures: int = 0             # CUDA graphs of the decode step
    graph_steps: int = 0                # decode steps run as a replay
    # running sums over the completed requests (``completed`` of them)
    ttft_sum: float = 0.0
    tpot_sum: float = 0.0
    norm_latency_sum: float = 0.0

    def summary(self) -> Dict[str, float]:
        n = self.completed
        return {
            "completed": self.completed,
            "decode_steps": self.decode_steps,
            "host_syncs": self.host_syncs,
            "prefill_batches": self.prefill_batches,
            "graph_captures": self.graph_captures,
            "graph_steps": self.graph_steps,
            "mean_ttft": self.ttft_sum / n if n else 0.0,
            "mean_tpot": self.tpot_sum / n if n else 0.0,
            "mean_norm_latency": self.norm_latency_sum / n if n else 0.0,
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
                 sync_every: int = 8,
                 prefill_chunk: Optional[int] = None,
                 kv_block_tokens: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 spill: bool = True, preempt_priority: bool = True,
                 device: DeviceLike = None):
        check_servable(cfg)
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.sync_every = sync_every
        self.prefill_chunk = prefill_chunk
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
        # The decode step as a CUDA graph (``_graph_ok``): the graph, the
        # side stream it was captured and is replayed on, and its
        # (2, slots) output.
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_stream: Optional[torch.cuda.Stream] = None
        self._graph_out: Optional[torch.Tensor] = None
        self._cols: List[torch.Tensor] = []   # (2, slots) per step
        # upper bound on decode steps any live slot can still take
        self._max_remaining = sync_every
        self._clock: Optional[Callable[[], float]] = None
        # Paged KV residency: sessions beyond the dense decode batch park
        # their state in a shared block pool and time-slice through the
        # slots at sync boundaries.  With kv_block_tokens None the engine
        # is the fixed-slot engine (self._paged is None everywhere).
        self.spill = spill
        self.preempt_priority = preempt_priority
        self._ran = [0] * slots         # decode steps since activation
        self._admitting: frozenset = frozenset()   # slots mid-admission
        if kv_block_tokens is not None:
            pool_blocks = kv_pool_blocks if kv_pool_blocks is not None \
                else slots * (max_len // kv_block_tokens)
            self._paged: Optional[PagedKvCache] = PagedKvCache(
                cfg, pool_blocks, kv_block_tokens, max_len,
                device=self.device)
        else:
            if kv_pool_blocks is not None:
                raise ValueError("kv_pool_blocks requires kv_block_tokens")
            self._paged = None
        self.sessions = SessionManager(self)

    # ------------------------------------------------------------------ #
    def _now(self, now: Optional[float]) -> float:
        if self._clock is not None:
            return self._clock()
        return now if now is not None else 0.0

    def _any_active(self) -> bool:
        if any(r is not None for r in self.active):
            return True
        return self._paged is not None and bool(self._paged.parked())

    def _ready(self, now: Optional[float]) -> float:
        """Wait for the device, then read the clock: a first token exists
        only once its prefill has finished."""
        _wait(self.device)
        return self._now(now)

    def _sample_host(self, logits: torch.Tensor) -> np.ndarray:
        return self._sample(logits).cpu().numpy()

    def _cursors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """pos, last_tok, budget on the host (one copy; a host sync)."""
        c = torch.stack([self.pos, self.last_tok, self.budget]).cpu().numpy()
        return c[0], c[1], c[2]

    def _set_cursor(self, slot: int, last_tok: int, pos: int,
                    budget: int) -> None:
        """Make ``slot`` live at the given decode cursor."""
        self.pos[slot] = pos
        self.last_tok[slot] = last_tok
        self.budget[slot] = budget
        self.active_mask[slot] = True

    def _prefill_len(self, longest: int) -> int:
        """The admission length S of a group whose longest prompt is
        ``longest``: a multiple of 8 for attention families (bucketed, as
        the JAX engine pads for its jit), the exact length for recurrent
        ones and for an injected prefill."""
        if self.cfg.family in _PAD_SAFE_FAMILIES \
                and self._prefill_custom is None:
            return min(-(-longest // 8) * 8, self.max_len - 1)
        return longest

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
        or -1 for an idle slot; done flag].  The decode state is written
        in place (``copy_``), so its tensors keep their storage, as a
        CUDA graph of this step needs."""
        if self._decode_custom is not None:
            logits, self.cache = self._decode_custom(
                self.params, self.cache, self.last_tok[:, None], self.pos)
        else:
            logits, cache = M.decode_step(
                self.params, self.cfg, self.last_tok[:, None], self.cache,
                self.pos)
            if cache is not self.cache:
                raise RuntimeError("decode_step must write the engine's "
                                   "cache in place")
        tok = self._sample(logits)
        active = self.active_mask
        new_pos = torch.where(active, self.pos + 1, self.pos)
        new_budget = torch.where(active, self.budget - 1, self.budget)
        done = (new_budget <= 0) | (new_pos >= self.max_len - 1)
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        done = active & done
        new_active = active & ~done
        emit = torch.where(active, tok, torch.full_like(tok, -1))
        packed = torch.stack([emit, done.to(torch.int32)])
        self.last_tok.copy_(torch.where(new_active, tok, self.last_tok))
        self.pos.copy_(new_pos)
        self.budget.copy_(new_budget)
        self.active_mask.copy_(new_active)
        return packed

    def _graph_ok(self) -> bool:
        """Whether the step runs as the captured CUDA graph, from what the
        engine observes now: a CUDA device, the model's own decode step
        (no ``decode_fn``, which may be set after construction), greedy
        sampling, no DTensor in the cache and no ambient device mesh (a
        step on one may run collectives).  Otherwise the step runs
        eagerly."""
        return (self.device.type == "cuda" and self._decode_custom is None
                and self.temperature <= 0.0 and current_mesh() is None
                and not any(LD.is_dtensor(t)
                            for t in M.state_leaves(self.cache)))

    def _decoder(self) -> Callable[[], torch.Tensor]:
        """What runs this step: the eager step, or where ``_graph_ok``
        holds a replay of the captured step (the capture first, after one
        eager step, where there is none yet)."""
        if not self._graph_ok():
            return self._step_fused
        if self._graph is None:
            return self._capture
        return self._replay

    def _capture(self) -> torch.Tensor:
        """Run the step eagerly on a side stream the engine owns (the
        real step; it also warms cuBLAS, the kernels, the allocator and
        K1's ticket buffer for that stream), then capture it there
        (``_record``).  Capture launches nothing, so the state the eager
        step left stands."""
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            self._graph_stream = torch.cuda.Stream()
            side = self._graph_stream
            side.wait_stream(main)
            with torch.cuda.stream(side):
                col = self._step_fused()
            main.wait_stream(side)
            self._record(side)
        self.stats.graph_captures += 1
        return col

    def _record(self, side: torch.cuda.Stream) -> None:
        """Capture ``_step_fused`` on ``side`` as the engine's CUDA graph.
        The kernels' wrappers run (and count a launch) as they record,
        but nothing reaches the card until a replay."""
        graph = torch.cuda.CUDAGraph()
        # no automatic collection while capturing: tearing down a
        # collected engine's graph is not permitted then and would end
        # this capture (``torch.cuda.graph`` collects just before)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._step_fused()
        finally:
            if gc_on:
                gc.enable()
        self._graph, self._graph_out = graph, out

    def _replay(self) -> torch.Tensor:
        """One replay of the captured step on its side stream, ordered
        after the work queued so far and before what follows; returns a
        copy of its output (the graph rewrites it at the next replay).
        The kernels' wrappers do not run, so their launch counters leave
        a replay out."""
        main = torch.cuda.current_stream(self.device)
        side = self._graph_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._graph.replay()
        main.wait_stream(side)
        self.stats.graph_steps += 1
        return self._graph_out.clone()

    # ------------------------------------------------------------------ #
    # Admission: batched multi-request prefill
    # ------------------------------------------------------------------ #
    def admit(self, req: Request, now: float) -> bool:
        """Admit one request (see :meth:`admit_batch`)."""
        return self.admit_batch([req], now) == 1

    def admit_batch(self, reqs: Sequence[Request], now: float) -> int:
        """Admit up to len(free slots) requests through one padded
        prefill per group (paged: as many as the pool's blocks hold, in
        waves of at most ``slots``).  Returns the number admitted.

        Traced as span ``admit``: ``rids``, and ``wait_s``, each request's
        wait from its ``arrival`` to this call on the engine's clock."""
        tr = _trace.active
        if tr is None:
            return self._admit_batch(reqs, now)
        t = self._now(now)
        sp = tr.begin("admit", rids=[r.rid for r in reqs],
                      wait_s=[t - r.arrival for r in reqs])
        try:
            return self._admit_batch(reqs, now)
        finally:
            tr.end(sp)

    def _admit_batch(self, reqs: Sequence[Request], now: float) -> int:
        # settle any buffered window first: admission must see fresh
        # slot state
        self.sync(now)
        if self._paged is not None:
            # each wave prefills into the dense batch, then parks into the
            # pool to free the slots for the next wave
            left = list(reqs)
            admitted = 0
            while left:
                pairs = self._paged_admit(left, now)
                if not pairs:
                    break
                # the whole wave's slots are held until its last group is
                # in: a chunked group runs the scheduler between chunks,
                # which must not activate a parked session into the slot
                # of a later group of the same wave
                self._admitting = frozenset(s for s, _ in pairs)
                try:
                    for group in self._admission_groups(pairs):
                        self._admit_group(group, now)
                finally:
                    self._admitting = frozenset()
                admitted += len(pairs)
                left = left[len(pairs):]
                if left:
                    self.sync(now)      # settle before parking
                    wave = {id(r) for _, r in pairs}
                    for s in range(self.slots):
                        if self.active[s] is not None \
                                and id(self.active[s]) in wave:
                            self._park_slot(s, self._now(now))
            self._recompute_remaining()
            return admitted
        free = [s for s in range(self.slots) if self.active[s] is None]
        take = list(reqs[:len(free)])
        for r in take:
            self._check_prompt(r)
        pairs = list(zip(free, take))
        if not pairs:
            return 0
        for group in self._admission_groups(pairs):
            self._admit_group(group, now)
        self._recompute_remaining()
        return len(pairs)

    def _check_prompt(self, r: Request) -> None:
        if len(r.prompt) >= self.max_len:
            raise ValueError(f"request {r.rid}: prompt of {len(r.prompt)} "
                             f"tokens does not fit max_len {self.max_len}")

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

    def _paged_admit(self, reqs: List[Request],
                     now: float) -> List[Tuple[int, Request]]:
        """Paged admission, gated by free blocks, not free slots.  Each
        request reserves blocks for its worst-case token capacity; under
        pressure idle parked sessions spill to the host (LRU), and with
        ``preempt_priority`` a strictly lower-priority active session is
        parked (freeing its slot) and spilled (freeing its blocks).
        Returns the admitted (slot, request) pairs."""
        t = self._now(now)
        taken: set = set()
        pairs: List[Tuple[int, Request]] = []

        def free_slot() -> Optional[int]:
            for s in range(self.slots):
                if self.active[s] is None and s not in taken:
                    return s
            return None

        for r in reqs:
            self._check_prompt(r)
            cap = min(len(r.prompt) + r.max_new_tokens, self.max_len)
            # blocks first: a request that cannot reserve memory must not
            # disturb any resident's slot
            reserved = self._paged.reserve(r, cap, spill=self.spill)
            while not reserved and self.preempt_priority and self.spill:
                # block pressure: park and spill a strictly lower-priority
                # active session, whose blocks go to the host
                victim = self._preempt_victim(r.priority, taken)
                if victim is None:
                    break
                vrid = self.active[victim].rid
                self._park_slot(victim, t)
                self._paged.spill(vrid)
                self._paged.preemptions += 1
                reserved = self._paged.reserve(r, cap, spill=self.spill)
            if not reserved:
                break
            slot = free_slot()
            if slot is None:
                # no free slot: park a resident of <= priority (equal
                # priorities time-slice; a higher one is never displaced
                # by admission)
                victim = self._preempt_victim(r.priority, taken,
                                              allow_equal=True)
                if victim is None:
                    self._paged.release(r.rid)   # roll the blocks back
                    break
                self._park_slot(victim, t)
                self._paged.preemptions += 1
                slot = victim
            taken.add(slot)
            pairs.append((slot, r))
        return pairs

    def _preempt_victim(self, incoming_prio: int, taken=(),
                        allow_equal: bool = False) -> Optional[int]:
        """Slot of the lowest-priority active session below (with
        ``allow_equal``: at or below) ``incoming_prio``, ties broken
        toward the longest-running.  Slots in ``taken`` (assigned in this
        admission) are never victims.  None when nothing is
        preemptible."""
        if not self.preempt_priority and not allow_equal:
            return None
        cands = []
        for s in range(self.slots):
            req = self.active[s]
            if req is None or s in taken:
                continue
            if req.priority < incoming_prio or \
                    (allow_equal and req.priority <= incoming_prio):
                cands.append((req.priority, -self._ran[s], s))
        return min(cands)[2] if cands else None

    # ------------------------------------------------------------------ #
    # Paged scheduling: park / activate through the block pool
    # ------------------------------------------------------------------ #
    def _park_slot(self, slot: int, t: float) -> None:
        """Preempt an active slot into the pool: export its state at the
        decode cursor and pack it into the session's blocks.  Only at a
        settled window (a sync boundary); the round trip is exact."""
        if self._cols:
            raise RuntimeError("parking requires a settled window")
        req = self.active[slot]
        pos, last, budget = self._cursors()
        p = int(pos[slot])
        state = M.export_kv(self.cfg, self.cache, slot, p)
        self._paged.park(req.rid, state, int(last[slot]), p,
                         int(budget[slot]), t)
        self.active[slot] = None
        self.active_mask[slot] = False
        self._ran[slot] = 0

    def _activate_parked(self, rid: int, slot: int, t: float) -> None:
        """Resume a parked session into a free slot (prefetching it from
        the host if needed) at its decode cursor."""
        req = self._paged.resident[rid].req
        state, last_tok, pos, budget = self._paged.activate(rid, t)
        M.import_kv(self.cfg, self.cache, slot, state)
        self._set_cursor(slot, last_tok, pos, budget)
        self.active[slot] = req
        self._ran[slot] = 0

    def _schedule(self, now: Optional[float]) -> None:
        """Round-robin time slicing at sync boundaries: parked sessions
        activate into free slots in park order; when none is free, active
        sessions that have run their quantum (``sync_every`` decode steps)
        rotate out so every resident session makes progress."""
        runnable = self._paged.parked()
        if not runnable:
            return
        t = self._now(now)
        changed = False
        for s in range(self.slots):
            if not runnable:
                break
            if self.active[s] is None and s not in self._admitting:
                self._activate_parked(runnable.pop(0), s, t)
                changed = True
        if runnable:
            expired = sorted(
                (s for s in range(self.slots)
                 if self.active[s] is not None
                 and self._ran[s] >= self.sync_every),
                key=lambda s: -self._ran[s])
            for s in expired[:len(runnable)]:
                self._park_slot(s, t)
                self._activate_parked(runnable.pop(0), s, t)
                changed = True
        if changed:
            self._recompute_remaining()

    def _admit_group(self, group: List, now: float) -> None:
        """One prefill group, traced as span ``admit.group``: ``rids``,
        ``prompt_tokens`` (the real lengths' sum) and ``slot_tokens`` (the
        Gp x S the prefill ran)."""
        slots_ = [s for s, _ in group]
        reqs = [r for _, r in group]
        G = len(reqs)
        lens = [len(r.prompt) for r in reqs]
        # bucketed admission shapes, as the JAX engine pads for its jit:
        # the batch to a power of two (pad rows are separate rows) and,
        # for attention families only, S to a multiple of 8; a recurrent
        # group has one exact length
        S = self._prefill_len(max(lens))
        Gp = min(1 << (G - 1).bit_length(), self.slots)
        tr = _trace.active
        sp = -1 if tr is None else tr.begin(
            "admit.group", rids=[r.rid for r in reqs],
            prompt_tokens=sum(lens), slot_tokens=Gp * S)
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
        # A chunked admission fills the same S slots chunk by chunk.
        cache_g = M.init_cache(self.cfg, Gp, S, device=dev)
        toks_d = torch.from_numpy(toks).to(dev)
        if self._prefill_custom is not None:
            # one request at its exact length: its logits are the last
            # column's
            logits, cache_g = self._prefill_custom(self.params, cache_g,
                                                   toks_d)
        elif self._can_chunk(S):
            # the live decode slots keep streaming between chunks instead
            # of stalling for the whole prompt
            logits, cache_g = self._prefill_chunks(
                cache_g, toks_d, torch.from_numpy(last).to(dev), slots_, now)
        else:
            logits, cache_g = M.prefill(
                self.params, self.cfg, toks_d, cache_g,
                last_pos=torch.from_numpy(last).to(dev))
        idx = torch.tensor(slots_, dtype=torch.long, device=dev)
        self._write_slots(idx, cache_g, G)
        # honest TTFT: the first token exists only once the device is done
        t_ready = self._ready(now)
        first = self._sample_host(logits)[:G]
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
        if tr is not None:
            tr.end(sp)

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

    # ------------------------------------------------------------------ #
    # Chunked prefill: incremental cache fill with decode interleaving
    # ------------------------------------------------------------------ #
    def _can_chunk(self, S: int) -> bool:
        """Chunked prefill needs the model's own prefill and a cache that
        is not a ring buffer, and pays only for more than one chunk."""
        return (self.prefill_chunk is not None
                and self._prefill_custom is None
                and self.cfg.sliding_window is None
                and S > self.prefill_chunk)

    def _prefill_chunks(self, cache_g: Dict[str, Any], toks: torch.Tensor,
                        last: torch.Tensor, slots_: List[int],
                        now: Optional[float] = None):
        """``prefill(offset=)`` over prefill_chunk slices of the padded
        admission batch, with one decode step of the live slots between
        chunks, so a long prompt does not freeze them for its whole
        prefill.  Returns (last-position logits, filled cache), those of
        one whole prefill.

        Two things differ from the JAX engine, whose chunked admission
        loses tokens and sessions (ROADMAP, Queue 3): the scheduler does
        not activate a parked session into the slots ``slots_`` of this
        group, nor into those of the rest of its wave (``admit_batch``
        holds them), while it runs, and the steps taken between chunks
        are settled before the group goes live (otherwise its first
        tokens sit behind those steps' idle markers and are dropped)."""
        S = toks.shape[1]
        logits = None
        held = self._admitting
        self._admitting = held | frozenset(slots_)
        try:
            for _, t1, logits, cache_g in M.iter_prefill_chunks(
                    self.params, self.cfg, toks, cache_g,
                    chunk_size=self.prefill_chunk, last_pos=last,
                    prefill_call=self._chunk_call):
                if t1 < S and self._any_active():
                    self.step(self._now(now))
        finally:
            self._admitting = held
        if self._cols:
            self._settle(now)
        return logits, cache_g

    def _chunk_call(self, cache, toks, off, rel):
        return M.prefill(self.params, self.cfg, toks, cache, offset=off,
                         last_pos=rel)

    # ------------------------------------------------------------------ #
    # Session movers over ``engine.sessions`` (kvpool.SessionManager),
    # in the older wire dicts
    # ------------------------------------------------------------------ #
    def prefill_handoff(self, req: Request,
                        now: Optional[float] = None) -> Dict[str, Any]:
        """``sessions.prefill``: run ``req``'s prompt here and package its
        state for a decode engine as a handoff dict."""
        return self.sessions.prefill(req, now).to_legacy()

    def prefill_handoff_stream(self, req: Request,
                               now: Optional[float] = None,
                               chunk_size: Optional[int] = None):
        """``sessions.stream``: yields the per-(layer, chunk) shard dicts,
        then the header dict."""
        for item in self.sessions.stream(req, now, chunk_size):
            if isinstance(item, SessionState):
                yield item.to_legacy(header=True)
            else:
                yield item.to_legacy()

    def admit_handoff(self, req: Request, handoff: Dict[str, Any],
                      now: Optional[float] = None) -> bool:
        """``sessions.restore`` with the first token pending: TTFT is
        stamped on admission.  Raises on a handoff that finished at
        prefill; False when no slot is free."""
        return self.sessions.restore(
            req, SessionState.from_legacy(handoff, first_token_pending=True),
            now)

    def admit_handoff_stream(self, req: Request, shards,
                             now: Optional[float] = None) -> bool:
        """``sessions.receive`` (which takes the shard dicts too)."""
        return self.sessions.receive(req, shards, now)

    def export_sessions(self, now: Optional[float] = None
                        ) -> List[Tuple[Request, Dict[str, Any]]]:
        """``sessions.checkpoint``: drain every resident session as
        (request, handoff dict) pairs."""
        return [(r, st.to_legacy())
                for r, st in self.sessions.checkpoint(now)]

    def import_session(self, req: Request, handoff: Dict[str, Any],
                       now: Optional[float] = None) -> bool:
        """``sessions.restore`` with the first token not pending:
        migration moves the session, not the client's clock."""
        return self.sessions.restore(
            req, SessionState.from_legacy(handoff,
                                          first_token_pending=False), now)

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
        ``sync_every`` steps.  Traced as span ``decode.enqueue``:
        ``graph`` 1 for a replay of the captured step, 0 for an eager
        step (the capture's included)."""
        if not any(r is not None for r in self.active):
            if self._paged is not None:
                # no slot decoding but sessions may be parked: settle and
                # let the scheduler rotate them in
                self.sync(now)
            if not any(r is not None for r in self.active):
                return
        run = self._decoder()
        tr = _trace.active
        if tr is None:
            self._cols.append(run())
        else:
            sp = tr.begin("decode.enqueue", graph=int(run == self._replay))
            self._cols.append(run())
            tr.end(sp)
        self.stats.decode_steps += 1
        if self._paged is not None:
            for s in range(self.slots):
                if self.active[s] is not None:
                    self._ran[s] += 1
        # sync at the cadence, or as soon as every live slot must have
        # exhausted its budget (no masked tail steps at drain)
        if len(self._cols) >= min(self.sync_every, self._max_remaining):
            self.sync(now)

    def sync(self, now: float) -> None:
        """Fetch the buffered tokens/flags (one device-to-host copy for
        the window) and settle completions on the host.  On a paged engine
        the settled boundary is also the scheduling point: parked sessions
        rotate into freed slots here."""
        if self._cols:
            self._settle(now)
        if self._paged is not None:
            self._schedule(now)

    def _settle(self, now: float) -> None:
        """The window's device-to-host copy, which waits for the device to
        finish it (span ``sync.wait``, ``steps`` its columns), then the
        host's bookkeeping (span ``sync.settle``)."""
        cols = self._cols[0] if len(self._cols) == 1 else \
            torch.stack(self._cols, dim=2)
        tr = _trace.active
        if tr is None:
            window = cols.cpu()
        else:
            sp = tr.begin("sync.wait", steps=len(self._cols))
            window = cols.cpu()
            tr.end(sp)
            sp = tr.begin("sync.settle")
        window = window.numpy().reshape(2, self.slots, -1)
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
        if tr is not None:
            tr.end(sp)

    def _recompute_remaining(self) -> None:
        rem = [r.max_new_tokens - len(r.output)
               for r in self.active if r is not None]
        self._max_remaining = max(rem) if rem else self.sync_every

    def _finalize(self, req: Request, now: float) -> None:
        req.finished = now
        if self._paged is not None:
            self._paged.release(req.rid)    # no-op if never reserved
        st = self.stats
        st.completed += 1
        st.ttft_sum += req.ttft - req.arrival
        st.tpot_sum += (now - req.ttft) / max(len(req.output) - 1, 1)
        st.norm_latency_sum += (now - req.arrival) / max(len(req.output), 1)

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
                        and (None in self.active or self._paged is not None):
                    # admit every due arrival that fits (admit_batch
                    # settles the buffered window itself); a paged engine
                    # may also preempt for a due arrival
                    batch = []
                    nfree = self.active.count(None)
                    if self._paged is not None:
                        nfree = max(nfree, 1)
                    while (pending and len(batch) < nfree
                           and pending[0].arrival <= self._clock()):
                        batch.append(pending.pop(0))
                    if batch:
                        n = self.admit_batch(batch, self._clock())
                        if n < len(batch):
                            # pool pressure refused the tail: requeue it
                            # (the earliest arrivals, so order holds)
                            pending = batch[n:] + pending
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
def serve_pd(pre: ServingEngine, dec: ServingEngine,
             requests: Sequence[Request], streamed: bool,
             on_landed: Optional[Callable[[Request, Dict[str, Any]],
                                          None]] = None
             ) -> Tuple[int, int, List[float]]:
    """The reference deployment spec's prefill -> decode loop
    (``LaunchedDeployment.run`` for a prefill pool of one engine and a
    decode pool of one) over ``pre`` and ``dec``, requests in arrival
    order, run to completion.

    Serial: ``pre.prefill_handoff`` for every request, then
    ``dec.admit_handoff`` in order, ``dec`` stepping while it is full;
    ``on_landed(req, handoff)`` is called as each handoff is admitted.
    Streamed: ``pre.prefill_handoff_stream`` into
    ``dec.admit_handoff_stream``, ``dec`` stepping until a slot takes the
    request.  The engines' ``now`` is wall time since the call.  Returns
    (the state bytes on the wire, the shards streamed, the wall of each
    handoff: serial, the prefill and export; streamed, the prefill,
    export and install)."""
    t0 = time.perf_counter()

    def clock():
        return time.perf_counter() - t0

    wire = shards = 0
    walls: List[float] = []
    ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
    if streamed:
        def counted(gen):
            nonlocal wire, shards
            for item in gen:
                if not item.get("header"):
                    wire += item["bytes"]
                    shards += 1
                yield item
        for req in ordered:
            gen = counted(pre.prefill_handoff_stream(req, clock()))
            while True:
                t = time.perf_counter()
                if dec.admit_handoff_stream(req, gen, clock()):
                    walls.append(time.perf_counter() - t)
                    break
                dec.step(clock())       # drain a slot, retry
    else:
        handoffs = []
        for req in ordered:
            t = time.perf_counter()
            h = pre.prefill_handoff(req, clock())
            walls.append(time.perf_counter() - t)
            if not h["done"]:
                wire += h["kv_bytes"]
                handoffs.append((req, h))
        while handoffs:
            while handoffs and dec.admit_handoff(*handoffs[0], clock()):
                req, h = handoffs.pop(0)
                if on_landed is not None:
                    on_landed(req, h)
            if handoffs:
                dec.step(clock())
    while dec._any_active():
        dec.step(clock())
    dec.sync(clock())
    return wire, shards, walls


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
