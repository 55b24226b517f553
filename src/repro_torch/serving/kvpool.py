"""Paged KV residency and the session-state API — the PyTorch counterpart
of ``repro/serving/kvpool.py``.

* **Paged residency** (`BlockPool`, `PagedKvCache`): a shared
  (layer, block) pool of attention KV.  Every admitted session reserves
  ``ceil(capacity_tokens / block_tokens)`` blocks (plus a fixed block
  cost for recurrent or ring-buffer state, which is not token-paged), so
  admission is gated by free blocks, not free slots.  Sessions
  time-slice through the engine's dense decode batch: "park" packs a
  slot's exported state into its blocks, "activate" gathers it back;
  priority preemption parks the lowest-priority active session, and a
  host tier below the pool takes idle parked sessions (least recently
  used first).  Park -> activate moves bytes and does no arithmetic, so
  resumed greedy decode is bit-identical to never having been parked.

* **Session API** (`KvSlice`, `SessionState`, `SessionManager`):
  ``engine.sessions`` holds ``prefill`` / ``stream`` / ``restore`` /
  ``receive`` / ``checkpoint`` / ``snapshot`` / ``crash`` /
  ``checkpoint_one`` / ``migrate`` / ``prefetch``; the engine's
  ``prefill_handoff{,_stream}``, ``admit_handoff{,_stream}``,
  ``export_sessions`` and ``import_session`` translate to and from the
  older wire dicts.

Device work happens only at sync boundaries of the engine (admission,
park, activate, spill, prefetch, handoff), never inside a decode step.
The pool lives on the engine's device; a spilled session's state is
moved to CPU tensors (``.to("cpu")``) and back (``.to(device)``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import model as M

__all__ = ["KvSlice", "SessionState", "BlockPool", "PagedKvCache",
           "SessionManager", "ShardChecksumError", "kv_checksum"]

State = Dict[str, Dict[str, torch.Tensor]]


class ShardChecksumError(RuntimeError):
    """A streamed shard arrived corrupted (its ``checksum`` does not match
    its state bytes).  :meth:`SessionManager.receive` raises it after
    rolling the reserved slot and blocks back, so the caller can prefill
    again on the receiving engine."""


def kv_checksum(state: State) -> int:
    """crc32 over the bytes of every leaf of a state or shard, in sorted
    key order (as a JAX pytree flattens a dict).  bf16
    leaves are read as their 16-bit patterns.  The values are this
    package's own, not the JAX package's."""
    crc = 0
    for t in M.state_leaves(state):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        crc = zlib.crc32(t.numpy().tobytes(), crc)
    return crc


def _state_to(state: Any, device) -> Any:
    """A copy of a nested dict of tensors on ``device``."""
    if isinstance(state, dict):
        return {k: _state_to(v, device) for k, v in state.items()}
    return None if state is None else state.to(device)


# ===================================================================== #
# Payload dataclasses: the session-state wire format
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class KvSlice:
    """One streamed shard of a session's state: a (component, layer,
    token-range) slice of the cache and its wire size, yielded by
    :meth:`SessionManager.stream` and consumed by
    :meth:`SessionManager.receive`.  ``checksum`` (``stream(checksum=
    True)``) carries the producer's :func:`kv_checksum`; ``klass`` is the
    fabric priority class (0 urgent, 1 bulk)."""
    rid: int
    component: str                      # "kv" / "rwkv" / "mamba"
    layer: int
    t0: Optional[int] = None            # token window [t0, t1) for "kv"
    t1: Optional[int] = None
    state: Any = None                   # batch-1, layer-1 state
    nbytes: int = 0
    checksum: Optional[int] = None
    klass: int = 0

    def verify(self) -> bool:
        """True when no checksum travelled or it matches the state."""
        return (self.checksum is None
                or self.checksum == kv_checksum(self.state))

    def to_legacy(self) -> Dict[str, Any]:
        """The older stream-shard dict."""
        return {"rid": self.rid, "key": self.component,
                "layer": self.layer, "t0": self.t0, "t1": self.t1,
                "state": self.state, "bytes": self.nbytes}

    @classmethod
    def from_legacy(cls, item: Dict[str, Any]) -> "KvSlice":
        return cls(rid=item["rid"], component=item["key"],
                   layer=item["layer"], t0=item.get("t0"),
                   t1=item.get("t1"), state=item["state"],
                   nbytes=item.get("bytes", 0))


@dataclasses.dataclass
class SessionState:
    """A session's portable decode state: the exported KV / recurrent
    state and the decode cursor.  ``first_token_pending`` True: the first
    token has not reached the client yet, so :meth:`SessionManager.
    restore` stamps TTFT on arrival (a handoff); False: the session
    already streamed tokens elsewhere and keeps its clock (migration)."""
    rid: int
    state: Any                          # None when done
    last_tok: int
    pos: int
    budget: int                         # decode tokens remaining
    nbytes: int                         # wire size of ``state``
    done: bool = False
    first_token_pending: bool = True
    priority: int = 0

    def to_legacy(self, header: bool = False) -> Dict[str, Any]:
        """The older handoff dict (``header=True`` marks the final item
        of a shard stream)."""
        d = {"rid": self.rid, "state": self.state,
             "last_tok": self.last_tok, "pos": self.pos,
             "budget": self.budget, "kv_bytes": self.nbytes,
             "done": self.done}
        if header:
            d["header"] = True
        return d

    @classmethod
    def from_legacy(cls, h: Dict[str, Any],
                    first_token_pending: bool = True) -> "SessionState":
        return cls(rid=h["rid"], state=h["state"],
                   last_tok=h["last_tok"], pos=h["pos"],
                   budget=h["budget"], nbytes=h["kv_bytes"],
                   done=h["done"],
                   first_token_pending=first_token_pending)


# ===================================================================== #
# Block pool allocator
# ===================================================================== #
class BlockPool:
    """Free-list allocator over a fixed set of block ids: a block is
    never handed out twice, and ``free + allocated == n_blocks`` after
    any interleaving of alloc and release."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError("pool needs at least one block")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._owner: Dict[int, int] = {}        # block id -> rid

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return len(self._owner)

    def alloc(self, rid: int, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"kv pool exhausted: need {n} blocks, {len(self._free)}"
                f" free of {self.n_blocks}")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            if b in self._owner:
                raise RuntimeError("double allocation")
            self._owner[b] = rid
        return ids

    def release(self, ids: List[int]) -> None:
        for b in ids:
            if b not in self._owner:
                raise ValueError("freeing an unowned block")
            del self._owner[b]
            self._free.append(b)

    def check(self) -> bool:
        """Raise if the bookkeeping is broken; True otherwise."""
        if self.free + self.allocated != self.n_blocks:
            raise RuntimeError("block accounting broken")
        if len(set(self._free)) != self.free:
            raise RuntimeError("free-list duplicate")
        if set(self._free) & set(self._owner):
            raise RuntimeError("block both free and owned")
        return True


# ===================================================================== #
# Paged residency: block tables, tiers, park/activate
# ===================================================================== #
@dataclasses.dataclass
class _Resident:
    """One session's residency record: active in a slot, parked in pool
    blocks ("hbm") or spilled to the host ("host")."""
    req: Any
    block_ids: List[int]
    capacity: int                       # reserved token capacity
    priority: int = 0
    tier: str = "active"                # "active" | "hbm" | "host"
    payload: Any = None                 # components that are not paged
    host: Any = None                    # CPU copy when tier == "host"
    last_tok: int = 0
    pos: int = 0
    budget: int = 0
    seq: int = 0                        # FIFO order for scheduling
    last_use: float = 0.0               # LRU key for spill


class PagedKvCache:
    """The residency layer of a paged engine: a shared (layer, block)
    attention-KV pool on ``device`` and per-session block tables, with a
    host spill tier below it.  The dense per-slot cache stays the
    engine's decode working set; this class owns where resident but
    parked state lives and how many blocks every session has reserved."""

    def __init__(self, cfg, pool_blocks: int, block_tokens: int,
                 max_len: int, *, device: torch.device):
        if pool_blocks < 1 or block_tokens < 1:
            raise ValueError("kv_pool_blocks and kv_block_tokens must be "
                             ">= 1")
        if max_len % block_tokens:
            raise ValueError("max_len must be a multiple of kv_block_tokens")
        self.cfg = cfg
        self.device = device
        self.block_tokens = block_tokens
        self.max_len = max_len
        self.pool = BlockPool(pool_blocks)
        self.resident: Dict[int, _Resident] = {}
        self._seq = 0
        self.spills = 0
        self.prefetches = 0
        self.preemptions = 0

        probe = M.init_cache(cfg, 1, max_len, device="meta")
        counts = M.cache_layer_counts(probe)
        # attention KV is token-paged only when the time axis is a real
        # prefix (a ring buffer's slots follow absolute positions, so the
        # whole ring travels as fixed payload)
        self.token_paged = "kv" in counts and cfg.sliding_window is None
        n_kv = counts.get("kv", cfg.num_layers)
        self.block_bytes = M.kv_block_bytes(cfg, block_tokens, layers=n_kv)
        unpaged = {k: v for k, v in probe.items()
                   if not (self.token_paged and k == "kv")}
        fixed = M.kv_state_bytes(unpaged)
        if self.token_paged:
            self.arrays = L.make_kv_block_pool(cfg, pool_blocks, block_tokens,
                                               device, layers=n_kv)
        else:
            self.arrays = None
        if self.block_bytes == 0:
            # no attention KV anywhere: one session's fixed-size state is
            # the block unit
            self.block_bytes = max(fixed, 1)
        # fixed per-session block cost of the state that is not paged
        self.fixed_blocks = -(-fixed // self.block_bytes) if fixed else 0

    # ---------------------------------------------------------------- #
    # Accounting
    # ---------------------------------------------------------------- #
    def blocks_for(self, tokens: int) -> int:
        """Reserved blocks for a session of ``tokens`` capacity."""
        paged = -(-tokens // self.block_tokens) if self.token_paged else 0
        return max(paged + self.fixed_blocks, 1)

    def util(self) -> float:
        return self.pool.allocated / self.pool.n_blocks

    def holds(self, rid: int) -> bool:
        return rid in self.resident

    def parked(self) -> List[int]:
        """Parked session rids in park order."""
        return sorted((r for r in self.resident
                       if self.resident[r].tier != "active"),
                      key=lambda r: self.resident[r].seq)

    # ---------------------------------------------------------------- #
    # Admission / release
    # ---------------------------------------------------------------- #
    def reserve(self, req: Any, capacity: int, *, spill: bool = True) -> bool:
        """Reserve blocks for a session of ``capacity`` tokens, spilling
        idle parked sessions (LRU) to the host under pressure.  False when
        the pool cannot fit it even after spilling."""
        capacity = min(capacity, self.max_len)
        need = self.blocks_for(capacity)
        while self.pool.free < need and spill and self.spill_lru():
            pass
        if self.pool.free < need:
            return False
        ids = self.pool.alloc(req.rid, need)
        self._seq += 1
        self.resident[req.rid] = _Resident(
            req=req, block_ids=ids, capacity=capacity,
            priority=getattr(req, "priority", 0), seq=self._seq)
        return True

    def release(self, rid: int) -> None:
        ent = self.resident.pop(rid, None)
        if ent is not None and ent.block_ids:
            self.pool.release(ent.block_ids)

    # ---------------------------------------------------------------- #
    # Park / activate: the slot <-> pool data path
    # ---------------------------------------------------------------- #
    def _nblocks(self, pos: int) -> int:
        return -(-max(pos, 1) // self.block_tokens)

    def _pack(self, ent: _Resident, state: State) -> None:
        """Keep ``state`` in ``ent``: the attention KV in its pool blocks
        (when paged), the rest as payload."""
        if self.token_paged and "kv" in state:
            M.pack_kv_blocks(self.arrays, state["kv"],
                             ent.block_ids[:self._nblocks(ent.pos)])
            ent.payload = {k: v for k, v in state.items() if k != "kv"}
        else:
            ent.payload = state

    def _assembled(self, ent: _Resident) -> State:
        """A parked (pool tier) session's whole state, gathered."""
        if self.token_paged and ent.payload is not None and ent.pos > 0 \
                and "kv" not in ent.payload:
            state = dict(ent.payload)
            state["kv"] = M.gather_kv_blocks(
                self.arrays, ent.block_ids[:self._nblocks(ent.pos)], ent.pos)
            return state
        return ent.payload

    def park(self, rid: int, state: State, last_tok: int, pos: int,
             budget: int, now: float = 0.0) -> None:
        """Pack an active session's exported state into its reserved
        blocks (recurrent and ring components ride along as payload)."""
        ent = self.resident[rid]
        if ent.tier != "active":
            raise RuntimeError("parking a non-active session")
        ent.last_tok, ent.pos, ent.budget = last_tok, pos, budget
        self._pack(ent, state)
        ent.tier = "hbm"
        ent.last_use = now
        self._seq += 1
        ent.seq = self._seq

    def activate(self, rid: int, now: float = 0.0
                 ) -> Tuple[State, int, int, int]:
        """Reassemble a parked session's state (prefetching it from the
        host if it was spilled) and mark it active.  Returns ``(state,
        last_tok, pos, budget)``, what :func:`models.model.import_kv`
        installs."""
        ent = self.resident[rid]
        if ent.tier == "active":
            raise RuntimeError("session already active")
        if ent.tier == "host":
            self._prefetch(ent)
        state = self._assembled(ent)
        ent.payload = None
        ent.tier = "active"
        ent.last_use = now
        return state, ent.last_tok, ent.pos, ent.budget

    # ---------------------------------------------------------------- #
    # Host tier: spill to CPU tensors, prefetch back to the device
    # ---------------------------------------------------------------- #
    def spill(self, rid: int) -> None:
        """Move a parked session's whole state to the host and free its
        pool blocks."""
        ent = self.resident[rid]
        if ent.tier != "hbm":
            raise RuntimeError("can only spill a parked session")
        ent.host = _state_to(self._assembled(ent), "cpu")
        ent.payload = None
        self.pool.release(ent.block_ids)
        ent.block_ids = []
        ent.tier = "host"
        self.spills += 1

    def _prefetch(self, ent: _Resident) -> None:
        """Bring a spilled session back into pool blocks."""
        need = self.blocks_for(ent.capacity)
        while self.pool.free < need and self.spill_lru(exclude=ent.req.rid):
            pass
        ent.block_ids = self.pool.alloc(ent.req.rid, need)
        state = _state_to(ent.host, self.device)
        ent.host = None
        if state is not None and "kv" in state and ent.pos > 0:
            self._pack(ent, state)
        else:
            ent.payload = state
        ent.tier = "hbm"
        self.prefetches += 1

    def spill_lru(self, exclude: Optional[int] = None) -> bool:
        """Spill the least recently used parked session; False when none
        is in the pool tier."""
        cands = [(ent.last_use, ent.seq, rid)
                 for rid, ent in self.resident.items()
                 if ent.tier == "hbm" and rid != exclude]
        if not cands:
            return False
        self.spill(min(cands)[2])
        return True

    # ---------------------------------------------------------------- #
    def peek(self, rid: int) -> Tuple[State, int, int, int]:
        """A parked session's state without releasing its blocks or
        changing its tier (the read a periodic checkpoint makes)."""
        ent = self.resident[rid]
        if ent.tier == "active":
            raise RuntimeError("active sessions export via slots")
        state = _state_to(ent.host, self.device) if ent.tier == "host" \
            else self._assembled(ent)
        return state, ent.last_tok, ent.pos, ent.budget

    def assemble(self, rid: int) -> Tuple[State, int, int, int]:
        """:meth:`peek`, then release the session (the checkpoint and
        drain path)."""
        out = self.peek(rid)
        self.release(rid)
        return out


# ===================================================================== #
# SessionManager: the session-state API
# ===================================================================== #
class SessionManager:
    """``engine.sessions``: prefill handoff, streamed shard handoff, live
    migration and peer prefetch over one engine.

    ======================  =========================================
    engine method           session call
    ======================  =========================================
    prefill_handoff         ``prefill(req).to_legacy()``
    prefill_handoff_stream  ``stream(req)`` (KvSlice ... SessionState)
    admit_handoff           ``restore(req, st)`` (first token pending)
    admit_handoff_stream    ``receive(req, slices)``
    export_sessions         ``checkpoint()``
    import_session          ``restore(req, st)`` (token not pending)
    ======================  =========================================

    plus ``migrate(peer)``, ``prefetch(rid, peer)`` (pull one session off
    a peer engine), ``snapshot()`` (a checkpoint that frees nothing) and
    ``crash()`` (lose every session, state not exported)."""

    def __init__(self, engine):
        self.eng = engine

    # ---------------------------------------------------------------- #
    # Producer side: prefill on this engine, state leaves it
    # ---------------------------------------------------------------- #
    def _whole_prefill(self, req, cache1: State):
        """One prefill of ``req``'s prompt into ``cache1`` (the engine's
        bucketing for a batch of one)."""
        eng = self.eng
        plen = len(req.prompt)
        S = eng._prefill_len(plen)
        toks = np.zeros((1, S), np.int32)
        toks[0, :plen] = req.prompt
        toks_d = torch.from_numpy(toks).to(eng.device)
        if eng._prefill_custom is not None:
            return eng._prefill_custom(eng.params, cache1,
                                       toks_d[:, :plen].contiguous())
        last = torch.tensor([plen - 1], dtype=torch.int32, device=eng.device)
        return M.prefill(eng.params, eng.cfg, toks_d, cache1, last_pos=last)

    def _first(self, req, logits, now, sent: int = 0) -> SessionState:
        """Sample the first token and package the session: finalized here
        (``done``) when it ends at prefill, else the cursor."""
        eng = self.eng
        t_ready = eng._ready(now)
        first = int(eng._sample_host(logits)[0])
        eng.stats.prefill_batches += 1
        req.output.append(first)
        plen = len(req.prompt)
        prio = getattr(req, "priority", 0)
        live = req.max_new_tokens > 1 and not (
            eng.eos_id is not None and first == eng.eos_id)
        if not live:            # done at prefill: nothing to hand off
            req.ttft = t_ready
            eng._finalize(req, t_ready)
            return SessionState(rid=req.rid, state=None, last_tok=first,
                                pos=plen, budget=0, nbytes=sent, done=True,
                                first_token_pending=False, priority=prio)
        return SessionState(rid=req.rid, state=None, last_tok=first,
                            pos=plen, budget=req.max_new_tokens - 1,
                            nbytes=sent, done=False,
                            first_token_pending=True, priority=prio)

    def prefill(self, req, now: Optional[float] = None) -> SessionState:
        """Run ``req``'s prompt in a private batch-1 cache (no decode slot)
        and package the state and cursor.  A request that finishes at
        prefill is finalized here and returns ``done=True`` with no state.
        TTFT is not stamped for a live session: it belongs to the engine
        that streams the first token."""
        eng = self.eng
        eng._check_prompt(req)
        plen = len(req.prompt)
        cache1 = M.init_cache(eng.cfg, 1, eng.max_len, device=eng.device)
        logits, cache1 = self._whole_prefill(req, cache1)
        st = self._first(req, logits, now)
        if not st.done:
            st.state = M.export_kv(eng.cfg, cache1, 0, plen)
            st.nbytes = M.kv_state_bytes(st.state)
        return st

    def stream(self, req, now: Optional[float] = None,
               chunk_size: Optional[int] = None, checksum: bool = False,
               klass: int = 0) -> Iterator[Any]:
        """Pipelined :meth:`prefill`: yield :class:`KvSlice` shards as each
        (layer, chunk) is computed, then the :class:`SessionState` cursor
        as the final item (its ``nbytes`` is the total of the shards, its
        ``state`` None).  Consuming the generator drives the prefill
        chunks.  ``checksum`` stamps each shard with :func:`kv_checksum`
        (a host read per shard); ``klass`` stamps its fabric class."""
        eng = self.eng
        eng._check_prompt(req)
        plen = len(req.prompt)
        C = chunk_size or eng.prefill_chunk or plen
        cache1 = M.init_cache(eng.cfg, 1, eng.max_len, device=eng.device)
        sent = 0

        def shard_item(key, layer, t0=None, t1=None):
            shard = M.export_kv_shard(eng.cfg, cache1, 0, key, layer, t0, t1)
            return KvSlice(rid=req.rid, component=key, layer=layer, t0=t0,
                           t1=t1, state=shard,
                           nbytes=M.kv_state_bytes(shard),
                           checksum=kv_checksum(shard) if checksum else None,
                           klass=klass)

        chunked = (eng._prefill_custom is None
                   and eng.cfg.sliding_window is None and C < plen)
        if chunked:
            toks = torch.from_numpy(np.asarray(req.prompt, np.int32)
                                    .reshape(1, plen)).to(eng.device)
            n_kv = M.cache_layer_counts(cache1).get("kv", 0)
            logits = None
            for t0, t1, logits, cache1 in M.iter_prefill_chunks(
                    eng.params, eng.cfg, toks, cache1, chunk_size=C,
                    prefill_call=eng._chunk_call):
                # this chunk's K/V are final in every layer: ship them now
                for layer in range(n_kv):
                    item = shard_item("kv", layer, t0, t1)
                    sent += item.nbytes
                    yield item
        else:
            # ring buffer, injected prefill or a one-chunk prompt
            logits, cache1 = self._whole_prefill(req, cache1)

        for key, n_layers in M.cache_layer_counts(cache1).items():
            if key == "kv" and chunked:
                continue        # already streamed per chunk
            for layer in range(n_layers):
                if key == "kv" and eng.cfg.sliding_window is None:
                    item = shard_item(key, layer, 0, plen)
                else:           # recurrent state / the whole ring
                    item = shard_item(key, layer)
                sent += item.nbytes
                yield item
        yield self._first(req, logits, now, sent=sent)

    # ---------------------------------------------------------------- #
    # Consumer side: state lands on this engine, decode continues
    # ---------------------------------------------------------------- #
    def _free_slot(self) -> Optional[int]:
        eng = self.eng
        free = [s for s in range(eng.slots) if eng.active[s] is None]
        return free[0] if free else None

    def _check_fits(self, st: SessionState) -> None:
        if st.pos >= self.eng.max_len:
            raise ValueError(f"request {st.rid}: imported state of {st.pos} "
                             f"tokens exceeds this engine's max_len "
                             f"{self.eng.max_len}")

    def _start(self, slot: int, req, st: SessionState) -> None:
        """Set ``slot``'s decode cursor from ``st`` and make it live."""
        eng = self.eng
        eng._set_cursor(slot, st.last_tok, st.pos, st.budget)
        eng.active[slot] = req
        eng._ran[slot] = 0
        eng._recompute_remaining()

    def restore(self, req, st: SessionState,
                now: Optional[float] = None) -> bool:
        """Install a session's state and continue decoding here.  Stamps
        TTFT iff ``st.first_token_pending``; a migrated session keeps its
        clock.  False when no slot is free or (paged) the pool cannot fit
        the session even after spilling."""
        eng = self.eng
        if st.done:
            if st.first_token_pending:
                raise ValueError(f"request {st.rid} finished at prefill; "
                                 "there is no decode to admit")
            raise ValueError("finished session cannot migrate")
        self._check_fits(st)
        eng.sync(now)
        slot = self._free_slot()
        if slot is None:
            return False
        if eng._paged is not None and not eng._paged.holds(st.rid):
            cap = min(st.pos + st.budget + 1, eng.max_len)
            if not eng._paged.reserve(req, cap, spill=eng.spill):
                return False
        M.import_kv(eng.cfg, eng.cache, slot, st.state)
        if st.first_token_pending:
            req.ttft = eng._now(now)
        self._start(slot, req, st)
        return True

    def receive(self, req, slices, now: Optional[float] = None) -> bool:
        """Consume a :meth:`stream` (or the older shard dicts): reserve a
        slot, install every shard as it arrives, and start decoding when
        the final :class:`SessionState` lands (TTFT is stamped then).
        False, without consuming anything, when no slot (or, paged, no
        pool room) is free.  A checksummed shard that fails
        :meth:`KvSlice.verify` raises :class:`ShardChecksumError` after
        the slot and blocks are rolled back."""
        eng = self.eng
        eng._check_prompt(req)
        eng.sync(now)
        slot = self._free_slot()
        if slot is None:
            return False
        reserved = False
        if eng._paged is not None and not eng._paged.holds(req.rid):
            cap = min(len(req.prompt) + req.max_new_tokens, eng.max_len)
            if not eng._paged.reserve(req, cap, spill=eng.spill):
                return False
            reserved = True
        # a host-side reservation only: the slot stays masked in the
        # decode step until the cursor makes it live
        eng.active[slot] = req
        header: Optional[SessionState] = None
        # attention-KV shards of one window coalesce into one copy per
        # leaf; stale K/V left in a released slot are masked causally and
        # overwritten by the next admission
        pend: List = []
        pend_win = None

        def flush():
            nonlocal pend, pend_win
            if pend:
                M.import_kv_window(eng.cfg, eng.cache, slot, pend[0][0],
                                   [s for _, s in pend], pend_win[0])
                pend, pend_win = [], None

        try:
            for raw in slices:
                if isinstance(raw, SessionState):
                    header = raw
                    break
                if isinstance(raw, KvSlice):
                    if not raw.verify():
                        raise ShardChecksumError(
                            f"rid {raw.rid}: shard {raw.component}/"
                            f"{raw.layer} arrived corrupted")
                    item = raw.to_legacy()
                else:
                    item = raw
                if item.get("header"):
                    header = SessionState.from_legacy(item)
                    break
                win = (item.get("t0") or 0, item.get("t1"))
                if item["key"] == "kv" and eng.cfg.sliding_window is None:
                    if pend and (pend_win != win or
                                 item["layer"] != pend[0][0] + len(pend)):
                        flush()
                    pend.append((item["layer"], item["state"]))
                    pend_win = pend_win or win
                    continue
                flush()
                M.import_kv_shard(eng.cfg, eng.cache, slot, item["key"],
                                  item["layer"], item["state"], win[0])
            flush()
            if header is None:
                raise ValueError("handoff stream ended without header")
            if not header.done:
                self._check_fits(header)
        except BaseException:
            eng.active[slot] = None    # release the reserved slot
            if reserved:
                eng._paged.release(req.rid)
            raise
        if header.done:             # finished at prefill: free the slot
            eng.active[slot] = None
            if reserved:
                eng._paged.release(req.rid)
            return True
        req.ttft = eng._now(now)
        self._start(slot, req, header)
        return True

    # ---------------------------------------------------------------- #
    # Whole-engine drain / migration / peer prefetch
    # ---------------------------------------------------------------- #
    def _export_active(self, release: bool,
                       only: Optional[int] = None
                       ) -> List[Tuple[Any, SessionState]]:
        """Package the active slots' sessions (only rid ``only`` when
        given); with ``release`` free their slots and blocks."""
        eng = self.eng
        out: List[Tuple[Any, SessionState]] = []
        if all(r is None for r in eng.active):
            return out
        pos, last, budget = eng._cursors()
        for slot in range(eng.slots):
            req = eng.active[slot]
            if req is None or (only is not None and req.rid != only):
                continue
            state = M.export_kv(eng.cfg, eng.cache, slot, int(pos[slot]))
            out.append((req, SessionState(
                rid=req.rid, state=state, last_tok=int(last[slot]),
                pos=int(pos[slot]), budget=int(budget[slot]),
                nbytes=M.kv_state_bytes(state), done=False,
                first_token_pending=False,
                priority=getattr(req, "priority", 0))))
            if release:
                eng.active[slot] = None
                eng.active_mask[slot] = False
                if eng._paged is not None:
                    eng._paged.release(req.rid)
        return out

    def _export_parked(self, rid: int, release: bool
                       ) -> Tuple[Any, SessionState]:
        eng = self.eng
        preq = eng._paged.resident[rid].req
        get = eng._paged.assemble if release else eng._paged.peek
        state, lt, p, b = get(rid)
        return preq, SessionState(
            rid=rid, state=state, last_tok=lt, pos=p, budget=b,
            nbytes=M.kv_state_bytes(state), done=False,
            first_token_pending=False, priority=getattr(preq, "priority", 0))

    def checkpoint(self, now: Optional[float] = None
                   ) -> List[Tuple[Any, SessionState]]:
        """Drain this engine loss-free: settle the buffered window,
        package every resident session (active slots and parked or
        spilled pool residents) with its cursor, and free every slot and
        block.  Sessions keep their clocks."""
        eng = self.eng
        eng.sync(now)
        out = self._export_active(release=True)
        if eng._paged is not None:
            out += [self._export_parked(rid, release=True)
                    for rid in eng._paged.parked()]
        eng._recompute_remaining()
        return out

    def snapshot(self, now: Optional[float] = None
                 ) -> List[Tuple[Any, SessionState]]:
        """:meth:`checkpoint` that frees nothing: decode continues
        untouched.  Exported states are copies, so later decode steps do
        not change a snapshot already taken."""
        eng = self.eng
        eng.sync(now)
        out = self._export_active(release=False)
        if eng._paged is not None:
            out += [self._export_parked(rid, release=False)
                    for rid in eng._paged.parked()]
        return out

    def crash(self, now: Optional[float] = None) -> List[Any]:
        """Lose every resident session without exporting state (fault
        injection): slots and blocks are freed; returns the lost
        requests."""
        eng = self.eng
        eng.sync(now)
        lost: List[Any] = []
        for slot in range(eng.slots):
            req = eng.active[slot]
            if req is None:
                continue
            lost.append(req)
            eng.active[slot] = None
            eng.active_mask[slot] = False
        if eng._paged is not None:
            lost += [eng._paged.resident[rid].req
                     for rid in eng._paged.parked()]
            for rid in list(eng._paged.resident):
                eng._paged.release(rid)
        eng._recompute_remaining()
        return lost

    def checkpoint_one(self, rid: int, now: Optional[float] = None
                       ) -> Optional[Tuple[Any, SessionState]]:
        """Checkpoint one resident session (active or parked) by rid,
        freeing its slot or blocks; None when this engine does not hold
        it."""
        eng = self.eng
        eng.sync(now)
        out = self._export_active(release=True, only=rid)
        if out:
            eng._recompute_remaining()
            return out[0]
        if eng._paged is not None and eng._paged.holds(rid):
            return self._export_parked(rid, release=True)
        return None

    def migrate(self, peer, now: Optional[float] = None) -> int:
        """Move every resident session to ``peer`` (checkpoint, then the
        peer's restore; clocks kept).  A session the peer cannot take is
        restored here again.  Returns the number moved."""
        dst = peer.sessions if hasattr(peer, "sessions") else peer
        moved = 0
        for req, st in self.checkpoint(now):
            if dst.restore(req, st, now):
                moved += 1
            elif not self.restore(req, st, now):
                raise RuntimeError("failed to re-import unmigrated session")
        return moved

    def prefetch(self, rid: int, peer, now: Optional[float] = None) -> bool:
        """Pull one session off ``peer`` into this engine.  False when the
        peer does not hold it or this engine cannot fit it (the session
        goes back to the peer)."""
        src = peer.sessions if hasattr(peer, "sessions") else peer
        item = src.checkpoint_one(rid, now)
        if item is None:
            return False
        req, st = item
        if self.restore(req, st, now):
            return True
        if not src.restore(req, st, now):
            raise RuntimeError("failed to return prefetched session to peer")
        return False
