"""Contended fabric: topology-aware shared channels + a KV-transfer
scheduler.

The point-to-point :class:`~repro_torch.core.simulator.Interconnect` prices a
transfer as if every request owned a private pipe.  Real clusters do
not work that way: groups inside an NVLink island share the island's
switch fabric, islands talk over a handful of PCIe/IB crossings, and a
checkpoint ship to host contends with the KV shard a decode replica is
blocked on.  This module models exactly that:

* :class:`Island` / :class:`Crossing` / :class:`Topology` — a named
  description of the fabric (which groups share an NVLink island, which
  island pairs are bridged, at what bandwidth/latency, full- or
  half-duplex) with a dict/JSON round trip so it rides inside
  ``DeploymentSpec``.
* :class:`ChannelState` — one shared directed channel with
  cross-request queueing.  Two disciplines:

  - ``"fifo"``: a single busy-until timeline; urgent and bulk traffic
    book in dispatch order.
  - ``"priority"`` (the :class:`TransferScheduler` policy):
    decode-blocking KV shards book immediately against the urgent
    timeline, while bulk traffic (checkpoint shipping, session
    migration, spill/prefetch) is *preemptible*: it drains lazily into
    the gaps urgent traffic leaves behind, sliced into as many spans as
    preemption requires.

* :class:`FabricState` — per-run mutable state: lowers ``src -> dst``
  group transfers onto channels, accepts bulk enqueues, materializes
  bulk schedules up to a watermark, and cancels pending bulk whose
  source died.
* :class:`LiveFabric` — accounting twin for launched engines: counts
  real streamed bytes per channel per class and reports the modeled
  channel seconds they would occupy.

Determinism contract: the committed-schedule DES resolves everything in
global dispatch order, so every urgent booking made *after* time ``w``
has ``ready >= w``.  That makes ``w`` a safe bulk watermark — any idle
interval the urgent timeline has left below ``w`` is permanently free,
and bulk can be materialized into it without ever needing to rewrite an
already-emitted event.  (This is the same trick the fast DES core uses:
commit early, never revisit.)

What the model abstracts away (honest caveats, also in the README):
one bottleneck channel per (src, dst) pair — no store-and-forward
multi-hop, no per-link routing inside an island; bulk slices restart
for free after preemption (no re-transmission penalty); FIFO bulk books
at enqueue time and cannot be cancelled.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "URGENT", "BULK", "HOST",
    "Island", "Crossing", "Topology", "TransferScheduler",
    "ChannelState", "FabricState", "LiveChannel", "LiveFabric",
]

# Priority classes.  URGENT is decode-blocking KV movement; BULK is
# everything that can wait (checkpoint shipping, session migration,
# spill/prefetch).
URGENT = 0
BULK = 1

# Pseudo group index for the host-side checkpoint store.
HOST = -1

_EPS = 1e-12

_ISLAND_KEYS = frozenset({"name", "groups", "bw", "latency"})
_CROSSING_KEYS = frozenset({"src", "dst", "bw", "latency", "duplex"})
_TOPOLOGY_KEYS = frozenset(
    {"islands", "crossings", "host_island", "scheduler"})


# ===================================================================== #
# Topology description
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class Island:
    """A set of replica groups behind one shared switch fabric (an
    NVLink island).  Intra-island transfers between *different* groups
    all ride one shared channel with ``bw`` bytes/s and ``latency``
    seconds of per-transfer setup."""
    name: str
    groups: Tuple[int, ...] = ()
    bw: float = 600e9
    latency: float = 5e-6

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("island needs a non-empty name")
        if self.bw <= 0 or self.latency < 0:
            raise ValueError(f"island {self.name!r}: bw must be > 0 and "
                             f"latency >= 0")
        gs = tuple(int(g) for g in self.groups)
        if any(g < 0 for g in gs):
            raise ValueError(f"island {self.name!r}: negative group index")
        if len(set(gs)) != len(gs):
            raise ValueError(f"island {self.name!r}: duplicate group")
        object.__setattr__(self, "groups", gs)


@dataclasses.dataclass(frozen=True)
class Crossing:
    """A bridge between two islands (PCIe switch, IB link, host NIC).
    ``duplex="full"`` gives each direction its own channel; ``"half"``
    makes both directions share ONE channel — the congestion mechanism
    a checkpoint ship exploits when it fights a KV shard headed the
    other way."""
    src: str
    dst: str
    bw: float = 25e9
    latency: float = 50e-6
    duplex: str = "full"

    def __post_init__(self) -> None:
        if self.src == self.dst:
            raise ValueError(f"crossing {self.src!r}->{self.dst!r}: "
                             f"endpoints must differ")
        if self.bw <= 0 or self.latency < 0:
            raise ValueError(f"crossing {self.src!r}->{self.dst!r}: bw must "
                             f"be > 0 and latency >= 0")
        if self.duplex not in ("full", "half"):
            raise ValueError(f"crossing {self.src!r}->{self.dst!r}: duplex "
                             f"must be 'full' or 'half', got {self.duplex!r}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """The fabric: islands, crossings between them, where the host-side
    checkpoint store hangs (``host_island``), and which scheduling
    discipline channels run (``scheduler``: ``"priority"`` or
    ``"fifo"``).

    Lowers a ``src -> dst`` group pair onto a channel key:

    * same island                  -> the island's shared channel
    * islands bridged ``src->dst`` -> that crossing's channel
    * only the reverse crossing exists and it is half-duplex
                                   -> the SAME channel as the reverse
    * anything else                -> ``ValueError``

    Group index ``HOST`` (-1) denotes the host checkpoint store and
    resolves to ``host_island``.
    """
    islands: Tuple[Island, ...]
    crossings: Tuple[Crossing, ...] = ()
    host_island: Optional[str] = None
    scheduler: str = "priority"

    def __post_init__(self) -> None:
        object.__setattr__(self, "islands", tuple(self.islands))
        object.__setattr__(self, "crossings", tuple(self.crossings))
        if not self.islands:
            raise ValueError("topology needs at least one island")
        if self.scheduler not in ("priority", "fifo"):
            raise ValueError(f"scheduler must be 'priority' or 'fifo', "
                             f"got {self.scheduler!r}")
        names = [i.name for i in self.islands]
        if len(set(names)) != len(names):
            raise ValueError("duplicate island name")
        seen: Dict[int, str] = {}
        for isl in self.islands:
            for g in isl.groups:
                if g in seen:
                    raise ValueError(f"group {g} in both {seen[g]!r} and "
                                     f"{isl.name!r}")
                seen[g] = isl.name
        if self.host_island is not None and self.host_island not in names:
            raise ValueError(f"host_island {self.host_island!r} is not a "
                             f"declared island")
        xs = set()
        for x in self.crossings:
            if x.src not in names or x.dst not in names:
                raise ValueError(f"crossing {x.src!r}->{x.dst!r} references "
                                 f"an undeclared island")
            if (x.src, x.dst) in xs:
                raise ValueError(f"duplicate crossing {x.src!r}->{x.dst!r}")
            xs.add((x.src, x.dst))
        for x in self.crossings:
            if (x.duplex == "half" and (x.dst, x.src) in xs):
                raise ValueError(f"half-duplex crossing {x.src!r}->{x.dst!r} "
                                 f"conflicts with a declared reverse crossing")
        # Eager reachability: every ordered island pair that can source
        # a transfer (has groups, or is the host island) must resolve.
        ends = [i.name for i in self.islands
                if i.groups or i.name == self.host_island]
        for a in ends:
            for b in ends:
                if a != b:
                    self._crossing_of(a, b)  # raises if unreachable

    # -- lowering ----------------------------------------------------- #
    def island_of(self, group: int) -> Island:
        if group == HOST:
            if self.host_island is None:
                raise ValueError("transfer touches the host but the "
                                 "topology declares no host_island")
            for isl in self.islands:
                if isl.name == self.host_island:
                    return isl
        for isl in self.islands:
            if group in isl.groups:
                return isl
        raise ValueError(f"group {group} is not on any island")

    def _crossing_of(self, a: str, b: str) -> Tuple[Crossing, Tuple]:
        for x in self.crossings:
            if x.src == a and x.dst == b:
                return x, ("x", a, b)
        for x in self.crossings:
            if x.src == b and x.dst == a and x.duplex == "half":
                return x, ("x", b, a)          # shared with the reverse
        raise ValueError(f"no crossing routes {a!r} -> {b!r}")

    def channel_key(self, src: int, dst: int) -> Optional[Tuple]:
        """Channel key for a src->dst group transfer, or ``None`` when
        no fabric hop is involved (same group)."""
        if src == dst:
            return None
        a, b = self.island_of(src), self.island_of(dst)
        if a.name == b.name:
            return ("isl", a.name)
        _, key = self._crossing_of(a.name, b.name)
        return key

    def channel_params(self, key: Tuple) -> Tuple[float, float]:
        """(bw, latency) of a channel key."""
        if key[0] == "isl":
            for isl in self.islands:
                if isl.name == key[1]:
                    return isl.bw, isl.latency
            raise KeyError(key)
        for x in self.crossings:
            if x.src == key[1] and x.dst == key[2]:
                return x.bw, x.latency
        raise KeyError(key)

    def planner_bw(self, group: int) -> float:
        """Effective KV/activation bandwidth the *planner* should
        assume for intra-group kernel placement: the group's island
        fabric, derated by how many co-resident groups share it (see
        :func:`repro_torch.core.planner.contended_bw`)."""
        from repro_torch.core.planner import contended_bw
        isl = self.island_of(group)
        return contended_bw(isl.bw, len(isl.groups))

    # -- dict / JSON round trip --------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "islands": [{"name": i.name, "groups": list(i.groups),
                         "bw": i.bw, "latency": i.latency}
                        for i in self.islands],
        }
        if self.crossings:
            d["crossings"] = [{"src": x.src, "dst": x.dst, "bw": x.bw,
                               "latency": x.latency, "duplex": x.duplex}
                              for x in self.crossings]
        if self.host_island is not None:
            d["host_island"] = self.host_island
        if self.scheduler != "priority":
            d["scheduler"] = self.scheduler
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Topology":
        if not isinstance(d, dict):
            raise ValueError(f"fabric must be a dict, got {type(d).__name__}")
        extra = set(d) - _TOPOLOGY_KEYS
        if extra:
            raise ValueError(f"unknown fabric key(s): {sorted(extra)}")
        islands = []
        for idat in d.get("islands", ()):
            extra = set(idat) - _ISLAND_KEYS
            if extra:
                raise ValueError(f"unknown island key(s): {sorted(extra)}")
            islands.append(Island(name=idat.get("name", ""),
                                  groups=tuple(idat.get("groups", ())),
                                  bw=float(idat.get("bw", 600e9)),
                                  latency=float(idat.get("latency", 5e-6))))
        crossings = []
        for xdat in d.get("crossings", ()):
            extra = set(xdat) - _CROSSING_KEYS
            if extra:
                raise ValueError(f"unknown crossing key(s): {sorted(extra)}")
            crossings.append(Crossing(src=xdat.get("src", ""),
                                      dst=xdat.get("dst", ""),
                                      bw=float(xdat.get("bw", 25e9)),
                                      latency=float(xdat.get("latency",
                                                             50e-6)),
                                      duplex=xdat.get("duplex", "full")))
        return cls(islands=tuple(islands), crossings=tuple(crossings),
                   host_island=d.get("host_island"),
                   scheduler=d.get("scheduler", "priority"))

    def bind(self, n_groups: int) -> "FabricState":
        """Per-run mutable state.  Validates that every group the run
        will place work on is on some island."""
        for g in range(n_groups):
            self.island_of(g)
        return FabricState(self, n_groups)


# The scheduler is the policy half of the channel: it decides how the
# two classes share a timeline.  Kept as an explicit object so the
# discipline is nameable/configurable ("priority" vs "fifo") rather
# than baked into ChannelState.
@dataclasses.dataclass(frozen=True)
class TransferScheduler:
    """Channel discipline.  ``"priority"``: urgent (decode-blocking KV)
    books immediately and preempts; bulk drains into the gaps, sliced
    as needed.  ``"fifo"``: one timeline, both classes book in dispatch
    order."""
    policy: str = "priority"

    def __post_init__(self) -> None:
        if self.policy not in ("priority", "fifo"):
            raise ValueError(f"unknown scheduler policy {self.policy!r}")

    def make_channel(self, key: Tuple, bw: float, latency: float
                     ) -> "ChannelState":
        return ChannelState(key, bw, latency, self.policy)


# ===================================================================== #
# One shared channel
# ===================================================================== #
class ChannelState:
    """Mutable schedule of one shared directed channel.

    Priority discipline invariants (the tests enforce these):

    * ``urgent_free`` only advances, and every urgent booking starts at
      ``max(ready, urgent_free)`` — urgent traffic NEVER waits for bulk.
    * Idle intervals below ``urgent_free`` are recorded in ``_gaps``;
      once recorded they are permanently free (any future urgent
      booking has ``ready >=`` the current watermark), so bulk can fill
      them without rewriting history.
    * Bulk is served strictly in ``(ready, seq)`` order, one segment at
      a time (``_cur`` holds the partially-served head), so completion
      order within the bulk class never inverts.
    * Byte conservation: the sum of emitted slice durations for a bulk
      tag equals its full ``latency + nbytes/bw`` duration.
    """

    __slots__ = ("key", "bw", "latency", "policy",
                 "urgent_free", "free", "busy", "wait", "nbytes",
                 "bulk_busy", "bulk_bytes", "bulk_ptr",
                 "_gaps", "_pend", "_cur", "_seq", "_done", "_order",
                 "_cancel")

    def __init__(self, key: Tuple, bw: float, latency: float,
                 policy: str = "priority") -> None:
        self.key = key
        self.bw = float(bw)
        self.latency = float(latency)
        self.policy = policy
        self.urgent_free = 0.0      # priority: urgent timeline head
        self.free = 0.0             # fifo: single timeline head
        self.busy = 0.0             # urgent seconds booked
        self.wait = 0.0             # urgent queueing delay (start-ready)
        self.nbytes = 0.0           # urgent bytes moved
        self.bulk_busy = 0.0        # bulk seconds emitted
        self.bulk_bytes = 0.0       # bulk bytes completed
        self.bulk_ptr = 0.0         # furthest bulk emission past urgent_free
        self._gaps: List[List[float]] = []   # settled idle [s, e) slots
        self._pend: List[Tuple] = []         # heap: (ready, seq, dur, nbytes, tag, src, dst, rid)
        self._cur: Optional[List] = None     # [resume_at, dur_left, nbytes, tag, src, dst, rid]
        self._seq = 0
        self._done: Dict[Any, float] = {}    # bulk tag -> completion time
        self._order: List[Any] = []          # bulk tags in service order
        self._cancel: set = set()

    # -- urgent class -------------------------------------------------- #
    def head(self) -> float:
        """Time the next urgent byte could start moving."""
        return self.urgent_free if self.policy == "priority" else self.free

    def duration(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bw

    def commit_urgent(self, spans: Iterable[Tuple[float, float]],
                      ready: float, nbytes: float) -> None:
        """Book an urgent transfer whose spans were computed against
        ``head()``.  Under priority, idle intervals skipped over become
        permanent bulk gaps."""
        spans = list(spans)
        if not spans:
            return
        self.wait += max(0.0, spans[0][0] - ready)
        self.nbytes += nbytes
        for s, e in spans:
            self.busy += e - s
            if self.policy == "priority":
                a0 = max(self.urgent_free, self._open_ptr())
                if s > a0 + _EPS:
                    self._gaps.append([a0, s])
                if e > self.urgent_free:
                    self.urgent_free = e
            else:
                if e > self.free:
                    self.free = e

    def _open_ptr(self) -> float:
        # How far the open region past the last urgent booking has
        # already been consumed by bulk.
        return max(self.urgent_free, self.bulk_ptr)

    # -- bulk class ---------------------------------------------------- #
    def enqueue_bulk(self, ready: float, nbytes: float, tag: Any,
                     src: int, dst: int, rid: int,
                     sink: Optional[Callable] = None) -> None:
        if nbytes <= 0:
            self._done[tag] = ready
            self._order.append(tag)
            return
        dur = self.duration(nbytes)
        if self.policy == "fifo":
            # FIFO books at enqueue, in dispatch order, one timeline.
            s = max(ready, self.free)
            e = s + dur
            self.free = e
            self.bulk_busy += dur
            self.bulk_bytes += nbytes
            self._done[tag] = e
            self._order.append(tag)
            if sink is not None:
                sink(src, dst, rid, s, e)
            return
        heapq.heappush(self._pend,
                       (ready, self._seq, dur, nbytes, tag, src, dst, rid))
        self._seq += 1

    def materialize(self, w: float, sink: Optional[Callable] = None) -> None:
        """Serve pending bulk into settled capacity strictly below the
        watermark ``w``.  Safe whenever every future urgent booking is
        guaranteed ``ready >= w`` (true in dispatch order)."""
        if self.policy == "fifo":
            return
        while True:
            if self._cur is None:
                nxt = None
                while self._pend:
                    cand = self._pend[0]
                    if cand[4] in self._cancel:
                        heapq.heappop(self._pend)
                        self._cancel.discard(cand[4])
                        continue
                    nxt = cand
                    break
                if nxt is None or nxt[0] >= w:
                    return
                heapq.heappop(self._pend)
                ready, _, dur, nbytes, tag, src, dst, rid = nxt
                self._cur = [ready, dur, nbytes, tag, src, dst, rid]
                self._order.append(tag)
            cur = self._cur
            if cur[3] in self._cancel:
                self._cancel.discard(cur[3])
                self._cur = None
                continue
            s, cap, gi = self._slot(cur[0], w)
            if s is None:
                return
            take = min(cur[1], cap - s)
            e = s + take
            if sink is not None:
                sink(cur[4], cur[5], cur[6], s, e)
            self._consume(gi, s, e)
            self.bulk_busy += take
            cur[1] -= take
            if cur[1] <= _EPS:
                self._done[cur[3]] = e
                self.bulk_bytes += cur[2]
                self._cur = None
            else:
                cur[0] = e

    def _slot(self, r: float, w: float):
        """Earliest idle [s, cap) at or after ``r`` and strictly below
        ``w``: first a settled gap, else the open region past the
        urgent timeline.  Returns (start, cap, gap_index|None)."""
        for gi, (g0, g1) in enumerate(self._gaps):
            if g1 <= r + _EPS or g0 >= w:
                continue
            s = max(g0, r)
            if s < min(g1, w) - _EPS:
                return s, min(g1, w), gi
        s = max(self._open_ptr(), r)
        if s < w - _EPS:
            return s, w, None
        return None, None, None

    def _consume(self, gi: Optional[int], s: float, e: float) -> None:
        if gi is None:
            # Open region: remember progress so the next urgent commit
            # does not re-record [urgent_free, e) as a free gap.
            if e > self.bulk_ptr:
                self.bulk_ptr = e
            return
        g0, g1 = self._gaps[gi]
        frags = []
        if g0 < s - _EPS:
            frags.append([g0, s])
        if e < g1 - _EPS:
            frags.append([e, g1])
        self._gaps[gi:gi + 1] = frags

    def cancel_bulk(self, pred: Callable[[Any, int], bool]) -> int:
        """Cancel pending (un-started remainder of) bulk segments whose
        ``pred(tag, src)`` holds.  Already-emitted slices stay — that
        bandwidth was genuinely spent."""
        n = 0
        for item in self._pend:
            if item[4] not in self._cancel and pred(item[4], item[5]):
                self._cancel.add(item[4])
                n += 1
        cur = self._cur
        if (cur is not None and cur[3] not in self._cancel
                and pred(cur[3], cur[4])):
            self._cancel.add(cur[3])
            n += 1
        return n

    def done_at(self, tag: Any) -> Optional[float]:
        return self._done.get(tag)

    def completions(self) -> List[Tuple[Any, float]]:
        """(tag, completion) in bulk service order (completed only)."""
        return [(t, self._done[t]) for t in self._order if t in self._done]


# ===================================================================== #
# Per-run fabric state
# ===================================================================== #
class FabricState:
    """Channels + lowering for one simulation/launch run.  The
    simulator points ``sink`` at its event log so bulk slices emit
    ``FABRIC_BULK`` events when they materialize."""

    def __init__(self, topo: Topology, n_groups: int) -> None:
        self.topo = topo
        self.n_groups = n_groups
        self.scheduler = TransferScheduler(topo.scheduler)
        self._channels: Dict[Tuple, ChannelState] = {}
        self.sink: Optional[Callable[[int, int, int, float, float], None]] \
            = None
        self.bulk_enqueued = 0

    def channel(self, src: int, dst: int) -> Optional[ChannelState]:
        key = self.topo.channel_key(src, dst)
        if key is None:
            return None
        ch = self._channels.get(key)
        if ch is None:
            bw, lat = self.topo.channel_params(key)
            ch = self.scheduler.make_channel(key, bw, lat)
            self._channels[key] = ch
        return ch

    def channels(self) -> List[ChannelState]:
        return list(self._channels.values())

    # -- bulk traffic -------------------------------------------------- #
    def enqueue_bulk(self, src: int, dst: int, rid: int, nbytes: float,
                     ready: float, tag: Any) -> None:
        ch = self.channel(src, dst)
        if ch is None:
            return
        self.bulk_enqueued += 1
        ch.enqueue_bulk(ready, nbytes, tag, src, dst, rid, self.sink)

    def materialize(self, w: float) -> None:
        for ch in self._channels.values():
            ch.materialize(w, self.sink)

    def flush(self) -> None:
        self.materialize(float("inf"))

    def cancel_src(self, group: int, now: float) -> int:
        """A group died at ``now``: finish accounting up to ``now``,
        then cancel every not-yet-started bulk remainder sourced from
        it (its memory is gone; there is nothing left to ship)."""
        self.materialize(now)
        n = 0
        for ch in self._channels.values():
            n += ch.cancel_bulk(lambda tag, src: src == group)
        return n

    def ships_done(self, ship: Optional[Tuple[int, int, int]],
                   t: float) -> int:
        """How many checkpoint ships of record ``ship = (group, seq,
        K)`` completed by time ``t``.  Materializes to ``t`` first —
        safe because ``t`` is the fault time currently being applied in
        dispatch order."""
        if ship is None:
            return 0
        g, seq, total = ship
        ch = self.channel(g, HOST)
        if ch is None:
            return 0
        ch.materialize(t, self.sink)
        k = 0
        for j in range(1, total + 1):
            at = ch.done_at(("ckpt", seq, j))
            if at is not None and at <= t:
                k += 1
        return k

    # -- run-level accounting ------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        chs = self._channels.values()
        return {
            "wait_seconds": sum(c.wait for c in chs),
            "urgent_seconds": sum(c.busy for c in chs),
            "urgent_bytes": sum(c.nbytes for c in chs),
            "bulk_seconds": sum(c.bulk_busy for c in chs),
            "bulk_bytes": sum(c.bulk_bytes for c in chs),
        }

    def ckpt_completed(self) -> int:
        n = 0
        for ch in self._channels.values():
            for tag in ch._done:
                if isinstance(tag, tuple) and tag and tag[0] == "ckpt":
                    n += 1
        return n


# ===================================================================== #
# Live accounting twin
# ===================================================================== #
class LiveChannel:
    """Accounting-only channel for launched engines: counts real bytes
    streamed per class and reports the modeled seconds they occupy."""

    __slots__ = ("key", "bw", "latency", "bytes_by_class",
                 "transfers_by_class")

    def __init__(self, key: Tuple, bw: float, latency: float) -> None:
        self.key = key
        self.bw = float(bw)
        self.latency = float(latency)
        self.bytes_by_class = {URGENT: 0, BULK: 0}
        self.transfers_by_class = {URGENT: 0, BULK: 0}

    def account(self, nbytes: int, klass: int = URGENT) -> None:
        self.bytes_by_class[klass] += int(nbytes)
        self.transfers_by_class[klass] += 1

    def wrap(self, shards: Iterable[Any], klass: int = URGENT
             ) -> Iterator[Any]:
        """Pass shards through, counting each stamped shard's
        ``nbytes``.  Only items carrying a ``klass`` attribute (typed
        :class:`~repro_torch.serving.kvpool.KvSlice` shards) are accounted —
        the terminal ``SessionState`` cursor's ``nbytes`` is the TOTAL
        of the shards already counted, so it must not be re-charged.
        A shard's own ``klass`` stamp overrides the stream default."""
        for item in shards:
            k = getattr(item, "klass", None)
            if k is not None:
                nb = getattr(item, "nbytes", 0) or 0
                if nb:
                    self.account(nb, k)
            yield item

    def modeled_seconds(self, klass: int) -> float:
        n = self.transfers_by_class[klass]
        return n * self.latency + self.bytes_by_class[klass] / self.bw


class LiveFabric:
    """Per-launch accounting: one :class:`LiveChannel` per fabric
    channel, same lowering as the DES."""

    def __init__(self, topo: Topology, n_groups: int) -> None:
        for g in range(n_groups):
            topo.island_of(g)
        self.topo = topo
        self._channels: Dict[Tuple, LiveChannel] = {}

    def channel(self, src: int, dst: int) -> Optional[LiveChannel]:
        key = self.topo.channel_key(src, dst)
        if key is None:
            return None
        ch = self._channels.get(key)
        if ch is None:
            bw, lat = self.topo.channel_params(key)
            ch = LiveChannel(key, bw, lat)
            self._channels[key] = ch
        return ch

    def account_ckpt(self, src: int, nbytes: int) -> None:
        """Checkpoint bytes shipped src -> host as bulk traffic."""
        ch = self.channel(src, HOST)
        if ch is not None and nbytes > 0:
            ch.account(nbytes, BULK)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"urgent_bytes": 0, "bulk_bytes": 0,
                               "urgent_seconds": 0.0, "bulk_seconds": 0.0}
        for ch in self._channels.values():
            out["urgent_bytes"] += ch.bytes_by_class[URGENT]
            out["bulk_bytes"] += ch.bytes_by_class[BULK]
            out["urgent_seconds"] += ch.modeled_seconds(URGENT)
            out["bulk_seconds"] += ch.modeled_seconds(BULK)
        return out
