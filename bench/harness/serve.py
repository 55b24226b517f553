"""One run of one cell: the program's serving engine under the cell's
traffic, a window on the loop's clock, the metrics, the check.

The loop is ``ServingEngine.run``'s, stopped when the window closes: it
admits every due request that fits the free slots through ``admit_batch``
and otherwise queues decode steps through ``step``, which syncs every
``sync_every`` steps.  Before an admission it calls ``sync`` itself (which
``admit_batch`` would do first anyway), so that the tokens settled there
are stamped before the admission's prefill runs.

Every token carries the loop's clock at the moment the harness first sees
it in its request's ``output`` on the host: after ``admit_batch`` returns
(the first token) and after each engine call (the others, which reach the
host at the engine's syncs).  A request is finished when it holds the
tokens it asked for; the closed loop's next request is due at that stamp.
Nothing is read from the engine's own stamps or counters.

Set-up (``setup_s``, from process start to the window's opening): weights
from the seed on the device, the engine, in the Tessera cell the traced
and planned decode step, a warm admission of every slot at the longest
prompt (the largest prefill the engine can form) and a decode step, and
the ramp: the cell's own traffic for ``ramp_s`` seconds, so that the
window opens at steady occupancy.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import check, traffic as TR, weights as WT
from harness.spec import Bench


class Spans:
    """The harness's spans around its calls into the engine: (label,
    start, end) on the loop's clock."""

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, label: str):
        t = self.clock()
        try:
            yield
        finally:
            self.items.append((label, t, self.clock()))


@dataclasses.dataclass
class Admission:
    """One ``admit_batch`` call: the (slot, prompt length) of each
    request, its span."""
    slots: List[Tuple[int, int]]
    t0: float
    t1: float


@dataclasses.dataclass
class Run:
    """What the loop observed; the metric readers' context."""
    cfg: Dict                      # the configuration file
    engine_cfg: Dict
    cell: Dict
    traffic: Dict
    open_: float
    close: float
    setup_s: float
    due: Dict[int, float]
    first: Dict[int, float]
    stamps: Dict[int, List[float]]
    spans: List[Tuple[str, float, float]]
    admissions: List[Admission]
    steps_open: int                # decode steps issued before the window
    steps_close: int               # ... before its close
    decodes: List[Tuple[int, int, int]]  # per request: (k0, P, m)
    extra: Dict[str, float]        # plan_build_s, dispatch_units
    t_trace: Optional[float] = None  # the device trace's start
    steps_trace: Optional[int] = None
    t_host_end: Optional[float] = None  # when the profiler was started
    kernels: Optional[list] = None  # the device trace, loop clock
    busy_s: Optional[float] = None
    merged: Optional[list] = None

    @property
    def window_s(self) -> float:
        return self.close - self.open_

    def in_window(self, t: float) -> bool:
        return self.open_ <= t < self.close

    @property
    def host_window(self) -> Tuple[float, float, range]:
        """(start, end, decode steps) of the part of the window that the
        span metrics read: all of it, or in a traced run the half before
        the device trace starts, which the profiler does not slow."""
        end = self.close if self.t_host_end is None else self.t_host_end
        last = self.steps_close if self.steps_trace is None \
            else self.steps_trace
        return self.open_, end, range(self.steps_open, last)

    @property
    def device_window(self) -> Tuple[float, float, range]:
        """(start, end, decode steps) of the traced part of the window."""
        return self.t_trace, self.close, range(self.steps_trace,
                                               self.steps_close)

    def admissions_in(self, a: float, b: float) -> List[Admission]:
        return [x for x in self.admissions if a <= x.t0 < b]

    def step_rows(self, k: int) -> List[int]:
        """Decode step ``k``: the cache length each active row reads (its
        position + 1).  A request admitted before step k0 with a prompt of
        P tokens that decoded m tokens is at position P + (k - k0) in
        steps k0 .. k0 + m - 1."""
        return [P + k - k0 + 1 for k0, P, m in self.decodes
                if k0 <= k < k0 + m]


def model_config(cfg: Dict):
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def _decode_fn(path: str, mcfg, params, eng_cfg: Dict, device,
               extra: Dict[str, float], clock: Callable[[], float]):
    if path == "eager":
        return None
    if path != "tessera-throughput":
        raise ValueError(f"unknown decode_path {path!r}")
    from repro_torch.launch.serve import disaggregated_decode
    t = clock()
    core = disaggregated_decode(mcfg, params, eng_cfg["slots"],
                                eng_cfg["max_len"], device,
                                policies=("throughput",))
    fn = core["executables"]["throughput"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    extra["plan_build_s"] = clock() - t
    extra["dispatch_units"] = float(fn.num_units)
    return fn


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_process: float,
        tamper: Optional[Callable[[Any], Any]] = None,
        cell_override: Optional[Dict] = None,
        control: bool = False) -> Dict[str, Any]:
    """One run; returns the result dict (without the import check).
    ``tamper(decode_fn_or_None, engine) -> decode_fn`` is the tests'
    hook to break the timed path; ``cell_override`` replaces entries of
    the cell's file (the rate sweep's rates); ``control`` also reads the
    fp8 control on the compared requests (``control.py``, never a
    benchmark run)."""
    from repro_torch.serving.engine import Request, ServingEngine

    clock0 = time.perf_counter

    def clock() -> float:
        return clock0() - t_loop

    t_loop = clock0()
    bench = Bench(root)
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    tr = bench.traffic(wl["traffic"])
    cell = {**bench.cell(workload), **(cell_override or {})}
    E = {**cfg["engine"], **cell.get("engine", {})}
    mcfg = model_config(cfg)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)

    phases: Dict[str, float] = {}

    def mark(name: str) -> None:
        """Set-up's phases, seconds since process start, in order."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases[name] = clock0() - t_process

    mark("imports")
    w = WT.make(cfg, seed, device)
    params = WT.port_params(w, cfg)
    mark("weights")
    extra: Dict[str, float] = {}
    decode_fn = _decode_fn(cell.get("decode_path", "eager"), mcfg, params, E,
                           device, extra, clock)
    eng = ServingEngine(mcfg, params, slots=E["slots"], max_len=E["max_len"],
                        sync_every=E["sync_every"], decode_fn=decode_fn,
                        device=device)
    if tamper is not None:
        eng._decode_custom = tamper(eng._decode_custom, eng)
    mark("engine")

    # --- the loop's records -------------------------------------------
    spans = Spans(clock)
    due: Dict[int, float] = {}
    first: Dict[int, float] = {}
    stamps: Dict[int, List[float]] = {}
    admissions: List[Admission] = []
    admitted_at: Dict[int, int] = {}    # rid -> decode steps before it
    live: Dict[int, Any] = {}
    done: List[Any] = []

    def collect(on_done: Callable[[Any, float], None]) -> None:
        """Stamp the tokens that reached the host since the last look;
        retire each request that holds all it asked for."""
        t = clock()
        for rid, r in list(live.items()):
            ts = stamps[rid]
            if len(r.output) > len(ts):
                ts.extend([t] * (len(r.output) - len(ts)))
                first.setdefault(rid, ts[0])
            if len(ts) >= r.max_new_tokens:
                del live[rid]
                done.append(r)
                on_done(r, t)

    def admit(batch: List[Any], on_done) -> None:
        with spans("sync"):
            eng.sync(clock())
            collect(on_done)
        # the slots admit_batch will fill, in its order
        free = [s for s in range(E["slots"]) if eng.active[s] is None]
        t0 = clock()
        with spans("admit"):
            n = eng.admit_batch(batch, clock())
        if n != len(batch):
            raise RuntimeError(f"admitted {n} of {len(batch)} requests "
                               "with free slots for all")
        admissions.append(Admission([(s, len(r.prompt))
                                     for s, r in zip(free, batch)],
                                    t0, clock()))
        for r in batch:
            admitted_at[r.rid] = eng.stats.decode_steps
            stamps[r.rid] = []
            live[r.rid] = r
        collect(on_done)

    def step() -> None:
        with spans("step"):
            eng.step(clock())

    eng._clock = clock

    # --- warm-up: the largest admission, then decode steps ------------
    P = min(tr["prompt_max"], E["max_len"] - 1)
    warm = [Request(rid=-1 - i, prompt=np.zeros(P, np.int32),
                    max_new_tokens=2) for i in range(E["slots"])]
    admit(warm, lambda r, t: None)
    while any(a is not None for a in eng.active):
        step()
        collect(lambda r, t: None)
    eng.sync(clock())
    collect(lambda r, t: None)
    mark("warm")

    # --- traffic ------------------------------------------------------
    ramp = float(tr["ramp_s"])
    t_open_loop = clock()
    horizon = ramp + seconds
    its = TR.items(tr, cell, E, seed, horizon)
    ids = TR.prompt_ids(seed, its, cfg["vocab_size"])
    reqs = {it.idx: Request(rid=it.idx, prompt=ids[it.idx],
                            max_new_tokens=it.max_new) for it in its}
    pending: collections.deque = collections.deque()
    if tr["loop"] == "open":
        for it in its:
            reqs[it.idx].arrival = t_open_loop + it.due
            pending.append(reqs[it.idx])
        nxt = [len(its)]
    else:
        n0 = tr["clients_per_slot"] * E["slots"]
        for it in its[:n0]:
            reqs[it.idx].arrival = t_open_loop
            pending.append(reqs[it.idx])
        nxt = [n0]
    for r in pending:
        due[r.rid] = r.arrival

    def on_done(r, t: float) -> None:
        """Closed loop: the client sends its next request at ``t``, when
        the harness saw its last one complete."""
        if tr["loop"] != "closed":
            return
        if nxt[0] >= len(its):
            raise RuntimeError("the closed loop ran out of requests")
        q = reqs[its[nxt[0]].idx]
        nxt[0] += 1
        q.arrival = t
        due[q.rid] = q.arrival
        pending.append(q)

    open_ = t_open_loop + ramp
    close = open_ + seconds
    t_trace = open_ + seconds / 2 if trace else None
    t_host_end = None
    dt = None
    opened = False
    steps_open = 0
    steps_trace = None
    peak_setup = 0
    backlog = {}

    def queued(t: float) -> int:
        return sum(r.arrival <= t for r in pending)

    while True:
        now = clock()
        if not opened and now >= open_:
            opened = True
            backlog["open"] = queued(now)
            setup_s = clock0() - t_process
            phases["ramp"] = setup_s
            steps_open = eng.stats.decode_steps
            if device.type == "cuda":
                # the window's peak from here; set-up's (the warm
                # admission of every slot at the longest prompt) apart
                peak_setup = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
        if t_trace is not None and dt is None and now >= t_trace:
            from harness.devtrace import DeviceTrace
            t_host_end = now
            steps_trace = eng.stats.decode_steps
            dt = DeviceTrace(clock)
            dt.start()
            t_trace = dt.t_mark
        if now >= close:
            break
        if pending and pending[0].arrival <= now and None in eng.active:
            nfree = eng.active.count(None)
            batch = []
            while pending and len(batch) < nfree \
                    and pending[0].arrival <= clock():
                batch.append(pending.popleft())
            if batch:
                admit(batch, on_done)
        if not any(r is not None for r in eng.active):
            if pending:
                delay = min(pending[0].arrival, close) - clock()
                if delay > 0:
                    with spans("sleep"):
                        time.sleep(delay)
            continue
        step()
        collect(on_done)
    steps_close = eng.stats.decode_steps
    backlog["close"] = queued(clock())
    if dt is not None:
        dt.stop()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    # settle the steps already issued (their tokens reached the host
    # after the close and count for nothing but the check)
    eng.sync(clock())
    collect(lambda r, t: None)
    # a request the engine let go of short of its tokens is finished too,
    # for the check to count what it lacks
    for rid, r in list(live.items()):
        if not any(a is r for a in eng.active):
            del live[rid]
            done.append(r)

    every = {r.rid: r for r in list(reqs.values()) + warm}
    decodes = [(k0, len(every[rid].prompt), len(every[rid].output) - 1)
               for rid, k0 in admitted_at.items()]
    result = Run(cfg=cfg, engine_cfg=E, cell=cell, traffic=tr, open_=open_,
                 close=close, setup_s=setup_s, due=due, first=first,
                 stamps={k: v for k, v in stamps.items() if k >= 0},
                 spans=spans.items, admissions=admissions,
                 steps_open=steps_open, steps_close=steps_close,
                 decodes=decodes, extra=extra, t_trace=t_trace,
                 steps_trace=steps_trace, t_host_end=t_host_end)
    if dt is not None:
        from harness import devtrace
        result.kernels = dt.kernels()
        result.busy_s, result.merged = devtrace.busy(result.kernels, t_trace,
                                                     close)

    # --- the check, after the program's state is freed ----------------
    finished = [r for r in done if r.rid >= 0]
    del eng, decode_fn, params, live
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    checks = check.run(w, cfg, seed, finished, cell.get("limits", {}),
                       control=control)
    ref_s = clock() - t_ref
    attempted = sum(result.in_window(t) for t in due.values())
    return {"run": result, "checks": checks, "peak": peak,
            "peak_setup": peak_setup,
            "attempted": attempted, "reference_s": ref_s,
            "requests_finished": len(finished), "backlog": backlog,
            "phases": phases}
