"""Open-loop trace generation for cluster-scale serving experiments.

Real serving traffic is open-loop (arrivals do not wait for service) and
bursty; the cluster benchmarks and tests drive the simulator with traces
from four arrival processes:

  * ``poisson``  — homogeneous Poisson at ``rate`` req/s,
  * ``bursty``   — 2-state MMPP: ON periods at ``burst_factor`` x the
    base rate alternating with quiet OFF periods (same long-run rate),
  * ``diurnal``  — sinusoidally modulated rate (a compressed day/night
    cycle), sampled by thinning against the peak rate,
  * ``chat``     — multi-turn sessions with accumulated context: each
    turn's prompt extends the conversation so far (the workload paged
    KV and session-cache hits are built for).

Request sizes come from a mixture of named request classes (chat,
summarization, generation) with lognormal prompt lengths and geometric
output lengths — heavy-tailed, as production traces are.  Requests can
continue an existing *session* (multi-turn chat): the router uses the
session id for decode/KV affinity.

Everything is driven by ``random.Random(seed)`` — traces are
deterministic and portable across runs and machines.

Generation is vectorized: each generator transplants its
``random.Random`` MT19937 state into a ``numpy.random.RandomState``
(the SAME generator, so the uniform stream is bit-identical) and
applies the arrival/length transforms to whole blocks.  Two numpy
caveats keep the sequences exactly equal to the historical per-request
``random`` calls (regression-tested in tests/test_workload_vec.py):

  * ``np.log``/``np.exp`` take SIMD paths that differ from libm in the
    last ulp on this numpy, so log/exp transforms go through
    ``math.log``/``math.exp`` element-wise (``_log_seq``/``_exp_seq``);
    ``sin``/``cos``/``sqrt``/``cumsum`` are bit-identical and stay
    vectorized,
  * ``random.gauss`` consumes two uniforms on every other call (the
    Box–Muller sine value is cached), so the length sampler indexes the
    uniform block in that 6-per-request-pair pattern.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TWOPI = 2.0 * math.pi


class _UniformStream:
    """Bit-exact numpy view of a ``random.Random`` uniform stream.

    Transplants the Mersenne-Twister state, so ``take(n)`` returns
    exactly the floats ``n`` successive ``rng.random()`` calls would
    have produced (both generators derive doubles from the same 624-word
    state with the same 53-bit recipe).
    """

    def __init__(self, rng: random.Random):
        key = rng.getstate()[1]         # 624 words + position
        self._rs = np.random.RandomState()
        self._rs.set_state(("MT19937",
                            np.asarray(key[:-1], dtype=np.uint32),
                            key[-1], 0, 0.0))

    def take(self, n: int) -> np.ndarray:
        return self._rs.random_sample(n)


def _log_seq(x: np.ndarray) -> np.ndarray:
    """Element-wise ``math.log`` (libm, not numpy's SIMD variant)."""
    return np.fromiter(map(math.log, x.tolist()),
                       dtype=np.float64, count=len(x))


def _exp_seq(x: np.ndarray) -> np.ndarray:
    """Element-wise ``math.exp`` (libm, not numpy's SIMD variant)."""
    return np.fromiter(map(math.exp, x.tolist()),
                       dtype=np.float64, count=len(x))


def _exp_gaps(u: np.ndarray, rate: float) -> np.ndarray:
    """``rng.expovariate(rate)`` applied to a uniform block:
    ``-log(1 - u) / rate``, the exact CPython expression."""
    return np.negative(_log_seq(1.0 - u)) / rate


@dataclasses.dataclass(frozen=True)
class WorkloadRequest:
    rid: int
    arrival: float              # seconds since trace start
    prompt_tokens: int
    output_tokens: int
    session: Optional[int] = None   # multi-turn conversation id
    slo: Optional[float] = None     # completion deadline (s of latency)
    slo_ttft: Optional[float] = None    # first-token deadline (s)
    priority: int = 0           # brown-out shedding order (higher
    #                             survives longer; see router health)


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One mode of the length mixture."""
    name: str
    weight: float
    prompt_median: int          # lognormal median of prompt length
    prompt_sigma: float         # lognormal shape
    output_mean: int            # geometric mean of output length


# Default mixture, loosely shaped like public serving traces: mostly
# chat, some long-prompt summarization, some long-output generation.
DEFAULT_MIX: Tuple[RequestClass, ...] = (
    RequestClass("chat", 0.70, prompt_median=256, prompt_sigma=0.8,
                 output_mean=128),
    RequestClass("summarize", 0.15, prompt_median=2048, prompt_sigma=0.5,
                 output_mean=64),
    RequestClass("generate", 0.15, prompt_median=128, prompt_sigma=0.6,
                 output_mean=512),
)

_MAX_PROMPT = 16384
_MAX_OUTPUT = 4096


def _sample_lengths_block(rng: random.Random, n: int,
                          mix: Sequence[RequestClass]
                          ) -> Tuple[List[int], List[int]]:
    """Vectorized length sampler: (prompts, outputs) for ``n`` requests.

    Reproduces, bit-for-bit, ``n`` sequential draws of the historical
    per-request sampler (class pick, ``gauss`` lognormal prompt,
    geometric output).  ``rng.gauss`` consumes two uniforms on
    even-numbered calls and zero on odd ones (Box–Muller caches the sine
    value), so a request PAIR consumes six uniforms in the fixed order
    [class0, gauss_a, gauss_b, out0, class1, out1].
    """
    if n <= 0:
        return [], []
    pairs_full = n // 2             # pairs with an odd member present
    pairs = (n + 1) // 2            # even members (incl. trailing half)
    u = _UniformStream(rng).take(6 * pairs)
    base = 6 * np.arange(pairs)
    base_full = base[:pairs_full]

    # class pick: first class whose cumulative weight >= r
    acc: List[float] = []
    total = 0.0
    for c in mix:
        total += c.weight
        acc.append(total)
    c_u = np.empty(n)
    c_u[0::2] = u[base]
    c_u[1::2] = u[base_full + 4]
    r = c_u * sum(c.weight for c in mix)
    idx = np.minimum(np.searchsorted(np.asarray(acc), r, side="left"),
                     len(mix) - 1)

    # Box–Muller exactly as random.gauss: cos branch for even calls,
    # cached sin branch for odd calls
    x2pi = u[base + 1] * _TWOPI
    g2rad = np.sqrt(-2.0 * _log_seq(1.0 - u[base + 2]))
    z = np.empty(n)
    z[0::2] = np.cos(x2pi) * g2rad
    z[1::2] = (np.sin(x2pi) * g2rad)[:pairs_full]

    med = np.asarray([float(c.prompt_median) for c in mix])[idx]
    sig = np.asarray([c.prompt_sigma for c in mix])[idx]
    prompt = (med * _exp_seq(0.0 + z * sig)).astype(np.int64)
    np.clip(prompt, 1, _MAX_PROMPT, out=prompt)

    o_u = np.empty(n)
    o_u[0::2] = u[base + 3]
    o_u[1::2] = u[base_full + 5]
    om = np.asarray([float(c.output_mean) for c in mix])[idx]
    output = 1 + (np.negative(om)
                  * _log_seq(np.maximum(o_u, 1e-12))).astype(np.int64)
    np.clip(output, 1, _MAX_OUTPUT, out=output)
    return prompt.tolist(), output.tolist()


def _attach_sessions(rng: random.Random, n: int, follow_prob: float,
                     session_pool: int = 64) -> List[Optional[int]]:
    """With prob ``follow_prob`` a request continues a live session.

    ``session_pool`` bounds the working set of live sessions (the
    population a follow-up draws from); the default 64 preserves the
    historical uniform stream bit-for-bit.
    """
    # Stays scalar: rng.choice draws a data-dependent number of random
    # words (rejection sampling over the live-list length), so the
    # uniform stream cannot be pre-split; bound methods keep it cheap.
    sessions: List[Optional[int]] = []
    append = sessions.append
    rand, choice = rng.random, rng.choice
    live: List[int] = []
    next_sid = 0
    for _ in range(n):
        if live and rand() < follow_prob:
            append(choice(live))
        else:
            append(next_sid)
            live.append(next_sid)
            if len(live) > session_pool:    # bounded working set
                live.pop(0)
            next_sid += 1
    return sessions


def _finish(arrivals: List[float], seed: int,
            mix: Sequence[RequestClass],
            session_follow: float,
            session_pool: int = 64) -> List[WorkloadRequest]:
    rng = random.Random(f"{seed}:lengths")
    sessions = _attach_sessions(random.Random(f"{seed}:sessions"),
                                len(arrivals), session_follow,
                                session_pool)
    prompts, outputs = _sample_lengths_block(rng, len(arrivals), mix)
    return [WorkloadRequest(rid=i, arrival=t, prompt_tokens=p,
                            output_tokens=o, session=s)
            for i, (t, p, o, s) in enumerate(
                zip(sorted(arrivals), prompts, outputs, sessions))]


# --------------------------------------------------------------------- #
def poisson_trace(rate: float, num_requests: int, seed: int = 0,
                  mix: Sequence[RequestClass] = DEFAULT_MIX,
                  session_follow: float = 0.3,
                  session_pool: int = 64) -> List[WorkloadRequest]:
    u = _UniformStream(random.Random(f"{seed}:poisson")).take(num_requests)
    arrivals = np.cumsum(_exp_gaps(u, rate)).tolist()
    return _finish(arrivals, seed, mix, session_follow, session_pool)


def bursty_trace(rate: float, num_requests: int, seed: int = 0,
                 burst_factor: float = 6.0, on_fraction: float = 0.1,
                 period: float = 0.0,
                 mix: Sequence[RequestClass] = DEFAULT_MIX,
                 session_follow: float = 0.3,
                 session_pool: int = 64) -> List[WorkloadRequest]:
    """2-state MMPP with the same long-run rate as ``poisson_trace``.

    ON state: ``burst_factor * rate``; OFF state: the remainder so the
    time-average stays ``rate`` — which requires the ON state to carry
    less than the whole budget: ``burst_factor * on_fraction < 1``.
    Mean cycle length defaults to the time of ~20 requests.
    """
    assert burst_factor * on_fraction < 1.0, \
        "burst_factor * on_fraction must be < 1 to preserve the " \
        "long-run rate (the OFF-state rate would go negative)"
    stream = _UniformStream(random.Random(f"{seed}:bursty"))
    period = period or 20.0 / rate
    on_rate = burst_factor * rate
    off_rate = rate * (1.0 - burst_factor * on_fraction) \
        / (1.0 - on_fraction)
    # The state machine is inherently sequential (state flips depend on
    # prior draws), but the expensive part — libm log per draw — batches:
    # precompute -log(1-u) blocks in draw order; expovariate(lam) is
    # then one divide per draw, matching CPython's -log(1-u)/lam bits.
    block: List[float] = []
    k = 0

    def draw() -> float:
        nonlocal block, k
        if k == len(block):
            block = np.negative(_log_seq(1.0 - stream.take(8192))).tolist()
            k = 0
        e = block[k]
        k += 1
        return e

    # precomputed constants equal the per-iteration 1/mean expressions
    inv_on = 1.0 / (period * on_fraction)
    inv_off = 1.0 / (period * (1 - on_fraction))
    t, arrivals = 0.0, []
    on = True
    state_end = draw() / inv_on
    while len(arrivals) < num_requests:
        dt = draw() / (on_rate if on else off_rate)
        if t + dt >= state_end:         # state flips before next arrival
            t = state_end
            on = not on
            state_end = t + draw() / (inv_on if on else inv_off)
            continue
        t += dt
        arrivals.append(t)
    return _finish(arrivals, seed, mix, session_follow, session_pool)


def diurnal_trace(rate: float, num_requests: int, seed: int = 0,
                  period: float = 0.0, amplitude: float = 0.8,
                  mix: Sequence[RequestClass] = DEFAULT_MIX,
                  session_follow: float = 0.3,
                  session_pool: int = 64) -> List[WorkloadRequest]:
    """Rate ``rate * (1 + amplitude*sin(2 pi t / period))`` by thinning."""
    assert 0.0 <= amplitude < 1.0
    stream = _UniformStream(random.Random(f"{seed}:diurnal"))
    period = period or 50.0 / rate      # a few "days" per trace
    peak = rate * (1.0 + amplitude)
    # Thinning consumes exactly 2 uniforms per candidate (gap, accept),
    # so whole blocks of candidates vectorize; acceptance averages
    # 1/(1+amplitude), so ~1.3x oversampling usually lands in one block.
    chunk = max(1024, min(2 * num_requests, 1 << 20))
    t_prev = 0.0
    arrivals: List[float] = []
    while len(arrivals) < num_requests:
        u = stream.take(2 * chunk)
        gaps = _exp_gaps(u[0::2], peak)
        ts = np.cumsum(np.concatenate(([t_prev], gaps)))[1:]
        lam = rate * (1.0 + amplitude * np.sin(2 * math.pi * ts / period))
        arrivals.extend(ts[u[1::2] < lam / peak].tolist())
        t_prev = float(ts[-1])
    del arrivals[num_requests:]
    return _finish(arrivals, seed, mix, session_follow, session_pool)


def chat_trace(rate: float, num_requests: int, seed: int = 0,
               turns_mean: float = 4.0, think_mean: float = 2.0,
               first_prompt_mean: int = 192, new_tokens_mean: int = 96,
               output_mean: int = 96,
               max_context: int = 4096) -> List[WorkloadRequest]:
    """Chat-heavy multi-turn trace: every request belongs to a session.

    Sessions open as a Poisson process at ``rate / turns_mean``
    sessions/s (so the long-run REQUEST rate is ~``rate``); each runs
    a geometric number of turns (mean ``turns_mean``) separated by
    exponential think gaps.  Turn ``k``'s prompt is the accumulated
    conversation — ``prompt_{k-1} + output_{k-1} + new tokens`` — which
    is precisely the shape paged KV with session residency exploits: a
    follow-up landing on its resident group re-prefills only the NEW
    tokens, so decode-session affinity shows a measured win instead of
    a modeling assumption.  Deterministic in ``seed``.
    """
    assert turns_mean >= 1.0 and think_mean > 0.0
    rng = random.Random(f"{seed}:chat")
    stop = 1.0 / turns_mean             # geometric stop probability
    sess_rate = rate / turns_mean
    rows: List[Tuple[float, int, int, int]] = []
    t0, sid = 0.0, 0
    while len(rows) < num_requests:
        t0 += rng.expovariate(sess_rate)
        t, ctx = t0, 0
        while True:
            new = 1 + int(rng.expovariate(
                1.0 / (first_prompt_mean if ctx == 0
                       else new_tokens_mean)))
            out = 1 + int(rng.expovariate(1.0 / output_mean))
            out = min(out, _MAX_OUTPUT)
            prompt = min(ctx + new, max_context, _MAX_PROMPT)
            rows.append((t, prompt, out, sid))
            ctx = min(prompt + out, max_context)
            if rng.random() < stop or len(rows) >= 2 * num_requests:
                break
            t += rng.expovariate(1.0 / think_mean)
        sid += 1
    rows.sort(key=lambda r: (r[0], r[3]))
    del rows[num_requests:]
    return [WorkloadRequest(rid=i, arrival=t, prompt_tokens=p,
                            output_tokens=o, session=s)
            for i, (t, p, o, s) in enumerate(rows)]


TRACE_KINDS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
    "chat": chat_trace,
}


def make_trace(kind: str, rate: float, num_requests: int, seed: int = 0,
               **kw) -> List[WorkloadRequest]:
    if rate <= 0.0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    try:
        gen = TRACE_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"pick from {sorted(TRACE_KINDS)}") from None
    return gen(rate, num_requests, seed, **kw)


# --------------------------------------------------------------------- #
def assign_slos(trace: Sequence[WorkloadRequest], *,
                base: float = 0.0,
                per_output_token: float = 0.0,
                ttft: Optional[float] = None
                ) -> List[WorkloadRequest]:
    """Attach per-request SLOs.

    Completion deadline: ``base + per_output_token * output_tokens``
    seconds of end-to-end latency — size-proportional, as production
    SLOs are (a 2k-token generation is allowed more wall time than a
    1-token classification).  ``ttft`` adds a first-token deadline: the
    interactivity SLO that phase-split serving isolates from decode
    head-of-line blocking.  Routers with ``slo_shed`` use the deadlines
    for admission control, and results report goodput (completions
    within BOTH deadlines) next to raw throughput.
    """
    assert base > 0.0 or per_output_token > 0.0 or ttft, \
        "SLO must be positive"
    comp = None if base <= 0.0 and per_output_token <= 0.0 else True
    return [dataclasses.replace(
        r,
        slo=(base + per_output_token * r.output_tokens) if comp else None,
        slo_ttft=ttft)
        for r in trace]


# --------------------------------------------------------------------- #
def trace_stats(trace: Sequence[WorkloadRequest]) -> Dict[str, float]:
    """Summary used by tests and benchmark headers."""
    if not trace:
        return {"n": 0}
    gaps = [b.arrival - a.arrival for a, b in zip(trace, trace[1:])]
    mean_gap = sum(gaps) / max(len(gaps), 1)
    var = sum((g - mean_gap) ** 2 for g in gaps) / max(len(gaps) - 1, 1)
    return {
        "n": len(trace),
        "duration": trace[-1].arrival - trace[0].arrival,
        "rate": (len(trace) - 1) / max(trace[-1].arrival
                                       - trace[0].arrival, 1e-12),
        "cv_interarrival": math.sqrt(var) / max(mean_gap, 1e-12),
        "mean_prompt": sum(r.prompt_tokens for r in trace) / len(trace),
        "mean_output": sum(r.output_tokens for r in trace) / len(trace),
        "sessions": len({r.session for r in trace}),
    }
