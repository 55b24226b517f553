"""What the metric files under ``bench/metrics/`` read from a run.

Each function takes the run (``harness.serve.Run``) and returns a number,
or None where the run holds nothing to read (no device trace, no
admission in the window, no kernel of that kind).  Kernels are matched by
the program's kernel names: K1 ``decode_*_kernel``, K2
``prefill_*_kernel``, K3 ``gmm_*_kernel``.

Roofline shares count what the launches' real inputs need: K1 the cache
lengths of the step's active rows, K2 each admitted prompt at its own
length (no padding), K3 the rows of real tokens; so work the engine adds
(idle rows, padded rows and columns) lowers the share and never raises it
past 100%.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from harness import flops, stats

K1, K2, K3 = "decode_", "prefill_", "gmm_"


# --- end to end (host clock) ---------------------------------------------
def ttft_p90(run) -> Optional[float]:
    s = stats.ttft_samples(run.due, run.first, run.open_, run.close)
    return stats.p90(s) if s else None


def tpot_p90(run) -> Optional[float]:
    s = stats.tpot_samples(run.stamps, run.open_, run.close)
    return stats.p90(s) if s else None


def output_tokens_per_s(run) -> float:
    return stats.tokens_in_window(run.stamps, run.open_, run.close) \
        / run.window_s


# --- the tails as per-layer metrics (host clock, untraced) -----------------
def ttft_p90_host(run) -> Optional[float]:
    """ttft_p90 over the requests due in the host window (a traced run's
    untraced half), each counted to its first token in the window, or
    censored at the close."""
    lo, hi, _ = run.host_window
    due = {rid: t for rid, t in run.due.items() if lo <= t < hi}
    s = stats.ttft_samples(due, run.first, run.open_, run.close)
    return stats.p90(s) if s else None


def tpot_p90_host(run) -> Optional[float]:
    """tpot_p90 over the stamps of the host window."""
    lo, hi, _ = run.host_window
    s = stats.tpot_samples(run.stamps, lo, hi)
    return stats.p90(s) if s else None


# --- spans and counters ----------------------------------------------------
def _span_s(run, labels, lo: float, hi: float) -> float:
    """Seconds of [lo, hi) inside the harness's spans of ``labels``."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for lab, a, b in run.spans if lab in labels)


def _host_admissions(run):
    lo, hi, _ = run.host_window
    return run.admissions_in(lo, hi)


def admit_ms_per_ktok(run) -> Optional[float]:
    adm = _host_admissions(run)
    tok = sum(P for a in adm for _, P in a.slots)
    if not tok:
        return None
    return 1e3 * sum(a.t1 - a.t0 for a in adm) / (tok / 1e3)


def decode_time_s(run) -> float:
    """The host window's time outside admissions (and their syncs) and
    sleeps."""
    lo, hi, _ = run.host_window
    return hi - lo - _span_s(run, ("admit", "sync", "sleep"), lo, hi)


def decode_step_ms(run) -> Optional[float]:
    n = len(run.host_window[2])
    return 1e3 * decode_time_s(run) / n if n else None


def decode_mfu(run) -> Optional[float]:
    steps = run.host_window[2]
    if not len(steps):
        return None
    fl = 0.0
    for k in steps:
        act = run.step_rows(k)
        fl += flops.model_flops(run.cfg, len(act), sum(act))
    return 100.0 * fl / (decode_time_s(run) * flops.PEAK_FLOPS)


def prefill_mfu(run) -> Optional[float]:
    adm = _host_admissions(run)
    if not adm:
        return None
    fl = sum(flops.model_flops(run.cfg, P, P * (P + 1) // 2)
             for a in adm for _, P in a.slots)
    wall = sum(a.t1 - a.t0 for a in adm)
    return 100.0 * fl / (wall * flops.PEAK_FLOPS)


def extra(name: str) -> Callable:
    def read(run) -> Optional[float]:
        return run.extra.get(name)
    return read


# --- the device trace ------------------------------------------------------
def _device_s(run, tag: str, prefill: Optional[bool] = None) -> float:
    """Summed device seconds of the kernels named ``tag``...: with
    ``prefill`` None those that start in the window; True those inside
    the window's admissions (to their end, past the close if need be);
    False those in the window outside every admission."""
    lo, hi, _ = run.device_window
    adm = [(a.t0, a.t1) for a in run.admissions_in(lo, hi)]
    everywhere = [(a.t0, a.t1) for a in run.admissions]
    tot = 0.0
    for name, a, b in run.kernels:
        if tag not in name:
            continue
        if prefill:
            keep = any(t0 <= a < t1 for t0, t1 in adm)
        else:
            keep = lo <= a < hi and (prefill is None or not any(
                t0 <= a < t1 for t0, t1 in everywhere))
        if keep:
            tot += b - a
    return tot


def _share(bound: float, device_s: float) -> Optional[float]:
    return 100.0 * bound / device_s if device_s > 0 and bound > 0 else None


def k1_roofline(run) -> Optional[float]:
    if run.kernels is None:
        return None
    L = run.cfg["num_layers"]
    bound = 0.0
    for k in run.device_window[2]:
        act = run.step_rows(k)
        if act:
            bound += L * flops.k1_bound(run.cfg, len(act), sum(act))
    return _share(bound, _device_s(run, K1))


def k2_roofline(run) -> Optional[float]:
    if run.kernels is None:
        return None
    L = run.cfg["num_layers"]
    lo, hi, _ = run.device_window
    bound = sum(L * flops.k2_bound(run.cfg, 1, P)
                for a in run.admissions_in(lo, hi) for _, P in a.slots)
    return _share(bound, _device_s(run, K2, prefill=True))


def k3_roofline_decode(run) -> Optional[float]:
    if run.kernels is None or run.cfg["family"] != "moe":
        return None
    L = run.cfg["num_layers"]
    bound = 0.0
    for k in run.device_window[2]:
        act = run.step_rows(k)
        if act:
            bound += L * flops.k3_bound(run.cfg, len(act))
    return _share(bound, _device_s(run, K3, prefill=False))


def k3_roofline_prefill(run) -> Optional[float]:
    if run.kernels is None or run.cfg["family"] != "moe":
        return None
    L = run.cfg["num_layers"]
    lo, hi, _ = run.device_window
    bound = sum(L * flops.k3_bound(run.cfg, sum(P for _, P in a.slots))
                for a in run.admissions_in(lo, hi))
    return _share(bound, _device_s(run, K3, prefill=True))


def decode_device_ms(run) -> Optional[float]:
    """Device-busy milliseconds per decode step in the traced window,
    admissions left out.  The profiler slows the host, not the device:
    beside ``decode_step_ms`` (the untraced half), 1 - this / that is the
    decode step's idle share without the profiler's cost."""
    if run.merged is None:
        return None
    lo, hi, steps = run.device_window
    if not len(steps) or not run.merged:
        return None
    iv = np.asarray(run.merged, dtype=np.float64)
    a, b = iv[:, 0], iv[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(b - a)])

    def busy_to(t: float) -> float:
        i = int(np.searchsorted(b, t))      # intervals ending before t
        return cum[i] + (max(0.0, t - a[i]) if i < len(a) else 0.0)

    adm = sum(busy_to(min(t1, hi)) - busy_to(max(t0, lo))
              for lab, t0, t1 in run.spans
              if lab == "admit" and t1 > lo and t0 < hi)
    return 1e3 * (cum[-1] - adm) / len(steps)


def device_idle_share(run) -> Optional[float]:
    if run.busy_s is None:
        return None
    lo, hi, _ = run.device_window
    return 100.0 * (1.0 - run.busy_s / (hi - lo))
