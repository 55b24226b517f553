"""End-to-end arithmetic over every request of the window.

Times are seconds on the loop's clock.  A request is *due* when it was to
be sent (open loop: its arrival; closed loop: when its client's previous
request completed).  Tokens carry the time the harness first saw them
on the host: the first after its admission returned, the others after the
engine's syncs, several at one time.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def p90(values: Sequence[float]) -> float:
    """The 90th percentile, linear between order statistics (numpy's
    default)."""
    if not len(values):
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 90.0))


def ttft_samples(due: Dict[int, float], first: Dict[int, float],
                 open_: float, close: float) -> List[float]:
    """Time to first token of every request due in [open_, close): from
    due to its first token, or, with none by the close, the time it has
    waited by then."""
    out = []
    for rid, t in due.items():
        if open_ <= t < close:
            f = first.get(rid)
            out.append((f if f is not None and f < close else close) - t)
    return out


def tpot_samples(stamps: Dict[int, Sequence[float]], open_: float,
                 close: float) -> List[float]:
    """Per request, the time per token after its first stamp in the
    window: (last - first) over the tokens stamped later than the first,
    for every request with two or more distinct stamps there.  Tokens
    that share the first stamp were made before it, some before the
    window opened, so they are not counted."""
    out = []
    for ts in stamps.values():
        w = [t for t in ts if open_ <= t < close]
        later = len(w) - w.count(w[0]) if w else 0
        if later:
            out.append((w[-1] - w[0]) / later)
    return out


def tokens_in_window(stamps: Dict[int, Sequence[float]], open_: float,
                     close: float) -> int:
    return sum(open_ <= t < close for ts in stamps.values() for t in ts)
