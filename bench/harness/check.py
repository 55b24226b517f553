"""Whether what the timed path served is correct.

After the window: a sample, drawn from the seed, of the requests the
engine finished, the longest of them always in it, until it holds
``SERVED_TOKENS`` served tokens or ``MAX_REQUESTS`` requests.  The plain
reference runs once over each prompt with its served tokens, and the
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position (greedy serving: 0 where the
two agree), or where a cell's limits say so the mean gap (``STATS``; PERF.md
says why a cell compares the mean).  Beside it, every finished request
must hold exactly the tokens it asked for.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference import decoder

SERVED_TOKENS = 512
MAX_REQUESTS = 12

# The numbers a cell's ``limits`` may name, over the compared tokens' gaps.
STATS = {"max_logit_gap": lambda g: g.max(),
         "mean_logit_gap": lambda g: g.mean()}


def sample(seed: int, finished: Sequence) -> List:
    """The requests to compare: the longest (prompt + output) finished
    one, then others in an order drawn from the seed."""
    if not finished:
        return []
    fin = sorted(finished, key=lambda r: r.rid)
    longest = max(fin, key=lambda r: (len(r.prompt) + len(r.output), -r.rid))
    rest = [r for r in fin if r is not longest]
    order = np.random.default_rng([seed, 2]).permutation(len(rest))
    out, served = [longest], len(longest.output)
    for i in order:
        if served >= SERVED_TOKENS or len(out) >= MAX_REQUESTS:
            break
        out.append(rest[i])
        served += len(rest[i].output)
    return out


def sequences(reqs: Sequence, device) -> Tuple[list, list, list]:
    """Each request's prompt + served tokens but the last, the positions
    whose logits chose the served tokens, and the served tokens."""
    seqs, read, toks = [], [], []
    for r in reqs:
        out = np.asarray(r.output, dtype=np.int64)
        P = len(r.prompt)
        s = np.concatenate([np.asarray(r.prompt, np.int64), out[:-1]])
        seqs.append(torch.from_numpy(s).to(device))
        read.append(torch.arange(P - 1, P - 1 + len(out), device=device))
        toks.append(torch.from_numpy(out).to(device))
    return seqs, read, toks


def gaps(logits: Sequence[torch.Tensor], toks: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    """Per served token: best reference logit - the served token's."""
    return torch.cat([lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
                      for lg, t in zip(logits, toks)])


def run(weights: Dict[str, torch.Tensor], cfg: Dict, seed: int,
        finished: Sequence, limits: Dict[str, float],
        control: bool = False) -> Dict[str, Dict]:
    """The numbers compared, each with its limit.  ``control`` adds the
    control's readings, ``control_<number>``: at the same positions, the
    gap of the token that the reference in fp8 puts first."""
    reqs = sample(seed, finished)
    short = sum(abs(len(r.output) - r.max_new_tokens) for r in finished)
    checks = {"tokens_short": {"value": int(short), "limit": 0}}
    if not reqs:
        checks["compared_tokens"] = {"value": 0, "limit": 1}
        return checks
    dev = weights["tok"].device
    seqs, read, toks = sequences(reqs, dev)
    logits = decoder.forward(weights, cfg, seqs, read)
    g = gaps(logits, toks)
    for name in limits:
        checks[name] = {"value": float(STATS[name](g)),
                        "limit": limits[name]}
    checks["compared_tokens"] = {"value": int(sum(len(t) for t in toks)),
                                 "limit": 1}
    if control:
        low = decoder.forward(weights, cfg, seqs, read, quant="fp8")
        gc_ = gaps(logits, [lg.argmax(-1) for lg in low])
        for name in limits:
            checks[f"control_{name}"] = {"value": float(STATS[name](gc_)),
                                         "limit": limits[name]}
    return checks


def passed(checks: Dict[str, Dict]) -> bool:
    """Every number within its limit; ``compared_tokens`` is a floor."""
    ok = True
    for name, c in checks.items():
        if name == "compared_tokens":
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return bool(ok)
