"""The one traffic generator: a mix's data file in, the run's requests out.

A mix (``bench/traffic/<name>.json``) is either open loop (independent
users: Poisson arrivals at the cell's ``rate_per_s``) or closed loop
(``clients_per_slot`` x slots clients, each sending its next request when
its last one completes).  Its lengths come from a mixture of request
classes (lognormal prompts, geometric outputs), the frozen arithmetic of
``vendor.workload``.

Every seed gets the same work in another order: arrivals and lengths are
drawn once from the mix's ``population_seed``; the run's seed only
permutes which lengths go with which arrival (open loop: among the
requests due before the window closes, so every seed sends the same set
of sizes) or in which order the clients take them (closed loop), and
draws the prompt ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from vendor import workload as W


@dataclasses.dataclass
class Item:
    """One request of the run: due at ``due`` seconds after the loop's
    start (open loop; closed loop: when its client's last request
    completed, set by the loop)."""
    idx: int
    prompt_len: int
    max_new: int
    due: Optional[float] = None


def _mix(traffic: Dict) -> List[W.RequestClass]:
    return [W.RequestClass(c["name"], c["weight"], c["prompt_median"],
                           c["prompt_sigma"], c["output_mean"])
            for c in traffic["mix"]]


def clip(prompt: int, out: int, traffic: Dict, max_len: int):
    """A request's lengths as the engine takes them: the prompt to
    ``prompt_max`` (and below ``max_len``), the output to ``output_max``
    and to what fits ``max_len`` after the prompt."""
    p = max(1, min(prompt, traffic["prompt_max"], max_len - 1))
    n = max(1, min(out, traffic.get("output_max", max_len), max_len - p))
    return p, n


def items(traffic: Dict, cell: Dict, engine: Dict, seed: int,
          horizon: float) -> List[Item]:
    """The run's requests.  Open loop: those due before ``horizon`` (the
    loop's end), with their due times.  Closed loop: the order in which
    clients take requests (``population`` of them), due times unset."""
    rng = np.random.default_rng([seed, 0])
    pop = traffic["population"]
    prompts, outs = W.sample_lengths(pop, traffic["population_seed"],
                                     _mix(traffic))
    lens = [clip(p, o, traffic, engine["max_len"])
            for p, o in zip(prompts, outs)]
    if traffic["loop"] == "open":
        due = W.poisson_arrivals(cell["rate_per_s"], pop,
                                 traffic["population_seed"])
        n = sum(t < horizon for t in due)
        if n == pop:
            raise ValueError(f"population {pop} runs out before the "
                             f"{horizon:.0f} s horizon at "
                             f"{cell['rate_per_s']} req/s")
        order = rng.permutation(n)
        return [Item(i, *lens[order[i]], due=due[i]) for i in range(n)]
    if traffic["loop"] == "closed":
        order = rng.permutation(pop)
        return [Item(i, *lens[j]) for i, j in enumerate(order)]
    raise ValueError(f"unknown loop {traffic['loop']!r}")


def prompt_ids(seed: int, its: List[Item], vocab: int) -> List[np.ndarray]:
    """Uniform prompt ids of each request, from the seed."""
    rng = np.random.default_rng([seed, 1])
    return [rng.integers(0, vocab, size=it.prompt_len).astype(np.int32)
            for it in its]
