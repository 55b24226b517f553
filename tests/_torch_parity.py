"""Helpers the port's parity tests share: the reference's kernel graph
carried into the port's ``KernelGraph``, field-by-field equality of the
two packages' simulation results, a vlm prompt's M-RoPE ids, and a JAX
Trainer state carried into the port's."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.graph import KernelGraph, KernelNode
from repro_torch.train.optim import AdamWState


def port_state(jstate) -> dict:
    """A JAX Trainer state ({"params", "opt"[, "residual"]}, leaves JAX
    or numpy arrays) as the port's, on the CPU: stacked layers split
    into lists, ``AdamWState`` fields carried over (a ``None`` master
    stays ``None``)."""
    def tree(t):
        return convert.params_from_jax(t, device="cpu")

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return np.asarray(t)
    opt = jstate["opt"]
    out = {"params": tree(np_tree(jstate["params"])),
           "opt": AdamWState(
               step=torch.from_numpy(np.array(opt.step)),
               mu=tree(np_tree(opt.mu)), nu=tree(np_tree(opt.nu)),
               master=None if opt.master is None
               else tree(np_tree(opt.master)))}
    if "residual" in jstate:
        out["residual"] = tree(np_tree(jstate["residual"]))
    return out


def grid_positions3(batch: int, length: int, npat: int, side: int
                    ) -> np.ndarray:
    """(3, batch, length) int32 M-RoPE ids of a prompt that starts with an
    image of ``npat`` patches on a ``side``-wide grid, laid out as
    Qwen2-VL's ``get_rope_index``: patch i at (t, h, w) = (0, i // side,
    i % side), then text from the largest id + 1 on all three axes."""
    p3 = np.zeros((3, length), np.int32)
    i = np.arange(npat)
    p3[1, :npat], p3[2, :npat] = i // side, i % side
    p3[:, npat:] = np.arange(length - npat) + p3.max() + 1
    return np.broadcast_to(p3[:, None], (3, batch, length)).copy()


def to_port(g) -> KernelGraph:
    """The reference's KernelGraph as the port's (same fields)."""
    return KernelGraph([KernelNode(**dataclasses.asdict(n))
                        for n in g.nodes], dict(g.edges), name=g.name)


def result_fields(res) -> dict:
    """Every field of a ``ClusterResult`` or ``SimResult``; an event
    aggregate as its counts and seconds."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if hasattr(v, "counts") and hasattr(v, "seconds"):
            v = (v.counts, v.seconds)
        out[f.name] = v
    return out


def assert_same_result(ref, port) -> None:
    """The reference's and the port's results are ``==`` field by
    field (event logs, latencies, TTFTs, assignments, busy times, shed
    and SLO counts, transfers, faults, fabric accounting)."""
    a, b = result_fields(ref), result_fields(port)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k
