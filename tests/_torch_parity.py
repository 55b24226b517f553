"""Helpers the port's parity tests share: the reference's kernel graph
carried into the port's ``KernelGraph``, and field-by-field equality of
the two packages' simulation results."""
import dataclasses

from repro_torch.core.graph import KernelGraph, KernelNode


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
