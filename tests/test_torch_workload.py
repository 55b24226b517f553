"""The port's copy of ``serving/workload.py`` gives traces bit-identical
to the JAX package's, over the grid of ``tests/test_workload_vec.py``
(every kind, seed, size and keyword), plus the chat trace, SLO stamping
and trace statistics."""
import pytest

pytest.importorskip("torch")

from repro.serving import workload as J  # noqa: E402
from repro_torch.serving import workload as T  # noqa: E402

KINDS = ["poisson", "bursty", "diurnal"]


def _same(got, want):
    """Field-for-field, bit-for-bit (the two modules define distinct
    dataclasses, so compare their tuples)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.arrival, g.prompt_tokens, g.output_tokens,
                g.session, g.slo, g.slo_ttft, g.priority) == \
            (w.rid, w.arrival, w.prompt_tokens, w.output_tokens,
             w.session, w.slo, w.slo_ttft, w.priority), (g, w)


def _mix(mod, classes):
    return tuple(mod.RequestClass(*c) for c in classes)


CUSTOM = (("tiny", 0.5, 32, 0.4, 16), ("huge", 0.5, 8192, 1.2, 2048))


@pytest.mark.parametrize("kind", KINDS + ["chat"])
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_traces_bit_identical(kind, seed):
    for rate, n in ((8.0, 50), (120.0, 500)):
        _same(T.make_trace(kind, rate, n, seed=seed),
              J.make_trace(kind, rate, n, seed=seed))


@pytest.mark.parametrize("kind,kw", [
    ("bursty", dict(burst_factor=3.0, on_fraction=0.25)),
    ("bursty", dict(period=2.5)),
    ("diurnal", dict(amplitude=0.3)),
    ("diurnal", dict(period=10.0, amplitude=0.95)),
    ("poisson", dict(session_follow=0.0)),
    ("poisson", dict(session_follow=0.9, session_pool=4)),
    ("chat", dict(turns_mean=2.0, max_context=512)),
])
def test_kwargs_preserved(kind, kw):
    _same(T.make_trace(kind, 40.0, 200, seed=3, **kw),
          J.make_trace(kind, 40.0, 200, seed=3, **kw))


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_tiny_traces(n):
    for kind in KINDS:
        _same(T.make_trace(kind, 10.0, n, seed=5),
              J.make_trace(kind, 10.0, n, seed=5))


def test_custom_mix_slos_and_stats():
    got = T.poisson_trace(20.0, 150, seed=9, mix=_mix(T, CUSTOM))
    want = J.poisson_trace(20.0, 150, seed=9, mix=_mix(J, CUSTOM))
    _same(got, want)
    _same(T.assign_slos(got, base=1.0, per_output_token=0.05, ttft=0.5),
          J.assign_slos(want, base=1.0, per_output_token=0.05, ttft=0.5))
    assert T.trace_stats(got) == J.trace_stats(want)
    with pytest.raises(ValueError, match="unknown trace kind"):
        T.make_trace("weekly", 1.0, 1)
    with pytest.raises(ValueError, match="positive"):
        T.make_trace("poisson", 0.0, 1)
