"""Traffic, percentiles and rates over every request of the window."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

import pytest

from harness import stats, traffic as TR
from vendor import workload as W

BENCH = Path(__file__).resolve().parent
ENG = {"slots": 48, "max_len": 4096, "sync_every": 8}


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_frozen_trace_arithmetic():
    """The vendored ``poisson_trace`` arithmetic, pinned to the values
    the program's generator gave at the commit it was copied from."""
    arr = W.poisson_arrivals(3.0, 500, 7)
    p, o = W.sample_lengths(500, 7)
    assert arr[:3] == [0.3811463439541058, 0.40440526163298846,
                       0.4850985001763738]
    assert p[:5] == [228, 154, 1431, 142, 137]
    assert o[:5] == [313, 58, 38, 308, 68]


@pytest.mark.parametrize("name", ["chat", "offline"])
def test_same_seed_same_requests(name):
    mix = _mix(name)
    cell = {"rate_per_s": 3.0}
    a = TR.items(mix, cell, ENG, 2**31 + 11, 60.0)
    b = TR.items(mix, cell, ENG, 2**31 + 11, 60.0)
    assert a == b
    ids_a = TR.prompt_ids(2**31 + 11, a[:20], 49152)
    ids_b = TR.prompt_ids(2**31 + 11, b[:20], 49152)
    assert all((x == y).all() for x, y in zip(ids_a, ids_b))


def test_open_loop_seeds_share_arrivals_and_sizes():
    """Every seed sends the same set of sizes at the same arrivals, in
    another order."""
    mix, cell = _mix("chat"), {"rate_per_s": 3.0}
    a = TR.items(mix, cell, ENG, 1, 60.0)
    b = TR.items(mix, cell, ENG, 2, 60.0)
    assert [x.due for x in a] == [x.due for x in b]
    assert all(x.due < 60.0 for x in a)
    sizes = lambda its: Counter((x.prompt_len, x.max_new) for x in its)
    assert sizes(a) == sizes(b)
    assert [x.prompt_len for x in a] != [x.prompt_len for x in b]
    for x in a:
        assert 1 <= x.prompt_len <= 2048
        assert x.prompt_len + x.max_new <= 4096


def test_tessera_cell_sends_the_chat_mix():
    """The Tessera cell's mix is a copy of ``chat`` under its own name:
    the two chat cells must not drift apart."""
    chat, tess = _mix("chat"), _mix("chat-tessera")
    chat.pop("about"), tess.pop("about")
    assert tess == chat


def test_closed_loop_clips():
    mix = _mix("offline")
    its = TR.items(mix, {}, ENG, 3, 60.0)
    assert len(its) == mix["population"]
    assert all(x.due is None for x in its)
    assert max(x.prompt_len for x in its) <= 2048
    assert max(x.max_new for x in its) <= 1024


def test_p90_is_linear_between_order_statistics():
    assert stats.p90(list(range(11))) == pytest.approx(9.0)
    assert stats.p90([1.0, 2.0]) == pytest.approx(1.9)
    with pytest.raises(ValueError):
        stats.p90([])


def test_ttft_counts_censored_requests():
    due = {0: 1.0, 1: 2.0, 2: 3.0, 3: 0.5, 4: 12.0}
    first = {0: 1.5, 1: 11.0, 3: 0.6}          # 2 never served; 1 late
    got = stats.ttft_samples(due, first, open_=1.0, close=10.0)
    # 3 was due before the window, 4 after it; 1's token came after the
    # close, so it counts with the wait it had by then
    assert sorted(got) == pytest.approx([0.5, 7.0, 8.0])


def test_tpot_and_rate_over_the_window():
    stamps = {0: [0.5, 1.0, 1.2, 1.4, 11.0],    # 3 tokens in [1, 10)
              1: [2.0],                          # 1 token: no tpot
              2: [9.0, 9.5, 10.0]}               # 2 in the window
    assert stats.tpot_samples(stamps, 1.0, 10.0) == pytest.approx([0.2, 0.5])
    assert stats.tokens_in_window(stamps, 1.0, 10.0) == 6


def test_tpot_leaves_out_tokens_that_share_the_first_stamp():
    """Tokens reach the host several at a sync.  A request that straddles
    the opening has its first in-window sync carry tokens made before
    the window: only the tokens stamped after that sync count, and a
    request whose in-window tokens all came at one sync gives no sample."""
    stamps = {0: [0.5, 2.0, 2.0, 2.0, 3.0, 3.0],   # 2 tokens in 1 s
              1: [0.5, 4.0, 4.0, 4.0],             # one sync: no sample
              2: [1.5, 2.5, 2.5, 2.5, 2.5]}        # first token, then 4
    assert stats.tpot_samples(stamps, 1.0, 10.0) == pytest.approx([0.5,
                                                                   0.25])


def test_step_rows_follow_each_request():
    """A request admitted before step k0 with a prompt of P tokens that
    decoded m tokens reads P + (k - k0) + 1 cache positions at step k."""
    from harness.serve import Run
    run = Run(cfg={}, engine_cfg={"slots": 2}, cell={}, traffic={},
              open_=0.0, close=1.0, setup_s=0.0, due={}, first={},
              stamps={}, spans=[], admissions=[], steps_open=0,
              steps_close=10, extra={},
              decodes=[(0, 5, 3), (4, 2, 0), (5, 7, 2), (1, 10, 4)])
    assert run.step_rows(0) == [6]
    assert sorted(run.step_rows(2)) == [8, 12]
    assert run.step_rows(3) == [13]         # the first is done after 3
    assert run.step_rows(4) == [14]         # m 0: finished at prefill
    assert run.step_rows(6) == [9]
    assert run.step_rows(7) == []


def test_decode_device_ms_leaves_out_admissions():
    """Device-busy time per traced decode step, the device's time inside
    the harness's admission spans left out."""
    from harness import readers
    from harness.serve import Run
    run = Run(cfg={}, engine_cfg={}, cell={}, traffic={}, open_=0.0,
              close=10.0, setup_s=0.0, due={}, first={}, stamps={},
              spans=[("admit", 2.5, 4.0), ("step", 4.0, 4.1),
                     ("admit", 9.5, 11.0)],
              admissions=[], steps_open=0, steps_close=10, decodes=[],
              extra={}, t_trace=2.0, steps_trace=6,
              merged=[[2.0, 3.0], [3.5, 5.0], [6.0, 6.5], [9.0, 10.0]])
    # busy 4.0 s; in admissions 0.5 + 0.5 + 0.5; 4 steps traced
    assert readers.decode_device_ms(run) == pytest.approx(1e3 * 2.5 / 4)
    run.merged = None
    assert readers.decode_device_ms(run) is None


def test_host_tails_read_the_untraced_part_of_the_window():
    """In a traced run the tails' per-layer forms read the half before
    the profiler starts: requests due there, each to its first token
    wherever it falls in the window, and the stamps there."""
    from harness import readers
    from harness.serve import Run
    run = Run(cfg={}, engine_cfg={}, cell={}, traffic={}, open_=0.0,
              close=10.0, setup_s=0.0,
              due={0: 1.0, 1: 4.0, 2: 6.0},
              first={0: 1.5, 1: 5.5, 2: 6.1},
              stamps={0: [1.5, 2.0, 3.0], 1: [5.5, 6.0, 7.0],
                      2: [6.1, 6.3]},
              spans=[], admissions=[], steps_open=0, steps_close=10,
              decodes=[], extra={}, t_trace=5.0, steps_trace=5,
              t_host_end=5.0)
    # due in [0, 5): 0 and 1, the latter's first token after 5.0
    assert readers.ttft_p90_host(run) == pytest.approx(
        stats.p90([0.5, 1.5]))
    # stamps in [0, 5): request 0 alone
    assert readers.tpot_p90_host(run) == pytest.approx(0.75)
    run.t_host_end = None                   # untraced: the whole window
    assert readers.ttft_p90_host(run) == pytest.approx(
        stats.p90([0.5, 1.5, 0.1]))
