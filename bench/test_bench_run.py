"""The harness driven end to end on the CPU at toy sizes, with the
program's plain kernel versions: correct on sound runs, not correct with
the timed path broken underneath, and not correct for the control."""
from __future__ import annotations

import time

import pytest
import torch

from benchfixtures import smoke_root  # noqa: F401  (a fixture)
from harness import check, serve
from harness.spec import Bench
import run as R

CPU = torch.device("cpu")
DENSE, MOE = "smoke-dense.smoke-chat", "smoke-moe.smoke-offline"
FULL = "smoke-dense.smoke-offline"      # every slot busy all the time


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the toy run is host-bound, and workers that
    share the machine's cores must not starve it of finished requests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(root, cell, seed=2**31 + 5, **kw):
    return serve.run(root, cell, seed, 3.0, False, CPU, time.perf_counter(),
                     **kw)


@pytest.mark.parametrize("cell", [DENSE, MOE])
def test_sound_run_is_correct_and_reports_its_metrics(smoke_root, cell):
    out = _run(smoke_root, cell, control=True)
    c = out["checks"]
    assert check.passed({k: v for k, v in c.items()
                         if k != "control_max_logit_gap"}), c
    assert c["compared_tokens"]["value"] > 0
    assert c["tokens_short"]["value"] == 0
    # the control (the reference in fp8 in the program's place) fails
    assert c["control_max_logit_gap"]["value"] \
        > c["max_logit_gap"]["limit"], c
    run = out["run"]
    # the harness's own stamps: a request's first token is its first
    # stamp, and its tokens reach the host in order
    assert run.first and all(run.first[k] == ts[0]
                             for k, ts in run.stamps.items() if ts)
    assert all(ts == sorted(ts) for ts in run.stamps.values())
    bench = Bench(smoke_root)
    e2e = R.metrics(bench, cell, "end_to_end", out["run"])
    assert {"tpot_p90_s", "setup_s"} <= set(e2e)
    layer = R.metrics(bench, cell, "per_layer", out["run"])
    # a metric added by a new file and a new entry only is read
    assert layer["admitted_requests"]["value"] > 0
    assert "k1_roofline" not in layer        # no device trace on the CPU


def _stale_state(fn, eng):
    """A decode step that returns its state unchanged."""
    from repro_torch.models import model as M

    def step(params, cache, tokens, pos):
        scratch = {p: {n: t.clone() for n, t in leaves.items()}
                   for p, leaves in cache.items()}
        logits, _ = M.decode_step(params, eng.cfg, tokens, scratch, pos)
        return logits, cache
    return step


def _half_batch(fn, eng):
    """Half of the batch left out (every other row), the mean of the
    rest taken in its place."""
    from repro_torch.models import model as M

    def step(params, cache, tokens, pos):
        logits, cache = M.decode_step(params, eng.cfg, tokens, cache, pos)
        out = logits.clone()
        out[1::2] = logits[0::2].mean(0, keepdim=True)
        return out, cache
    return step


def _altered_token(fn, eng):
    """A token altered where it is produced: every third step, row 0's
    choice moves to the next vocabulary id."""
    from repro_torch.models import model as M
    calls = [0]

    def step(params, cache, tokens, pos):
        logits, cache = M.decode_step(params, eng.cfg, tokens, cache, pos)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            top = int(logits[0].argmax())
            logits[0, (top + 1) % eng.cfg.vocab_size] += 1e4
        return logits, cache
    return step


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _altered_token],
                         ids=["stale_state", "half_batch", "altered_token"])
def test_broken_timed_path_is_not_correct(smoke_root, fault):
    out = _run(smoke_root, FULL, tamper=fault)
    assert not check.passed(out["checks"]), out["checks"]
