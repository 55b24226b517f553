"""The port's prefill -> decode handoff between two engines against the
JAX package, at fp32 on the CPU.

Mirrors the engine-side cases of ``tests/test_pd_split.py``:
  * prefill on engine P, export, import, decode on engine D gives the
    greedy tokens of one engine doing both, for every family;
  * ``export_kv`` / ``import_kv`` round-trip a cache slot;
  * a one-token request finishes at prefill and a decode engine refuses
    its handoff;
  * TTFT is stamped at decode admission, where the reference stamps it;
  * the bytes of a real export equal the JAX export's;
and the prefill -> decode loop that the reference deployment spec runs
(``src/repro/serving/spec.py``, its serial and streamed pairings): the
port's pair of engines gives the greedy tokens of the JAX pair and of
one port engine, with the same wire bytes and shard counts.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.workload import poisson_trace as j_poisson  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.workload import poisson_trace  # noqa: E402

ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b")


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(arch, **kw):
    _, _, cfg, params = _model(arch)
    return TE.ServingEngine(cfg, params, device="cpu", **kw)


def _one_request(cfg, n, max_new, seed):
    rng = np.random.default_rng(seed)
    return TE.Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=max_new)


@pytest.mark.parametrize("arch", ARCHS)
def test_handoff_bit_identical_to_single_engine(arch):
    _, _, cfg, _ = _model(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 3)]
    singles = [TE.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
               for i, p in enumerate(prompts)]
    _engine(arch, slots=2, max_len=32, sync_every=2).run(singles)
    splits = [TE.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
              for i, p in enumerate(prompts)]
    pre = _engine(arch, slots=2, max_len=32)
    dec = _engine(arch, slots=2, max_len=32, sync_every=2)
    for req in splits:
        h = pre.prefill_handoff(req, 0.0)
        assert h["kv_bytes"] > 0
        assert dec.admit_handoff(req, h, 0.0)
    while dec._any_active():
        dec.step(0.0)
    dec.sync(0.0)
    assert dec.stats.prefill_batches == 0          # a decode-only engine
    assert dec.stats.completed == len(splits)
    assert [r.output for r in splits] == [r.output for r in singles]


def test_export_import_round_trips_cache_slot():
    _, _, cfg, params = _model("llama3_8b")
    toks = torch.arange(12, dtype=torch.int32).reshape(3, 4) % cfg.vocab_size
    _, cache = TM.prefill(params, cfg, toks,
                          TM.init_cache(cfg, 3, 16, device="cpu"))
    state = TM.export_kv(cfg, cache, 1, 4)
    assert TM.kv_state_bytes(state) > 0
    filled = TM.import_kv(cfg, TM.init_cache(cfg, 2, 16, device="cpu"), 0,
                          state)
    for c in ("k", "v"):
        assert torch.equal(filled["kv"][c][:, 0, :4], cache["kv"][c][:, 1, :4])


def test_prefill_handoff_finishes_one_token_requests():
    """max_new_tokens=1 completes at prefill; the handoff is marked done
    and a decode engine refuses it loudly (a caller retrying it until
    admission would never end)."""
    _, _, cfg, _ = _model("llama3_8b")
    req = _one_request(cfg, 4, 1, seed=3)
    pre = _engine("llama3_8b", slots=1, max_len=16)
    h = pre.prefill_handoff(req, 0.0)
    assert h["done"] and h["kv_bytes"] == 0 and h["state"] is None
    assert pre.stats.completed == 1 and len(req.output) == 1
    dec = _engine("llama3_8b", slots=1, max_len=16)
    with pytest.raises(ValueError, match="finished at prefill"):
        dec.admit_handoff(req, h, 0.0)


def test_handoff_ttft_stamped_at_decode_admission():
    """The first token streams only once the state lands on the decode
    engine, so admit_handoff (not prefill_handoff) stamps TTFT, as the
    JAX engine does."""
    _, _, cfg, _ = _model("llama3_8b")
    req = _one_request(cfg, 5, 4, seed=5)
    pre = _engine("llama3_8b", slots=1, max_len=16)
    h = pre.prefill_handoff(req, now=1.0)
    assert req.ttft == -1.0
    dec = _engine("llama3_8b", slots=1, max_len=16)
    assert dec.admit_handoff(req, h, now=3.5)
    assert req.ttft == 3.5


@pytest.mark.parametrize("arch", ("llama3_8b", "rwkv6_3b", "zamba2_7b"))
def test_kv_bytes_match_jax_export(arch):
    """What the port ships for a prompt equals what the JAX package ships
    (dense per-token KV, ssm fixed-size state, hybrid both)."""
    jcfg, _, cfg, _ = _model(arch)
    plen = 6
    ours = TM.export_kv(cfg, TM.init_cache(cfg, 2, 16, device="cpu"), 0,
                        plen)
    ref = JM.export_kv(jcfg, JM.init_cache(jcfg, 2, 16), 0, plen)
    assert TM.kv_state_bytes(ours) == JM.kv_state_bytes(ref)


# ===================================================================== #
# The deployment spec's prefill -> decode loop, on two engines
# ===================================================================== #
@pytest.mark.parametrize("arch", ("llama3_8b", "zamba2_7b"))
@pytest.mark.parametrize("streamed", [False, True])
def test_pd_pair_matches_jax_pair(arch, streamed):
    """Six trace requests through a prefill engine and a two-slot decode
    engine (streamed: 4-token chunks): the JAX pair's greedy tokens,
    wire bytes and shard count, and the tokens of one port engine."""
    jcfg, jparams, cfg, params = _model(arch)
    knobs = dict(slots=2, max_len=32, sync_every=2,
                 prefill_chunk=4 if streamed else None)

    def reqs(mod, fn):
        return mod.requests_from_trace(fn(40.0, 6, seed=3), cfg.vocab_size,
                                       max_prompt=12, max_new=6,
                                       time_scale=0.0)
    ours = reqs(TE, poisson_trace)
    got = TE.serve_pd(_engine(arch, **knobs), _engine(arch, **knobs), ours,
                      streamed)[:2]
    theirs = reqs(JE, j_poisson)
    want = TE.serve_pd(JE.ServingEngine(jcfg, jparams, **knobs),
                       JE.ServingEngine(jcfg, jparams, **knobs), theirs,
                       streamed)[:2]
    single = reqs(TE, poisson_trace)
    _engine(arch, slots=2, max_len=32, sync_every=2).run(single)
    assert [r.output for r in ours] == [r.output for r in theirs] == \
        [r.output for r in single]
    assert all(len(r.output) == r.max_new_tokens for r in ours)
    assert got == want and got[0] > 0 and (got[1] > 0) == streamed
