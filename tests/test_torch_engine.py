"""The port's ServingEngine against the JAX ServingEngine on the CPU.

Both engines serve the same requests (a Poisson trace with every arrival
at 0, more requests than slots) on the same fp32 weights (initialised in
JAX, carried across by ``repro_torch.convert``).  Greedy outputs must be
identical, and must not depend on ``sync_every``; EOS must end a
request; temperature sampling must repeat under a fixed seed.
"""
import dataclasses

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

ARCH = "llama3_8b"
SLOTS, MAX_LEN, N_REQ = 2, 32, 5


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, tparams


def _requests(mod, trace_fn):
    trace = trace_fn(10.0, N_REQ, seed=3)
    return mod.requests_from_trace(trace, 256, max_prompt=12, max_new=7,
                                   time_scale=0.0)


def _serve_port(tcfg, tparams, **kw):
    reqs = _requests(TE, poisson_trace)
    eng = TE.ServingEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           device="cpu", **kw)
    stats = eng.run(reqs)
    assert stats.completed == N_REQ
    return {r.rid: r.output for r in reqs}, stats


def _serve_jax(jcfg, params, **kw):
    reqs = _requests(JE, j_poisson)
    JE.ServingEngine(jcfg, params, slots=SLOTS, max_len=MAX_LEN,
                     **kw).run(reqs)
    return {r.rid: r.output for r in reqs}


@pytest.fixture(scope="module")
def jax_greedy(weights):
    jcfg, params, _, _ = weights
    return _serve_jax(jcfg, params)


def test_requests_from_trace_identical():
    t = _requests(TE, poisson_trace)
    j = _requests(JE, j_poisson)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival)
            for r in t] == \
        [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.arrival)
         for r in j]
    assert all(r.prompt.dtype == np.int32 for r in t)


@pytest.mark.parametrize("sync_every", [1, 4, 8])
def test_greedy_outputs_match_jax_engine(weights, jax_greedy, sync_every):
    _, _, tcfg, tparams = weights
    out, stats = _serve_port(tcfg, tparams, sync_every=sync_every)
    assert out == jax_greedy
    assert all(len(o) == r.max_new_tokens for o, r in
               zip(out.values(), _requests(TE, poisson_trace)))
    assert stats.prefill_batches >= 2          # slots were reused
    assert len(stats.ttft) == len(stats.tpot) == N_REQ


def test_eos_ends_requests_like_jax(weights, jax_greedy):
    jcfg, params, tcfg, tparams = weights
    eos = jax_greedy[0][2]
    out, _ = _serve_port(tcfg, tparams, eos_id=eos, sync_every=4)
    assert out == _serve_jax(jcfg, params, eos_id=eos, sync_every=4)
    for rid, o in out.items():
        full = jax_greedy[rid]
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert o == full[:cut]
    assert len(out[0]) == 3


def test_temperature_sampling_repeats_under_seed(weights):
    _, _, tcfg, tparams = weights
    a, _ = _serve_port(tcfg, tparams, temperature=1.0, seed=5)
    b, _ = _serve_port(tcfg, tparams, temperature=1.0, seed=5)
    c, _ = _serve_port(tcfg, tparams, temperature=1.0, seed=6)
    assert a == b
    assert a != c
    assert all(0 <= t < tcfg.vocab_size for o in a.values() for t in o)


def test_engine_rejects_bad_input(weights):
    _, _, tcfg, tparams = weights
    eng = TE.ServingEngine(tcfg, tparams, slots=1, max_len=8, device="cpu")
    long = TE.Request(rid=0, prompt=np.zeros(8, np.int32))
    with pytest.raises(ValueError, match="max_len"):
        eng.admit_batch([long], 0.0)
    with pytest.raises(ValueError, match="sync_every"):
        TE.ServingEngine(tcfg, tparams, sync_every=0, device="cpu")
    # the logit softcap is served (test_torch_softcap.py holds its
    # tokens against the JAX engine's); a negative one is refused
    TE.ServingEngine(dataclasses.replace(tcfg, attn_logit_softcap=30.0),
                     tparams, device="cpu")
    with pytest.raises(ValueError, match="softcap"):
        TE.ServingEngine(dataclasses.replace(tcfg, attn_logit_softcap=-1.0),
                         tparams, device="cpu")
    # expert-parallel MoE is served under a mesh (test_torch_moe_ep.py);
    # without one its first forward raises
    ep_cfg = dataclasses.replace(TC.get_smoke("gpt_oss_20b"),
                                 moe_impl="ep", dtype="float32")
    ep = TE.ServingEngine(ep_cfg, TM.init_params(ep_cfg, device="cpu"),
                          device="cpu")
    with pytest.raises(RuntimeError, match="mesh_context"):
        ep.warmup()


def test_warmup_leaves_serving_unchanged(weights, jax_greedy):
    _, _, tcfg, tparams = weights
    reqs = _requests(TE, poisson_trace)
    eng = TE.ServingEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           device="cpu")
    eng.warmup()
    eng.run(reqs)
    assert {r.rid: r.output for r in reqs} == jax_greedy


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "gemma_2b", "qwen3_1_7b"])
def test_greedy_outputs_match_jax_engine_other_dense(arch):
    """qkv bias with zero-padded heads, geglu with tied embeddings and
    MQA, qk-norm: the engines agree on each."""
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    out, _ = _serve_port(tcfg, tparams, sync_every=4)
    assert out == _serve_jax(jcfg, params, sync_every=4)
