"""gemma-2b's head structure in the port against the JAX package, at fp32
on the CPU: 8 query heads over one KV head (MQA, rep 8) at head_dim 256,
the shape K1 and K2 take at their widest, with GeGLU and tied
embeddings, cut to 2 layers, d_model 64, d_ff 128 and a vocabulary of
512 (the full width runs on the card, in ``chip_smoke.py``).

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.
  * the logits of a right-padded prefill and of 8 greedy decode steps
    agree at atol = rtol = 1e-4 (summation order differs between the
    frameworks), and the greedy tokens are identical;
  * the engines' greedy tokens are identical: fixed slots, and paged KV
    with preemption (more sessions than slots) against the JAX engine
    with the same knobs; the port's chunked admission gives the fixed
    engine's tokens;
  * the analyzer traces one K1 op node a layer in a decode step.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gemma_2b as JG  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import gemma_2b as TG  # noqa: E402
from repro_torch.core.analyzer import analyze  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPE = dict(name="gemma-head-dim-256", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=1, head_dim=256, d_ff=128,
             vocab_size=512, dtype="float32")
PROMPTS = (6, 3, 5, 4, 7, 2)
MAX_NEW = 5


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JG.CONFIG, **SHAPE)
    tcfg = dataclasses.replace(TG.CONFIG, **SHAPE)
    params = JM.init_params(jcfg, jax.random.PRNGKey(21))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, tparams


def test_config_keeps_gemma_heads_geglu_and_tied_embeddings(model):
    jcfg, params, tcfg, tparams = model
    for cfg in (jcfg, tcfg):
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (8, 1, 256)
        assert cfg.activation == "geglu" and cfg.tie_embeddings
    assert (TG.CONFIG.num_heads, TG.CONFIG.num_kv_heads,
            TG.CONFIG.head_dim) == (8, 1, 256)
    assert "lm_head" not in tparams["embed"]


def test_prefill_and_decode_match_jax(model):
    jcfg, params, tcfg, tparams = model
    B, S, T = 3, 13, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.array([S - 1, 5, 0], np.int32)      # right-padded rows
    jprefill = jax.jit(functools.partial(JM.prefill, params, jcfg))
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    jl, jc = jprefill(jnp.asarray(toks), JM.init_cache(jcfg, B, T),
                      last_pos=jnp.asarray(last))
    tc = TM.init_cache(tcfg, B, T, device="cpu")
    assert tuple(tc["kv"]["k"].shape[-2:]) == (1, 256)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = last + 1
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(8):
        jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok)[:, None],
                                tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        tok, pos = jtok, pos + 1


def _requests(mod, cfg):
    rng = np.random.default_rng(3)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=MAX_NEW,
                        arrival=0.0) for i, n in enumerate(PROMPTS)]


def _serve(mod, cfg, params, **knobs):
    reqs = _requests(mod, cfg)
    extra = {"device": "cpu"} if mod is TE else {}
    eng = mod.ServingEngine(cfg, params, max_len=32, sync_every=2,
                            **knobs, **extra)
    eng.run(reqs)
    assert all(len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("knobs", [
    pytest.param(dict(slots=2), id="fixed"),
    pytest.param(dict(slots=2, kv_block_tokens=8, kv_pool_blocks=64),
                 id="paged")])
def test_engine_tokens_match_jax_engine(model, knobs):
    """Six sessions on two slots: the fixed engine cycles its slots, the
    paged one parks and activates sessions; each gives the JAX engine's
    greedy tokens with the same knobs, and the pool drains clean."""
    jcfg, params, tcfg, tparams = model
    ours, eng = _serve(TE, tcfg, tparams, **knobs)
    theirs, _ = _serve(JE, jcfg, params, **knobs)
    assert ours == theirs
    if "kv_block_tokens" in knobs:
        assert eng._paged.pool.free == eng._paged.pool.n_blocks
        assert eng._paged.pool.check()


def test_chunked_admission_gives_fixed_engine_tokens(model):
    """Chunked admission (4-token chunks, K2 at q_offset > 0 inside the
    model) gives the fixed-slot engine's greedy tokens."""
    _, _, tcfg, tparams = model
    fixed, _ = _serve(TE, tcfg, tparams, slots=2)
    chunked, _ = _serve(TE, tcfg, tparams, slots=2, prefill_chunk=4)
    assert chunked == fixed


def test_decode_step_traces_one_k1_node_a_layer(model):
    """The analyzer's decode step holds one K1 op node per layer (2) and
    no K2 node; the graph's attention nodes are those calls."""
    _, _, tcfg, tparams = model
    cache = TM.init_cache(tcfg, 2, 16, device="cpu")
    tg = analyze(lambda p, c, t, q: TM.decode_step(p, tcfg, t, c, q,
                                                   tagged=True),
                 tparams, cache, torch.tensor([[3], [5]], dtype=torch.int32),
                 torch.tensor([2, 4], dtype=torch.int32),
                 state_argnums=(1,), fuse=False)
    ops = [n.target._overloadpacket.__name__.split(".")[-1] for n in tg.eqns
           if getattr(n.target, "namespace", "") == "repro_torch"]
    assert ops == ["flash_decode"] * tcfg.num_layers
    assert len([n for n in tg.graph.nodes
                if n.name == "flash_attention"]) == tcfg.num_layers
