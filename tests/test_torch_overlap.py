"""The port's chunked prefill and streamed (layer, chunk) handoff against
the JAX package, at fp32 on the CPU.

Mirrors the engine-side cases of ``tests/test_overlap.py``:
  * ``prefill_chunked`` against JAX's, for every decoder family at chunk
    sizes 1, 2, 3 and 5 with per-row ``last_pos``: logits and the filled
    cache at atol = rtol = 2e-5 (the reference test's tolerance), and
    against the port's own whole prefill at the same tolerance;
  * installing every (layer, chunk) shard equals ``import_kv`` of the
    whole export, and the shard bytes add up to it;
  * mamba2 carries its state across chunks;
  * the streamed handoff gives the greedy tokens of one engine and of
    the JAX pair, for every family; a request done at prefill releases
    the reserved slot; a full engine refuses without consuming the
    producer; an oversized handoff leaks no slot;
  * chunked admission steps the live slots between chunks and changes
    no token (and matches the JAX engine with the same knob at
    sync_every 1; at sync_every 8 the JAX engine drops the admitted
    slot's first tokens and the port does not);
  * ``admit_handoff(now=None)`` stamps times through the engine clock.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b")
TOL = dict(atol=2e-5, rtol=2e-5)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    return t.detach().numpy()


def _leaves(state):
    return [state[k][n] for k in sorted(state) for n in sorted(state[k])]


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


# ===================================================================== #
# Model level: chunked prefill == whole prefill == JAX
# ===================================================================== #
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_jax_and_whole(arch):
    """Per-row last_pos selection across chunk boundaries; the filled
    cache too (attention KV over the filled prefix).  A ring buffer
    (gpt-oss's window) takes one whole prefill in both packages."""
    jcfg, jparams, tcfg, tparams = _model(arch)
    rng = np.random.default_rng(0)
    B, S, T = 2, 7, 16
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    last = np.asarray([S - 1, 4], np.int32)
    lg_w, cache_w = TM.prefill(tparams, tcfg, torch.from_numpy(toks),
                               TM.init_cache(tcfg, B, T, device="cpu"),
                               last_pos=torch.from_numpy(last))
    # JAX's chunk call jitted, as its engine runs it (``_prefill_at``)
    jcall = jax.jit(lambda c, t, off, lp: JM.prefill(
        jparams, jcfg, t, c, offset=off, last_pos=lp))
    for cs in (1, 2, 3, 5):
        lg_j, cache_j = JM.prefill_chunked(
            jparams, jcfg, jnp.asarray(toks), JM.init_cache(jcfg, B, T),
            chunk_size=cs, last_pos=jnp.asarray(last), prefill_call=jcall)
        lg_c, cache_c = TM.prefill_chunked(
            tparams, tcfg, torch.from_numpy(toks),
            TM.init_cache(tcfg, B, T, device="cpu"), chunk_size=cs,
            last_pos=torch.from_numpy(last))
        np.testing.assert_allclose(_np(lg_c), np.asarray(lg_j), **TOL)
        np.testing.assert_allclose(_np(lg_c), _np(lg_w), **TOL)
        for row in range(B):
            ours = TM.export_kv(tcfg, cache_c, row, S)
            for a, b in zip(_leaves(ours),
                            _jleaves(JM.export_kv(jcfg, cache_j, row, S))):
                np.testing.assert_allclose(_np(a), b, **TOL)
            for a, b in zip(_leaves(ours),
                            _leaves(TM.export_kv(tcfg, cache_w, row, S))):
                np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_chunk_mode_rejects_ring_buffer():
    _, _, tcfg, tparams = _model("gpt_oss_20b")
    cache = TM.init_cache(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="ring-buffer"):
        TM.prefill(tparams, tcfg, torch.zeros((1, 4), dtype=torch.int32),
                   cache, offset=4)
    with pytest.raises(ValueError, match="exceeds"):
        _, _, dcfg, dparams = _model("llama3_8b")
        TM.prefill(dparams, dcfg, torch.zeros((1, 4), dtype=torch.int32),
                   TM.init_cache(dcfg, 1, 8, device="cpu"), offset=6)


def test_layer_shards_reassemble_whole_export():
    """Installing every (layer, chunk) shard == import_kv of the whole
    export, bit for bit, and the shard bytes add up to it (hybrid: kv
    and mamba components); the byte counts equal JAX's."""
    jcfg, jparams, cfg, params = _model("zamba2_7b")
    rng = np.random.default_rng(1)
    S, T = 6, 16
    toks = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    _, cache = TM.prefill(params, cfg, torch.from_numpy(toks),
                          TM.init_cache(cfg, 2, T, device="cpu"))
    whole = TM.import_kv(cfg, TM.init_cache(cfg, 1, T, device="cpu"), 0,
                         TM.export_kv(cfg, cache, 1, S))
    sharded = TM.init_cache(cfg, 1, T, device="cpu")
    _, jcache = JM.prefill(jparams, jcfg, jnp.asarray(toks),
                           JM.init_cache(jcfg, 2, T))
    total = jtotal = 0
    for key, n in TM.cache_layer_counts(cache).items():
        assert JM.cache_layer_counts(jcache)[key] == n
        for layer in range(n):
            windows = [(t0, min(t0 + 2, S)) for t0 in range(0, S, 2)] \
                if key == "kv" else [(None, None)]
            for t0, t1 in windows:
                sh = TM.export_kv_shard(cfg, cache, 1, key, layer, t0, t1)
                total += TM.kv_state_bytes(sh)
                jtotal += JM.kv_state_bytes(JM.export_kv_shard(
                    jcfg, jcache, 1, key, layer, t0, t1))
                TM.import_kv_shard(cfg, sharded, 0, key, layer, sh, t0 or 0)
    assert total == jtotal == TM.kv_state_bytes(TM.export_kv(cfg, cache, 1,
                                                              S))
    for a, b in zip(_leaves(whole), _leaves(sharded)):
        assert torch.equal(a, b)


def test_recurrent_state_carries_across_chunks():
    """mamba2 with an incoming state and S > 1 continues that state: two
    pieces equal one whole run, and JAX's mamba2 on the same pieces (the
    chunked-prefill case above covers rwkv6 and the whole models)."""
    jcfg, _, cfg, _ = _model("zamba2_7b")
    jp = JS.init_mamba2(jcfg, jax.random.PRNGKey(0))
    p = convert.tree_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 8, cfg.d_model), jnp.float32))

    def fresh():
        return {k: v[0] for k, v in
                TS.make_mamba2_state(cfg, 2, torch.device("cpu")).items()}
    xt = torch.from_numpy(x.copy())
    st_w = fresh()
    y_whole, _ = TS.mamba2(p, xt, cfg, state=st_w)
    st = fresh()
    y1, _ = TS.mamba2(p, xt[:, :3], cfg, state=st)
    y2, _ = TS.mamba2(p, xt[:, 3:], cfg, state=st)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_whole),
                               **TOL)
    for k in st_w:
        np.testing.assert_allclose(_np(st[k]), _np(st_w[k]), **TOL)
    jst = {k: v[0] for k, v in JS.make_mamba2_state(jcfg, 2).items()}
    jy1, jst = JS.mamba2(jp, jnp.asarray(x[:, :3]), jcfg, state=jst)
    jy2, jst = JS.mamba2(jp, jnp.asarray(x[:, 3:]), jcfg, state=jst)
    np.testing.assert_allclose(_np(y2), np.asarray(jy2), **TOL)
    for k in st:
        np.testing.assert_allclose(_np(st[k]), np.asarray(jst[k]), **TOL)


# ===================================================================== #
# Engine level: streamed handoff + chunked colocated admission
# ===================================================================== #
def _single(arch, prompts, max_new=6):
    """Greedy outputs of one port engine that never split the requests."""
    _, _, cfg, params = _model(arch)
    reqs = [TE.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    TE.ServingEngine(cfg, params, slots=2, max_len=32, sync_every=2,
                     device="cpu").run(reqs)
    return [r.output for r in reqs]


def _jax_streamed(arch, prompts, max_new=6, chunk=3):
    jcfg, jparams, _, _ = _model(arch)
    reqs = [JE.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    pre = JE.ServingEngine(jcfg, jparams, slots=2, max_len=32)
    dec = JE.ServingEngine(jcfg, jparams, slots=2, max_len=32, sync_every=2)
    for req in reqs:
        assert dec.admit_handoff_stream(
            req, pre.prefill_handoff_stream(req, 0.0, chunk_size=chunk), 0.0)
    while dec._any_active():
        dec.step(0.0)
    dec.sync(0.0)
    return [r.output for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_handoff_bit_identical(arch):
    """prefill_handoff_stream -> admit_handoff_stream gives the greedy
    tokens of a single port engine and of the JAX pair, for every family
    (a ring buffer streams each layer whole)."""
    _, _, cfg, params = _model(arch)
    prompts = _prompts(cfg.vocab_size, (9, 5), seed=7)
    splits = [TE.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
              for i, p in enumerate(prompts)]
    pre = TE.ServingEngine(cfg, params, slots=2, max_len=32, device="cpu")
    dec = TE.ServingEngine(cfg, params, slots=2, max_len=32, sync_every=2,
                           device="cpu")
    for req in splits:
        shards = []

        def spy(gen):
            for item in gen:
                shards.append(item)
                yield item
        assert dec.admit_handoff_stream(
            req, spy(pre.prefill_handoff_stream(req, 0.0, chunk_size=3)),
            0.0)
        header, body = shards[-1], shards[:-1]
        assert header["header"] and not header["done"]
        assert body and all("state" in it and it["bytes"] > 0
                            for it in body)
        kv = [it for it in body if it["key"] == "kv"]
        if kv and cfg.sliding_window is None:
            expect = {(t0, min(t0 + 3, len(req.prompt)))
                      for t0 in range(0, len(req.prompt), 3)}
            assert {(it["t0"], it["t1"]) for it in kv} == expect
        assert header["kv_bytes"] == sum(it["bytes"] for it in body)
    assert dec.stats.prefill_batches == 0
    while dec._any_active():
        dec.step(0.0)
    dec.sync(0.0)
    got = [r.output for r in splits]
    assert got == _single(arch, prompts)
    assert got == _jax_streamed(arch, prompts)


def test_streamed_handoff_done_at_prefill_releases_slot():
    """A one-token request finishes at prefill after its shards streamed:
    the done header releases the reserved slot and the producer
    finalizes the request."""
    _, _, cfg, params = _model("llama3_8b")
    rng = np.random.default_rng(3)
    req = TE.Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=6).astype(np.int32), max_new_tokens=1)
    pre = TE.ServingEngine(cfg, params, slots=1, max_len=16, device="cpu")
    dec = TE.ServingEngine(cfg, params, slots=1, max_len=16, device="cpu")
    assert dec.admit_handoff_stream(
        req, pre.prefill_handoff_stream(req, 0.0, chunk_size=2), 0.0)
    assert dec.active == [None]
    assert not dec._any_active()
    assert pre.stats.completed == 1 and len(req.output) == 1


def test_streamed_handoff_full_engine_rejects_without_consuming():
    """No free slot -> False, and the producer generator was not advanced
    (nothing prefilled, nothing lost)."""
    _, _, cfg, params = _model("llama3_8b")
    rng = np.random.default_rng(4)

    def mk(rid):
        return TE.Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, size=5).astype(np.int32), max_new_tokens=4)
    pre = TE.ServingEngine(cfg, params, slots=2, max_len=16, device="cpu")
    dec = TE.ServingEngine(cfg, params, slots=1, max_len=16, device="cpu")
    first = mk(0)
    assert dec.admit_handoff_stream(
        first, pre.prefill_handoff_stream(first, 0.0, chunk_size=2), 0.0)
    blocked = mk(1)
    gen = pre.prefill_handoff_stream(blocked, 0.0, chunk_size=2)
    before = pre.stats.prefill_batches
    assert not dec.admit_handoff_stream(blocked, gen, 0.0)
    assert pre.stats.prefill_batches == before
    assert blocked.output == []


def test_streamed_handoff_oversized_releases_slot():
    """An oversized handoff fails without leaking the reserved slot: the
    engine keeps serving afterwards."""
    _, _, cfg, params = _model("llama3_8b")
    rng = np.random.default_rng(6)
    big = TE.Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=20).astype(np.int32), max_new_tokens=4)
    pre = TE.ServingEngine(cfg, params, slots=1, max_len=32, device="cpu")
    dec = TE.ServingEngine(cfg, params, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        dec.admit_handoff_stream(
            big, pre.prefill_handoff_stream(big, 0.0, chunk_size=4), 0.0)
    assert dec.active == [None]
    ok = TE.Request(rid=1, prompt=rng.integers(
        0, cfg.vocab_size, size=5).astype(np.int32), max_new_tokens=3)
    assert dec.admit_handoff_stream(
        ok, pre.prefill_handoff_stream(ok, 0.0, chunk_size=2), 0.0)
    while dec._any_active():
        dec.step(0.0)
    dec.sync(0.0)
    assert dec.stats.completed == 1


def _interleaved(mod, cfg, params, short, long_p, chunk, sync_every=1,
                 **kw):
    eng = mod.ServingEngine(cfg, params, slots=2, max_len=40,
                            sync_every=sync_every, prefill_chunk=chunk, **kw)
    a = mod.Request(rid=0, prompt=short.copy(), max_new_tokens=12)
    eng.admit(a, 0.0)
    b = mod.Request(rid=1, prompt=long_p.copy(), max_new_tokens=4)
    before = eng.stats.decode_steps
    eng.admit(b, 0.0)
    interleaved = eng.stats.decode_steps - before
    for _ in range(64):             # enough for 12 tokens; a lost slot
        if not eng._any_active():   # would otherwise step for ever
            break
        eng.step(0.0)
    eng.sync(0.0)
    return a.output, b.output, interleaved


@pytest.mark.parametrize("arch", ("llama3_8b", "rwkv6_3b"))
def test_chunked_admission_interleaves_decode(arch):
    """With prefill_chunk set, a long admitted prompt lets the live slot
    step between chunks and changes no token; the JAX engine with the
    same knob gives the same tokens and the same interleaving."""
    jcfg, jparams, cfg, params = _model(arch)
    rng = np.random.default_rng(11)
    short = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
    long_p = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    a0, b0, il0 = _interleaved(TE, cfg, params, short, long_p, None,
                               device="cpu")
    a1, b1, il1 = _interleaved(TE, cfg, params, short, long_p, 4,
                               device="cpu")
    assert il0 == 0
    assert il1 > 0
    assert (a1, b1) == (a0, b0)
    assert (a1, b1, il1) == _interleaved(JE, jcfg, jparams, short, long_p, 4)


def test_chunked_admission_keeps_the_new_slots_tokens():
    """At sync_every 8 the steps taken between chunks are buffered; the
    port settles them before the admitted slot goes live, so its greedy
    tokens are the unchunked engine's (and the JAX unchunked engine's).
    The JAX engine does not: the slot's first tokens sit behind those
    steps' idle markers and its next sync drops them, its done flag too,
    so the slot never frees (ROADMAP, Queue 3), which this case pins."""
    jcfg, jparams, cfg, params = _model("llama3_8b")
    rng = np.random.default_rng(11)
    short = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
    long_p = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    a0, b0, _ = _interleaved(TE, cfg, params, short, long_p, None,
                             sync_every=8, device="cpu")
    a1, b1, il1 = _interleaved(TE, cfg, params, short, long_p, 4,
                               sync_every=8, device="cpu")
    assert il1 > 0 and len(b1) == 4
    assert (a1, b1) == (a0, b0)
    assert (a0, b0) == _interleaved(JE, jcfg, jparams, short, long_p, None,
                                    sync_every=8)[:2]
    _, jb, _ = _interleaved(JE, jcfg, jparams, short, long_p, 4,
                            sync_every=8)
    assert len(jb) < len(b1)


def test_admit_handoff_uses_engine_clock_when_now_is_none():
    """admit_handoff(now=None) stamps wall-clock-mode times through the
    engine clock, not a literal 0.0."""
    _, _, cfg, params = _model("llama3_8b")
    rng = np.random.default_rng(5)
    req = TE.Request(rid=0, prompt=rng.integers(
        0, cfg.vocab_size, size=5).astype(np.int32), max_new_tokens=3)
    pre = TE.ServingEngine(cfg, params, slots=1, max_len=16, device="cpu")
    h = pre.prefill_handoff(req, 0.0)
    dec = TE.ServingEngine(cfg, params, slots=1, max_len=16, sync_every=1,
                           device="cpu")
    dec._clock = lambda: 7.5
    try:
        assert dec.admit_handoff(req, h, now=None)
        assert req.ttft == 7.5
        while dec._any_active():
            dec.step(None)
        dec.sync(None)
    finally:
        dec._clock = None
    assert req.finished == 7.5
