"""The port's paged KV pool, priority preemption, host spill and the
sessions API against the JAX package, at fp32 on the CPU.

Mirrors the engine-side cases of ``tests/test_paged_kv.py``:
  * ``BlockPool``: the invariants after any interleaving of alloc and
    release (property-tested), and the same block ids as JAX's pool for
    the same sequence;
  * ``PagedKvCache`` block accounting (token paging, block bytes, fixed
    blocks, blocks per capacity) equal to JAX's for the four families;
  * the state movers against JAX's (``export_kv`` / ``import_kv``, the
    shards, ``import_kv_window``, ``pack`` / ``gather_kv_blocks``):
    shapes, byte counts and values at atol = rtol = 1e-5; in the port a
    round trip is bitwise and an export is a copy;
  * a paged engine with preemption (more sessions than slots), spill and
    prefetch gives the greedy tokens of a roomy fixed-slot engine and of
    the JAX engine with the same knobs, for the four families, and the
    pool drains clean;
  * priority preemption, and ``preempt_priority=False``;
  * the sessions API and the engine's handoff methods give the same
    tokens (checkpoint / restore, migrate, stream / receive, peer
    prefetch).

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.
"""
import dataclasses
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, strategies as st

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import kvpool as JK  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import kvpool as TK  # noqa: E402

ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b")
MOVER_TOL = dict(atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(cfg, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in sizes]


def _reqs(mod, prompts, max_new=6, priority=None):
    return [mod.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new,
                        arrival=0.0,
                        priority=0 if priority is None else priority[i])
            for i, p in enumerate(prompts)]


def _drain(eng, t=0.0):
    while eng._any_active():
        eng.step(t)
        eng.sync(t)


def _engine(arch, **kw):
    _, _, cfg, params = _model(arch)
    return TE.ServingEngine(cfg, params, device="cpu", **kw)


def _jengine(arch, **kw):
    jcfg, jparams, _, _ = _model(arch)
    return JE.ServingEngine(jcfg, jparams, **kw)


def _reference(arch, prompts, slots, max_new=6):
    """Greedy outputs of a roomy fixed-slot port engine."""
    reqs = _reqs(TE, prompts, max_new)
    _engine(arch, slots=slots, max_len=32, sync_every=2).run(reqs)
    return [r.output for r in reqs]


def _leaves(state):
    return list(TM.state_leaves(state))


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


# ===================================================================== #
# BlockPool: invariants and the JAX pool's block ids
# ===================================================================== #
def _interleave(pool, n_blocks, seed, failure):
    """An interleaving of admits, preempts and drains; returns every id
    list handed out."""
    rng = random.Random(seed)
    held, handed, rid = {}, [], 0
    for _ in range(80):
        op = rng.random()
        if op < 0.5:                     # admit
            want = rng.randint(1, max(1, n_blocks // 2))
            if want <= pool.free:
                ids = pool.alloc(rid, want)
                assert len(ids) == len(set(ids)) == want
                for other in held.values():
                    assert not set(ids) & set(other), "double allocation"
                held[rid] = ids
                handed.append(ids)
                rid += 1
            else:
                with pytest.raises(failure):
                    pool.alloc(rid, want)
        elif op < 0.8 and held:          # preempt: release one session
            pool.release(held.pop(rng.choice(sorted(held))))
        elif held:                       # drain: release everything
            for ids in held.values():
                pool.release(ids)
            held.clear()
        assert pool.check()
        assert pool.free + pool.allocated == n_blocks
        assert pool.allocated == sum(len(v) for v in held.values())
    for ids in held.values():
        pool.release(ids)
    assert pool.free == n_blocks and pool.check()
    return handed


@pytest.mark.parametrize("against_jax", [False, True])
@settings(max_examples=60, deadline=None)
@given(n_blocks=st.integers(min_value=1, max_value=24),
       seed=st.integers(min_value=0, max_value=10_000))
def test_blockpool_any_interleaving(against_jax, n_blocks, seed):
    """free + allocated == pool and no double allocation after any
    interleaving of alloc (admit), partial release (preempt) and full
    release (drain); against JAX's pool, the same block ids."""
    ours = _interleave(TK.BlockPool(n_blocks), n_blocks, seed, MemoryError)
    if against_jax:
        assert ours == _interleave(JK.BlockPool(n_blocks), n_blocks, seed,
                                   MemoryError)


def test_blockpool_rejects_foreign_release():
    pool = TK.BlockPool(4)
    pool.alloc(0, 2)
    with pytest.raises(ValueError, match="unowned"):
        pool.release([3])                # block 3 was never allocated


@pytest.mark.parametrize("arch", ARCHS)
def test_block_accounting_matches_jax(arch):
    jcfg, _, cfg, _ = _model(arch)
    for bt, blocks, max_len in ((8, 64, 32), (16, 5, 64)):
        ours = TK.PagedKvCache(cfg, blocks, bt, max_len,
                               device=torch.device("cpu"))
        ref = JK.PagedKvCache(jcfg, blocks, bt, max_len)
        assert (ours.token_paged, ours.block_bytes, ours.fixed_blocks) == \
            (ref.token_paged, ref.block_bytes, ref.fixed_blocks)
        assert [ours.blocks_for(n) for n in range(1, max_len + 1)] == \
            [ref.blocks_for(n) for n in range(1, max_len + 1)]
        if ours.token_paged:
            assert {k: tuple(v.shape) for k, v in ours.arrays.items()} == \
                {k: v.shape for k, v in ref.arrays.items()}
    with pytest.raises(ValueError, match="multiple"):
        TK.PagedKvCache(cfg, 4, 24, 32, device=torch.device("cpu"))


# ===================================================================== #
# State movers against JAX's; round trips in the port
# ===================================================================== #
@pytest.mark.parametrize("arch", ARCHS)
def test_state_movers_match_jax(arch):
    """export / import, shards, windows and pack / gather: equal shapes
    and byte counts, values within 1e-5 of JAX's; a port round trip is
    bitwise, and an export is a copy of the slot."""
    jcfg, jparams, cfg, params = _model(arch)
    rng = np.random.default_rng(2)
    S, T, plen = 6, 16, 5
    toks = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
    _, cache = TM.prefill(params, cfg, torch.from_numpy(toks),
                          TM.init_cache(cfg, 3, T, device="cpu"))
    _, jcache = JM.prefill(jparams, jcfg, jnp.asarray(toks),
                           JM.init_cache(jcfg, 3, T))

    def same(ours, ref):
        a, b = _leaves(ours), _jleaves(ref)
        assert [tuple(x.shape) for x in a] == [x.shape for x in b]
        assert TM.kv_state_bytes(ours) == JM.kv_state_bytes(ref)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y, **MOVER_TOL)

    state = TM.export_kv(cfg, cache, 1, plen)
    same(state, JM.export_kv(jcfg, jcache, 1, plen))
    # import into a blank cache: the port's in place, JAX's functional
    blank = TM.init_cache(cfg, 2, T, device="cpu")
    storage = [t.data_ptr() for t in _leaves(blank)]
    filled = TM.import_kv(cfg, blank, 0, state)
    assert filled is blank and [t.data_ptr() for t in _leaves(blank)] == \
        storage
    jfilled = JM.import_kv(jcfg, JM.init_cache(jcfg, 2, T), 0,
                           JM.export_kv(jcfg, jcache, 1, plen))
    same(filled, jfilled)
    again = TM.export_kv(cfg, filled, 0, plen)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(again),
                                                 _leaves(state)))
    # an export is a copy: writing the slot afterwards leaves it alone
    kept = [t.clone() for t in _leaves(state)]
    for t in _leaves(cache):
        t[:, 1].fill_(7.0)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(state), kept))
    _, cache = TM.prefill(params, cfg, torch.from_numpy(toks),
                          TM.init_cache(cfg, 3, T, device="cpu"))

    # shards, and the kv window of several layers at once
    counts = TM.cache_layer_counts(cache)
    assert counts == JM.cache_layer_counts(jcache)
    for key, n in counts.items():
        for layer in range(n):
            t0, t1 = (1, 4) if key == "kv" else (None, None)
            same(TM.export_kv_shard(cfg, cache, 2, key, layer, t0, t1),
                 JM.export_kv_shard(jcfg, jcache, 2, key, layer, t0, t1))
    if "kv" in counts and cfg.sliding_window is None:
        n = counts["kv"]
        shards = [TM.export_kv_shard(cfg, cache, 2, "kv", i, 0, 3)
                  for i in range(n)]
        jshards = [JM.export_kv_shard(jcfg, jcache, 2, "kv", i, 0, 3)
                   for i in range(n)]
        win = TM.import_kv_window(cfg, TM.init_cache(cfg, 2, T,
                                                     device="cpu"),
                                  1, 0, shards, 0)
        jwin = JM.import_kv_window(jcfg, JM.init_cache(jcfg, 2, T), 1, 0,
                                   jshards, 0)
        same(TM.export_kv(cfg, win, 1, 3), JM.export_kv(jcfg, jwin, 1, 3))
        assert torch.equal(win["kv"]["k"][:, 1, :3],
                           cache["kv"]["k"][:, 2, :3])

    # pack / gather through a block pool
    if "kv" in counts and cfg.sliding_window is None:
        bt, ids = 2, [4, 1, 6]
        pool = TL.make_kv_block_pool(cfg, 8, bt, torch.device("cpu"),
                                     layers=counts["kv"])
        jpool = JL.make_kv_block_pool(jcfg, 8, bt, layers=counts["kv"])
        TM.pack_kv_blocks(pool, state["kv"], ids)
        jpool = JM.pack_kv_blocks(
            jpool, JM.export_kv(jcfg, jcache, 1, plen)["kv"], ids)
        same(pool, jpool)
        back = TM.gather_kv_blocks(pool, ids, plen)
        same(back, JM.gather_kv_blocks(jpool, ids, plen))
        assert all(torch.equal(a, b) for a, b in
                   zip(_leaves(back), _leaves(state["kv"])))


# ===================================================================== #
# Preempt-and-resume, spill and prefetch: bit parity
# ===================================================================== #
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_preempt_resume_bit_identical(arch):
    """Six sessions on a two-slot paged engine (park / activate cycling)
    give the greedy tokens of a six-slot engine and of the JAX paged
    engine with the same knobs; the pool drains clean."""
    _, _, cfg, _ = _model(arch)
    prompts = _prompts(cfg, (6, 3, 5, 4, 7, 2), seed=1)
    knobs = dict(slots=2, max_len=32, sync_every=2, kv_block_tokens=8,
                 kv_pool_blocks=64)
    paged = _reqs(TE, prompts)
    eng = _engine(arch, **knobs)
    eng.run(paged)
    jpaged = _reqs(JE, prompts)
    _jengine(arch, **knobs).run(jpaged)
    assert [r.output for r in paged] == _reference(arch, prompts, 6)
    assert [r.output for r in paged] == [r.output for r in jpaged]
    assert eng._paged.pool.free == eng._paged.pool.n_blocks
    assert eng._paged.pool.check()


def test_paged_admits_beyond_slots():
    """Admission is gated by blocks, not slots: 8 sessions enter a 2-slot
    engine at once and all complete."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (4, 5, 3, 6, 4, 5, 3, 4), seed=2)
    reqs = _reqs(TE, prompts, max_new=4)
    eng = _engine("llama3_8b", slots=2, max_len=32, sync_every=2,
                  kv_block_tokens=8, kv_pool_blocks=64)
    assert eng.admit_batch(reqs, 0.0) == 8
    assert len(eng._paged.parked()) >= 6
    _drain(eng)
    assert eng.stats.completed == 8
    assert all(len(r.output) == 4 for r in reqs)


@pytest.mark.parametrize("arch", ("llama3_8b", "zamba2_7b"))
def test_spill_prefetch_roundtrip_bit_identical(arch):
    """Spilling a parked session to CPU tensors and letting the scheduler
    prefetch it back changes no token (and the JAX engine, driven the
    same way, gives the same tokens)."""
    _, _, cfg, _ = _model(arch)
    prompts = _prompts(cfg, (5, 3, 4, 6), seed=3)
    outs = []
    for mod, make in ((TE, _engine), (JE, _jengine)):
        spilled = _reqs(mod, prompts)
        eng = make(arch, slots=2, max_len=32, sync_every=2,
                   kv_block_tokens=8, kv_pool_blocks=64)
        assert eng.admit_batch(spilled, 0.0) == 4
        parked = eng._paged.parked()
        assert parked
        eng._paged.spill(parked[0])
        assert eng._paged.spills == 1
        if mod is TE:
            host = eng._paged.resident[parked[0]].host
            assert all(t.device.type == "cpu" for t in TM.state_leaves(host))
        _drain(eng)
        assert eng._paged.prefetches == 1
        assert eng._paged.pool.free == eng._paged.pool.n_blocks
        outs.append([r.output for r in spilled])
    assert outs[0] == _reference(arch, prompts, 4) == outs[1]


def test_park_activate_roundtrip_is_bitwise():
    """Park -> spill -> prefetch -> activate returns every cache leaf of
    the slot bit for bit."""
    _, _, cfg, _ = _model("zamba2_7b")
    prompts = _prompts(cfg, (5, 3, 4), seed=4)
    eng = _engine("zamba2_7b", slots=2, max_len=32, sync_every=2,
                  kv_block_tokens=8, kv_pool_blocks=64)
    reqs = _reqs(TE, prompts)
    assert eng.admit_batch(reqs[:2], 0.0) == 2
    eng.step(0.0)
    eng.sync(0.0)
    pos = int(eng.pos[0])
    before = TM.export_kv(cfg, eng.cache, 0, pos)
    rid = eng.active[0].rid
    eng._park_slot(0, 0.0)
    eng._paged.spill(rid)
    for t in TM.state_leaves(eng.cache):
        t[:, 0].fill_(3.0)              # the slot's next occupant
    eng._activate_parked(rid, 0, 0.0)
    assert eng._paged.prefetches == 1 and eng.active[0].rid == rid
    after = TM.export_kv(cfg, eng.cache, 0, pos)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(before),
                                                 _leaves(after)))


def test_priority_preempts_lowest_resident():
    """Under block pressure a high-priority arrival parks and spills the
    lowest-priority resident; with ``preempt_priority=False`` nothing is
    displaced for priority.  The JAX engine counts the same."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (8, 8, 8), seed=4)
    knobs = dict(slots=2, max_len=16, sync_every=2, kv_block_tokens=8,
                 kv_pool_blocks=4)
    outs = []
    for mod, make in ((TE, _engine), (JE, _jengine)):
        reqs = _reqs(mod, prompts, priority=[0, 0, 5])
        eng = make("llama3_8b", **knobs)
        assert eng.admit_batch(reqs[:2], 0.0) == 2
        assert eng.admit_batch(reqs[2:], 0.0) == 1
        assert eng._paged.preemptions >= 1
        _drain(eng)
        assert eng.stats.completed == 3
        assert eng._paged.pool.check()
        outs.append(([r.output for r in reqs], eng._paged.preemptions,
                     eng._paged.spills, eng._paged.prefetches))
    assert outs[0] == outs[1]

    eng2 = _engine("llama3_8b", preempt_priority=False, spill=False, **knobs)
    reqs2 = _reqs(TE, prompts, priority=[0, 0, 5])
    assert eng2.admit_batch(reqs2[:2], 0.0) == 2
    assert eng2.admit_batch(reqs2[2:], 0.0) == 0
    assert eng2._paged.preemptions == 0
    _drain(eng2)


def test_paged_run_with_priorities_matches_jax():
    """``run`` on a paged engine whose pool forces preemption, spill and
    prefetch, with priorities alternating 0 / 1: the JAX engine's greedy
    tokens, and every request completes."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (7, 12, 3, 9, 5, 11), seed=12)
    knobs = dict(slots=2, max_len=24, sync_every=2, kv_block_tokens=8,
                 kv_pool_blocks=6)
    prio = [i % 2 for i in range(len(prompts))]
    ours = _reqs(TE, prompts, max_new=5, priority=prio)
    eng = _engine("llama3_8b", **knobs)
    eng.run(ours)
    ref = _reqs(JE, prompts, max_new=5, priority=prio)
    jeng = _jengine("llama3_8b", **knobs)
    jeng.run(ref)
    assert [r.output for r in ours] == [r.output for r in ref]
    assert eng.stats.completed == len(prompts)
    assert eng._paged.preemptions > 0 and eng._paged.spills > 0 \
        and eng._paged.prefetches > 0
    assert (eng._paged.preemptions, eng._paged.spills,
            eng._paged.prefetches) == (jeng._paged.preemptions,
                                       jeng._paged.spills,
                                       jeng._paged.prefetches)
    assert [r.output for r in ours] == _reference("llama3_8b", prompts, 6,
                                                  max_new=5)


def test_paged_chunked_admission_keeps_every_session():
    """A paged engine with chunked admission: while a group is prefilled
    in chunks, the scheduler runs (a decode step between chunks) and
    must not activate a parked session into the group's slots.  The
    port completes every request with the fixed engine's tokens; the
    JAX engine does activate into them, and loses those sessions
    (ROADMAP, Queue 3), which this case pins."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (5, 18, 7, 21, 9), seed=13)
    knobs = dict(slots=2, max_len=32, sync_every=2, kv_block_tokens=8,
                 kv_pool_blocks=64, prefill_chunk=4)
    ours = _reqs(TE, prompts, max_new=6)
    eng = _engine("llama3_8b", **knobs)
    assert eng.admit_batch(ours, 0.0) == len(prompts)
    _drain(eng)
    assert eng.stats.completed == len(prompts)
    assert [r.output for r in ours] == _reference("llama3_8b", prompts, 6)
    assert eng._paged.pool.free == eng._paged.pool.n_blocks
    ref = _reqs(JE, prompts, max_new=6)
    jeng = _jengine("llama3_8b", **knobs)
    jeng.admit_batch(ref, 0.0)
    for _ in range(200):        # a lost session can keep it stepping
        if not jeng._any_active():
            break
        jeng.step(0.0)
        jeng.sync(0.0)
    assert jeng.stats.completed < len(prompts)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_paged_chunked_multi_group_wave_keeps_every_session(arch):
    """A recurrent family admits a wave as exact-length groups.  While
    the first group is prefilled in chunks, the scheduler runs and must
    not activate a parked session (the previous wave's) into the slot of
    a later group of the same wave: every request completes with the
    fixed engine's tokens and the pool ends fully free."""
    _, _, cfg, _ = _model(arch)
    prompts = _prompts(cfg, (9, 14, 11, 17, 6, 13), seed=14)
    ours = _reqs(TE, prompts, max_new=6)
    eng = _engine(arch, slots=2, max_len=32, sync_every=2,
                  kv_block_tokens=8, kv_pool_blocks=64, prefill_chunk=4)
    assert eng.admit_batch(ours, 0.0) == len(prompts)
    _drain(eng)
    assert eng.stats.completed == len(prompts)
    assert all(r.finished is not None for r in ours)
    assert [r.output for r in ours] == _reference(arch, prompts, 6)
    assert not eng._paged.resident
    assert eng._paged.pool.free == eng._paged.pool.n_blocks
    assert eng._paged.pool.check()


# ===================================================================== #
# The sessions API and the engine's handoff methods
# ===================================================================== #
def test_sessions_match_handoff_methods():
    """sessions.prefill / restore and prefill_handoff / admit_handoff are
    the same machine: the same wire dicts, the same decode."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (6, 4), seed=5)
    keys = {"rid", "state", "last_tok", "pos", "budget", "kv_bytes", "done"}
    legacy = _reqs(TE, prompts)
    pre = _engine("llama3_8b", slots=2, max_len=32)
    dec = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    for r in legacy:
        h = pre.prefill_handoff(r, 0.0)
        assert set(h) == keys
        assert dec.admit_handoff(r, h, 0.0)
    dec.run([])
    facade = _reqs(TE, prompts)
    pre = _engine("llama3_8b", slots=2, max_len=32)
    dec = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    for r in facade:
        st_ = pre.sessions.prefill(r, 0.0)
        assert isinstance(st_, TK.SessionState)
        assert set(st_.to_legacy()) == keys
        assert dec.sessions.restore(r, st_, 0.0)
    dec.run([])
    assert [r.output for r in legacy] == [r.output for r in facade] == \
        _reference("llama3_8b", prompts, 2)


def test_checkpoint_restore_matches_export_import():
    """sessions.checkpoint / restore == export_sessions / import_session,
    mid-decode, with the tokens of an engine that never moved them."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (5, 3, 4), seed=6)
    moved = _reqs(TE, prompts)
    src = _engine("llama3_8b", slots=3, max_len=32, sync_every=2)
    assert src.admit_batch(moved, 0.0) == 3
    src.step(0.0)
    src.step(0.0)
    exported = src.export_sessions(0.0)
    assert len(exported) == 3 and not src._any_active()
    dst = _engine("llama3_8b", slots=3, max_len=32, sync_every=2)
    for _, h in exported:
        r = next(r for r in moved if r.rid == h["rid"])
        assert dst.import_session(r, h, 0.0)
    _drain(dst)
    assert [r.output for r in moved] == _reference("llama3_8b", prompts, 3)


def test_sessions_migrate_between_engines():
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (4, 6), seed=7)
    mig = _reqs(TE, prompts)
    a = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    b = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    assert a.admit_batch(mig, 0.0) == 2
    a.step(0.0)
    a.step(0.0)
    assert a.sessions.migrate(b, 0.0) == 2
    assert not a._any_active()
    _drain(b)
    assert [r.output for r in mig] == _reference("llama3_8b", prompts, 2)


def test_stream_receive_kvslice_and_legacy_dicts():
    """sessions.stream yields KvSlice items then the SessionState;
    sessions.receive takes both them and their dict encodings, and
    checksummed slices verify."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (7, 5), seed=8)
    typed = _reqs(TE, prompts)
    pre = _engine("llama3_8b", slots=2, max_len=32, prefill_chunk=4)
    dec = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    for r in typed:
        items = list(pre.sessions.stream(r, 0.0, checksum=True))
        assert isinstance(items[-1], TK.SessionState)
        assert all(isinstance(i, TK.KvSlice) and i.verify()
                   for i in items[:-1])
        wire = [i.to_legacy(header=True) if isinstance(i, TK.SessionState)
                else i.to_legacy() for i in items]
        assert dec.sessions.receive(r, wire, 0.0)
    dec.run([])
    assert [r.output for r in typed] == _reference("llama3_8b", prompts, 2)


def test_corrupted_shard_rolls_back():
    """A shard whose bytes no longer match its checksum raises
    ShardChecksumError after the slot is released."""
    _, _, cfg, _ = _model("llama3_8b")
    (p,) = _prompts(cfg, (6,), seed=9)
    req = TE.Request(rid=0, prompt=p, max_new_tokens=4)
    pre = _engine("llama3_8b", slots=1, max_len=32)
    dec = _engine("llama3_8b", slots=1, max_len=32, kv_block_tokens=8)
    items = list(pre.sessions.stream(req, 0.0, chunk_size=2, checksum=True))
    bad = items[1]
    bad.state["k"].add_(1.0)
    with pytest.raises(TK.ShardChecksumError):
        dec.sessions.receive(req, iter(items), 0.0)
    assert dec.active == [None] and not dec._paged.holds(req.rid)
    assert TK.kv_checksum(items[0].state) == items[0].checksum


def test_peer_prefetch_pulls_session():
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (5, 4), seed=9)
    far = _reqs(TE, prompts)
    peer = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    local = _engine("llama3_8b", slots=2, max_len=32, sync_every=2)
    assert peer.admit_batch(far, 0.0) == 2
    peer.step(0.0)
    peer.step(0.0)
    assert local.sessions.prefetch(far[0].rid, peer, 0.0)
    _drain(local)
    _drain(peer)
    assert [r.output for r in far] == _reference("llama3_8b", prompts, 2)


def test_snapshot_keeps_decoding_and_crash_frees_everything():
    """snapshot copies every session (active and parked) and frees
    nothing; crash loses them all and frees every slot and block."""
    _, _, cfg, _ = _model("llama3_8b")
    prompts = _prompts(cfg, (5, 4, 6), seed=10)
    reqs = _reqs(TE, prompts)
    eng = _engine("llama3_8b", slots=2, max_len=32, sync_every=2,
                  kv_block_tokens=8)
    assert eng.admit_batch(reqs, 0.0) == 3
    eng.step(0.0)
    snap = eng.sessions.snapshot(0.0)
    assert sorted(st.rid for _, st in snap) == [0, 1, 2]
    kept = [[t.clone() for t in TM.state_leaves(st.state)] for _, st in snap]
    eng.step(0.0)
    eng.sync(0.0)
    for (_, st), k in zip(snap, kept):
        assert all(torch.equal(a, b)
                   for a, b in zip(TM.state_leaves(st.state), k))
    lost = eng.sessions.crash(0.0)
    assert sorted(r.rid for r in lost) == [0, 1, 2]
    assert not eng._any_active()
    assert eng._paged.pool.free == eng._paged.pool.n_blocks
