"""Rollback paths of the port's ``SessionManager.migrate`` / ``prefetch``
when the receiver cannot take a session, as ``tests/test_session_
rollback.py`` drives the JAX package's: slots full, or (paged,
``spill=False``) the block pool exhausted.  The rolled-back sessions
finish with the greedy tokens of an engine that never tried the move,
and of the JAX engines driven the same way; slots and blocks are left as
the reference leaves them.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``; fp32 on the CPU.
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
from repro_torch import convert  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

ARCH = "llama3_8b"
PAGED = dict(kv_block_tokens=8, kv_pool_blocks=4, spill=False)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]


def _reqs(mod, prompts, max_new=6, rid0=0):
    return [mod.Request(rid=rid0 + i, prompt=p.copy(),
                        max_new_tokens=max_new, arrival=0.0)
            for i, p in enumerate(prompts)]


def _drain(eng):
    while eng._any_active():
        eng.step(0.0)
        eng.sync(0.0)


def _engine(mod, slots, **kw):
    jcfg, jparams, tcfg, tparams = _model()
    if mod is TE:
        return TE.ServingEngine(tcfg, tparams, slots=slots, max_len=32,
                                sync_every=2, device="cpu", **kw)
    return JE.ServingEngine(jcfg, jparams, slots=slots, max_len=32,
                            sync_every=2, **kw)


def _reference(prompts):
    reqs = _reqs(TE, prompts)
    _engine(TE, 2).run(reqs)
    return [r.output for r in reqs]


def _layout(eng):
    """Which rid sits in each slot, and the pool's free blocks."""
    return ([r.rid if r is not None else None for r in eng.active],
            eng._paged.pool.free if eng._paged is not None else None)


def _migrate(mod, peer_slots, peer_kw, blocker_size, blocker_new, moved):
    """Blocker on the peer, two sessions on the source stepped twice, then
    migrate; returns (moved, source layout, peer layout, outputs)."""
    src = _engine(mod, 2)
    peer = _engine(mod, peer_slots, **peer_kw)
    blocker = _reqs(mod, _prompts((blocker_size,), seed=8),
                    max_new=blocker_new, rid0=100)
    assert peer.admit_batch(blocker, 0.0) == 1
    mig = _reqs(mod, _prompts((4, 6), seed=7))
    assert src.admit_batch(mig, 0.0) == 2
    src.step(0.0)
    src.step(0.0)
    n = src.sessions.migrate(peer, 0.0)
    assert n == moved
    layouts = (_layout(src), _layout(peer))
    _drain(src)
    _drain(peer)
    return n, layouts, [r.output for r in mig]


@pytest.mark.parametrize("case", ["peer_slots_full", "peer_pool_exhausted",
                                  "partial_move"])
def test_migrate_rolls_back(case):
    """The peer has no free slot (nothing moves), a free slot but no
    blocks (paged, spill=False: nothing moves), or one free slot (one
    session moves, the other is restored locally)."""
    peer_slots, peer_kw, size, new, moved = {
        "peer_slots_full": (1, {}, 5, 12, 0),
        "peer_pool_exhausted": (2, PAGED, 20, 11, 0),
        "partial_move": (2, {}, 5, 12, 1)}[case]
    got = _migrate(TE, peer_slots, peer_kw, size, new, moved)
    assert got == _migrate(JE, peer_slots, peer_kw, size, new, moved)
    if moved == 0:
        assert sorted(r for r in got[1][0][0] if r is not None) == [0, 1]
    assert got[2] == _reference(_prompts((4, 6), seed=7))


def _prefetch(mod, local_kw):
    peer = _engine(mod, 2)
    local = _engine(mod, 1 if not local_kw else 2, **local_kw)
    blocker = _reqs(mod, _prompts((5 if not local_kw else 20,), seed=10),
                    max_new=12 if not local_kw else 11, rid0=100)
    assert local.admit_batch(blocker, 0.0) == 1
    far = _reqs(mod, _prompts((5, 4), seed=9))
    assert peer.admit_batch(far, 0.0) == 2
    peer.step(0.0)
    peer.step(0.0)
    # the local engine cannot take it: the session goes back to the peer
    assert not local.sessions.prefetch(far[0].rid, peer, 0.0)
    assert any(r is not None and r.rid == far[0].rid for r in peer.active)
    layouts = (_layout(local), _layout(peer))
    _drain(peer)
    _drain(local)
    return layouts, [r.output for r in far]


@pytest.mark.parametrize("local_kw", [{}, PAGED],
                         ids=["local_slots_full", "local_pool_exhausted"])
def test_prefetch_returns_session(local_kw):
    got = _prefetch(TE, local_kw)
    assert got == _prefetch(JE, local_kw)
    assert got[1] == _reference(_prompts((5, 4), seed=9))
