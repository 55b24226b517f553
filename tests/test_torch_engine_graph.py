"""The port's engine as the CUDA graph of its decode step needs it, on the
CPU (where the graph never engages).

  * the decode state (``pos``, ``budget``, ``last_tok``, ``active_mask``)
    and every cache leaf keep their storage across steps, admissions,
    syncs, chunked admission and a paged park / activate, since a
    captured step reads and writes them at fixed addresses;
  * the columns of one sync window are distinct tensors;
  * the engagement predicate (``_graph_ok``) holds only for a CUDA
    device, the model's own decode step, greedy sampling, no ambient
    mesh and a plain cache, and ``graph_captures`` / ``graph_steps`` stay
    0 where it does not; the step's path follows it (eager, capture,
    replay), and a decode step that returns another cache dict is
    refused;
  * greedy tokens through the in-place state writes still match the JAX
    engine (MoE, with EOS).

The capture and replay themselves run only on the card
(``chip_smoke.py`` phase "graph": the graph's greedy tokens against the
eager step's, the kernels a replay runs on the card and no host sync in
a replay).
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
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.context import mesh_context  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

from _torch_dist import run  # noqa: E402

STATE = ("pos", "budget", "last_tok", "active_mask")
PROMPTS = (6, 3, 9, 4, 7, 2)


def _model(arch="llama3_8b"):
    cfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    g = torch.Generator().manual_seed(2)
    return cfg, TM.init_params(cfg, generator=g, device="cpu")


def _requests(cfg, max_new=(5, 3, 7, 2, 6, 4)):
    rng = np.random.default_rng(1)
    return [TE.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPTS, max_new))]


def _storage(eng):
    return [getattr(eng, n).data_ptr() for n in STATE] + \
        [t.data_ptr() for t in TM.state_leaves(eng.cache)]


def _watched(eng, names):
    """Wrap each engine method of ``names`` so that the decode state's
    and the cache's storage is checked after every call; returns the
    calls counted by name."""
    want = _storage(eng)
    calls = dict.fromkeys(names, 0)

    def wrap(name):
        fn = getattr(eng, name)

        def checked(*a, **kw):
            out = fn(*a, **kw)
            calls[name] += 1
            assert _storage(eng) == want, f"storage moved in {name}"
            return out
        setattr(eng, name, checked)
    for name in names:
        wrap(name)
    return calls


@pytest.mark.parametrize("mode", ["fixed", "paged", "chunked"])
def test_decode_state_keeps_storage(mode):
    """Six requests on two slots: steps, admissions between them, syncs;
    paged, sessions park and come back; chunked, steps between chunks.
    The storage never moves and the tokens are the fixed engine's."""
    cfg, params = _model()
    knobs = dict(slots=2, max_len=32, sync_every=2, device="cpu")
    base = _requests(cfg)
    TE.ServingEngine(cfg, params, **knobs).run(base)
    if mode == "paged":
        knobs.update(kv_block_tokens=8, kv_pool_blocks=64)
    elif mode == "chunked":
        knobs.update(prefill_chunk=4)
    eng = TE.ServingEngine(cfg, params, **knobs)
    names = ["step", "sync", "admit_batch"]
    if mode == "paged":
        names += ["_park_slot", "_activate_parked"]
    calls = _watched(eng, names)
    reqs = _requests(cfg)
    eng.run(reqs)
    assert [r.output for r in reqs] == [r.output for r in base]
    assert calls["step"] > 0 and calls["admit_batch"] >= 2
    if mode == "paged":
        assert calls["_park_slot"] > 0 and calls["_activate_parked"] > 0
    if mode == "chunked":
        # steps ran inside admissions, between chunks
        assert eng.stats.decode_steps > 0 and eng.stats.completed == 6


def test_window_columns_do_not_alias():
    cfg, params = _model()
    eng = TE.ServingEngine(cfg, params, slots=2, max_len=32, sync_every=4,
                           device="cpu")
    settle = eng._settle
    widths = []

    def checked(now):
        ptrs = [c.untyped_storage().data_ptr() for c in eng._cols]
        assert len(set(ptrs)) == len(ptrs)
        widths.append(len(ptrs))
        settle(now)
    eng._settle = checked
    eng.run(_requests(cfg))
    assert max(widths) == 4


def _faked_cuda(eng):
    """The engine as the predicate would see it on a card (nothing is
    run: only ``_graph_ok`` and ``_decoder`` read the device)."""
    eng.device = torch.device("cuda")
    return eng


@pytest.mark.parametrize("case", ["qualifies", "cpu", "decode_fn",
                                  "temperature", "mesh"])
def test_graph_predicate(case):
    cfg, params = _model()
    eng = TE.ServingEngine(cfg, params, slots=2, max_len=32, device="cpu",
                           temperature=0.7 if case == "temperature" else 0.0)
    if case != "cpu":
        _faked_cuda(eng)
    if case == "decode_fn":
        # set after construction, as the benchmark's planted faults do
        eng._decode_custom = lambda p, c, t, pos: TM.decode_step(
            p, cfg, t, c, pos)
    if case == "mesh":
        with mesh_context(object()):
            assert not eng._graph_ok()
        assert eng._graph_ok()
        return
    assert eng._graph_ok() is (case == "qualifies")


def test_decoder_follows_predicate_and_cache():
    cfg, params = _model()
    eng = TE.ServingEngine(cfg, params, slots=2, max_len=32, device="cpu")
    assert eng._decoder() == eng._step_fused
    _faked_cuda(eng)
    assert eng._decoder() == eng._capture
    eng._graph = object()
    assert eng._decoder() == eng._replay
    eng._decode_custom = lambda p, c, t, pos: TM.decode_step(
        p, cfg, t, c, pos)
    assert eng._decoder() == eng._step_fused


@pytest.mark.parametrize("case", ["cpu", "decode_fn", "temperature"])
def test_graph_counters_stay_zero_off_the_card(case):
    cfg, params = _model()
    kw = {}
    if case == "decode_fn":
        kw["decode_fn"] = lambda p, c, t, pos: TM.decode_step(
            p, cfg, t, c, pos)
    if case == "temperature":
        kw["temperature"] = 1.0
    eng = TE.ServingEngine(cfg, params, slots=2, max_len=32, sync_every=3,
                           device="cpu", **kw)
    with trace.recording() as tr:
        s = eng.run(_requests(cfg)).summary()
    assert s["completed"] == 6 and s["decode_steps"] > 0
    assert (s["graph_captures"], s["graph_steps"]) == (0, 0)
    spans = [x for x in tr.spans if x.name == "decode.enqueue"]
    assert len(spans) == s["decode_steps"]
    assert all(x.attrs == {"graph": 0} for x in spans)


def test_step_refuses_a_cache_written_out_of_place(monkeypatch):
    """A captured step reads and writes the cache at fixed addresses, so
    the step refuses a decode step that returns another cache dict."""
    cfg, params = _model()
    eng = TE.ServingEngine(cfg, params, slots=2, max_len=32, device="cpu")
    step = TM.decode_step

    def out_of_place(*a, **kw):
        logits, cache = step(*a, **kw)
        return logits, dict(cache)
    monkeypatch.setattr(TE.M, "decode_step", out_of_place)
    with pytest.raises(RuntimeError, match="in place"):
        eng.run(_requests(cfg))


def dtensor_cache_predicate():
    """Run in a subprocess under a one-rank gloo group: the predicate
    with a plain cache, then with one cache leaf a replicated DTensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg, params = _model()
    eng = _faked_cuda(TE.ServingEngine(cfg, params, slots=2, max_len=32,
                                       device="cpu"))
    plain = eng._graph_ok()
    mesh = init_device_mesh("cpu", (1,))
    kv = eng.cache["kv"]
    kv["k"] = distribute_tensor(kv["k"], mesh, [Replicate()])
    return plain, eng._graph_ok(), eng.stats.graph_steps


def test_graph_predicate_false_with_dtensor_cache():
    plain, sharded, steps = run("""
    from _torch_dist import one_rank, save
    import test_torch_engine_graph as T
    with one_rank():
        save(OUT, T.dtensor_cache_predicate())
    """)
    assert plain and not sharded and steps == 0


def test_greedy_moe_with_eos_matches_jax_through_in_place_state():
    arch = "gpt_oss_20b"
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    knobs = dict(slots=2, max_len=32, sync_every=3)
    ours = _requests(tcfg)
    TE.ServingEngine(tcfg, tparams, device="cpu", **knobs).run(ours)
    eos = ours[2].output[3]
    ours = _requests(tcfg)
    TE.ServingEngine(tcfg, tparams, device="cpu", eos_id=eos,
                     **knobs).run(ours)
    ref = [JE.Request(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens)
           for r in _requests(tcfg)]
    JE.ServingEngine(jcfg, jparams, eos_id=eos, **knobs).run(ref)
    assert [r.output for r in ours] == [r.output for r in ref]
    assert len(ours[2].output) <= 4 and ours[2].output[-1] == eos
