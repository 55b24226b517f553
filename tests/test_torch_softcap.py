"""The logit softcap (``attn_logit_softcap``) through the port's attention
paths, against the JAX package at fp32 on the CPU.

The reference applies ``tanh(logits / cap) * cap`` to the scaled logits
before the mask (``_sdpa_chunked``); the port does so in K1's and K2's
plain versions (``kernels/flash_attention/ref.py``, what the CPU runs)
and in its training form (``layers._sdpa_chunked``).  Parameters are
initialised in JAX and carried across by ``repro_torch.convert``.

The cap bites: each case first measures the largest scaled logit of the
uncapped port model on the same inputs (``_reach``) and sets the cap to
a quarter of it, so a model that dropped the cap fails; each case also
asserts that the uncapped logits lie more than 10x the tolerance from
the capped ones.  Covered: the dense decoder (llama3-8b smoke: prefill,
greedy decode, chunked prefill, the engine, a traced decode step planned
and executed on two logical devices), MoE with the sliding-window ring
decode (gpt-oss-20b smoke), the encoder and cross-attention (seamless
smoke), ``forward_logits`` / ``loss_fn`` and every gradient against
``jax.value_and_grad`` (dense and MoE), and the plain K1 / K2 against the
port's and the reference's ``_sdpa_chunked`` with the cap.
Tolerances: the parity tests' (1e-4; gradients ``test_torch_train.py``'s
GRAD_TOL, its atol in units of each leaf's largest magnitude above 1).
"""
import contextlib
import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models import layers as JLy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.workload import poisson_trace as j_poisson  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.analyzer import analyze, pin_nodes  # noqa: E402
from repro_torch.core.costmodel import CATALOG, PAPER_PAIRS  # noqa: E402
from repro_torch.core.executor import (build_executable,  # noqa: E402
                                       logical_devices)
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.workload import poisson_trace  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import leaves_as  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
REACH = 4.0                     # the inputs' largest scaled logit / cap
B, S, T, STEPS = 3, 13, 40, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch, seed=1):
    """(JAX config, JAX params, port config, port params), fp32, no cap."""
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, tcfg, convert.params_from_jax(_np_tree(params),
                                                       device="cpu")


def _capped(cfg, cap):
    return dataclasses.replace(cfg, attn_logit_softcap=cap)


@contextlib.contextmanager
def _recording(found: list):
    """Every plain K1 / K2 call appends its largest |scaled logit| (the
    uncapped logits ``ref._capped`` receives; masked pairs included)."""
    capped = FR._capped

    def rec(logits, softcap):
        found.append(float(logits.abs().max()))
        return capped(logits, softcap)
    FR._capped = rec
    try:
        yield
    finally:
        FR._capped = capped


def _reach(tcfg, tparams, toks, **kw) -> float:
    """The largest |scaled logit| of an uncapped port prefill of
    ``toks``."""
    found = []
    with _recording(found):
        TM.prefill(tparams, tcfg, torch.from_numpy(toks),
                   TM.init_cache(tcfg, toks.shape[0], T, device="cpu",
                                 enc_len=kw.get("enc_len")),
                   **kw.get("extras", {}))
    assert found
    return max(found)


def _cap_for(tcfg, tparams, toks, **kw) -> float:
    """A cap of 1 / REACH (at most half) of the inputs' largest scaled
    logit."""
    assert REACH >= 2.0
    return _reach(tcfg, tparams, toks, **kw) / REACH


def _tokens(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_bites(capped, uncapped):
    """The uncapped logits lie more than 10x the tolerance away."""
    a, b = np.asarray(capped), np.asarray(uncapped)
    assert np.abs(a - b).max() > 10 * (TOL["atol"] + TOL["rtol"]
                                       * np.abs(a).max())


def _prefill_decode(arch, last, extras=None, enc_len=None):
    """Prefill (right-padded rows ending at ``last``) and STEPS greedy
    decode steps of the capped port against the capped JAX model: logits
    at TOL, greedy tokens identical; the uncapped port's prefill logits
    more than 10x TOL away.  Returns the cap."""
    jcfg, params, tcfg, tparams = _model(arch)
    toks = _tokens(jcfg, (B, S))
    extras = extras or {}
    cap = _cap_for(tcfg, tparams, toks, enc_len=enc_len, extras={
        "last_pos": torch.from_numpy(last),
        **{k: torch.from_numpy(v) for k, v in extras.items()}})
    jc_cfg, tc_cfg = _capped(jcfg, cap), _capped(tcfg, cap)
    jl, jc = jax.jit(functools.partial(JM.prefill, params, jc_cfg))(
        jnp.asarray(toks), JM.init_cache(jc_cfg, B, T, enc_len=enc_len),
        last_pos=jnp.asarray(last),
        **{k: jnp.asarray(v) for k, v in extras.items()})
    textras = {k: torch.from_numpy(v) for k, v in extras.items()}
    tl, tc = TM.prefill(tparams, tc_cfg, torch.from_numpy(toks),
                        TM.init_cache(tc_cfg, B, T, device="cpu",
                                      enc_len=enc_len),
                        last_pos=torch.from_numpy(last), **textras)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    free, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks),
                         TM.init_cache(tcfg, B, T, device="cpu",
                                       enc_len=enc_len),
                         last_pos=torch.from_numpy(last), **textras)
    _assert_bites(tl.numpy(), free.numpy())
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jc_cfg))
    pos = last + 1
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(STEPS):
        jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tc_cfg,
                                torch.from_numpy(tok)[:, None], tc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        tok, pos = jtok, pos + 1
    return cap


# --------------------------------------------------------------------- #
# Serving paths
# --------------------------------------------------------------------- #
def test_dense_prefill_decode_and_greedy_tokens_match_jax():
    _prefill_decode("llama3_8b", np.array([S - 1, 5, 0], np.int32))


def test_moe_ring_decode_matches_jax():
    """gpt-oss-20b's smoke config: a window of 16 slots, so the cache is
    a ring that the 8 steps after a 13-token prompt wrap (K1 over
    min(pos + 1, 16) slots)."""
    jcfg, _, tcfg, _ = _model("gpt_oss_20b")
    assert tcfg.sliding_window is not None and tcfg.sliding_window < S + STEPS
    assert TM.init_cache(tcfg, 1, T, device="cpu")["kv"]["k"].shape[2] \
        == tcfg.sliding_window
    _prefill_decode("gpt_oss_20b", np.array([S - 1, 9, 2], np.int32))


def test_encdec_encoder_and_cross_attention_match_jax():
    """seamless's smoke config: the encoder (K2 not causal), the decoder's
    cross-attention (K2 not causal at prefill, K1 over the cross cache at
    decode) and its self-attention, all capped."""
    rng = np.random.default_rng(3)
    jcfg, _, _, _ = _model("seamless_m4t_large_v2")
    enc = (rng.standard_normal((B, 7, jcfg.d_model)) * 0.02).astype(
        np.float32)
    _prefill_decode("seamless_m4t_large_v2", np.full(B, S - 1, np.int32),
                    extras={"enc_embeds": enc}, enc_len=7)


def test_dense_chunked_prefill_matches_jax():
    """Chunked prefill (K2 at q_offset > 0 over the filled prefix) against
    JAX's, in chunks of 1, 3 and 5, and against the whole capped prefill."""
    jcfg, params, tcfg, tparams = _model("llama3_8b")
    toks = _tokens(jcfg, (2, 7), seed=4)
    last = np.asarray([6, 4], np.int32)
    cap = _cap_for(tcfg, tparams, toks, extras={
        "last_pos": torch.from_numpy(last)})
    jc_cfg, tc_cfg = _capped(jcfg, cap), _capped(tcfg, cap)
    whole, _ = TM.prefill(tparams, tc_cfg, torch.from_numpy(toks),
                          TM.init_cache(tc_cfg, 2, 16, device="cpu"),
                          last_pos=torch.from_numpy(last))
    jcall = jax.jit(lambda c, t, off, lp: JM.prefill(
        params, jc_cfg, t, c, offset=off, last_pos=lp))
    for cs in (1, 3, 5):
        lg_j, _ = JM.prefill_chunked(
            params, jc_cfg, jnp.asarray(toks), JM.init_cache(jc_cfg, 2, 16),
            chunk_size=cs, last_pos=jnp.asarray(last), prefill_call=jcall)
        lg_c, _ = TM.prefill_chunked(
            tparams, tc_cfg, torch.from_numpy(toks),
            TM.init_cache(tc_cfg, 2, 16, device="cpu"), chunk_size=cs,
            last_pos=torch.from_numpy(last))
        np.testing.assert_allclose(lg_c.numpy(), np.asarray(lg_j), **TOL)
        np.testing.assert_allclose(lg_c.numpy(), whole.numpy(), **TOL)
    free, _ = TM.prefill(tparams, tcfg, torch.from_numpy(toks),
                         TM.init_cache(tcfg, 2, 16, device="cpu"),
                         last_pos=torch.from_numpy(last))
    _assert_bites(whole.numpy(), free.numpy())


def test_dense_engine_serves_jax_greedy_tokens():
    """The port's ServingEngine against the JAX ServingEngine, capped: 5
    requests over 2 slots, identical greedy outputs."""
    jcfg, params, tcfg, tparams = _model("llama3_8b", seed=2)
    cap = _cap_for(tcfg, tparams, _tokens(jcfg, (2, 12), seed=5))

    def requests(mod, trace_fn):
        return mod.requests_from_trace(trace_fn(10.0, 5, seed=3), 256,
                                       max_prompt=12, max_new=7,
                                       time_scale=0.0)
    jreqs = requests(JE, j_poisson)
    JE.ServingEngine(_capped(jcfg, cap), params, slots=2, max_len=32).run(
        jreqs)
    out = {}
    for c in (cap, 0.0):
        treqs = requests(TE, poisson_trace)
        stats = TE.ServingEngine(_capped(tcfg, c), tparams, slots=2,
                                 max_len=32, device="cpu").run(treqs)
        assert stats.completed == 5
        out[c] = {r.rid: r.output for r in treqs}
    assert out[cap] == {r.rid: r.output for r in jreqs}
    assert out[cap] != out[0.0]


def test_traced_decode_step_costs_plans_and_executes():
    """A capped decode step traced by the analyzer: its K1 nodes are
    costed as the uncapped step's, it is planned for the paper's pair,
    and run on two logical CPU devices it gives the eager step's logits
    (1e-5) and JAX's (TOL)."""
    jcfg, params, tcfg, tparams = _model("llama3_8b")
    toks = _tokens(jcfg, (B, 9), seed=6)
    last = np.array([8, 5, 2], np.int32)
    cap = _cap_for(tcfg, tparams, toks, extras={
        "last_pos": torch.from_numpy(last)})
    jc_cfg, tc_cfg = _capped(jcfg, cap), _capped(tcfg, cap)
    jl, jc = jax.jit(functools.partial(JM.prefill, params, jc_cfg))(
        jnp.asarray(toks), JM.init_cache(jc_cfg, B, T),
        last_pos=jnp.asarray(last))
    tc0 = TM.init_cache(tc_cfg, B, T, device="cpu")
    TM.prefill(tparams, tc_cfg, torch.from_numpy(toks), tc0,
               last_pos=torch.from_numpy(last))
    tok = torch.from_numpy(np.asarray(jnp.argmax(jl, -1)).astype(np.int32))
    pos = torch.from_numpy(last + 1)

    def step(cfg):
        def f(p, c, t, q):
            return TM.decode_step(p, cfg, t, c, q)
        return f
    traced = {}
    for name, cfg in (("capped", tc_cfg), ("free", tcfg)):
        traced[name] = analyze(step(cfg), tparams, copy.deepcopy(tc0),
                               tok[:, None], pos, state_argnums=(1,))
    kernel_nodes = {name: sorted((n.flops, n.bytes_accessed) for n in
                                 tg.graph.nodes if n.name == "flash_attention")
                    for name, tg in traced.items()}
    assert len(kernel_nodes["capped"]) == tcfg.num_layers
    assert kernel_nodes["capped"] == kernel_nodes["free"]
    tg = traced["capped"]
    g = pin_nodes(tg.graph, tg.state_readers | tg.state_writers, 0)
    tg = tg.with_graph(g)
    devs = [CATALOG[d] for d in PAPER_PAIRS[1]]
    exe = build_executable(tg, planner.plan(g, devs, cache=False),
                           logical_devices(2, "cpu"))
    assert exe.num_units > 1
    cache, single = copy.deepcopy(tc0), copy.deepcopy(tc0)
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jc_cfg))
    for _ in range(3):
        jl, jc = jdecode(jnp.asarray(tok.numpy())[:, None], jc,
                         jnp.asarray(pos.numpy()))
        want, _ = step(tc_cfg)(tparams, single, tok[:, None], pos)
        got, _ = exe(tparams, cache, tok[:, None], pos)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
        tok, pos = got.argmax(-1).to(torch.int32), pos + 1


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3_8b", "gpt_oss_20b"])
def test_forward_loss_and_grads_match_jax(arch):
    """``forward_logits`` (the training form, ``_sdpa_chunked`` with the
    cap) and ``loss_fn`` with every gradient against
    ``jax.value_and_grad``."""
    jcfg, params, tcfg, tparams = _model(arch, seed=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    tgts = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    cap = _cap_for(tcfg, tparams, toks)
    jc_cfg, tc_cfg = _capped(jcfg, cap), _capped(tcfg, cap)
    jlogits = JM.forward_logits(params, jc_cfg, jnp.asarray(toks))
    tlogits = TM.forward_logits(tparams, tc_cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    _assert_bites(tlogits.numpy(), TM.forward_logits(
        tparams, tcfg, torch.from_numpy(toks)).numpy())
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc_cfg, jnp.asarray(toks),
                             jnp.asarray(tgts)))(params)
    tloss, tgrads = value_and_grad(
        lambda p: TM.loss_fn(p, tc_cfg, torch.from_numpy(toks),
                             torch.from_numpy(tgts)), tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    ref = convert.params_from_jax(_np_tree(jgrads), device="cpu")
    got = pytree.tree_leaves(tgrads)
    want = leaves_as(tgrads, ref)
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        b = b.numpy()
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * scale)


# --------------------------------------------------------------------- #
# The plain K1 / K2 against the training form
# --------------------------------------------------------------------- #
def _qkv(Sq, Skv, H=4, Hkv=2, D=16, Bn=2, seed=0, gain=3.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bn, Sq, H, D)).astype(np.float32) * gain
    k = rng.standard_normal((Bn, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bn, Skv, Hkv, D)).astype(np.float32)
    return q, k, v


CAP = 1.5


@pytest.mark.parametrize("causal,window,Sq,Skv,q_offset", [
    (True, None, 12, 12, 0), (True, 5, 12, 12, 0), (True, None, 4, 12, 8),
    (False, None, 7, 11, 0)], ids=["causal", "window", "offset",
                                   "not-causal"])
def test_plain_prefill_matches_sdpa_chunked(causal, window, Sq, Skv,
                                            q_offset):
    q, k, v = _qkv(Sq, Skv)
    assert np.abs(np.einsum("bqhd,bkhd->bqk", q[:, :, :2], k)).max() \
        / 4.0 / CAP >= 2.0
    got = FR.prefill_attention(*map(torch.from_numpy, (q, k, v)),
                               q_offset=q_offset, window=window,
                               causal=causal, softcap=CAP)
    port = TL._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            q_offset=q_offset, window=window, chunk=512,
                            softcap=CAP)
    ref = JLy._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                            q_offset=q_offset, window=window, chunk=512,
                            softcap=CAP)
    np.testing.assert_allclose(got.numpy(), port.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    free = FR.prefill_attention(*map(torch.from_numpy, (q, k, v)),
                                q_offset=q_offset, window=window,
                                causal=causal)
    _assert_bites(got.numpy(), free.numpy())


def test_plain_decode_matches_sdpa_chunked():
    """K1's plain version over per-row lengths against the training form
    at each row's last position (q_offset = length - 1)."""
    q, k, v = _qkv(1, 12, seed=1)
    lengths = np.array([12, 5], np.int32)
    got = FR.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths),
                              softcap=CAP)
    ref = JLy._sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                            q_offset=jnp.asarray(lengths - 1), window=None,
                            chunk=512, softcap=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0], **TOL)
    free = FR.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lengths))
    _assert_bites(got.numpy(), free.numpy())


def test_negative_softcap_is_refused():
    _, _, tcfg, _ = _model("llama3_8b")
    TL.check_supported(_capped(tcfg, 30.0))
    with pytest.raises(ValueError, match="softcap"):
        TL.check_supported(_capped(tcfg, -1.0))
