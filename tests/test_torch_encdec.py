"""The port's encdec family (seamless-m4t-large-v2's backbone) against
the JAX model: the bidirectional encoder, the decoder's cross-attention
over the cross caches, prefill and decode.

Parameters are initialised in JAX and carried across by
``repro_torch.convert`` (the ``encoder`` stack is unstacked like
``layers``); everything runs at fp32 on the CPU, at the shapes of
``tests/test_arch_smoke.py:test_prefill_decode_consistency`` (B 2, a
5-frame encoder input, a prefill of 6 tokens, 3 decode steps).  Logits
and every cache leaf are held at atol = rtol = 1e-4 (the port's parity
tolerance: summation order differs between the frameworks) and the
greedy tokens must be identical.
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
from repro_torch import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "seamless_m4t_large_v2"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, T = 2, 6, 9              # rows, prompt, cache (prompt + 3 steps)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


def _inputs(cfg, enc_len, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    enc = (rng.standard_normal((B, enc_len, cfg.d_model)) * 0.02) \
        .astype(np.float32)
    return toks, enc


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    a = tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {prefix.rstrip("/"): a}


def test_params_convert_with_the_encoder_unstacked(model):
    jcfg, tcfg, params, tparams = model
    assert len(tparams["encoder"]) == jcfg.encoder_layers
    assert len(tparams["layers"]) == jcfg.num_layers
    assert set(tparams["layers"][0]) == {"ln1", "attn", "ln_x", "xattn",
                                         "ln2", "mlp"}
    np.testing.assert_array_equal(
        tparams["encoder"][1]["attn"]["wq"].numpy(),
        np.asarray(params["encoder"]["attn"]["wq"][1]))
    # the port's own init has the reference's tree, shapes and dtypes
    own = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    for group in ("encoder", "layers"):
        for i in range(len(own[group])):
            a, b = _leaves(own[group][i]), _leaves(tparams[group][i])
            assert {k: v.shape for k, v in a.items()} \
                == {k: v.shape for k, v in b.items()}
    assert _leaves(own["enc_norm"]).keys() == _leaves(tparams["enc_norm"]) \
        .keys()


@pytest.mark.parametrize("enc_len", [5, 11])
def test_encoder_output_matches_jax(model, enc_len):
    """The bidirectional encoder alone (non-causal attention with RoPE at
    positions [0, Se)), at the reference smoke test's 5 frames and at
    11."""
    jcfg, tcfg, params, tparams = model
    _, enc = _inputs(jcfg, enc_len)
    want = JM._encoder_forward(params, jcfg, jnp.asarray(enc))
    got = TM._encoder_forward(tparams, tcfg, torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("enc_len", [5, 11])
def test_prefill_decode_match_jax_and_teacher_forcing(model, enc_len):
    """Prefill of 6 tokens then 3 teacher-forced decode steps: logits
    against the JAX prefill / decode_step and against JAX
    ``forward_logits`` at every position; every cache leaf after the
    prefill (self KV and the cross caches) and after the last step.
    ``enc_len`` 11 is an encoder length that is neither the prompt's nor
    the cache's."""
    jcfg, tcfg, params, tparams = model
    toks, enc = _inputs(jcfg, enc_len)
    full = np.asarray(JM.forward_logits(params, jcfg, jnp.asarray(toks),
                                        enc_embeds=jnp.asarray(enc)))
    jprefill = jax.jit(functools.partial(JM.prefill, params, jcfg))
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    jl, jc = jprefill(jnp.asarray(toks[:, :S]),
                      JM.init_cache(jcfg, B, T, enc_len=enc_len),
                      enc_embeds=jnp.asarray(enc))
    tc = TM.init_cache(tcfg, B, T, device="cpu", enc_len=enc_len)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks[:, :S]), tc,
                        enc_embeds=torch.from_numpy(enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), full[:, S - 1], **TOL)
    jleaves, tleaves = _leaves(jc), _leaves(tc)
    assert set(tleaves) == {"kv/k", "kv/v", "cross_k", "cross_v"} \
        == set(jleaves)
    for k in tleaves:
        np.testing.assert_allclose(tleaves[k], jleaves[k], err_msg=k, **TOL)
    assert tc["cross_k"].shape == (jcfg.num_layers, B, enc_len,
                                   jcfg.num_kv_heads, jcfg.head_dim)
    for t in range(S, T):
        pos = np.full(B, t, np.int32)
        tok = toks[:, t:t + 1]
        jl, jc = jdecode(jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t], **TOL)
    jleaves, tleaves = _leaves(jc), _leaves(tc)
    for k in tleaves:
        np.testing.assert_allclose(tleaves[k], jleaves[k], err_msg=k, **TOL)


def test_greedy_decode_matches_jax(model):
    """Right-padded prompts (per-row ``last_pos``) and 6 greedy steps:
    identical tokens, logits at the parity tolerance."""
    jcfg, tcfg, params, tparams = model
    enc_len, steps, max_len = 7, 6, 16
    toks, enc = _inputs(jcfg, enc_len, seed=1)
    last = np.array([S - 1, 2], np.int32)
    jl, jc = jax.jit(functools.partial(JM.prefill, params, jcfg))(
        jnp.asarray(toks[:, :S]), JM.init_cache(jcfg, B, max_len,
                                                enc_len=enc_len),
        enc_embeds=jnp.asarray(enc), last_pos=jnp.asarray(last))
    tc = TM.init_cache(tcfg, B, max_len, device="cpu", enc_len=enc_len)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks[:, :S]), tc,
                        enc_embeds=torch.from_numpy(enc),
                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    pos = last + 1
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        jl, jc = jdecode(jnp.asarray(jtok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(jtok)[:, None],
                                tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))


def test_prefill_refuses_what_the_reference_refuses(model):
    """No encoder input, one of another length than the cross caches', or
    a chunk offset: the reference asserts, the port raises."""
    _, tcfg, _, tparams = model
    toks = torch.zeros((B, S), dtype=torch.int32)
    enc = torch.zeros((B, 5, tcfg.d_model))
    for kw in (dict(), dict(enc_embeds=enc[:, :4]),
               dict(enc_embeds=enc, offset=0)):
        with pytest.raises(ValueError):
            TM.prefill(tparams, tcfg, toks, TM.init_cache(
                tcfg, B, T, device="cpu", enc_len=5), **kw)


def test_state_movers_round_trip_against_jax_export(model):
    """``export_kv`` / ``import_kv`` over the top-level cross caches, as
    the reference's movers: the row is sliced, the self KV trimmed to a
    length and the cross caches moved whole.  The exported state holds
    the reference export's leaves and bytes (``kv_state_bytes``); one
    row imported into another slot of a fresh cache decodes as the
    original; the per-layer shards cover the same state."""
    jcfg, tcfg, params, tparams = model
    enc_len, length = 5, S
    toks, enc = _inputs(jcfg, enc_len)
    _, jc = jax.jit(functools.partial(JM.prefill, params, jcfg))(
        jnp.asarray(toks[:, :S]), JM.init_cache(jcfg, B, T, enc_len=enc_len),
        enc_embeds=jnp.asarray(enc))
    tc = TM.init_cache(tcfg, B, T, device="cpu", enc_len=enc_len)
    TM.prefill(tparams, tcfg, torch.from_numpy(toks[:, :S]), tc,
               enc_embeds=torch.from_numpy(enc))
    jstate = JM.export_kv(jcfg, jc, 1, length)
    tstate = TM.export_kv(tcfg, tc, 1, length)
    assert TM.kv_state_bytes(tstate) == JM.kv_state_bytes(jstate)
    jl, tl = _leaves(jstate), _leaves(tstate)
    assert {k: v.shape for k, v in tl.items()} \
        == {k: v.shape for k, v in jl.items()}
    for k in tl:
        np.testing.assert_allclose(tl[k], jl[k], err_msg=k, **TOL)
    assert TM.cache_layer_counts(tc) == JM.cache_layer_counts(jc)

    # row 1 into a fresh cache: the next step's logits of that row are
    # the original's, bit for bit
    moved = TM.import_kv(tcfg, TM.init_cache(tcfg, B, T, device="cpu",
                                             enc_len=enc_len), 1, tstate)
    tok = torch.from_numpy(toks[:, S:S + 1])
    pos = torch.full((B,), S, dtype=torch.int32)
    want, _ = TM.decode_step(tparams, tcfg, tok, tc, pos)
    got, _ = TM.decode_step(tparams, tcfg, tok, moved, pos)
    assert torch.equal(got[1], want[1])

    # shard by shard: the same state as the whole export
    shards = TM.init_cache(tcfg, B, T, device="cpu", enc_len=enc_len)
    for key, n in TM.cache_layer_counts(tc).items():
        for layer in range(n):
            t0, t1 = (0, length) if key == "kv" else (None, None)
            TM.import_kv_shard(tcfg, shards, 0, key, layer, TM.export_kv_shard(
                tcfg, tc, 1, key, layer, t0, t1))
    for a, b in zip(TM.state_leaves(TM.export_kv(tcfg, shards, 0, length)),
                    TM.state_leaves(tstate)):
        assert torch.equal(a, b)
