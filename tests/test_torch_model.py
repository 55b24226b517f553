"""The port's dense decoder against the JAX model.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``; everything runs at fp32 on the CPU.  The
logits of a right-padded ``prefill`` (with per-row ``last_pos``) and of
16 greedy ``decode_step``s must match at atol = rtol = 1e-4 (summation
order differs between the frameworks), and the greedy tokens must be
identical.
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

DENSE = ["llama3_8b", "granite_8b", "qwen3_1_7b", "qwen2_5_14b",
         "gemma_2b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch):
    return (dataclasses.replace(JC.get_smoke(arch), dtype="float32"),
            dataclasses.replace(TC.get_smoke(arch), dtype="float32"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    B, S, T = 3, 13, 40
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.array([S - 1, 5, 0], np.int32)      # right-padded rows

    jprefill = jax.jit(functools.partial(JM.prefill, params, jcfg))
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    jl, jc = jprefill(jnp.asarray(toks), JM.init_cache(jcfg, B, T),
                      last_pos=jnp.asarray(last))
    tc = TM.init_cache(tcfg, B, T, device="cpu")
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    pos = last + 1
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(16):
        jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok)[:, None],
                                tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        tok, pos = jtok, pos + 1
    # the in-place cache holds what JAX's functional cache holds
    for c in ("k", "v"):
        np.testing.assert_allclose(tc["kv"][c].numpy(),
                                   np.asarray(jc["kv"][c]), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_jax_structure(arch):
    """Same tree, shapes and dtypes as the JAX init (unstacked layers),
    zero padded heads, unit norms, and the same weight scales."""
    jcfg, tcfg = _cfgs(arch)
    jp = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    g = torch.Generator().manual_seed(0)
    tp = TM.init_params(tcfg, generator=g, device="cpu")
    assert len(tp["layers"]) == jcfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        flat_t = _flatten(lp)
        flat_j = _flatten(jax.tree_util.tree_map(lambda a: a[i],
                                                 jp["layers"]))
        assert flat_t.keys() == flat_j.keys()
        for key, t in flat_t.items():
            assert tuple(t.shape) == flat_j[key].shape, key
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t.std()),
                                       float(flat_j[key].std()),
                                       rtol=0.25, atol=1e-6, err_msg=key)
        nh = jcfg.num_heads
        assert float(lp["attn"]["wq"][:, nh:].abs().sum()) == 0.0
        assert float(lp["attn"]["wo"][nh:].abs().sum()) == 0.0
    assert _flatten(tp["embed"]).keys() == _flatten(jp["embed"]).keys()
    jcache = JM.init_cache(jcfg, 2, 24)
    tcache = TM.init_cache(tcfg, 2, 24, device="cpu")
    for c in ("k", "v"):
        assert tuple(tcache["kv"][c].shape) == jcache["kv"][c].shape
        assert not tcache["kv"][c].any()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_convert_bfloat16_is_bit_exact():
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (5, 7),
                                     jnp.bfloat16))
    t = convert.array_to_torch(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    cache = convert.cache_from_jax(_np_tree(JM.init_cache(
        JC.get_smoke("llama3_8b"), 2, 8)), device="cpu")
    assert cache["kv"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["gpt_oss_20b", "mixtral_8x7b"])
def test_unported_families_raise(arch):
    """Every family is ported, the MoE family with its expert-parallel
    ``ep`` path, which builds parameters and caches as ``ragged`` does
    and raises at its first forward without a device mesh
    (``mesh_context``; its parity tests are in ``test_torch_moe_ep.py``).
    The ssm, hybrid, encdec and vlm parity tests are in
    ``test_torch_ssm.py``, ``test_torch_hybrid.py``,
    ``test_torch_encdec.py`` and ``test_torch_vlm.py``."""
    cfg = dataclasses.replace(TC.get_smoke(arch), moe_impl="ep",
                              dtype="float32")
    params = TM.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="mesh_context"):
        TM.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                   cache)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "qwen2_vl_7b"])
def test_encdec_and_vlm_build_but_are_not_served(arch):
    """encdec and vlm build parameters and caches and run the model's
    entry points; the engine, the launcher and chunked prefill refuse
    them, as the reference's engine and ``prefill(offset=)`` do."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServingEngine
    cfg = TC.get_smoke(arch)
    params = TM.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    assert ("encoder" in params) == (cfg.family == "encdec")
    assert ("cross_k" in cache) == (cfg.family == "encdec")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(cfg, params, slots=1, max_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="chunked prefill"):
        TM.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                   cache, offset=0)


@pytest.mark.parametrize("option", [dict(family="moe", moe_impl="ep"),
                                    dict(attn_logit_softcap=30.0)])
def test_unported_dense_options_raise(option):
    """Both options are ported.  The softcap serves (its parity with the
    reference is ``test_torch_softcap.py``'s); ``ep`` raises at its
    forward without a device mesh."""
    cfg = dataclasses.replace(TC.get_smoke("llama3_8b"), **option)
    if "moe_impl" not in option:
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = TM.init_params(cfg, device="cpu")
        logits, _ = TM.prefill(params, cfg,
                               torch.zeros((1, 4), dtype=torch.int32),
                               TM.init_cache(cfg, 1, 8, device="cpu"))
        assert logits.shape == (1, cfg.padded_vocab)
        assert torch.isfinite(logits).all()
        return
    cfg = dataclasses.replace(cfg, num_experts=4, experts_per_token=2,
                              dtype="float32")
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="mesh_context"):
        TM.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                   TM.init_cache(cfg, 1, 8, device="cpu"))


def test_prefill_longer_than_cache_raises_without_window():
    """Only a sliding-window ring buffer may take a prompt longer than the
    cache; a full-length cache refuses it."""
    _, tcfg = _cfgs("llama3_8b")
    params = TM.init_params(tcfg, device="cpu")
    toks = torch.zeros((1, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        TM.prefill(params, tcfg, toks, TM.init_cache(tcfg, 1, 8,
                                                     device="cpu"))
