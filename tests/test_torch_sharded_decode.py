"""Decode over a KV cache sharded over T, at fp32 on a 4-rank (2 data x 2
model) gloo mesh under ``SERVE_RULES`` (the batch over ``data``, the
cache's T over ``model``), against the unsharded port and the
reference's ``prefill`` / ``decode_step``.

Each rank attends with every query head over its own half of the cache
(K1's log-sum-exp form on its slots, the lengths clipped to them) and
the halves are merged by all-reduces (``distributed.local.attend``).
Three smoke models: the dense llama, gemma (one KV head, a logit
softcap that bites) and gpt-oss (MoE, ``ep``, dropless; a window of 16
slots, so the cache is a ring that the decode steps wrap).  The rows'
prompts end at different positions, so that some rows stay inside the
first shard (the second holds none of their tokens) while others cross
into the second; the reference's greedy tokens are fed to every side.
Logits within 1e-5 of both, greedy tokens identical, no NaN.

Every process group lives in a subprocess (``_torch_dist``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import result, run  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("llama3_8b", "gemma_2b", "gpt_oss_20b")
B, S, T, STEPS = 4, 13, 32, 6
# prompts end at these positions: with T 32 (16 slots a shard) row 1's
# and row 2's lengths (7-12 and 2-7) stay in the first shard; in
# gpt-oss's ring of 16 (8 slots a shard) row 2's do, row 0 wraps
LAST = (12, 5, 0, 9)
GEMMA_CAP = 0.05


def _cfgs(arch):
    """(reference config, port config), fp32; MoE dropless, gemma
    capped."""
    import repro.configs as JC
    import repro_torch.configs as TC
    out = []
    for C in (JC, TC):
        cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
        if cfg.family == "moe":
            cfg = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.num_experts
                / cfg.experts_per_token)
        if arch == "gemma_2b":
            cfg = dataclasses.replace(cfg, attn_logit_softcap=GEMMA_CAP)
        out.append(cfg)
    return tuple(out)


def reference() -> dict:
    """Per arch: the reference's parameters (numpy), prompt, the greedy
    tokens it feeds each decode step, and its logits (prefill, then each
    step)."""
    import functools
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        params = JM.init_params(jcfg, jax.random.PRNGKey(1))
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        last = np.asarray(LAST, np.int32)
        jl, jc = jax.jit(functools.partial(JM.prefill, params, jcfg))(
            jnp.asarray(toks), JM.init_cache(jcfg, B, T),
            last_pos=jnp.asarray(last))
        decode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
        logits, fed, pos = [np.asarray(jl)], [], last + 1
        for _ in range(STEPS):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            fed.append(tok)
            jl, jc = decode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
            logits.append(np.asarray(jl))
            pos = pos + 1
        out[arch] = (jax.tree_util.tree_map(np.asarray, params), toks, fed,
                     logits)
    return out


def decode_rank(rank, world, ref):
    """One rank of the (2, 2) mesh: each model's prefill and decode steps
    on plain tensors and on DTensors."""
    import torch.utils._pytree as pytree
    from repro_torch import convert
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import steps as St
    from repro_torch.launch.dryrun import build_shardings
    from repro_torch.models import model as M
    mesh = ML.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    calls = {"flash_decode": 0, "flash_decode_lse": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    FA.decode_attention = counted("flash_decode", FA.decode_attention)
    FA.decode_attention_lse = counted("flash_decode_lse",
                                      FA.decode_attention_lse)
    out = {}
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        np_params, toks, fed, _ = ref[arch]
        params = convert.params_from_jax(np_params, device="cpu")
        toks = torch.from_numpy(toks)
        last = torch.tensor(LAST, dtype=torch.int32)
        cache = M.init_cache(cfg, B, T, device="cpu")
        dcfg = dataclasses.replace(cfg, moe_impl="ep") \
            if cfg.family == "moe" else cfg
        cell = dataclasses.replace(St.get_cell(arch, "prefill_32k"),
                                   cfg=dcfg)
        (p_sh, c_sh, b_sh), _ = build_shardings(
            cell, (params, cache, {"tokens": toks}), mesh)
        # copies: the plain steps write their cache in place
        dp = SH.distribute(pytree.tree_map(torch.clone, params), p_sh)
        dc = SH.distribute(pytree.tree_map(torch.clone, cache), c_sh)
        dtok = SH.distribute({"tokens": toks}, b_sh)["tokens"]
        plain, sharded = [], []
        want, _ = M.prefill(params, cfg, toks, cache, last_pos=last)
        with mesh_context(mesh):
            got, _ = M.prefill(dp, dcfg, dtok, dc, last_pos=last)
        plain.append(want.numpy())
        sharded.append(got.full_tensor().numpy())
        pos = last + 1
        dcell = dataclasses.replace(St.get_cell(arch, "decode_32k"),
                                    cfg=dcfg)
        before = dict(calls)
        for tok in fed:
            nxt = torch.from_numpy(tok)[:, None]
            (_, _, db_sh), _ = build_shardings(
                dcell, (params, cache, {"tokens": nxt, "pos": pos}), mesh)
            db = SH.distribute({"tokens": nxt, "pos": pos}, db_sh)
            want, _ = M.decode_step(params, cfg, nxt, cache, pos)
            with mesh_context(mesh):
                got, _ = M.decode_step(dp, dcfg, db["tokens"], dc, db["pos"])
            plain.append(want.numpy())
            sharded.append(got.full_tensor().numpy())
            pos = pos + 1
        # K1 ran on the plain steps, its log-sum-exp form on the sharded
        # ones, once a layer and step each
        n = STEPS * cfg.num_layers
        assert calls["flash_decode"] - before["flash_decode"] == n, calls
        assert calls["flash_decode_lse"] - before["flash_decode_lse"] == n
        kv = dc["kv"]["k"]                      # (L, B, T, Hkv, D)
        out[arch] = {"plain": plain, "sharded": sharded,
                     "cache_placements": [getattr(p, "dim", None)
                                          for p in kv.placements],
                     "cache_slots": kv.shape[2]}
    return out


def one_rank(ref) -> dict:
    """On a one-rank (1, 1) mesh (gloo): the llama's decode steps with the
    cache's T sharded over ``model`` of size 1 (the placement a pod gives
    it, each leaf its own whole shard, as ``chip_smoke.py`` places it on
    the card): the T-sharded path, against the plain steps."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from _torch_dist import one_rank as group
    from repro_torch import convert
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import mesh as ML
    from repro_torch.models import model as M
    _, cfg = _cfgs("llama3_8b")
    np_params, toks, fed, _ = ref["llama3_8b"]
    params = convert.params_from_jax(np_params, device="cpu")
    last = torch.tensor(LAST, dtype=torch.int32)
    cache = M.init_cache(cfg, B, T, device="cpu")
    M.prefill(params, cfg, torch.from_numpy(toks), cache, last_pos=last)
    plain = pytree.tree_map(torch.clone, cache)
    calls = []
    lse = FA.decode_attention_lse

    def counted(*a, **kw):
        calls.append(1)
        return lse(*a, **kw)
    FA.decode_attention_lse = counted
    gaps = []
    try:
        with group():
            mesh = ML.make_mesh((1, 1), ("data", "model"), device_type="cpu")
            def place(*pl):
                return lambda t: DTensor.from_local(
                    t, mesh, pl, run_check=False, shape=t.shape,
                    stride=t.stride())
            dp = pytree.tree_map(place(Replicate(), Replicate()), params)
            dc = pytree.tree_map(place(Replicate(), Shard(2)), cache)
            pos = last + 1
            for tok in fed:
                nxt = torch.from_numpy(tok)[:, None]
                want, _ = M.decode_step(params, cfg, nxt, plain, pos)
                with mesh_context(mesh):
                    got, _ = M.decode_step(dp, cfg, nxt, dc, pos)
                gaps.append(float((got.full_tensor() - want).abs().max()))
                pos = pos + 1
    finally:
        FA.decode_attention_lse = lse
    return {"gaps": gaps, "calls": len(calls),
            "expected": STEPS * cfg.num_layers}


def _uncapped_gap(ref) -> float:
    """The largest gap of the uncapped port's prefill logits from the
    capped reference's."""
    from repro_torch import convert
    from repro_torch.models import model as M
    params, toks, _, logits = ref
    free = dataclasses.replace(_cfgs("gemma_2b")[1], attn_logit_softcap=0.0)
    got, _ = M.prefill(convert.params_from_jax(params, device="cpu"), free,
                       torch.from_numpy(toks),
                       M.init_cache(free, B, T, device="cpu"),
                       last_pos=torch.tensor(LAST, dtype=torch.int32))
    return float(np.abs(got.numpy() - logits[0]).max())


def sharded_decode() -> dict:
    """Run in a subprocess: the reference, then the 4-rank gloo world."""
    import torch.distributed as dist
    from _torch_dist import checks, gloo_world
    ref = reference()
    out = checks([("ranks", lambda: gloo_world(decode_rank, 4, ref))])
    out["reference"] = {a: (r[2], r[3]) for a, r in ref.items()}
    out["gemma_uncapped_gap"] = _uncapped_gap(ref["gemma_2b"])
    out.update(checks([("one_rank", lambda: one_rank(ref))]))
    out["initialized"] = dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def world():
    return run("""
    from _torch_dist import save
    import test_torch_sharded_decode as T
    save(OUT, T.sharded_decode())
    """, timeout=600)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_plain_and_reference(world, arch):
    fed, want = world["reference"][arch]
    for r in result(world, "ranks"):
        got = r[arch]
        assert len(got["sharded"]) == len(want) == STEPS + 1
        for i, (sh, pl, ref) in enumerate(zip(got["sharded"], got["plain"],
                                              want)):
            assert np.isfinite(sh).all(), i
            np.testing.assert_allclose(sh, pl, **TOL, err_msg=f"step {i}")
            np.testing.assert_allclose(sh, ref, **TOL, err_msg=f"step {i}")
            # greedy tokens: the reference's next token, on every side
            tok = fed[i] if i < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(sh.argmax(-1), tok)
            np.testing.assert_array_equal(pl.argmax(-1), tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_stays_sharded_over_t(world, arch):
    """The cache's T (dimension 2 of the stacked (L, B, T, Hkv, D)) is
    split over ``model`` and the batch over ``data``; some rows end
    inside the first shard while others reach the second."""
    for r in result(world, "ranks"):
        got = r[arch]
        assert got["cache_placements"] == [1, 2], got["cache_placements"]
        half = got["cache_slots"] // 2
        lengths = np.minimum(np.asarray(LAST) + 1 + STEPS, got["cache_slots"])
        assert (lengths <= half).any() and (lengths > half).any()
    assert world["initialized"] is False


def test_one_rank_t_sharded_decode_matches_plain(world):
    """T sharded over a mesh dimension of one rank still takes the
    T-sharded path (the log-sum-exp form once a layer and step, merged
    over a group of one), and gives the plain steps' logits."""
    r = result(world, "one_rank")
    assert r["calls"] == r["expected"] and len(r["gaps"]) == STEPS, r
    assert max(r["gaps"]) <= TOL["atol"], r


def test_gemma_cap_bites(world):
    """The cap changes gemma's logits: the capped reference's prefill
    logits lie more than 10x the tolerance from the uncapped port's."""
    assert world["gemma_uncapped_gap"] > 10 * (TOL["atol"] + TOL["rtol"])
