"""The port's model with every parameter, cache and batch leaf a DTensor,
against the same model on plain tensors, at fp32 on gloo ranks.

  * training: an 8-rank (2 data x 4 model) mesh under ``TRAIN_RULES``,
    the smoke llama of the reference's ``test_pjit_mesh_train_step_runs``
    (``tests/test_multidevice.py``): the loss and every gradient
    (``full_tensor``) within 1e-5 of the plain single-process step, then
    three AdamW steps of ``steps.make_train_step`` with the loss falling,
    each step's loss within 1e-5 of the plain step's;
  * serving: a 4-rank (2 data x 2 model) mesh under ``SERVE_RULES``:
    prefill and two decode steps of the dense, ssm (rwkv6), hybrid
    (zamba2) and MoE (``ep``, dropless) smoke models, each logit within
    1e-5 of the plain model's (MoE: the plain ``ragged`` path, which the
    dropless ``ep`` equals);
  * K1, K2 and K3 called on DTensors directly, through their
    registered sharding strategies, against the plain ops;
  * an int8 compressed mean over a 4-rank ``pod`` axis (the counterpart
    of the reference's ``test_gradient_compression_crosspod_allreduce``)
    tracks the true mean, and with error feedback its running sum
    tracks the true running sum.

Every process group lives in a subprocess (``_torch_dist``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import result, run  # noqa: E402

TOL = 1e-5
# gemma-2b's one KV head cannot follow its query heads over ``model``:
# each rank slices the KV head its query heads read; rwkv6_keys has 3
# heads, so the cache rules shard its WKV state over its key channels
SERVE_ARCHS = ("llama3_8b", "gemma_2b", "rwkv6_3b", "rwkv6_keys",
               "zamba2_7b", "gpt_oss_20b")


def _cfg(arch):
    import repro_torch.configs as C
    if arch == "train_llama":
        return dataclasses.replace(C.get_smoke("llama3_8b"), dtype="float32",
                                   num_heads=4, num_kv_heads=4, d_ff=128)
    if arch == "train_gqa":      # 2 KV heads over a 4-rank model axis
        return dataclasses.replace(C.get_smoke("llama3_8b"), dtype="float32")
    if arch == "rwkv6_keys":
        return dataclasses.replace(C.get_smoke("rwkv6_3b"), d_model=48,
                                   dtype="float32")
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
    if cfg.family == "moe":      # dropless: capacity for every assignment
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def _gap(got, want) -> float:
    return float((got - want).abs().max())


def train_rank(rank, world):
    """One rank of the (2, 4) mesh: loss and gradients against the plain
    step, then three training steps on both."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.local import sharded
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import build_shardings
    from repro_torch.models import model as M
    from repro_torch.train import optim
    from repro_torch.train.loop import value_and_grad
    import torch.utils._pytree as pytree
    cfg = _cfg("train_llama")
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=4)
    mesh = ML.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    cell = dataclasses.replace(S.get_cell("llama3_8b", "train_4k"), cfg=cfg)
    specs = (params, optim.init(ocfg, params), batch)
    (p_sh, o_sh, b_sh), _ = build_shardings(cell, specs, mesh)
    # copies: the plain steps update their parameters in place
    dp = SH.distribute(pytree.tree_map(torch.clone, params), p_sh)
    db = SH.distribute(batch, b_sh)

    def lf(p, b):
        return M.loss_fn(p, cfg, b["tokens"], b["targets"])
    loss, grads = value_and_grad(lambda p: lf(p, batch), params)
    with sharded(dp["embed"]):
        dloss, dgrads = value_and_grad(lambda p: lf(p, db), dp)
    out = {"loss": _gap(dloss.full_tensor(), loss),
           "grads": max(_gap(d.full_tensor(), g) for d, g in zip(
               pytree.tree_leaves(dgrads), pytree.tree_leaves(grads)))}
    # GQA whose KV heads stay whole over ``model``: each rank's KV
    # gradient is its query heads' share of the sum
    gcfg = _cfg("train_gqa")
    gp = M.init_params(gcfg, generator=torch.Generator().manual_seed(2),
                       device="cpu")
    gsh = SH.param_shardings(gp, mesh, SH.TRAIN_RULES)
    gdp = SH.distribute(pytree.tree_map(torch.clone, gp), gsh)

    def glf(p, b):
        return M.loss_fn(p, gcfg, b["tokens"], b["targets"], remat=True)
    gl, gg = value_and_grad(lambda p: glf(p, batch), gp)
    with sharded(gdp["embed"]):
        gdl, gdg = value_and_grad(lambda p: glf(p, db), gdp)
    out["gqa"] = max(_gap(gdl.full_tensor(), gl), max(
        _gap(d.full_tensor(), g) for d, g in zip(
            pytree.tree_leaves(gdg), pytree.tree_leaves(gg))))
    step = S.make_train_step(cfg, ocfg)
    opt = optim.init(ocfg, params)
    dopt = SH.distribute(pytree.tree_map(torch.clone, opt), o_sh)
    losses, dlosses = [], []
    for _ in range(3):
        params, opt, lo = step(params, opt, batch)
        dp, dopt, dlo = step(dp, dopt, db)
        losses.append(float(lo))
        dlosses.append(float(dlo.full_tensor()))
    out["losses"] = (losses, dlosses)
    out["params"] = max(_gap(d.full_tensor(), p) for d, p in zip(
        pytree.tree_leaves(dp), pytree.tree_leaves(params)))
    # the update is in place: every parameter keeps its placements
    out["placements_kept"] = all(
        tuple(d.placements) == s.placements for d, s in zip(
            pytree.tree_leaves(dp), pytree.tree_leaves(
                p_sh, is_leaf=lambda x: isinstance(x, SH.NamedSharding))))
    return out


def serve_rank(rank, world):
    """One rank of the (2, 2) mesh: prefill and two decode steps of each
    family on DTensors against the plain model."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import mesh_context
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import build_shardings
    from repro_torch.models import model as M
    import torch.utils._pytree as pytree
    mesh = ML.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        B, T, Sp = 4, 16, 8
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, Sp))
                                  .astype(np.int32))
        params = M.init_params(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(1))
        cache = M.init_cache(cfg, B, T, device="cpu")
        ep = cfg.family == "moe"
        dcfg = dataclasses.replace(cfg, moe_impl="ep") if ep else cfg
        name = "rwkv6_3b" if arch == "rwkv6_keys" else arch
        cell = dataclasses.replace(S.get_cell(name, "prefill_32k"), cfg=dcfg)
        (p_sh, c_sh, b_sh), _ = build_shardings(
            cell, (params, cache, {"tokens": tokens}), mesh)
        # copies: the plain steps write their cache in place
        dp = SH.distribute(pytree.tree_map(torch.clone, params), p_sh)
        dc = SH.distribute(pytree.tree_map(torch.clone, cache), c_sh)
        dtok = SH.distribute({"tokens": tokens}, b_sh)["tokens"]
        gaps = []
        want, _ = M.prefill(params, cfg, tokens, cache)
        with mesh_context(mesh):
            got, _ = M.prefill(dp, dcfg, dtok, dc)
        gaps.append(_gap(got.full_tensor(), want))
        nxt = want.argmax(-1).to(torch.int32)[:, None]
        for i in range(2):
            pos = torch.full((B,), Sp + i, dtype=torch.int32)
            dcell = dataclasses.replace(S.get_cell(name, "decode_32k"),
                                        cfg=dcfg)
            (_, _, db_sh), _ = build_shardings(
                dcell, (params, cache, {"tokens": nxt, "pos": pos}), mesh)
            db = SH.distribute({"tokens": nxt, "pos": pos}, db_sh)
            want, _ = M.decode_step(params, cfg, nxt, cache, pos)
            with mesh_context(mesh):
                got, _ = M.decode_step(dp, dcfg, db["tokens"], dc, db["pos"])
            gaps.append(_gap(got.full_tensor(), want))
            nxt = want.argmax(-1).to(torch.int32)[:, None]
        # the cache on DTensors holds what the plain cache holds
        gaps.append(max(_gap(d.full_tensor(), c) for d, c in zip(
            pytree.tree_leaves(dc), pytree.tree_leaves(cache))))
        out[arch] = gaps
        if arch == "rwkv6_keys":        # the case this config is for
            wkv_pl = c_sh["rwkv"]["wkv"].placements
            assert any(getattr(p, "dim", None) == 3 for p in wkv_pl), wkv_pl
    return out


def ops_rank(rank, world):
    """One rank of the (2, 2) mesh: K1, K2 and K3 called on DTensors
    (their registered strategies: batch over data, heads over model; K3
    column-sharded) against the plain ops."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.moe_gmm import ops as G
    from repro_torch.launch import mesh as ML
    mesh = ML.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    g = torch.Generator().manual_seed(3)

    def put(t, *pl):
        return distribute_tensor(t, mesh, pl)
    R = Replicate()
    q = torch.randn(4, 8, 16, generator=g)
    k, v = (torch.randn(4, 10, 4, 16, generator=g) for _ in range(2))
    lengths = torch.tensor([10, 3, 7, 1], dtype=torch.int32)
    got = FA.decode_attention(put(q, Shard(0), Shard(1)),
                              put(k, Shard(0), Shard(2)),
                              put(v, Shard(0), Shard(2)),
                              put(lengths, Shard(0), R))
    gaps = [_gap(got.full_tensor(), FA.decode_attention(q, k, v, lengths))]
    q = torch.randn(4, 6, 8, 16, generator=g)
    k, v = (torch.randn(4, 6, 4, 16, generator=g) for _ in range(2))
    got = FA.prefill_attention(*(put(t, Shard(0), Shard(2))
                                 for t in (q, k, v)))
    gaps.append(_gap(got.full_tensor(), FA.prefill_attention(q, k, v)))
    x, w = torch.randn(10, 16, generator=g), torch.randn(4, 16, 24,
                                                         generator=g)
    gs = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
    got = G.gmm(put(x, R, R), put(w, R, Shard(2)), put(gs, R, R))
    gaps.append(_gap(got.full_tensor(), G.gmm(x, w, gs)))
    return gaps


def compressed_rank(rank, world):
    """One rank of a 4-rank ``pod`` axis: the int8 compressed mean, one
    step and, with error feedback, eight."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch import mesh as ML
    from repro_torch.train.compress import dequantize_int8, quantize_int8
    mesh = ML.make_mesh((4,), ("pod",), device_type="cpu")
    group = mesh.get_group("pod")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 32)).astype(np.float32))

    def compressed_mean(x):
        q, s = quantize_int8(x)
        y = dequantize_int8(q, s)           # the wire format
        dist.all_reduce(y, op=dist.ReduceOp.AVG, group=group)
        return y
    local = distribute_tensor(g, mesh, (Shard(0),)).to_local()
    true_mean = g.reshape(4, 2, 32).mean(0)
    err = _gap(compressed_mean(local), true_mean)
    # error feedback: the residual of each round goes into the next
    resid, acc, steps = torch.zeros_like(local), torch.zeros(2, 32), 8
    for _ in range(steps):
        x = local + resid
        q, s = quantize_int8(x)
        y = dequantize_int8(q, s)
        resid = x - y
        dist.all_reduce(y, op=dist.ReduceOp.AVG, group=group)
        acc += y
    ef = _gap(acc / steps, true_mean)
    return err, ef


def sharded_checks() -> dict:
    """Run in a subprocess: the gloo worlds of every check."""
    import torch.distributed as dist
    from _torch_dist import checks, gloo_world
    out = checks([("train", lambda: gloo_world(train_rank, 8)),
                  ("serve", lambda: gloo_world(serve_rank, 4)),
                  ("ops", lambda: gloo_world(ops_rank, 4)),
                  ("compressed", lambda: gloo_world(compressed_rank, 4))])
    out["initialized"] = dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def worlds():
    return run("""
    from _torch_dist import save
    import test_torch_sharded_model as T
    save(OUT, T.sharded_checks())
    """, timeout=600)


def test_train_loss_and_gradients_match_plain(worlds):
    for r in result(worlds, "train"):
        assert r["loss"] <= TOL and r["grads"] <= TOL, r
        assert r["gqa"] <= TOL, r


def test_three_steps_lower_the_loss_as_plain(worlds):
    for r in result(worlds, "train"):
        losses, dlosses = r["losses"]
        assert dlosses[-1] < dlosses[0], dlosses
        np.testing.assert_allclose(dlosses, losses, rtol=0, atol=TOL)
        assert r["params"] <= TOL and r["placements_kept"], r


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_logits_and_cache_match_plain(worlds, arch):
    for r in result(worlds, "serve"):
        gaps = r[arch]
        assert len(gaps) == 4 and max(gaps) <= TOL, gaps


def test_kernel_ops_take_dtensors(worlds):
    for gaps in result(worlds, "ops"):
        assert len(gaps) == 3 and max(gaps) <= TOL, gaps


def test_compressed_mean_tracks_the_true_mean(worlds):
    for err, ef in result(worlds, "compressed"):
        assert err < 0.05, err
        assert ef < err, (ef, err)
    assert worlds["initialized"] is False
