"""The port's expert-parallel MoE (``layers._moe_ep``, ``moe_impl="ep"``)
against the JAX package's, at fp32 on the smoke gpt-oss-20b,
mixtral-8x7b and dbrx-132b.

The reference has no test of its ``_moe_ep``, so the oracles are:
  * at capacity factor >= E/k nothing drops: port ``ep`` = port
    ``ragged`` = reference ``ep``, at 1e-5;
  * at the default 1.25, on an input built to drop (every token's
    largest router logit on one expert, so that expert is over capacity;
    no near-ties): drops on both sides, the same kept assignments, and
    port ``ep`` = reference ``ep`` at 1e-5;
  * on a (2 data x 2 model) mesh: 4 gloo ranks with DTensor inputs
    against the reference's ``shard_map`` on 4 JAX host devices, with
    and without drops, and with a batch of 1 (tokens replicated over
    data); and on each rank the gradients of a loss of ``ep``'s output
    (``moe_train``, every input and weight a DTensor) against those of
    the ``ragged`` path on plain tensors, at capacity E/k (dropless).
    The reference's ``shard_map`` runs with ``check_vma=False``, so its
    transpose is no settled oracle for ``ep``'s gradients; the ragged
    path computes the same function without a collective;
  * under a (1, 1) mesh: the model's prefill / decode logits and greedy
    tokens, and ``loss_fn`` with its gradients against
    ``jax.value_and_grad`` (the model tolerance, 1e-4, and
    ``test_torch_train.py``'s gradient tolerance); the port's engine
    gives the ``ragged`` engine's greedy tokens when nothing drops;
  * ``check_supported`` accepts ``ep`` and the softcap (a negative one
    is refused); ``ep`` raises without a mesh, and on a mesh of several
    devices without a DTensor.

Every process group lives in a subprocess (``_torch_dist``): one for
the one-device checks (a one-rank gloo group) and one for the 2 x 2
mesh.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.distributed.context import mesh_context as jmesh_context  # noqa: E402,E501
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed.context import mesh_context  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _torch_dist import result, run  # noqa: E402

ARCHS = ["gpt_oss_20b", "mixtral_8x7b", "dbrx_132b"]
EP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(TC.get_smoke(arch), dtype="float32", **kw))


def _ep(arch, factor=None):
    """(JAX, port) configs with ``moe_impl="ep"`` at capacity ``factor``
    (default: the configs' 1.25)."""
    kw = {} if factor is None else {"moe_capacity_factor": factor}
    return _cfgs(arch, moe_impl="ep", **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_inputs(arch, B, S, drops, seed=0):
    """(JAX MoE params as numpy, x (B, S, d)).  With ``drops`` every
    token gets a shared direction u and the router's expert 0 column
    leans on u, so expert 0 is every token's first choice and goes over
    capacity.  Each token's k-th and (k+1)-th largest router logits lie
    more than 1e-4 apart: no near-tie for the frameworks' rounding to
    flip."""
    jcfg, _ = _cfgs(arch)
    p = _np_tree(JL.init_moe(jcfg, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(seed)
    d = jcfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if drops:
        u = rng.standard_normal(d).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 4.0 * u
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 1.5 * u
    k = jcfg.experts_per_token
    logits = -np.sort(-(x.reshape(-1, d) @ p["router"]), axis=-1)
    assert (logits[:, k - 1] - logits[:, k]).min() > 1e-4
    return p, x


def _ref_moe(p, x, jcfg) -> np.ndarray:
    """The reference's MoE layer under the ambient mesh, jitted (its
    shard_map runs op by op, and slowly, outside a jit)."""
    return np.asarray(jax.jit(lambda p_, x_: JL.moe(p_, x_, jcfg))(
        p, jnp.asarray(x)))


def _ref_kept(x, router, k, E, factor, shards=1) -> np.ndarray:
    """The reference's kept assignments (token-major, k per token) from
    JAX's top-k of its router logits, per data shard of the tokens."""
    out = []
    for xs in np.split(x, shards, axis=0):
        xt = jnp.asarray(xs.reshape(-1, xs.shape[-1]))
        _, eid = jax.lax.top_k(xt @ jnp.asarray(router), k)
        flat = np.asarray(eid).reshape(-1)
        onehot = np.eye(E, dtype=np.int64)[flat]
        pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        C = max(int(-(-xt.shape[0] * k // E) * factor), 1)
        out.append(pos < C)
    return np.concatenate(out)


def _port_kept(x, router, tcfg) -> np.ndarray:
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    return TL.ep_route(xt, torch.from_numpy(np.array(router)), tcfg)[3] \
        .numpy()


# --------------------------------------------------------------------- #
# One device: the checks of one subprocess under a one-rank gloo group
# --------------------------------------------------------------------- #
def _layer_check(arch, factor, drops):
    """Port ep, port ragged and reference ep on one (1, 1) mesh."""
    from repro.launch.mesh import make_mesh
    jcfg, tcfg = _ep(arch, factor)
    p, x = _layer_inputs(arch, 3, 7, drops)
    tp = convert.tree_to_torch(p, device="cpu")
    with jmesh_context(make_mesh((1, 1), ("data", "model"))):
        want = _ref_moe(p, x, jcfg)
    got = TL.moe(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, **EP_TOL)
    k, E = tcfg.experts_per_token, tcfg.num_experts
    f = tcfg.moe_capacity_factor
    kept = _port_kept(x, p["router"], tcfg)
    np.testing.assert_array_equal(kept, _ref_kept(x, p["router"], k, E, f))
    if drops:
        assert not kept.all()
    else:
        assert kept.all()
        ragged = TL.moe(tp, torch.from_numpy(x),
                        dataclasses.replace(tcfg, moe_impl="ragged"))
        np.testing.assert_allclose(got, ragged.numpy(), **EP_TOL)
    return int((~kept).sum())


def _model_check(arch):
    """Prefill of right-padded rows and 8 greedy decode steps at the
    default capacity, against the reference under its (1, 1) mesh."""
    from repro.launch.mesh import make_mesh
    jcfg, tcfg = _ep(arch)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    B, S, T = 3, 13, 40
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.asarray([12, 5, 0], np.int32)
    with jmesh_context(make_mesh((1, 1), ("data", "model"))):
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
        tokens = [tok]
        for _ in range(8):
            jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
            tl, tc = TM.decode_step(tparams, tcfg,
                                    torch.from_numpy(tok)[:, None], tc,
                                    torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
            tok, pos = jtok, pos + 1
            tokens.append(tok)
    return np.stack(tokens).tolist()


def _grad_check():
    """loss_fn and its gradients, gpt-oss-20b smoke, default capacity."""
    from repro.launch.mesh import make_mesh
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import leaves_as
    jcfg, tcfg = _ep("gpt_oss_20b")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    tgts = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    with jmesh_context(make_mesh((1, 1), ("data", "model"))):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, jcfg, jnp.asarray(toks),
                                 jnp.asarray(tgts))))(params)
        tloss, tgrads = value_and_grad(
            lambda p: TM.loss_fn(p, tcfg, torch.from_numpy(toks),
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
    moe = tgrads["layers"][0]["moe"]
    assert all(float(moe[n].abs().max()) > 0 for n in
               ("router", "w_gate", "w_up", "w_down"))
    return float(tloss)


def _engine_check():
    """The port's engine, ep at capacity E/k against ragged: the same
    greedy tokens for 5 requests over 2 slots."""
    from repro_torch.serving import engine as TE
    from repro_torch.serving.workload import poisson_trace
    jcfg, tcfg = _ep("gpt_oss_20b", factor=2.0)
    assert tcfg.moe_capacity_factor * tcfg.experts_per_token \
        >= tcfg.num_experts
    params = convert.params_from_jax(
        _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(2))), device="cpu")
    out = {}
    for impl in ("ep", "ragged"):
        reqs = TE.requests_from_trace(poisson_trace(10.0, 5, seed=3), 256,
                                      max_prompt=20, max_new=12,
                                      time_scale=0.0)
        eng = TE.ServingEngine(dataclasses.replace(tcfg, moe_impl=impl),
                               params, slots=2, max_len=32, device="cpu")
        stats = eng.run(reqs)
        assert stats.completed == 5
        assert all(len(r.output) == r.max_new_tokens for r in reqs)
        out[impl] = {r.rid: r.output for r in reqs}
    assert out["ep"] == out["ragged"]
    return out["ep"]


def _refusal_check():
    """On a mesh of 4 devices (a fake group), a plain x raises."""
    _, tcfg = _ep("gpt_oss_20b")
    p, x = _layer_inputs("gpt_oss_20b", 2, 4, False)
    with TMESH.fake_world(4):
        mesh = TMESH.make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with mesh_context(mesh):
            with pytest.raises(ValueError, match="DTensor"):
                TL.moe(convert.tree_to_torch(p, device="cpu"),
                       torch.from_numpy(x), tcfg)
    return True


def one_device_checks() -> dict:
    """Run in a subprocess: every one-device check under a one-rank gloo
    group and a (1, 1) mesh."""
    from _torch_dist import checks, one_rank
    fns = []
    for arch in ARCHS:
        E, k = JC.get_smoke(arch).num_experts, \
            JC.get_smoke(arch).experts_per_token
        for factor in (E / k, 2 * E / k):
            fns.append((f"dropless_{arch}_{factor}", functools.partial(
                _layer_check, arch, factor, False)))
        fns.append((f"drops_{arch}", functools.partial(
            _layer_check, arch, None, True)))
    fns += [(f"model_{arch}", functools.partial(_model_check, arch))
            for arch in ("gpt_oss_20b", "mixtral_8x7b")]
    fns += [("grads", _grad_check), ("engine", _engine_check)]
    with one_rank():
        mesh = TMESH.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with mesh_context(mesh):
            out = checks(fns)
    out.update(checks([("refusal", _refusal_check)]))
    out["initialized_at_exit"] = dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def one_device():
    return run("""
    from _torch_dist import save
    import test_torch_moe_ep as T
    save(OUT, T.one_device_checks())
    """, timeout=600)


@pytest.mark.parametrize("factor", ["E/k", "2E/k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_ep_equals_ragged_and_reference(one_device, arch, factor):
    cfg = JC.get_smoke(arch)
    f = cfg.num_experts / cfg.experts_per_token * (2 if factor == "2E/k"
                                                   else 1)
    assert result(one_device, f"dropless_{arch}_{f}") == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_drops_match_reference(one_device, arch):
    assert result(one_device, f"drops_{arch}") > 0


@pytest.mark.parametrize("arch", ["gpt_oss_20b", "mixtral_8x7b"])
def test_model_logits_and_greedy_tokens_match_reference(one_device, arch):
    tokens = result(one_device, f"model_{arch}")
    assert len(tokens) == 9 and len(tokens[0]) == 3


def test_loss_and_gradients_match_reference(one_device):
    assert np.isfinite(result(one_device, "grads"))


def test_engine_ep_gives_the_ragged_engines_tokens(one_device):
    out = result(one_device, "engine")
    assert len(out) == 5 and all(out.values())


def test_ep_on_several_devices_needs_a_dtensor(one_device):
    assert result(one_device, "refusal") is True
    assert one_device["initialized_at_exit"] is False


# --------------------------------------------------------------------- #
# A 2 x 2 mesh: four gloo ranks against four JAX host devices
# --------------------------------------------------------------------- #
# (name, arch, B, S, capacity factor (None: 1.25), an input that drops)
MESH_CASES = [("dropless", "gpt_oss_20b", 4, 6, 2.0, False),
              ("drops", "gpt_oss_20b", 4, 8, None, True),
              ("drops", "dbrx_132b", 4, 8, None, True),
              ("batch_1", "mixtral_8x7b", 1, 9, None, True)]
# the gradient cases: (name, arch, B, S), at capacity E/k (dropless)
MESH_GRAD_CASES = [("grads", "gpt_oss_20b", 4, 6),
                   ("grads_batch_1", "mixtral_8x7b", 1, 9)]
GRAD_NAMES = ("x", "router", "w_gate", "w_up", "w_down")


def _placed(p, x, mesh, B):
    """x and the MoE weights as DTensors placed as the reference's
    shard_map specs (tokens over data where B splits, experts' f over
    model)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rep = (Replicate(), Replicate())
    xd = distribute_tensor(torch.from_numpy(x).clone(), mesh,
                           (Shard(0) if B % 2 == 0 else Replicate(),
                            Replicate()))
    w = {"router": (p["router"], rep),
         "w_gate": (p["w_gate"], (Replicate(), Shard(2))),
         "w_up": (p["w_up"], (Replicate(), Shard(2))),
         "w_down": (p["w_down"], (Replicate(), Shard(1)))}
    return xd, {n: distribute_tensor(torch.from_numpy(np.array(a)), mesh, pl)
                for n, (a, pl) in w.items()}


def _loss_weights(x):
    return torch.linspace(-1.0, 1.0, x.size).reshape(x.shape)


def _ep_and_ragged_grads(p, x, arch, mesh, B):
    """The gradients (GRAD_NAMES) of sum(y * c) for ``ep``'s ``moe_train``
    on DTensors over ``mesh`` (gathered whole) and for the ragged path's
    on plain tensors, at capacity E/k."""
    jcfg, _ = _cfgs(arch)
    _, tcfg = _ep(arch, jcfg.num_experts / jcfg.experts_per_token)
    c = _loss_weights(x)
    plain = [torch.from_numpy(np.array(a)).requires_grad_()
             for a in (x, *(p[n] for n in GRAD_NAMES[1:]))]
    y = TL.moe_train(dict(zip(GRAD_NAMES[1:], plain[1:])), plain[0],
                     dataclasses.replace(tcfg, moe_impl="ragged"))
    ragged = torch.autograd.grad((y * c).sum(), plain)
    with mesh_context(mesh):
        xd, pd = _placed(p, x, mesh, B)
        leaves = [xd.requires_grad_()] + [pd[n].requires_grad_()
                                          for n in GRAD_NAMES[1:]]
        y = TL.moe_train(dict(zip(GRAD_NAMES[1:], leaves[1:])), leaves[0],
                         tcfg)
        ep = torch.autograd.grad((y.full_tensor() * c).sum(), leaves)
        ep = [g.full_tensor().numpy() for g in ep]
    return ep, [g.numpy() for g in ragged]


def ep_rank(rank, world, inputs_file):
    """One gloo rank of the (2, 2) mesh: every case's output through
    DTensor inputs placed as the reference's shard_map specs, and the
    gradient cases' ``ep`` and ragged gradients."""
    import pickle
    with open(inputs_file, "rb") as f:
        cases, grad_cases = pickle.load(f)
    mesh = TMESH.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    with mesh_context(mesh):
        for (name, arch, B, S, factor, drops), (p, x) in cases.items():
            _, tcfg = _ep(arch, factor)
            xd, pd = _placed(p, x, mesh, B)
            y = TL.moe(pd, xd, tcfg)
            out[name, arch] = (tuple(y.placements) == xd.placements,
                               y.full_tensor().numpy())
    for (name, arch, B, S), (p, x) in grad_cases.items():
        out[name, arch] = _ep_and_ragged_grads(p, x, arch, mesh, B)
    return out


def two_by_two() -> dict:
    """Run in a subprocess with 4 JAX host devices: the reference's
    outputs and kept sets on its (2, 2) mesh, and the gloo ranks'."""
    import os
    import tempfile
    from repro.launch.mesh import make_mesh
    from _torch_dist import gloo_world, save
    assert len(jax.devices()) == 4
    jmesh = make_mesh((2, 2), ("data", "model"))
    cases, ref = {}, {}
    for name, arch, B, S, factor, drops in MESH_CASES:
        jcfg, tcfg = _ep(arch, factor)
        p, x = _layer_inputs(arch, B, S, drops, seed=B * S)
        cases[name, arch, B, S, factor, drops] = (p, x)
        with jmesh_context(jmesh):
            want = _ref_moe(p, x, jcfg)
        kept = _ref_kept(x, p["router"], tcfg.experts_per_token,
                         tcfg.num_experts, tcfg.moe_capacity_factor,
                         shards=2 if B % 2 == 0 else 1)
        ref[name, arch] = (want, int((~kept).sum()))
    grad_cases = {case: _layer_inputs(case[1], case[2], case[3], False,
                                      seed=case[2] * case[3] + 1)
                  for case in MESH_GRAD_CASES}
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "cases.pkl")
        save(f, (cases, grad_cases))
        ranks = gloo_world(ep_rank, 4, f)
    return {"ref": ref, "ranks": ranks,
            "initialized": dist.is_initialized()}


@pytest.fixture(scope="module")
def mesh_2x2():
    return run("""
    from _torch_dist import save
    import test_torch_moe_ep as T
    save(OUT, T.two_by_two())
    """, jax_devices=4, timeout=600)


@pytest.mark.parametrize("case", MESH_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in MESH_CASES])
def test_two_by_two_mesh_matches_reference(mesh_2x2, case):
    name, arch, _, _, _, drops = case
    want, dropped = mesh_2x2["ref"][name, arch]
    assert (dropped > 0) == drops
    for rank_out in mesh_2x2["ranks"]:
        same_placements, got = rank_out[name, arch]
        assert same_placements
        np.testing.assert_allclose(got, want, **EP_TOL)
    assert mesh_2x2["initialized"] is False


@pytest.mark.parametrize("case", MESH_GRAD_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in MESH_GRAD_CASES])
def test_two_by_two_ep_gradients_match_ragged(mesh_2x2, case):
    """On every rank of the 2 x 2 mesh, ``ep``'s gradients of x and of
    every MoE weight (all reduced across the ranks that hold a shard)
    equal the ragged path's at capacity E/k, at GRAD_TOL, its atol in
    units of each gradient's largest magnitude above 1."""
    name, arch = case[:2]
    for rank_out in mesh_2x2["ranks"]:
        ep, ragged = rank_out[name, arch]
        assert len(ep) == len(ragged) == len(GRAD_NAMES)
        for n, a, b in zip(GRAD_NAMES, ep, ragged):
            assert a.shape == b.shape, n
            assert np.abs(b).max() > 0, n
            scale = max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=GRAD_TOL["rtol"],
                                       atol=GRAD_TOL["atol"] * scale,
                                       err_msg=n)
    assert mesh_2x2["initialized"] is False


# --------------------------------------------------------------------- #
# In this process: no group
# --------------------------------------------------------------------- #
def test_check_supported_accepts_ep_and_refuses_softcap():
    """``ep`` and the logit softcap are both accepted, together too; only
    a negative softcap is refused."""
    _, tcfg = _ep("gpt_oss_20b")
    TL.check_supported(tcfg)
    TL.check_supported(dataclasses.replace(tcfg, attn_logit_softcap=30.0))
    with pytest.raises(ValueError, match="softcap"):
        TL.check_supported(dataclasses.replace(tcfg, attn_logit_softcap=-1.0))


def test_ep_without_a_mesh_raises():
    _, tcfg = _ep("gpt_oss_20b")
    p, x = _layer_inputs("gpt_oss_20b", 2, 4, False)
    for fn in (TL.moe, TL.moe_train):
        with pytest.raises(RuntimeError, match="mesh_context"):
            fn(convert.tree_to_torch(p, device="cpu"), torch.from_numpy(x),
               tcfg)
    assert not dist.is_initialized()


def test_ep_route_capacity():
    """C = ceil(T*k/E * factor) in Python numbers: 1 at gpt-oss-20b's
    decode (4 tokens, k 4, E 32) and 320 at its 4 x 512 prefill."""
    cfg = TC.get("gpt_oss_20b")
    for T, factor, want in ((4, 1.25, 1), (2048, 1.25, 320), (4, 8.0, 8),
                            (2048, 8.0, 2048)):
        xt = torch.zeros(T, 8)
        C = TL.ep_route(xt, torch.zeros(8, 32), dataclasses.replace(
            cfg, moe_capacity_factor=factor))[4]
        assert C == want
