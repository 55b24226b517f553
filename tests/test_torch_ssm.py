"""The port's ssm family (rwkv6) against the JAX package, at fp32 on the
CPU.

  * K4's plain version (``rwkv6.ref.wkv``) against ``wkv_ref`` and the
    Pallas ``wkv`` in interpret mode, with a nonzero incoming state, at
    S = 1 (decode), 13 and 64;
  * dispatch: ``ops`` sends CPU tensors to the plain version, and the
    kernel wrapper refuses them;
  * ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` against JAX, output and
    every new state leaf, at prefill and at one decode step;
  * model ``prefill`` + greedy ``decode_step``s against JAX on the
    rwkv6-3b smoke at prompt lengths 13 and 150, with every cache leaf;
  * ``init_params``/``init_cache`` against JAX's tree, shapes and dtypes;
  * the port engine against the JAX engine (exact-length admission
    groups), and the launcher.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.  Tolerances: the recurrence and the layers at
1e-5 (fp32, the same operations in another summation order); the model
at 1e-4 over several layers, as the dense and MoE tests.  Greedy tokens
must be identical.
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
from repro.kernels.rwkv6.kernel import wkv as pallas_wkv  # noqa: E402
from repro.kernels.rwkv6.ref import wkv_ref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.workload import poisson_trace as j_poisson  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.workload import poisson_trace  # noqa: E402

ARCH = "rwkv6_3b"
WKV_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(**kw):
    return (dataclasses.replace(JC.get_smoke(ARCH), dtype="float32", **kw),
            dataclasses.replace(TC.get_smoke(ARCH), dtype="float32", **kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    """Every leaf of the port's (nested dict) tree against JAX's."""
    assert got.keys() == want.keys()
    for k, v in got.items():
        if isinstance(v, dict):
            _assert_tree_close(v, want[k], **tol)
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       err_msg=k, **tol)


def _wkv_inputs(S, B=2, H=3, P=16, seed=0):
    """r, k, v, w (in (0, 1)), u and a nonzero state, from a numpy seed."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, P))))
         ).astype(np.float32)
    u = (rng.standard_normal((H, P)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, P)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


# --------------------------------------------------------------------- #
# K4's plain version
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [1, 13, 64])
def test_wkv_plain_matches_jax(S):
    r, k, v, w, u, s0 = _wkv_inputs(S, seed=S)
    state = torch.from_numpy(s0.copy())
    y = ref.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u)), state)
    jy, js = wkv_ref(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(js), **WKV_TOL)
    # the Pallas kernel as the JAX tests run it on the CPU (its chunk is
    # min(64, S), which divides each of these S)
    py, ps = pallas_wkv(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)),
                        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **WKV_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ps), **WKV_TOL)


def test_wkv_plain_matches_model_scan_and_splits_over_calls():
    """The model's ``_wkv_scan`` (with its fp32 w) is the same function,
    and running 13 tokens as 5 + 8 through the carried state equals one
    call: the decode path is the prefill path at S = 1."""
    r, k, v, w, u, s0 = _wkv_inputs(13, seed=7)
    jy, js = JS._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    t = [torch.from_numpy(a) for a in (r, k, v, w)]
    state = torch.from_numpy(s0.copy())
    y1 = ref.wkv(*(a[:, :5] for a in t), torch.from_numpy(u), state)
    y2 = ref.wkv(*(a[:, 5:] for a in t), torch.from_numpy(u), state)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(js), **WKV_TOL)


def test_wkv_ops_dispatch_cpu_to_plain_version():
    a = [torch.from_numpy(x) for x in _wkv_inputs(5, seed=1)]
    s_ops, s_ref = a[5].clone(), a[5].clone()
    before = dict(kernel.LAUNCHES)
    assert torch.equal(ops.wkv(*a[:5], s_ops), ref.wkv(*a[:5], s_ref))
    assert torch.equal(s_ops, s_ref)
    assert kernel.LAUNCHES == before


def test_wkv_kernel_wrapper_refuses_cpu_tensors():
    """Off the card the wrapper raises instead of falling back."""
    a = [torch.from_numpy(x) for x in _wkv_inputs(3, P=64, seed=2)]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.wkv(*a)
    assert kernel._LIBS == {}


# --------------------------------------------------------------------- #
# The layers
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rwkv_layer():
    jcfg, tcfg = _cfgs()
    p = JS.init_rwkv6(jcfg, jax.random.PRNGKey(5))
    # a nonzero bonus, so the u term is exercised
    p["u"] = jax.random.normal(jax.random.PRNGKey(6), p["u"].shape) * 0.3
    return jcfg, tcfg, p, convert.tree_to_torch(_np_tree(p), device="cpu")


def _state(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    d, H, P = jcfg.d_model, jcfg.rwkv_heads, jcfg.rwkv_head_dim
    return {"tm_x": rng.standard_normal((B, d)).astype(np.float32),
            "wkv": (rng.standard_normal((B, H, P, P)) * 0.1)
            .astype(np.float32),
            "cm_x": rng.standard_normal((B, d)).astype(np.float32)}


@pytest.mark.parametrize("S", [1, 9])
def test_rwkv6_time_and_channel_mix_match_jax(rwkv_layer, S):
    jcfg, tcfg, p, tp = rwkv_layer
    B = 2
    st = _state(jcfg, B, seed=S)
    x = np.random.default_rng(S + 1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jy, jst = JS.rwkv6_time_mix(p, jnp.asarray(x), jcfg, state={
        "tm_x": jnp.asarray(st["tm_x"]), "wkv": jnp.asarray(st["wkv"])})
    tst = {k: torch.from_numpy(st[k].copy()) for k in ("tm_x", "wkv")}
    ty, tst2 = TS.rwkv6_time_mix(tp, torch.from_numpy(x), tcfg, state=tst)
    assert tst2 is tst                    # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    _assert_tree_close(tst, jst, **LAYER_TOL)

    jy, jcm = JS.rwkv6_channel_mix(p, jnp.asarray(x), jcfg,
                                   state=jnp.asarray(st["cm_x"]))
    cm = torch.from_numpy(st["cm_x"].copy())
    ty, _ = TS.rwkv6_channel_mix(tp, torch.from_numpy(x), tcfg, state=cm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(cm.numpy(), np.asarray(jcm), **LAYER_TOL)


def test_rwkv6_layers_without_state_start_from_zeros(rwkv_layer):
    jcfg, tcfg, p, tp = rwkv_layer
    x = np.random.default_rng(3).standard_normal(
        (1, 6, jcfg.d_model)).astype(np.float32)
    for jfn, tfn in ((JS.rwkv6_time_mix, TS.rwkv6_time_mix),
                     (JS.rwkv6_channel_mix, TS.rwkv6_channel_mix)):
        jy, jst = jfn(p, jnp.asarray(x), jcfg)
        ty, tst = tfn(tp, torch.from_numpy(x), tcfg)
        assert jst is None and tst is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)


# --------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [13, 150])
def test_prefill_and_decode_match_jax(S):
    """Equal-length rows (a recurrent prefill takes no padding) and eight
    greedy decode steps; logits, tokens and every cache leaf."""
    jcfg, tcfg = _cfgs()
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    assert "tm" in tparams["layers"][0] and len(tparams["layers"]) == 2
    B, T = 2, S + 16
    toks = np.random.default_rng(S).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)

    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    jl, jc = JM.prefill(params, jcfg, jnp.asarray(toks),
                        JM.init_cache(jcfg, B, T))
    tc = TM.init_cache(tcfg, B, T, device="cpu")
    tl, tc2 = TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc)
    assert tc2 is tc                      # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc, **TOL)

    pos = np.full(B, S, np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(8):
        jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok)[:, None],
                                tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        tok, pos = jtok, pos + 1
    _assert_tree_close(tc, jc, **TOL)


def test_init_matches_jax_structure_ssm():
    """Same tree, shapes and dtypes as the JAX init (fp32 decay base and
    bonus in a bf16 model), and the same weight scales; the cache is the
    three recurrent leaves, with no KV."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jp = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert tp.keys() == jp.keys() and len(tp["layers"]) == jcfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        jl = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        assert lp.keys() == jl.keys()
        for key, t in lp["tm"].items():
            want = jl["tm"][key]
            assert tuple(t.shape) == want.shape, key
            assert str(t.dtype).split(".")[1] == want.dtype.name, key
            wstd = float(np.asarray(want, np.float32).std())
            np.testing.assert_allclose(float(t.float().std()), wstd,
                                       rtol=0.25, atol=1e-6, err_msg=key)
    jcache = JM.init_cache(jcfg, 2, 24)
    tcache = TM.init_cache(tcfg, 2, 24, device="cpu")
    assert tcache.keys() == jcache.keys() == {"rwkv"}
    for k, t in tcache["rwkv"].items():
        want = jcache["rwkv"][k]
        assert tuple(t.shape) == want.shape, k
        assert str(t.dtype).split(".")[1] == want.dtype.name, k
        assert not t.any()


def test_convert_carries_the_rwkv_state_tree():
    jcfg = JC.get_smoke(ARCH)
    jcache = JM.init_cache(jcfg, 2, 8)
    jcache["rwkv"]["wkv"] = jcache["rwkv"]["wkv"] + 0.5
    tcache = convert.cache_from_jax(_np_tree(jcache), device="cpu")
    assert tcache["rwkv"]["tm_x"].dtype == torch.bfloat16
    assert tcache["rwkv"]["wkv"].dtype == torch.float32
    _assert_tree_close({k: v.float() for k, v in tcache["rwkv"].items()},
                       jax.tree_util.tree_map(
                           lambda a: np.asarray(a, np.float32),
                           jcache["rwkv"]), atol=0, rtol=0)


# --------------------------------------------------------------------- #
# The engine and the launcher
# --------------------------------------------------------------------- #
SLOTS, MAX_LEN = 4, 48


LENS = [20, 13, 9, 9, 5]


def _engine_requests(mod, trace_fn):
    """Distinct prompt lengths plus two equal ones arriving together, so
    that one-row and multi-row exact-length groups both run."""
    reqs = mod.requests_from_trace(trace_fn(10.0, len(LENS), seed=3), 256,
                                   max_prompt=20, max_new=6, time_scale=0.0)
    for r, n in zip(reqs, LENS):
        r.prompt = r.prompt[:n].copy()
    return reqs


@pytest.mark.parametrize("sync_every", [1, 8])
def test_engine_matches_jax_engine(sync_every):
    jcfg, tcfg = _cfgs()
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    jreqs = _engine_requests(JE, j_poisson)
    JE.ServingEngine(jcfg, params, slots=SLOTS, max_len=MAX_LEN,
                     sync_every=sync_every).run(jreqs)
    treqs = _engine_requests(TE, poisson_trace)
    lens = [len(r.prompt) for r in treqs]
    assert lens == LENS
    eng = TE.ServingEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           sync_every=sync_every, device="cpu")
    stats = eng.run(treqs)
    assert stats.completed == len(treqs)
    # one prefill per exact length among the first wave of four
    assert stats.prefill_batches >= len(set(lens[:SLOTS]))
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert all(len(r.output) == r.max_new_tokens for r in treqs)


def test_admission_groups_by_exact_length():
    _, tcfg = _cfgs()
    eng = TE.ServingEngine(tcfg, TM.init_params(tcfg, device="cpu"),
                           slots=4, max_len=16, device="cpu")
    reqs = [TE.Request(rid=i, prompt=np.zeros(n, np.int32))
            for i, n in enumerate([3, 5, 3, 7])]
    groups = eng._admission_groups(list(enumerate(reqs)))
    assert [[r.rid for _, r in g] for g in groups] == [[0, 2], [1], [3]]


def test_serve_smoke_on_cpu():
    out = serve.main(["--smoke", "--device", "cpu", "--arch", ARCH,
                      "--trace", "poisson", "--requests", "4",
                      "--max-new", "5"])
    assert out["completed"] == 4 and out["decode_steps"] > 0
