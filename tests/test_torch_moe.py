"""The port's MoE family against the JAX package, at fp32 on the CPU.

  * K3's plain version (``moe_gmm.ref.gmm``) against ``gmm_ref`` and the
    Pallas ``gmm`` in interpret mode (after ``pad_groups``), over the
    group-size sweep of the JAX kernel tests, empty groups included;
  * ``layers.moe`` (``ragged`` and ``dense_einsum``) against the JAX
    ``layers.moe`` on the gpt-oss-20b and mixtral-8x7b smokes;
  * model ``prefill`` + 24 greedy ``decode_step``s against JAX on both
    smokes with window 16 and max_len 40, so the ring buffer wraps, and
    with a prompt longer than the window;
  * the port engine against the JAX engine on the gpt-oss smoke.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.  Tolerances: the grouped matmul at 1e-5 (one
fp32 dot product per element); the layer and the model at 1e-4, since
summation order differs between the frameworks through several layers.
Greedy tokens must be identical.
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
from repro.kernels.moe_gmm.kernel import gmm as pallas_gmm  # noqa: E402
from repro.kernels.moe_gmm.kernel import pad_groups  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.workload import poisson_trace as j_poisson  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.moe_gmm import kernel, ops, ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.workload import poisson_trace  # noqa: E402

MOE = ["gpt_oss_20b", "mixtral_8x7b"]
GMM_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(TC.get_smoke(arch), dtype="float32", **kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------- #
# K3's plain version
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("sizes", [
    [13, 0, 25, 12], [8, 8, 8, 8], [0, 0, 50, 0], [1, 2, 3, 4]])
def test_gmm_plain_matches_jax(sizes):
    sizes = np.array(sizes)
    T, d, E, f = int(sizes.sum()), 32, 4, 64
    rng = np.random.default_rng(int(sizes @ [1, 10, 100, 1000]))
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32)
    got = ref.gmm(torch.from_numpy(x), torch.from_numpy(w),
                  torch.from_numpy(sizes.astype(np.int32))).numpy()
    want = gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes))
    np.testing.assert_allclose(got, np.asarray(want), **GMM_TOL)
    xp, tile_gid, scatter = pad_groups(jnp.asarray(x), sizes, 8)
    pallas = pallas_gmm(xp, jnp.asarray(w), tile_gid, block_m=8, block_n=32,
                        interpret=True)[scatter]
    np.testing.assert_allclose(got, np.asarray(pallas), **GMM_TOL)
    ragged = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(sizes, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(ragged), **GMM_TOL)


def test_gmm_plain_rejects_sizes_that_do_not_cover_the_rows():
    x, w = torch.zeros(5, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="cover"):
        ref.gmm(x, w, torch.tensor([2, 2], dtype=torch.int32))


def test_gmm_ops_dispatch_cpu_to_plain_version():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    sizes = torch.tensor([2, 0, 4], dtype=torch.int32)
    before = dict(kernel.LAUNCHES)
    assert torch.equal(ops.gmm(x, w, sizes), ref.gmm(x, w, sizes))
    assert kernel.LAUNCHES == before


def test_gmm_kernel_wrapper_refuses_cpu_tensors():
    """Off the card the wrapper raises instead of falling back."""
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gmm(torch.zeros(4, 8), torch.zeros(2, 8, 8),
                   torch.tensor([2, 2], dtype=torch.int32))
    assert kernel._LIBS == {}


# --------------------------------------------------------------------- #
# The MoE layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["ragged", "dense_einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_jax(arch, impl):
    jcfg, tcfg = _cfgs(arch, moe_impl=impl)
    p = JL.init_moe(jcfg, jax.random.PRNGKey(5))
    tp = convert.tree_to_torch(_np_tree(p), device="cpu")
    assert tp["router"].dtype == torch.float32
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    want = JL.moe(p, jnp.asarray(x), jcfg)
    got = TL.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_routes_every_token_k_times():
    """Each token's output is the gate-weighted sum of its top-k
    experts' SwiGLU outputs (checked expert by expert)."""
    _, tcfg = _cfgs("gpt_oss_20b")
    g = torch.Generator().manual_seed(2)
    p = TL.init_moe(tcfg, g, torch.device("cpu"))
    x = torch.randn(1, 5, tcfg.d_model, generator=g)
    out = TL.moe(p, x, tcfg)[0]
    logits = x[0] @ p["router"]
    vals, ids = logits.topk(tcfg.experts_per_token, dim=-1)
    gates = vals.softmax(-1)
    for t in range(5):
        want = sum(gates[t, j] * ((torch.nn.functional.silu(
            x[0, t] @ p["w_gate"][e]) * (x[0, t] @ p["w_up"][e]))
            @ p["w_down"][e]) for j, e in enumerate(ids[t].tolist()))
        torch.testing.assert_close(out[t], want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- #
# The model, with the sliding-window ring buffer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S,last", [(13, [12, 5, 0]), (24, [23, 20, 7])],
                         ids=["ring_wraps_in_decode", "prompt_over_window"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch, S, last):
    jcfg, tcfg = _cfgs(arch)
    assert jcfg.sliding_window == 16
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    assert "moe" in tparams["layers"][0] and len(tparams["layers"]) == 2
    B, T = 3, 40
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.asarray(last, np.int32)           # right-padded rows

    jprefill = jax.jit(functools.partial(JM.prefill, params, jcfg))
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    jl, jc = jprefill(jnp.asarray(toks), JM.init_cache(jcfg, B, T),
                      last_pos=jnp.asarray(last))
    tc = TM.init_cache(tcfg, B, T, device="cpu")
    assert tc["kv"]["k"].shape[2] == 16         # the ring: min(40, 16)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                        last_pos=torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    pos = last + 1
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(24):                         # positions pass 16: wrap
        jl, jc = jdecode(jnp.asarray(tok)[:, None], jc, jnp.asarray(pos))
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok)[:, None],
                                tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jtok)
        tok, pos = jtok, pos + 1
    for c in ("k", "v"):
        np.testing.assert_allclose(tc["kv"][c].numpy(),
                                   np.asarray(jc["kv"][c]), **TOL)


def test_decode_pos_ring_slots():
    p = torch.tensor([0, 15, 16, 40])
    at = TL.DecodePos.of(p, 16)
    assert at.slot.tolist() == [0, 15, 0, 8]
    assert at.lengths.tolist() == [1, 16, 16, 16]
    assert at.lengths.dtype == torch.int32
    flat = TL.DecodePos.of(p)
    assert flat.slot.tolist() == [0, 15, 16, 40]
    assert flat.lengths.tolist() == [1, 16, 17, 41]


@pytest.mark.parametrize("arch", MOE)
def test_init_matches_jax_structure_moe(arch):
    """Same tree, shapes and dtypes as the JAX init (fp32 router in a
    bf16 model), the same weight scales, and a ring-buffer cache."""
    jcfg = JC.get_smoke(arch)
    tcfg = TC.get_smoke(arch)
    jp = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    for i, lp in enumerate(tp["layers"]):
        jl = jax.tree_util.tree_map(lambda a: a[i], jp["layers"])
        assert lp.keys() == jl.keys() and "mlp" not in lp
        for key, t in lp["moe"].items():
            assert tuple(t.shape) == jl["moe"][key].shape, key
            assert str(t.dtype).split(".")[1] == jl["moe"][key].dtype.name
            np.testing.assert_allclose(
                float(t.float().std()),
                float(np.asarray(jl["moe"][key], np.float32).std()),
                rtol=0.25, err_msg=key)
    jcache = JM.init_cache(jcfg, 2, 40)
    tcache = TM.init_cache(tcfg, 2, 40, device="cpu")
    assert tuple(tcache["kv"]["k"].shape) == jcache["kv"]["k"].shape
    assert tcache["kv"]["k"].shape[2] == tcfg.sliding_window


# --------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------- #
SLOTS, MAX_LEN, N_REQ = 2, 32, 5


@pytest.fixture(scope="module")
def gptoss_weights():
    jcfg, tcfg = _cfgs("gpt_oss_20b")
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, params, tcfg, convert.params_from_jax(_np_tree(params),
                                                       device="cpu")


def _requests(mod, trace_fn):
    # prompts up to 20 tokens (over the window of 16) and 12 new tokens,
    # so decode wraps the ring buffer
    return mod.requests_from_trace(trace_fn(10.0, N_REQ, seed=3), 256,
                                   max_prompt=20, max_new=12,
                                   time_scale=0.0)


@pytest.mark.parametrize("sync_every", [1, 8])
def test_engine_matches_jax_engine(gptoss_weights, sync_every):
    jcfg, params, tcfg, tparams = gptoss_weights
    jreqs = _requests(JE, j_poisson)
    JE.ServingEngine(jcfg, params, slots=SLOTS, max_len=MAX_LEN,
                     sync_every=sync_every).run(jreqs)
    treqs = _requests(TE, poisson_trace)
    eng = TE.ServingEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           sync_every=sync_every, device="cpu")
    stats = eng.run(treqs)
    assert stats.completed == N_REQ and stats.prefill_batches >= 2
    assert eng.cache["kv"]["k"].shape[2] == 16
    assert max(len(r.prompt) for r in treqs) > 16
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert all(len(r.output) == r.max_new_tokens for r in treqs)
