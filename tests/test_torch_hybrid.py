"""The port's hybrid family (zamba2: Mamba2 + a shared attention block)
against the JAX package, at fp32 on the CPU.

  * K5's plain version (``mamba2_ssd.ref.ssd``) against the model's
    ``_ssd_chunk_scan`` with a NONZERO incoming state, at S = 16, 40 (a
    ragged tail: JAX is given the model's zero padding, the port the
    unpadded sequence) and 256; and against the Pallas
    ``ssd_chunk_scan`` in interpret mode, which starts from zeros;
  * dispatch: ``ops`` sends CPU tensors to the plain version, and the
    kernel wrapper refuses them;
  * ``mamba2`` against JAX: prefill from a state, one decode step, and a
    fresh prefill, output and every new state leaf;
  * model ``prefill`` + greedy ``decode_step``s against JAX on the
    zamba2-7b smoke (mamba chunk 128) at prompt lengths 13 and 150,
    with every cache leaf;
  * ``init_params``/``init_cache`` against JAX's tree, shapes and
    dtypes (one shared block, a KV layer per application);
  * the port engine against the JAX engine (exact-length admission
    groups), and the launcher.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.  Tolerances: the scan at 1e-4, as the JAX
kernel tests hold the chunked scan; the layer at 1e-5; the model at
1e-4 over several layers.  Greedy tokens must be identical.
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
from repro.kernels.mamba2_ssd.kernel import ssd_chunk_scan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.workload import poisson_trace as j_poisson  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving.workload import poisson_trace  # noqa: E402

ARCH = "zamba2_7b"
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
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


def _ssd_inputs(S, B=2, H=3, P=16, N=8, seed=0):
    """xh, B, C, a_log (negative) and a nonzero h0, from a numpy seed."""
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    a_log = (-np.log1p(np.exp(rng.standard_normal((B, S, H))))
             ).astype(np.float32)
    h0 = (rng.standard_normal((B, H, N, P)) * 0.5).astype(np.float32)
    return xh, Bm, Cm, a_log, h0


def _pad_tokens(a, pad):
    """Zero-pad axis 1 (tokens), as the model pads before its scan."""
    width = [(0, 0)] * a.ndim
    width[1] = (0, pad)
    return np.pad(a, width)


# --------------------------------------------------------------------- #
# K5's plain version
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S,chunk", [(16, 16), (40, 16), (256, 128)],
                         ids=["one_chunk", "ragged_tail", "two_chunks"])
def test_ssd_plain_matches_model_scan_with_state(S, chunk):
    xh, Bm, Cm, a_log, h0 = _ssd_inputs(S, seed=S)
    h = torch.from_numpy(h0.copy())
    y = ref.ssd(*(torch.from_numpy(a) for a in (xh, Bm, Cm, a_log)), h,
                chunk=chunk)
    pad = (-S) % chunk
    jy, jh = JS._ssd_chunk_scan(
        *(jnp.asarray(_pad_tokens(a, pad)) for a in (xh, Bm, Cm, a_log)),
        chunk, h0=jnp.asarray(h0))
    assert y.shape == xh.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :S], **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(32, 16), (64, 64)])
def test_ssd_plain_matches_pallas_from_zero_state(S, chunk):
    xh, Bm, Cm, a_log, _ = _ssd_inputs(S, seed=S + 1)
    h = torch.zeros((2, 3, 8, 16))
    y = ref.ssd(*(torch.from_numpy(a) for a in (xh, Bm, Cm, a_log)), h,
                chunk=chunk)
    py, ph = ssd_chunk_scan(*(jnp.asarray(a) for a in (xh, Bm, Cm, a_log)),
                            chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **SSD_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), **SSD_TOL)


def test_ssd_plain_state_carries_across_calls():
    """A 40-token scan equals 23 tokens then 17 from the carried state
    (ragged tails both), so a later chunk continues an earlier one."""
    xh, Bm, Cm, a_log, h0 = _ssd_inputs(40, seed=9)
    t = [torch.from_numpy(a) for a in (xh, Bm, Cm, a_log)]
    h1, h2 = torch.from_numpy(h0.copy()), torch.from_numpy(h0.copy())
    y = ref.ssd(*t, h1, chunk=16)
    ya = ref.ssd(*(a[:, :23] for a in t), h2, chunk=16)
    yb = ref.ssd(*(a[:, 23:] for a in t), h2, chunk=16)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, **SSD_TOL)
    torch.testing.assert_close(h2, h1, **SSD_TOL)


def test_ssd_ops_dispatch_cpu_to_plain_version():
    a = [torch.from_numpy(x) for x in _ssd_inputs(20, seed=4)]
    h_ops, h_ref = a[4].clone(), a[4].clone()
    before = dict(kernel.LAUNCHES)
    assert torch.equal(ops.ssd(*a[:4], h_ops, chunk=16),
                       ref.ssd(*a[:4], h_ref, chunk=16))
    assert torch.equal(h_ops, h_ref)
    assert kernel.LAUNCHES == before


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """Off the card the wrapper raises instead of falling back."""
    a = [torch.from_numpy(x) for x in _ssd_inputs(8, P=64, N=64, seed=5)]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd(*a)
    assert kernel._LIBS == {}


# --------------------------------------------------------------------- #
# The Mamba2 layer
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mamba_layer():
    jcfg, tcfg = _cfgs()
    p = JS.init_mamba2(jcfg, jax.random.PRNGKey(5))
    # nonzero decay rates and dt biases, so every head decays differently
    p["A_log"] = jax.random.normal(jax.random.PRNGKey(6), p["A_log"].shape)
    p["dt_bias"] = jax.random.normal(jax.random.PRNGKey(7),
                                     p["dt_bias"].shape) * 0.5
    return jcfg, tcfg, p, convert.tree_to_torch(_np_tree(p), device="cpu")


@pytest.mark.parametrize("S", [1, 37, 150],
                         ids=["decode", "ragged_prefill", "over_a_chunk"])
def test_mamba2_matches_jax_with_state(mamba_layer, S):
    jcfg, tcfg, p, tp = mamba_layer
    B = 2
    rng = np.random.default_rng(S)
    C = jcfg.d_inner + 2 * jcfg.ssm_state
    st = {"ssm": (rng.standard_normal((B, jcfg.ssm_heads, jcfg.ssm_state,
                                       jcfg.ssm_head_dim)) * 0.5)
          .astype(np.float32),
          "conv": rng.standard_normal((B, jcfg.conv_width - 1, C))
          .astype(np.float32)}
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jy, jst = JS.mamba2(p, jnp.asarray(x), jcfg,
                        state=jax.tree_util.tree_map(jnp.asarray, st))
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ty, tst2 = TS.mamba2(tp, torch.from_numpy(x), tcfg, state=tst)
    assert tst2 is tst                    # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    _assert_tree_close(tst, jst, **LAYER_TOL)


def test_mamba2_without_state_starts_from_zeros(mamba_layer):
    jcfg, tcfg, p, tp = mamba_layer
    x = np.random.default_rng(2).standard_normal(
        (2, 19, jcfg.d_model)).astype(np.float32)
    jy, jst = JS.mamba2(p, jnp.asarray(x), jcfg)
    ty, tst = TS.mamba2(tp, torch.from_numpy(x), tcfg)
    assert jst is None and tst is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)


# --------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [13, 150])
def test_prefill_and_decode_match_jax(S):
    """Equal-length rows (a recurrent prefill takes no padding), the
    shared attention block over its own KV layers, and eight greedy
    decode steps; logits, tokens and every cache leaf."""
    jcfg, tcfg = _cfgs()
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    assert len(tparams["layers"]) == jcfg.num_layers
    assert tparams["shared_attn"]["attn"]["wq"].dim() == 3
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


def test_init_matches_jax_structure_hybrid():
    """Same tree, shapes and dtypes as the JAX init (the fp32 A_log, D and
    dt_bias in a bf16 model; one unstacked shared block), the same weight
    scales, and a cache of mamba state for every layer with a KV layer
    for each shared-attention application."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    jp = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert tp.keys() == jp.keys() and len(tp["layers"]) == jcfg.num_layers
    pairs = [(lp, jax.tree_util.tree_map(lambda a: a[i], jp["layers"]))
             for i, lp in enumerate(tp["layers"])]
    pairs.append((tp["shared_attn"], jp["shared_attn"]))
    for t_tree, j_tree in pairs:
        flat_t, flat_j = _flatten(t_tree), _flatten(j_tree)
        assert flat_t.keys() == flat_j.keys()
        for key, t in flat_t.items():
            want = flat_j[key]
            assert tuple(t.shape) == want.shape, key
            assert str(t.dtype).split(".")[1] == want.dtype.name, key
            np.testing.assert_allclose(
                float(t.float().std()),
                float(np.asarray(want, np.float32).std()),
                rtol=0.25, atol=1e-6, err_msg=key)
    jcache = _np_tree(JM.init_cache(jcfg, 2, 24))
    tcache = TM.init_cache(tcfg, 2, 24, device="cpu")
    flat_t, flat_j = _flatten(tcache), _flatten(jcache)
    assert flat_t.keys() == flat_j.keys() == {
        "mamba/ssm", "mamba/conv", "kv/k", "kv/v"}
    for key, t in flat_t.items():
        assert tuple(t.shape) == flat_j[key].shape, key
        assert str(t.dtype).split(".")[1] == flat_j[key].dtype.name, key
    assert tcache["kv"]["k"].shape[0] == \
        jcfg.num_layers // jcfg.hybrid_attn_every


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_full_config_shapes():
    """zamba2-7b: 81 mamba layers in 27 groups of 3, so 27 KV layers;
    its attention runs K1/K2 at head_dim 112, H = Hkv = 32; the SSD at
    112 heads of 64 with state 64, the shapes K5 takes."""
    from repro_torch.kernels.flash_attention import kernel as FK
    cfg = TC.get(ARCH)
    assert cfg.num_layers // cfg.hybrid_attn_every == 27
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads) == (112, 32, 32)
    assert cfg.head_dim in FK.HEAD_DIMS
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == \
        (112, kernel.HEAD_DIM, kernel.STATE)
    TL.check_supported(cfg)
    with pytest.raises(ValueError, match="groups"):
        TL.check_supported(dataclasses.replace(cfg, num_layers=80))


def test_convert_carries_the_mamba_state_and_shared_block():
    jcfg = JC.get_smoke(ARCH)
    params = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_jax(_np_tree(params), device="cpu")
    np.testing.assert_array_equal(
        tparams["shared_attn"]["mlp"]["w_up"].view(torch.int16).numpy(),
        np.asarray(params["shared_attn"]["mlp"]["w_up"]).view(np.int16))
    np.testing.assert_array_equal(
        tparams["layers"][1]["mamba"]["A_log"].numpy(),
        np.asarray(params["layers"]["mamba"]["A_log"][1]))
    jcache = JM.init_cache(jcfg, 2, 8)
    jcache["mamba"]["ssm"] = jcache["mamba"]["ssm"] + 0.25
    tcache = convert.cache_from_jax(_np_tree(jcache), device="cpu")
    assert tcache["mamba"]["ssm"].dtype == torch.float32
    assert tcache["mamba"]["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tcache["mamba"]["ssm"].numpy(),
                                  np.asarray(jcache["mamba"]["ssm"]))


# --------------------------------------------------------------------- #
# The engine and the launcher
# --------------------------------------------------------------------- #
SLOTS, MAX_LEN = 4, 48
LENS = [20, 13, 9, 9, 5]


def _engine_requests(mod, trace_fn):
    """Distinct prompt lengths plus two equal ones arriving together, so
    that one-row and multi-row exact-length groups both run."""
    reqs = mod.requests_from_trace(trace_fn(10.0, len(LENS), seed=4), 256,
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
    assert [len(r.prompt) for r in treqs] == LENS
    eng = TE.ServingEngine(tcfg, tparams, slots=SLOTS, max_len=MAX_LEN,
                           sync_every=sync_every, device="cpu")
    eng.warmup()
    stats = eng.run(treqs)
    assert stats.completed == len(treqs)
    assert stats.prefill_batches >= len(set(LENS[:SLOTS]))
    assert {r.rid: r.output for r in treqs} == \
        {r.rid: r.output for r in jreqs}
    assert all(len(r.output) == r.max_new_tokens for r in treqs)


def test_serve_smoke_on_cpu():
    out = serve.main(["--smoke", "--device", "cpu", "--arch", ARCH,
                      "--trace", "poisson", "--requests", "4",
                      "--max-new", "5"])
    assert out["completed"] == 4 and out["decode_steps"] > 0
