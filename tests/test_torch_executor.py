"""The port's disaggregated executor (``repro_torch.core.executor``) and
pipelined runner: the staged executable reproduces the traced function
on two logical CPU devices, for both policies; the four families' decode
steps equal the single-device step (1e-5, fp32) and JAX's decode step
(the parity tests' tolerance, identical greedy tokens), writing the
cache in place; the engine serves the same greedy tokens through it."""
import copy
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
from repro_torch.core import marker, planner  # noqa: E402
from repro_torch.core.analyzer import analyze, pin_nodes  # noqa: E402
from repro_torch.core.costmodel import CATALOG, PAPER_PAIRS  # noqa: E402
from repro_torch.core.executor import (LogicalDevice,  # noqa: E402
                                       build_executable, logical_devices)
from repro_torch.core.pipeline import PipelinedRunner  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving.engine import (Request,  # noqa: E402
                                        ServingEngine)

from _torch_parity import grid_positions3  # noqa: E402

DEVS = [CATALOG[d] for d in PAPER_PAIRS[1]]
TOL = dict(atol=1e-4, rtol=1e-4)          # the port's JAX parity tolerance


def _check(fn, *args, policy="throughput", state_argnums=(), lds=None):
    want = fn(*copy.deepcopy(args))
    tg = analyze(fn, *copy.deepcopy(args), state_argnums=state_argnums)
    p = planner.plan(tg.graph, DEVS, policy=policy, cache=False)
    exe = build_executable(tg, p, lds or logical_devices(2, "cpu"))
    got = exe(*args)
    torch.utils._pytree.tree_map(
        lambda a, b: torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6),
        got, want)
    return exe, p


@pytest.fixture
def small_mlp():
    def model(x, params):
        for i, (w1, w2) in enumerate(params):
            x = marker.wrap(lambda y, a=w1, b=w2:
                            torch.nn.functional.gelu(y @ a) @ b,
                            block="ffn", layer=i)(x)
        return torch.tanh(x)

    g = torch.Generator().manual_seed(0)
    params = [(torch.randn(32, 64, generator=g) * 0.1,
               torch.randn(64, 32, generator=g) * 0.1) for _ in range(4)]
    return model, (torch.randn(4, 32, generator=g), params)


# --------------------------------------------------------------------- #
# The reference's executor cases
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["throughput", "latency"])
def test_mlp_both_policies(small_mlp, policy):
    fn, args = small_mlp
    _check(fn, *args, policy=policy)


def test_multi_output_function():
    def f(x, w):
        h = x @ w
        return torch.tanh(h), h.sum(), {"logits": h * 2}

    _check(f, torch.arange(12.0).reshape(3, 4), torch.ones(4, 4))


def test_constant_handling():
    c = torch.linspace(0, 1, 8)

    def f(x):
        return x * 2.0 + c             # c closes over -> a lifted constant

    _check(f, torch.ones(8))


def test_kwargs_and_pytrees():
    def f(x, params, *, scale):
        return torch.relu(x @ params["w"]) + params["b"] * scale

    x = torch.ones(4, 8)
    params = {"w": torch.full((8, 8), 0.1), "b": torch.ones(8)}
    want = f(x, params, scale=torch.tensor(2.0))
    tg = analyze(f, x, params, scale=torch.tensor(2.0))
    p = planner.plan(tg.graph, DEVS, cache=False)
    exe = build_executable(tg, p, logical_devices(2, "cpu"))
    torch.testing.assert_close(exe(x, params, scale=torch.tensor(2.0)), want)
    with pytest.raises(TypeError, match="structure"):
        exe(x, [params["w"], params["b"]], scale=torch.tensor(2.0))


def test_stateful_step_with_pinning():
    """A cache written in place: pinned kernels keep it home, the writes
    land in the caller's tensor, and its storage is not copied."""
    def step(kv, x):
        score = (kv * x).sum()
        kv[0] = score
        kv.mul_(0.5)
        return kv, torch.tanh(score)

    kv, x = torch.arange(16.0), torch.ones(16)
    tg = analyze(step, kv.clone(), x, state_argnums=(0,))
    g = pin_nodes(tg.graph, tg.state_readers | tg.state_writers, 0)
    tg = tg.with_graph(g)
    p = planner.plan(g, DEVS, policy="throughput", cache=False)
    for nid in tg.state_readers | tg.state_writers:
        assert p.labels[nid] == 0
    exe = build_executable(tg, p, logical_devices(2, "cpu"))
    ref_kv = kv.clone()
    ptr = kv.data_ptr()
    new_kv, out = exe(kv, x)
    ref_new, ref_out = step(ref_kv, x)
    assert new_kv is kv and kv.data_ptr() == ptr
    torch.testing.assert_close(kv, ref_kv)
    torch.testing.assert_close(out, ref_out)


def test_iterated_state_threading():
    def step(s, x):
        s.mul_(0.9).add_(x)
        return s.sum()

    s, x = torch.ones(8), torch.full((8,), 0.5)
    tg = analyze(step, s.clone(), x, state_argnums=(0,))
    g = pin_nodes(tg.graph, tg.state_readers | tg.state_writers, 0)
    exe = build_executable(tg.with_graph(g),
                           planner.plan(g, DEVS, cache=False),
                           logical_devices(2, "cpu"))
    s_ref = s.clone()
    for _ in range(5):
        out = exe(s, x)
        out_ref = step(s_ref, x)
        torch.testing.assert_close(s, s_ref)
        torch.testing.assert_close(out, out_ref)


def test_markers_execute_as_identity(small_mlp):
    fn, args = small_mlp
    assert fn(*args).shape == args[0].shape
    with marker.region(block="attention", layer=1):
        assert fn(*args).shape == args[0].shape


def test_stage_device_assignment_matches_plan(small_mlp):
    fn, args = small_mlp
    tg = analyze(fn, *args)
    p = planner.plan(tg.graph, DEVS, cache=False)
    lds = logical_devices(2, "cpu")
    exe = build_executable(tg, p, lds)
    for cs in exe.stages:
        assert cs.stage.device == p.labels[cs.stage.node_ids[0]]
        assert cs.device is lds[cs.stage.device]
        for k in cs.stage.node_ids:
            assert p.labels[k] == cs.stage.device
    # one logical device for both plan devices: one dispatch unit
    one = LogicalDevice(torch.device("cpu"))
    fused = build_executable(tg, p, [one, one])
    assert fused.num_units == 1 and exe.num_units == len(p.stages)
    torch.testing.assert_close(fused(*args), fn(*args))
    torch.testing.assert_close(exe.call_reference(*args), fn(*args))


def test_pipelined_runner_outputs_match(small_mlp):
    fn, (x, params) = small_mlp
    tg = analyze(fn, x, params)
    exe = build_executable(tg, planner.plan(tg.graph, DEVS, cache=False),
                           logical_devices(2, "cpu"))
    for sched in ("priority", "naive"):
        runner = PipelinedRunner(exe, max_inflight=3, scheduling=sched)
        outs, stats = runner.run([((x + i, params), {}) for i in range(5)])
        assert stats.completed == 5
        assert stats.stage_dispatches == 5 * exe.num_units
        for i, o in enumerate(outs):
            torch.testing.assert_close(o, fn(x + i, params), rtol=1e-5,
                                       atol=1e-6)


def test_straggler_reexecution_path(small_mlp):
    """A deadline of 0 sends every pure unit through the straggler path;
    the result must still be correct."""
    fn, (x, params) = small_mlp
    tg = analyze(fn, x, params)
    exe = build_executable(tg, planner.plan(tg.graph, DEVS, cache=False),
                           logical_devices(2, "cpu"))
    assert all(fs.pure for fs in exe.program.fused)
    runner = PipelinedRunner(exe, max_inflight=2, straggler_deadline=1e-9,
                             fallback_device=LogicalDevice(
                                 torch.device("cpu")))
    outs, stats = runner.run([((x, params), {})])
    assert stats.straggler_reexecs > 0
    torch.testing.assert_close(outs[0], fn(x, params), rtol=1e-5, atol=1e-6)


def test_straggler_path_never_reruns_an_in_place_write():
    """A unit that writes the caller's state runs exactly once, deadline
    or not (running it twice would apply the update twice)."""
    def step(s, x):
        s.add_(x)
        return s * 2.0

    s, x = torch.zeros(4), torch.ones(4)
    tg = analyze(step, s.clone(), x, state_argnums=(0,))
    exe = build_executable(tg, planner.plan(tg.graph, DEVS, cache=False),
                           logical_devices(2, "cpu"))
    runner = PipelinedRunner(exe, max_inflight=1, straggler_deadline=1e-9,
                             fallback_device=LogicalDevice(
                                 torch.device("cpu")))
    outs, _ = runner.run([((s, x), {})])
    torch.testing.assert_close(s, torch.ones(4))
    torch.testing.assert_close(outs[0], torch.full((4,), 2.0))


# --------------------------------------------------------------------- #
# The families' decode steps
# --------------------------------------------------------------------- #
B, T = 3, 40
STEPS = 4


def _family(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


ENC_LEN = 5                               # encdec: encoder frames
NPAT = 4                                  # vlm: patches of a 2 x 2 image


def _prefill_extras(cfg, rng, S):
    """The encoder input of an encdec prefill, or the patch embeddings and
    M-RoPE ids (image at (0, i // 2, i % 2), text from 2 on) of a vlm
    one, as numpy arrays; and a function of the decode positions giving
    a vlm step's ids (3, B, 1)."""
    if cfg.family == "encdec":
        enc = rng.standard_normal((B, ENC_LEN, cfg.d_model)) * 0.02
        return {"enc_embeds": enc.astype(np.float32)}, None
    if cfg.family == "vlm":
        patches = rng.standard_normal((B, NPAT, cfg.d_model)) * 0.02
        return ({"patch_embeds": patches.astype(np.float32),
                 "positions3": grid_positions3(B, S, NPAT, 2)},
                lambda pos: np.broadcast_to((pos - NPAT + 2)[None, :, None],
                                            (3, B, 1)).astype(np.int32))
    return {}, None


@pytest.mark.parametrize("arch", ["llama3_8b", "gpt_oss_20b", "rwkv6_3b",
                                  "zamba2_7b", "seamless_m4t_large_v2",
                                  "qwen2_vl_7b"])
def test_decode_step_disaggregated_matches_single_device_and_jax(arch):
    jcfg, tcfg, params, tparams = _family(arch)
    rng = np.random.default_rng(0)
    recurrent = tcfg.family in ("ssm", "hybrid")
    S = 9
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    last = np.full(B, S - 1, np.int32) if recurrent \
        else np.array([S - 1, 5, 2], np.int32)
    if tcfg.family == "vlm":
        last[2] += NPAT                   # every prompt ends past the image
    extras, ids_of = _prefill_extras(tcfg, rng, S)
    enc_len = ENC_LEN if tcfg.family == "encdec" else None
    jl, jc = jax.jit(functools.partial(JM.prefill, params, jcfg))(
        jnp.asarray(toks), JM.init_cache(jcfg, B, T, enc_len=enc_len),
        last_pos=jnp.asarray(last),
        **{k: jnp.asarray(v) for k, v in extras.items()})
    tc0 = TM.init_cache(tcfg, B, T, device="cpu", enc_len=enc_len)
    TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc0,
               last_pos=torch.from_numpy(last),
               **{k: torch.from_numpy(v) for k, v in extras.items()})

    tok = torch.from_numpy(np.asarray(jnp.argmax(jl, -1)).astype(np.int32))
    pos = torch.from_numpy(last + 1)

    def step(p, c, t, q, *p3, tagged=True):
        return TM.decode_step(p, tcfg, t, c, q, tagged=tagged,
                              positions3=p3[0] if p3 else None)

    def ids(pos):
        """The step's extra arguments: a vlm step's M-RoPE ids."""
        return () if ids_of is None else (torch.from_numpy(
            ids_of(pos.numpy())),)

    tg = analyze(step, tparams, copy.deepcopy(tc0), tok[:, None], pos,
                 *ids(pos), state_argnums=(1,))
    g = pin_nodes(tg.graph, tg.state_readers | tg.state_writers, 0)
    tg = tg.with_graph(g)
    caches = {"single": copy.deepcopy(tc0)}
    exes = {}
    for policy in ("latency", "throughput"):
        exes[policy] = build_executable(
            tg, planner.plan(g, DEVS, policy=policy, cache=False),
            logical_devices(2, "cpu"))
        assert exes[policy].num_units > 1
        caches[policy] = copy.deepcopy(tc0)
    ptrs = {k: [t.data_ptr() for t in torch.utils._pytree.tree_leaves(c)]
            for k, c in caches.items()}
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    for _ in range(STEPS):
        extra = ids(pos)
        jl, jc = jdecode(jnp.asarray(tok.numpy())[:, None], jc,
                         jnp.asarray(pos.numpy()),
                         **({"positions3": jnp.asarray(extra[0].numpy())}
                            if extra else {}))
        single, _ = step(tparams, caches["single"], tok[:, None], pos,
                         *extra, tagged=False)
        for policy, exe in exes.items():
            got, c = exe(tparams, caches[policy], tok[:, None], pos, *extra)
            assert all(a is b for a, b in zip(
                torch.utils._pytree.tree_leaves(c),
                torch.utils._pytree.tree_leaves(caches[policy])))
            torch.testing.assert_close(got, single, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          np.asarray(jnp.argmax(jl, -1)))
        tok = single.argmax(-1).to(torch.int32)
        pos = pos + 1
    for k, c in caches.items():
        assert [t.data_ptr() for t in torch.utils._pytree.tree_leaves(c)] \
            == ptrs[k], "a cache tensor was replaced, not written in place"
        for a, b in zip(torch.utils._pytree.tree_leaves(c),
                        torch.utils._pytree.tree_leaves(caches["single"])):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_engine_with_decode_fn_gives_the_same_greedy_tokens():
    cfg = dataclasses.replace(TC.get_smoke("gpt_oss_20b"), dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, generator=g, device="cpu")
    slots, max_len = 4, 40

    def step(p, c, t, q):
        return TM.decode_step(p, cfg, t, c, q, tagged=True)

    tg = analyze(step, params, TM.init_cache(cfg, slots, max_len,
                                             device="cpu"),
                 torch.zeros((slots, 1), dtype=torch.int32),
                 torch.zeros(slots, dtype=torch.int32), state_argnums=(1,))
    gp = pin_nodes(tg.graph, tg.state_readers | tg.state_writers, 0)
    exe = build_executable(tg.with_graph(gp),
                           planner.plan(gp, DEVS, cache=False),
                           logical_devices(2, "cpu"))

    def requests():
        rng = np.random.default_rng(5)
        return [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 3 + 2 * i).astype(np.int32),
            max_new_tokens=6, arrival=0.0) for i in range(6)]

    outs = []
    for decode_fn in (None, exe):
        engine = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                               decode_fn=decode_fn, sync_every=2,
                               device="cpu")
        engine.warmup()
        reqs = requests()
        stats = engine.run(reqs)
        assert stats.completed == len(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["gpt_oss_20b", "rwkv6_3b"])
def test_engine_with_prefill_fn_gives_the_same_greedy_tokens(arch):
    """An injected prefill (one request per admission at its exact
    length) serves the greedy tokens of the engine's own padded or
    length-grouped prefill."""
    cfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, generator=g, device="cpu")
    calls = []

    def prefill_fn(p, c, t):
        calls.append(tuple(t.shape))
        return TM.prefill(p, cfg, t, c)

    def requests():
        rng = np.random.default_rng(5)
        return [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 3 + 2 * (i % 3)).astype(np.int32),
            max_new_tokens=5, arrival=0.0) for i in range(6)]

    outs = []
    for fn in (None, prefill_fn):
        engine = ServingEngine(cfg, params, slots=4, max_len=40,
                               prefill_fn=fn, sync_every=2, device="cpu")
        engine.warmup()
        reqs = requests()
        assert engine.run(reqs).completed == len(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert sorted(calls) == sorted((1, len(r.prompt)) for r in requests())


def test_logical_devices_default_to_the_card():
    """Like every entry point of the port, ``logical_devices`` runs on
    CUDA unless the caller names another device, and raises without a
    card rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert all(ld.device.type == "cuda" and ld.stream is not None
                   for ld in logical_devices(2))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            logical_devices(2)
    lds = logical_devices(2, "cpu")
    assert [ld.device for ld in lds] == [torch.device("cpu")] * 2
    assert lds[0] is not lds[1] and lds[0].stream is None


def test_build_executable_takes_the_traced_device_or_raises(small_mlp):
    fn, args = small_mlp
    tg = analyze(fn, *args)
    p = planner.plan(tg.graph, DEVS, cache=False)
    exe = build_executable(tg, p)
    assert exe.num_units == 1
    assert exe.logical[0].device == torch.device("cpu")
    torch.testing.assert_close(exe(*args), fn(*args))
    for n in tg.fx_graph.nodes:
        n.meta.pop("val", None)
    with pytest.raises(ValueError, match="device_map"):
        build_executable(tg, p)
