"""The port's training path against the JAX package: ``forward_logits``,
``loss_fn`` and their gradients for all six families, ``_sdpa_chunked``
with its sliding-window slice, remat, the split between training (no
kernel op) and serving (the kernels' ops), the ``Trainer``'s losses,
``launch.train`` and the cell builders of ``launch/steps.py``.

Smoke configs at fp32 with JAX parameters from ``PRNGKey(0)`` carried
across by ``repro_torch.convert``; inputs made with numpy from a seed.
Logits and losses are held at atol = rtol = 1e-4 (the port's model
tolerance, as ``test_torch_model.py``), every gradient leaf at rtol 1e-4
and atol 1e-5 times the leaf's largest magnitude where that exceeds 1.
The scale is for rwkv6's bonus ``u``: its gradient reaches 10.6 and
sums terms of that size to entries of 4e-3, so fp32 resolves it to about
1e-5 only in the leaf's own units (against an fp64 run of the same math,
JAX's entries are 1.3e-5 off, the port's 2.4e-5).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.data.pipeline import TokenBatches  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JLy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import SHAPES  # noqa: E402
from repro.train import loop as JL  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as TLy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.tree import leaves_as  # noqa: E402
from _torch_parity import port_state  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
FAMILIES = {"dense": "qwen3_1_7b", "moe": "gpt_oss_20b", "ssm": "rwkv6_3b",
            "hybrid": "zamba2_7b", "encdec": "seamless_m4t_large_v2",
            "vlm": "qwen2_vl_7b"}
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _cfgs(arch, **kw):
    return (dataclasses.replace(JC.get_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(TC.get_smoke(arch), dtype="float32", **kw))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch)
    return JM.init_params(jcfg, jax.random.PRNGKey(0))


def _port_params(arch):
    return convert.params_from_jax(_np_tree(_jax_params(arch)), device="cpu")


def _inputs(cfg, B=2, S=8, seed=0):
    """tokens, targets and the family's extras, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["patch_embeds"] = (rng.standard_normal((B, 4, cfg.d_model))
                              * 0.02).astype(np.float32)
        kw["positions3"] = np.broadcast_to(
            np.arange(S)[None, None], (3, B, S)).astype(np.int32).copy()
    if cfg.family == "encdec":
        kw["enc_embeds"] = (rng.standard_normal((B, 5, cfg.d_model))
                            * 0.02).astype(np.float32)
    return toks, tgts, kw


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _assert_tree_close(port, ref, **tol):
    """Every leaf of the port's tree against the reference tree (JAX
    stacked leaves split per layer)."""
    ref = convert.params_from_jax(_np_tree(ref), device="cpu")
    got = pytree.tree_leaves(port)
    want = leaves_as(port, ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **tol)


def _assert_grads_close(port, ref):
    """GRAD_TOL, its atol in units of each leaf's largest magnitude when
    that exceeds 1 (see the module's docstring)."""
    ref = convert.params_from_jax(_np_tree(ref), device="cpu")
    got = pytree.tree_leaves(port)
    want = leaves_as(port, ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = b.numpy()
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * scale)


# --------------------------------------------------------------------- #
# forward_logits / loss_fn / gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_loss_and_grads_match_jax(family):
    arch = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch)
    toks, tgts, kw = _inputs(jcfg)
    jparams = _jax_params(arch)
    tparams = _port_params(arch)

    jlogits = JM.forward_logits(jparams, jcfg, jnp.asarray(toks), **_j(kw))
    tlogits = TM.forward_logits(tparams, tcfg, torch.from_numpy(toks),
                                **_t(kw))
    assert tlogits.shape == (2, 8, tcfg.padded_vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)

    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jnp.asarray(toks), jnp.asarray(tgts),
                             **_j(kw)))(jparams)
    tloss, tgrads = TL.value_and_grad(
        lambda p: TM.loss_fn(p, tcfg, torch.from_numpy(toks),
                             torch.from_numpy(tgts), **_t(kw)), tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _assert_grads_close(tgrads, jgrads)


def test_sliding_window_slice_matches_jax():
    """gpt-oss-20b's smoke config (window 16) over 1024 tokens: each of
    the two 512-query chunks attends over a 528-key slice."""
    arch = "gpt_oss_20b"
    jcfg, tcfg = _cfgs(arch)
    toks, tgts, _ = _inputs(jcfg, B=1, S=1024, seed=3)
    assert 1024 > jcfg.sliding_window + 512
    jlogits = JM.forward_logits(_jax_params(arch), jcfg, jnp.asarray(toks))
    tlogits = TM.forward_logits(_port_params(arch), tcfg,
                                torch.from_numpy(toks))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jloss = JM.loss_fn(_jax_params(arch), jcfg, jnp.asarray(toks),
                       jnp.asarray(tgts))
    tloss = TM.loss_fn(_port_params(arch), tcfg, torch.from_numpy(toks),
                       torch.from_numpy(tgts))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


@pytest.mark.parametrize("causal,window,chunk,Sq,Skv,q_offset", [
    (True, None, 8, 32, 32, 0),
    (True, 6, 8, 32, 32, 0),             # window slice: 32 > 6 + 8
    (True, 20, 8, 32, 32, 0),            # window, no slice: 32 <= 28 + 8
    (True, 5, 4, 16, 24, [8, 3]),        # per-row offsets over a longer cache
    (False, None, 8, 16, 40, 0),         # cross-attention shape
    (True, None, 64, 16, 16, 0),         # one chunk
])
def test_sdpa_chunked_matches_jax(causal, window, chunk, Sq, Skv, q_offset):
    rng = np.random.default_rng(1)
    B, H, Hkv, D = 2, 4, 2, 8
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    off = np.asarray(q_offset, np.int32)
    want = JLy._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=jnp.asarray(off),
                             window=window, chunk=chunk)
    got = TLy._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            q_offset=torch.from_numpy(off), window=window,
                            chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gives_the_same_loss_and_grads(family):
    """``remat=True`` recomputes each layer in the backward pass: the
    same loss and gradients (and the reference's remat loss)."""
    arch = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch)
    toks, tgts, kw = _inputs(jcfg, seed=5)
    tparams = _port_params(arch)

    def run(remat):
        return TL.value_and_grad(
            lambda p: TM.loss_fn(p, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(tgts), remat=remat,
                                 **_t(kw)), tparams)
    l0, g0 = run(False)
    l1, g1 = run(True)
    assert float(l1) == float(l0)
    for a, b in zip(pytree.tree_leaves(g1), pytree.tree_leaves(g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    jloss = JM.loss_fn(_jax_params(arch), jcfg, jnp.asarray(toks),
                       jnp.asarray(tgts), remat=True, **_j(kw))
    np.testing.assert_allclose(float(l1), float(jloss), **TOL)


# --------------------------------------------------------------------- #
# training reaches no kernel op; serving still does
# --------------------------------------------------------------------- #
class _OpRecorder(TorchDispatchMode):
    """Records every ``repro_torch::`` op call."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.ops.append(func.name())
        return func(*args, **(kwargs or {}))


SERVING_OPS = {"dense": {"flash_prefill"},
               "moe": {"flash_prefill", "gmm"},
               "ssm": {"wkv"},
               "hybrid": {"flash_prefill", "ssd"},
               "encdec": {"flash_prefill"},
               "vlm": {"flash_prefill"}}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_training_reaches_no_kernel_op(family):
    arch = FAMILIES[family]
    _, tcfg = _cfgs(arch)
    toks, tgts, kw = _inputs(tcfg, seed=2)
    params = _port_params(arch)
    leaves = [p.requires_grad_() for p in pytree.tree_leaves(params)]
    with _OpRecorder() as rec:
        loss = TM.loss_fn(params, tcfg, torch.from_numpy(toks),
                          torch.from_numpy(tgts), **_t(kw))
        loss.backward()
    assert rec.ops == []
    assert any(p.grad is not None for p in leaves)

    params = _port_params(arch)
    extra = _t(kw)
    enc_len = None
    if family == "encdec":
        enc_len = extra["enc_embeds"].shape[1]
    cache = TM.init_cache(tcfg, 2, 16, device="cpu", enc_len=enc_len)
    with _OpRecorder() as rec:
        TM.prefill(params, tcfg, torch.from_numpy(toks), cache, **extra)
    want = {f"repro_torch::{n}" for n in SERVING_OPS[family]}
    assert set(rec.ops) == want, rec.ops


# --------------------------------------------------------------------- #
# Trainer against the reference Trainer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,accum", [
    ("llama3_8b", 1), ("llama3_8b", 2), ("gpt_oss_20b", 1),
], ids=["dense", "dense_accum2", "moe"])
def test_trainer_losses_match_reference(arch, accum):
    """Six steps from the same converted state on the same TokenBatches
    log the reference Trainer's losses within 1e-4.  (Without
    compression: int8 rounding turns fp32 noise into whole quantization
    steps, which Adam's first updates amplify; the compression itself is
    held to the reference in ``test_torch_substrates.py``.)"""
    jcfg, tcfg = _cfgs(arch)
    steps = 6
    jocfg = JO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    tocfg = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    jt = JL.Trainer(jcfg, JL.TrainConfig(steps=steps, log_every=1,
                                         accum=accum), jocfg)
    tt = TL.Trainer(tcfg, TL.TrainConfig(steps=steps, log_every=1,
                                         accum=accum), tocfg, device="cpu")
    jstate = jt.init_state()
    batches = TokenBatches(jcfg.vocab_size, 4, 16, seed=1)
    tt.run(batches, state=port_state(jstate))
    jt.run(batches, state=jstate)
    want = [m["loss"] for m in jt.metrics]
    got = [m["loss"] for m in tt.metrics]
    assert [m["step"] for m in tt.metrics] == list(range(steps))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_launch_train_runs():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "5"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    losses = [float(ln.split("loss")[1].split()[0])
              for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all(), out.stdout


def test_launch_train_defaults_to_the_card():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])


# --------------------------------------------------------------------- #
# Cell builders
# --------------------------------------------------------------------- #
def _jax_shapes(tree):
    """{checkpoint key: (shape, dtype name)} of a JAX (abstract) tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(leaf.shape),
                                      np.dtype(leaf.dtype).name)
            for path, leaf in flat}


def _port_shapes(tree, prefix=""):
    """The same of a port tree, its per-layer lists stacked."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {kk: vv for k, v in tree.items()
                for kk, vv in _port_shapes(v, key(k)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {kk: vv for f, v in zip(tree._fields, tree)
                for kk, vv in _port_shapes(v, key(f".{f}")).items()}
    if isinstance(tree, list):
        parts = [_port_shapes(v, prefix) for v in tree]
        return {k: ((len(parts),) + s, d) for k, (s, d) in parts[0].items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[1])}


@functools.lru_cache(maxsize=None)
def _param_specs(arch):
    """(reference, port) parameter and optimizer-state shapes."""
    jp = jax.eval_shape(lambda: JM.init_params(JC.get(arch)))
    jopt = jax.eval_shape(lambda p: JO.init(JO.AdamWConfig(), p), jp)
    cell = TS.get_cell(arch, "train_4k")
    tp, topt, _ = TS.input_specs(cell)
    return ((_jax_shapes(jp), _jax_shapes(jopt)),
            (_port_shapes(tp), _port_shapes(topt)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cell_builders_match_reference(arch, shape):
    assert TS.cell_is_defined(arch, shape) == JS.cell_is_defined(arch, shape)
    jcell, tcell = JS.get_cell(arch, shape), TS.get_cell(arch, shape)
    assert (tcell.step_kind, tcell.extras) == (jcell.step_kind, jcell.extras)
    assert _port_shapes(TS.batch_specs(tcell)) == \
        _jax_shapes(JS.batch_specs(jcell))
    (jp, jopt), (tp, topt) = _param_specs(arch)
    assert tp == jp
    if jcell.step_kind == "train":
        assert topt == jopt
    else:
        # the cache of a prefill / decode cell
        jspec = JS.input_specs(jcell)
        tspec = TS.input_specs(tcell)
        assert _port_shapes(tspec[1]) == _jax_shapes(jspec[1])
        assert all(t.device.type == "meta"
                   for t in pytree.tree_leaves(tspec))


@pytest.mark.parametrize("family", ["dense", "encdec", "vlm"])
def test_make_train_step_matches_reference(family):
    """One step of the cell builder's train step (remat on) from equal
    parameters and optimizer state: the same loss and new parameters.
    Adam's first update moves each parameter by lr * g / (|g| + eps);
    with the default eps (1e-8) a gradient at fp32's noise floor moves
    its parameter by a share of lr that the noise decides, so this step
    takes eps 1e-3 (the arithmetic at the default eps is held to the
    reference on equal gradients in ``test_torch_substrates.py``)."""
    arch = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch)
    toks, tgts, kw = _inputs(jcfg, seed=7)
    ocfg = dict(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=10)
    jp = _jax_params(arch)
    jopt = JO.init(JO.AdamWConfig(**ocfg), jp)
    tstate = port_state({"params": jp, "opt": jopt})
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
              **_j(kw)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "targets": torch.from_numpy(tgts), **_t(kw)}
    jnew, jnopt, jloss = JS.make_train_step(jcfg, JO.AdamWConfig(**ocfg))(
        jp, jopt, jbatch)
    tnew, tnopt, tloss = TS.make_train_step(tcfg, TO.AdamWConfig(**ocfg))(
        tstate["params"], tstate["opt"], tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert int(tnopt.step) == int(jnopt.step) == 1
    _assert_tree_close(tnew, jnew, atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_builders_match_reference(family):
    arch = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch)
    toks, _, kw = _inputs(jcfg, seed=9)
    B, S, T = 2, 8, 12
    enc_len = 5 if family == "encdec" else None
    jl, jc = JS.make_prefill_step(jcfg)(
        _jax_params(arch), JM.init_cache(jcfg, B, T, enc_len=enc_len),
        {"tokens": jnp.asarray(toks), **_j(kw)})
    tparams = _port_params(arch)
    tl, tc = TS.make_prefill_step(tcfg)(
        tparams, TM.init_cache(tcfg, B, T, device="cpu", enc_len=enc_len),
        {"tokens": torch.from_numpy(toks), **_t(kw)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    dec = {"tokens": tok, "pos": pos}
    if family == "vlm":
        dec["positions3"] = np.full((3, B, 1), S, np.int32)
    jl, _ = JS.make_decode_step(jcfg)(_jax_params(arch), jc, _j(dec))
    tl, _ = TS.make_decode_step(tcfg)(tparams, tc, _t(dec))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
