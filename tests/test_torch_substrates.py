"""The port's training substrates against the JAX package: the data
pipeline, AdamW, gradient compression and checkpoints (readable across
the two packages in both directions), and the Trainer's crash and
resume, gradient accumulation and learning — the port's counterpart of
``tests/test_substrates.py`` (its training half).

Everything runs on the CPU at smoke sizes; inputs are made with numpy
from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # collect without hypothesis (tier-1 guard)
    from _hypothesis_stub import given, settings, strategies as st

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.checkpoint import manager as JCK  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import compress as JCP  # noqa: E402
from repro.train import loop as JL  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, TokenBatches  # noqa: E402
from repro_torch.train import compress as TCP  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train.compress import CompressionConfig  # noqa: E402
from repro_torch.train.loop import (SimulatedFailure, TrainConfig,  # noqa: E402
                                    Trainer)
from repro_torch.tree import leaves_as  # noqa: E402
from _torch_parity import port_state  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(tree):
    return convert.params_from_jax(_np_tree(tree), device="cpu")


def _assert_same(port, ref, **tol):
    """Every leaf of a port tree against a JAX tree of its structure (the
    JAX stacked leaves split per layer); exact without ``tol``."""
    got = pytree.tree_leaves(port)
    want = leaves_as(port, _to_port(ref))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if tol:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       **tol)
        else:
            assert torch.equal(a, b)


# ===================================================================== #
# Data pipeline
# ===================================================================== #
@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (128, 4, 16, 7), (1024, 2, 33, 0), (151936, 1, 8, 3)])
def test_batches_equal_the_reference(vocab, batch, seq, seed):
    ours = TokenBatches(vocab, batch, seq, seed=seed)
    ref = JD.TokenBatches(vocab, batch, seq, seed=seed)
    for step in (0, 1, 5, 123):
        a, b = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_batches_deterministic_random_access():
    tb = TokenBatches(vocab_size=128, batch=4, seq_len=16, seed=7)
    b1, b2, b3 = tb.batch_at(5), tb.batch_at(5), tb.batch_at(6)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:],
                                  b1["targets"][:, :-1])


def test_prefetcher_preserves_order():
    tb = TokenBatches(vocab_size=64, batch=2, seq_len=8)
    got = list(Prefetcher(iter([tb.batch_at(i) for i in range(5)]),
                          depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], tb.batch_at(i)["tokens"])


# ===================================================================== #
# AdamW
# ===================================================================== #
@pytest.mark.parametrize("step", [0, 1, 2, 50, 99, 100, 101, 5000, 10_000,
                                  12_000])
def test_schedule_matches_reference(step):
    for kw in ({}, {"warmup_steps": 0, "total_steps": 7, "lr": 1e-2}):
        want = JO.schedule(JO.AdamWConfig(**kw), jnp.float32(step))
        got = TO.schedule(TO.AdamWConfig(**kw), torch.tensor(float(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)


def _random_like(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * scale)
                              .astype(np.float32)).astype(a.dtype), tree)


@pytest.mark.parametrize("arch,dtype,clip,master", [
    ("llama3_8b", "float32", 1.0, True),       # clipping active
    ("llama3_8b", "float32", 1e6, True),       # clipping inactive
    ("llama3_8b", "float32", 0.0, False),      # no clip, no master copy
    ("gpt_oss_20b", "bfloat16", 1.0, True),    # bf16 params, fp32 router
])
def test_adamw_apply_matches_reference(arch, dtype, clip, master):
    """One ``apply`` on equal gradients and equal state (at step 3 of
    the schedule, moments nonzero) gives equal parameters, moments,
    master weights and step."""
    cfg = dataclasses.replace(JC.get_smoke(arch), dtype=dtype)
    rng = np.random.default_rng(0)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    kw = dict(grad_clip=clip, master_fp32=master, warmup_steps=2,
              total_steps=20, lr=1e-2)
    jcfg, tcfg = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    state = JO.init(jcfg, params)
    f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    state = JO.AdamWState(
        step=jnp.int32(3), mu=_random_like(f32, rng, 1e-2),
        nu=jax.tree_util.tree_map(jnp.abs, _random_like(f32, rng, 1e-3)),
        master=_random_like(f32, rng, 1.0) if master else None)
    grads = _random_like(params, rng, 0.1)
    gnorm = float(JO.global_norm(grads))
    if clip > 0:
        assert (gnorm > clip) == (clip == 1.0)

    tstate = port_state({"params": params, "opt": state, "residual": f32})
    tparams, topt = TO.apply(tcfg, _to_port(grads), tstate["opt"],
                             tstate["params"])
    jparams, jopt = JO.apply(jcfg, grads, state, params)
    assert int(topt.step) == int(jopt.step) == 4
    assert topt.step.dtype == torch.int32
    _assert_same(topt.mu, jopt.mu, atol=1e-6, rtol=0)
    _assert_same(topt.nu, jopt.nu, atol=1e-6, rtol=0)
    if master:
        _assert_same(topt.master, jopt.master, atol=1e-6, rtol=0)
        # each parameter is its master weight in its own dtype
        for p, m in zip(pytree.tree_leaves(tparams),
                        leaves_as(tparams, topt.master)):
            assert torch.equal(p, m.to(p.dtype))
    else:
        assert topt.master is None
    if dtype == "float32":
        _assert_same(tparams, jparams, atol=1e-6, rtol=0)
    if arch == "gpt_oss_20b":
        assert tparams["layers"][0]["moe"]["router"].dtype == torch.float32
        assert tparams["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16


def test_adamw_init_matches_reference_and_copies_fp32_params():
    cfg = dataclasses.replace(JC.get_smoke("llama3_8b"), dtype="float32")
    params = _to_port(JM.init_params(cfg, jax.random.PRNGKey(0)))
    opt = TO.init(TO.AdamWConfig(), params)
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    for p, m, mu in zip(pytree.tree_leaves(params),
                        leaves_as(params, opt.master),
                        leaves_as(params, opt.mu)):
        assert torch.equal(p, m) and p.data_ptr() != m.data_ptr()
        assert mu.dtype == torch.float32 and not mu.any()


# ===================================================================== #
# Gradient compression
# ===================================================================== #
def test_int8_matches_reference():
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e-4, 3e3):
        x = (rng.standard_normal(4096) * scale).astype(np.float32)
        jq, js = JCP.quantize_int8(jnp.asarray(x))
        tq, ts = TCP.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
        np.testing.assert_allclose(TCP.dequantize_int8(tq, ts).numpy(),
                                   np.asarray(JCP.dequantize_int8(jq, js)),
                                   rtol=1e-7, atol=0)


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    q, s = TCP.quantize_int8(x)
    y = TCP.dequantize_int8(q, s)
    assert float((x - y).abs().max()) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("ratio", [0.05, 0.25, 0.5])
def test_topk_matches_reference(ratio):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 33)).astype(np.float32)
    jv, ji = JCP.topk_sparsify(jnp.asarray(x), ratio)
    tv, ti = TCP.topk_sparsify(torch.from_numpy(x), ratio)
    np.testing.assert_array_equal(
        TCP.topk_densify(tv, ti, x.shape).numpy(),
        np.asarray(JCP.topk_densify(jv, ji, x.shape)))


def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    vals, idx = TCP.topk_sparsify(x, ratio=0.4)
    np.testing.assert_allclose(TCP.topk_densify(vals, idx, x.shape).numpy(),
                               [0.0, -5.0, 0.0, 3.0, 0.0])


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compress_decompress_and_wire_bytes_match_reference(scheme):
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal(64).astype(np.float32),
         "b": {"c": rng.standard_normal((4, 8)).astype(np.float32)}}
    r = {"a": rng.standard_normal(64).astype(np.float32) * 0.1,
         "b": {"c": rng.standard_normal((4, 8)).astype(np.float32) * 0.1}}
    jcfg = JCP.CompressionConfig(scheme, topk_ratio=0.25)
    tcfg = CompressionConfig(scheme, topk_ratio=0.25)
    jy, jr = JCP.compress_decompress(jcfg, jax.tree_util.tree_map(
        jnp.asarray, g), jax.tree_util.tree_map(jnp.asarray, r))
    ty, tr = TCP.compress_decompress(tcfg, convert.tree_to_torch(g, "cpu"),
                                     convert.tree_to_torch(r, "cpu"))
    _assert_same(ty, jy, atol=1e-7, rtol=1e-6)
    _assert_same(tr, jr, atol=1e-7, rtol=1e-6)
    assert TCP.wire_bytes(tcfg, ty) == JCP.wire_bytes(
        jcfg, jax.tree_util.tree_map(jnp.asarray, g))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000),
       scheme=st.sampled_from(["int8", "topk"]))
def test_property_error_feedback_conserves_mass(seed, scheme):
    """EF invariant: decompressed + new_residual == grads + old_residual."""
    rng = np.random.default_rng(seed)
    g = {"a": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((4, 8))
                               .astype(np.float32))}
    r = TCP.init_residual(g)
    y, r2 = TCP.compress_decompress(
        CompressionConfig(scheme=scheme, topk_ratio=0.25), g, r)
    for k in g:
        np.testing.assert_allclose((y[k] + r2[k]).numpy(),
                                   (g[k] + r[k]).numpy(), rtol=1e-5,
                                   atol=1e-5)


# ===================================================================== #
# Checkpointing
# ===================================================================== #
def test_checkpoint_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"w": torch.arange(8, dtype=torch.bfloat16) * 0.5,
             "m": {"v": torch.ones((3, 3)) * 3},
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr.save(10, state)
    step, restored = mgr.restore(state)
    assert step == 10
    for k in ("w", "step"):
        assert restored[k].dtype == state[k].dtype
        assert torch.equal(restored[k], state[k])
    assert torch.equal(restored["m"]["v"], state["m"]["v"])


def test_checkpoint_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(2)})
    assert mgr.steps() == [3, 4]


def test_checkpoint_ignores_partial_writes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"a": torch.zeros(2)})
    (tmp_path / "step_00000002.tmp").mkdir()
    assert mgr.latest_step() == 1


def test_checkpoint_async_copies_before_returning(tmp_path):
    """``save_async`` snapshots the state before it returns: an in-place
    change after the call is not in the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    state = {"a": torch.ones(4)}
    mgr.save_async(5, state)
    state["a"].add_(1)
    mgr.wait()
    assert mgr.latest_step() == 5
    _, restored = mgr.restore({"a": torch.zeros(4)})
    assert torch.equal(restored["a"], torch.ones(4))


def _trainer_states(arch="gpt_oss_20b"):
    """A bf16 JAX Trainer state (fp32 router, master, moments, residual)
    moved off its init, and the port's conversion of it."""
    cfg = JC.get_smoke(arch)
    assert cfg.dtype == "bfloat16"
    jt = JL.Trainer(cfg, JL.TrainConfig(steps=2, log_every=1))
    jstate = jt.run(TokenBatches(cfg.vocab_size, 2, 8))
    jstate.pop("last_step")
    return cfg, jt, jstate, port_state(jstate)


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    cfg, jt, jstate, want = _trainer_states()
    JCK.CheckpointManager(tmp_path).save(2, jstate)
    tt = Trainer(TC.get_smoke("gpt_oss_20b"), TrainConfig(steps=2),
                 device="cpu")
    step, got = CheckpointManager(tmp_path).restore(tt.init_state())
    assert step == 2
    assert got["params"]["layers"][0]["moe"]["router"].dtype == torch.float32
    for a, b in zip(pytree.tree_leaves(got), leaves_as(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b)     # bf16 bitwise


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    cfg, jt, jstate, state = _trainer_states()
    CheckpointManager(tmp_path).save(2, state)
    # the same keys and dtype tags as the reference's own writer
    ref_dir = tmp_path / "ref"
    JCK.CheckpointManager(ref_dir).save(2, jstate)
    ours = np.load(tmp_path / "step_00000002" / "arrays.npz")
    theirs = np.load(ref_dir / "step_00000002" / "arrays.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    assert "opt/.mu/embed/tok" in ours.files and "opt/.step" in ours.files
    for k in theirs.files:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    step, got = JCK.CheckpointManager(tmp_path).restore(jt.init_state())
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ===================================================================== #
# Train loop + fault tolerance
# ===================================================================== #
def _tiny_trainer(tmp_path, steps=12, **kw):
    cfg = dataclasses.replace(TC.get_smoke("llama3_8b"), dtype="float32")
    tcfg = TrainConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp_path),
                       log_every=1, **kw)
    ocfg = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    return (Trainer(cfg, tcfg, ocfg, device="cpu"),
            TokenBatches(cfg.vocab_size, 2, 16))


def test_crash_restart_resumes_identically(tmp_path):
    """Train 12 steps straight vs crash-at-8 + resume: identical params."""
    trainer, batches = _tiny_trainer(tmp_path / "a")
    final = trainer.run(batches)

    trainer2, batches2 = _tiny_trainer(tmp_path / "b")
    with pytest.raises(SimulatedFailure):
        trainer2.run(batches2, fail_at=8)
    trainer3, _ = _tiny_trainer(tmp_path / "b")        # a fresh process
    resumed = trainer3.resume(batches2)
    for a, b in zip(pytree.tree_leaves(final["params"]),
                    pytree.tree_leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_loss_decreases_on_learnable_data(tmp_path):
    trainer, batches = _tiny_trainer(tmp_path, steps=40)
    trainer.run(batches)
    losses = [m["loss"] for m in trainer.metrics]
    assert losses[-1] < losses[0] - 0.05, losses


def test_grad_accumulation_matches_full_batch():
    cfg = dataclasses.replace(TC.get_smoke("llama3_8b"), dtype="float32")
    batches = TokenBatches(cfg.vocab_size, 4, 16)
    t1 = Trainer(cfg, TrainConfig(steps=3, log_every=1), device="cpu")
    t2 = Trainer(cfg, TrainConfig(steps=3, log_every=1, accum=2),
                 device="cpu")
    s1, s2 = t1.run(batches), t2.run(batches)
    for a, b in zip(pytree.tree_leaves(s1["params"]),
                    pytree.tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_training_still_learns(tmp_path, scheme):
    trainer, batches = _tiny_trainer(
        tmp_path, steps=40, compression=CompressionConfig(scheme))
    trainer.run(batches)
    losses = [m["loss"] for m in trainer.metrics]
    assert losses[-1] < losses[0] - 0.05, losses


def test_reference_trainer_cannot_run_topk():
    """A fault of the reference the port does not reproduce: its jitted
    train step cannot trace ``topk_densify`` (``int()`` of a traced
    ``jnp.prod``), so ``CompressionConfig("topk")`` training raises; the
    port's Trainer trains with it (above)."""
    cfg = dataclasses.replace(JC.get_smoke("llama3_8b"), dtype="float32")
    jt = JL.Trainer(cfg, JL.TrainConfig(
        steps=1, compression=JCP.CompressionConfig("topk")))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jt.run(JD.TokenBatches(cfg.vocab_size, 2, 8))
