"""The port's vlm family (qwen2-vl-7b's language model) against the JAX
model: M-RoPE, the patch-embedding splice, prefill and decode.

The smoke configuration with ``mrope_sections=(4, 2, 2)`` and 4 patch
embeddings, fp32 on the CPU, parameters initialised in JAX and carried
across by ``repro_torch.convert``.  Position ids are laid out as
Qwen2-VL's ``get_rope_index`` lays out one image followed by text: the
image's 2 x 2 patches at (t, h, w) = (0, i // 2, i % 2), then the text
from max + 1 = 2 onwards on all three axes, so a text token in cache
slot p rotates at p - 2 (slot and angle differ).  Without ``positions3``
the model falls back to 1-D RoPE over the positions, as the reference.
Logits at atol = rtol = 1e-4, greedy tokens identical.
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from _torch_parity import grid_positions3  # noqa: E402

ARCH = "qwen2_vl_7b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 9, 6
NPAT, SIDE = 4, 2                  # a 2 x 2 image


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), dtype="float32",
                               num_patches=NPAT)
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), dtype="float32",
                               num_patches=NPAT)
    assert jcfg.mrope_sections == (4, 2, 2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("sections,D", [((4, 2, 2), 16),
                                        ((16, 24, 24), 128)])
def test_mrope_tables_match_jax_apply_mrope(sections, D):
    """``apply_rope(x, mrope_tables(...))`` against JAX ``apply_mrope``
    on ids that differ on the three axes (qwen2-vl-7b's sections and the
    smoke's), and against plain RoPE when the three axes agree."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 300, 3, D)).astype(np.float32)
    p3 = grid_positions3(2, 300, 256, 16)
    p3[1, 1] += 7                                   # rows differ
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, sections)
    tabs = TL.mrope_tables(torch.from_numpy(p3), D, 1e6, sections)
    assert tabs[0].shape == (2, 300, 1, D // 2)
    got = TL.apply_rope(torch.from_numpy(x), tabs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    flat = np.broadcast_to(np.arange(300, dtype=np.int32), (3, 2, 300))
    same = TL.mrope_tables(torch.from_numpy(flat.copy()), D, 1e6, sections)
    one_d = TL.rope_tables(torch.from_numpy(flat[0].copy()), D, 1e6)
    for a, b in zip(same, one_d):
        assert torch.equal(a, b)


def _run(model, with_positions3: bool):
    """Prefill of right-padded rows with the patches spliced in, then
    greedy decode steps, in JAX and in the port: logits and tokens."""
    jcfg, tcfg, params, tparams = model
    rng = np.random.default_rng(3)
    max_len = S + STEPS + 1
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, NPAT, jcfg.d_model)) * 0.02) \
        .astype(np.float32)
    last = np.array([S - 1, 6], np.int32)
    p3 = grid_positions3(B, max_len, NPAT, SIDE)
    pre = dict(patch_embeds=patches)
    if with_positions3:
        pre["positions3"] = p3[:, :, :S]
    jl, jc = jax.jit(functools.partial(JM.prefill, params, jcfg))(
        jnp.asarray(toks), JM.init_cache(jcfg, B, max_len),
        last_pos=jnp.asarray(last),
        **{k: jnp.asarray(v) for k, v in pre.items()})
    tc = TM.init_cache(tcfg, B, max_len, device="cpu")
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                        last_pos=torch.from_numpy(last),
                        **{k: torch.from_numpy(v) for k, v in pre.items()})
    out = [(tl.numpy(), np.asarray(jl))]
    jdecode = jax.jit(functools.partial(JM.decode_step, params, jcfg))
    pos = last + 1
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok[:, 0])
        dk = {}
        if with_positions3:
            # this token's ids: slot pos rotates at pos - NPAT + SIDE
            dk["positions3"] = np.take_along_axis(
                p3, np.broadcast_to(pos[None, :, None], (3, B, 1)), axis=2)
            assert (dk["positions3"] == (pos - NPAT + SIDE)[None, :, None]) \
                .all()
        jl, jc = jdecode(jnp.asarray(tok), jc, jnp.asarray(pos),
                         **{k: jnp.asarray(v) for k, v in dk.items()})
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos),
                                **{k: torch.from_numpy(v)
                                   for k, v in dk.items()})
        out.append((tl.numpy(), np.asarray(jl)))
        pos = pos + 1
    for c in ("k", "v"):
        np.testing.assert_allclose(tc["kv"][c].numpy(),
                                   np.asarray(jc["kv"][c]), **TOL)
    return out


@pytest.mark.parametrize("with_positions3", [True, False])
def test_prefill_and_decode_match_jax(model, with_positions3):
    out = _run(model, with_positions3)
    for got, want in out:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_positions3_move_the_angle_not_the_slot(model):
    """The grid ids change the angle and leave the cache's slot layout
    alone: the fallback run and the M-RoPE run fill the same slots of the
    first layer with the same values (V carries no rotation) and with
    keys rotated differently."""
    a, b = _run(model, True), _run(model, False)
    assert not np.allclose(a[0][0], b[0][0], atol=1e-3)
    _, tcfg, _, tparams = model
    toks = torch.arange(1, S + 1, dtype=torch.int32)[None]
    caches = []
    for p3 in (None, torch.from_numpy(grid_positions3(1, S, NPAT, SIDE))):
        c = TM.init_cache(tcfg, 1, S + 3, device="cpu")
        TM.prefill(tparams, tcfg, toks, c, positions3=p3)
        assert not c["kv"]["k"][:, :, S:].any()
        caches.append(c["kv"])
    assert torch.equal(caches[0]["v"][0], caches[1]["v"][0])
    assert not torch.allclose(caches[0]["k"][0, :, 1:],
                              caches[1]["k"][0, :, 1:], atol=1e-3)


def test_vlm_prefill_refuses_a_chunk_offset(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError, match="chunked prefill"):
        TM.prefill(tparams, tcfg, torch.zeros((1, 4), dtype=torch.int32),
                   TM.init_cache(tcfg, 1, 8, device="cpu"), offset=0)
