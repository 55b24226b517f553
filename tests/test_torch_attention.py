"""The port's plain prefill and decode attention (the CPU side of K1/K2)
against three JAX references, at fp32 with atol = rtol = 1e-5:

  * ``attention_ref`` / ``decode_ref`` (the Pallas kernels' oracles),
  * the Pallas kernels ``flash_attention_prefill`` /
    ``flash_attention_decode`` in interpret mode, after a transpose to
    their (B, H, S, D) layout,
  * the model's own ``layers._sdpa_chunked`` in the model's layout.

Inputs come from a numpy seed.  The Pallas prefill aligns its causal
mask top-left and ``attention_ref`` bottom-right; both agree with the
model only when Sq == Skv, so the q_offset > 0 cases compare against
``_sdpa_chunked`` alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_decode, flash_attention_prefill)
from repro.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref, decode_ref)
from repro.models.layers import _sdpa_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S", [8, 13, 37])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)])
def test_prefill_matches_jax_references(H, Hkv, S):
    rng = np.random.default_rng(1000 * H + 10 * Hkv + S)
    B, D = 2, 16
    q, k, v = _randn(rng, B, S, H, D), _randn(rng, B, S, Hkv, D), \
        _randn(rng, B, S, Hkv, D)
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v)).numpy()
    # model layout (B, S, H, D)
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=0, window=None, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    # kernel layout (B, H, S, D)
    qt, kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    for want in (attention_ref(qt, kt, vt, causal=True),
                 flash_attention_prefill(qt, kt, vt, causal=True,
                                         interpret=True)):
        np.testing.assert_allclose(
            got, np.asarray(want).transpose(0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("Sq,Skv", [(8, 8), (5, 12), (12, 5), (37, 40)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_non_causal_prefill_matches_jax_references(H, Hkv, Sq, Skv):
    """K2's non-causal mode (an encoder, cross-attention): every query
    sees all Skv keys, against the model's ``_sdpa_chunked(causal=False)``
    and the jitted Pallas ``flash_attention(causal=False)`` in interpret
    mode, which agree when no causal mask applies."""
    rng = np.random.default_rng(1000 * Sq + 10 * Skv + H)
    B, D = 2, 16
    q, k, v = _randn(rng, B, Sq, H, D), _randn(rng, B, Skv, Hkv, D), \
        _randn(rng, B, Skv, Hkv, D)
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, q_offset=0, window=None, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    qt, kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    pallas = flash_attention(qt, kt, vt, causal=False, interpret=True)
    np.testing.assert_allclose(
        got, np.asarray(pallas).transpose(0, 2, 1, 3), **TOL)
    # through the op, on the CPU: the plain version, with the flag kept
    assert torch.equal(ops.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False), torch.from_numpy(got))


def test_non_causal_kernel_call_refuses_offset_and_window():
    """K2 runs non-causal only at q_offset 0 and without a window (no
    model sets either there): the wrapper raises before it looks for the
    card, as it does for every call it does not take."""
    q = torch.zeros(1, 4, 2, 64)
    for kw in (dict(q_offset=3), dict(window=8)):
        with pytest.raises(ValueError, match="non-causal"):
            kernel.flash_prefill(q, q, q, causal=False, **kw)


@pytest.mark.parametrize("Sq,Skv", [(5, 12), (9, 40), (1, 7)])
def test_prefill_q_offset_matches_model(Sq, Skv):
    """Chunked-prefill alignment: query i sits at Skv - Sq + i."""
    rng = np.random.default_rng(Sq * 100 + Skv)
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v = _randn(rng, B, Sq, H, D), _randn(rng, B, Skv, Hkv, D), \
        _randn(rng, B, Skv, Hkv, D)
    off = Skv - Sq
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), q_offset=off).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=off, window=None, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)


@pytest.mark.parametrize("lengths", [[1, 17, 64], [64, 3, 40]])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)])
def test_decode_matches_jax_references(H, Hkv, lengths):
    rng = np.random.default_rng(H * 10 + Hkv + sum(lengths))
    B, T, D = len(lengths), 64, 16
    q, k, v = _randn(rng, B, H, D), _randn(rng, B, T, Hkv, D), \
        _randn(rng, B, T, Hkv, D)
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lens)).numpy()
    # the model's decode: one query at position pos = length - 1
    model = _sdpa_chunked(jnp.asarray(q)[:, None], jnp.asarray(k),
                          jnp.asarray(v), causal=True,
                          q_offset=jnp.asarray(lens - 1), window=None,
                          chunk=512)[:, 0]
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v))
    for want in (decode_ref(jnp.asarray(q), kt, vt, jnp.asarray(lens)),
                 flash_attention_decode(jnp.asarray(q), kt, vt,
                                        jnp.asarray(lens), block_k=16,
                                        interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_ops_dispatch_cpu_to_plain_version():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_randn(rng, 2, 9, 4, 16)),
               torch.from_numpy(_randn(rng, 2, 9, 2, 16)),
               torch.from_numpy(_randn(rng, 2, 9, 2, 16)))
    before = dict(kernel.LAUNCHES)
    assert torch.equal(ops.prefill_attention(q, k, v),
                       ref.prefill_attention(q, k, v))
    lens = torch.tensor([3, 9], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, 0], k, v, lens),
                       ref.decode_attention(q[:, 0], k, v, lens))
    assert kernel.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes on its own: off the card it
    raises instead of falling back to the plain version."""
    q = torch.zeros(1, 4, 128)
    kv = torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_decode(q, kv, kv, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_prefill(q[:, None], kv, kv)
    assert kernel._LIBS == {}


@pytest.mark.parametrize("S,window", [(13, 4), (37, 16), (40, 1)])
@pytest.mark.parametrize("D", [16, 64])
def test_windowed_prefill_matches_jax(D, S, window):
    """Sliding-window prefill: a query at p sees keys in (p - window, p],
    against the model's ``_sdpa_chunked(window=)`` and the Pallas prefill
    with ``window`` in interpret mode."""
    rng = np.random.default_rng(S * 100 + window + D)
    B, H, Hkv = 2, 8, 2
    q, k, v = _randn(rng, B, S, H, D), _randn(rng, B, S, Hkv, D), \
        _randn(rng, B, S, Hkv, D)
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=0, window=window, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    qt, kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    pallas = flash_attention_prefill(qt, kt, vt, causal=True, window=window,
                                     interpret=True)
    np.testing.assert_allclose(
        got, np.asarray(pallas).transpose(0, 2, 1, 3), **TOL)
    # a window as long as the prompt masks nothing
    full = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window=S)
    assert torch.equal(full, ref.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)))


@pytest.mark.parametrize("lengths", [[1, 40, 64], [64, 64, 9]])
def test_decode_head_dim_64_rep_8_matches_jax(lengths):
    """gpt-oss-20b's attention shape: head_dim 64, 8 query heads per KV
    head, over a full ring buffer (length = capacity) and ragged rows."""
    rng = np.random.default_rng(sum(lengths))
    B, T, H, Hkv, D = len(lengths), 64, 16, 2, 64
    q, k, v = _randn(rng, B, H, D), _randn(rng, B, T, Hkv, D), \
        _randn(rng, B, T, Hkv, D)
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lens)).numpy()
    # the model's ring-buffer decode: non-causal over kv_valid_len slots
    model = _sdpa_chunked(jnp.asarray(q)[:, None], jnp.asarray(k),
                          jnp.asarray(v), causal=False, q_offset=0,
                          window=None, chunk=512,
                          kv_valid_len=jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v))
    pallas = flash_attention_decode(jnp.asarray(q), kt, vt,
                                    jnp.asarray(lens), block_k=16,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)



# K1's split planning at the main-path attention shapes (H, Hkv), B 4:
# llama3-8b, gpt-oss-20b, zamba2-7b, gemma-2b (4 (row, KV head) pairs)
DECODE_SHAPES = {"llama3-8b": (32, 8), "gpt-oss-20b": (64, 8),
                 "zamba2-7b": (32, 32), "gemma-2b": (8, 1)}


@pytest.mark.parametrize("T", [1, 63, 64, 1000, 1024])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_splits_hold_whole_tiles_and_cover_the_cache(shape, T):
    """The split count is a pure function of (B, Hkv, T, SM count): it
    never exceeds T's tile count (nor MAX_SPLIT), and for every valid
    length up to T the splits the kernel deals out hold whole tiles (a
    ragged end only at the row's last token) and cover [0, length)
    without overlap."""
    H, Hkv = DECODE_SHAPES[shape]
    tiles = -(-T // kernel.DECODE_TILE)
    for sms in (1, 66, 132, 10_000):
        nsplit = kernel.decode_splits(4, Hkv, T, sms)
        assert nsplit == kernel.decode_splits(4, Hkv, T, sms)
        assert 1 <= nsplit <= min(tiles, kernel.MAX_SPLIT)
        for length in sorted({1, (T + 1) // 2, T}):
            bounds = kernel.split_bounds(length, nsplit)
            assert len(bounds) == nsplit
            covered = 0
            for begin, end in bounds:
                if begin >= length:             # an empty split
                    assert end <= begin
                    continue
                assert begin == covered and begin % kernel.DECODE_TILE == 0
                assert (end - begin) % kernel.DECODE_TILE == 0 \
                    or end == length
                covered = end
            assert covered == length


# --------------------------------------------------------------------- #
# head_dim 256 at rep 8 over one KV head: gemma-2b's attention shape,
# the widest K1 and K2 take
# --------------------------------------------------------------------- #
GEMMA_B, GEMMA_H, GEMMA_HKV, GEMMA_D = 2, 8, 1, 256


def _gemma_prefill_inputs(seed, Sq, Skv):
    rng = np.random.default_rng(seed)
    return (_randn(rng, GEMMA_B, Sq, GEMMA_H, GEMMA_D),
            _randn(rng, GEMMA_B, Skv, GEMMA_HKV, GEMMA_D),
            _randn(rng, GEMMA_B, Skv, GEMMA_HKV, GEMMA_D))


@pytest.mark.parametrize("S,window", [(8, None), (37, None), (13, 4),
                                      (37, 16)])
def test_prefill_head_dim_256_rep_8_matches_jax(S, window):
    """Causal, with and without a sliding window, against
    ``_sdpa_chunked``, the Pallas prefill in interpret mode and (no
    window) ``attention_ref``."""
    q, k, v = _gemma_prefill_inputs(S * 10 + (window or 0), S, S)
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=0, window=window, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    qt, kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    wants = [flash_attention_prefill(qt, kt, vt, causal=True, window=window,
                                     interpret=True)]
    if window is None:
        wants.append(attention_ref(qt, kt, vt, causal=True))
    for want in wants:
        np.testing.assert_allclose(
            got, np.asarray(want).transpose(0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("Sq,Skv", [(5, 12), (9, 40), (1, 7)])
def test_prefill_head_dim_256_q_offset_matches_model(Sq, Skv):
    """A chunk of a chunked admission at head_dim 256: query i sits at
    Skv - Sq + i (``_sdpa_chunked`` alone, as for the other head_dims)."""
    q, k, v = _gemma_prefill_inputs(Sq * 100 + Skv, Sq, Skv)
    off = Skv - Sq
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), q_offset=off).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=off, window=None, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)


@pytest.mark.parametrize("Sq,Skv", [(5, 12), (37, 40)])
def test_non_causal_prefill_head_dim_256_matches_jax(Sq, Skv):
    """K2's non-causal mode at head_dim 256 on ragged pairs, against
    ``_sdpa_chunked(causal=False)`` and the jitted Pallas
    ``flash_attention(causal=False)`` in interpret mode."""
    q, k, v = _gemma_prefill_inputs(Sq * 1000 + Skv, Sq, Skv)
    got = ref.prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False).numpy()
    model = _sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, q_offset=0, window=None, chunk=512)
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    qt, kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    pallas = flash_attention(qt, kt, vt, causal=False, interpret=True)
    np.testing.assert_allclose(
        got, np.asarray(pallas).transpose(0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("lengths", [[1, 40, 64], [64, 17, 9]])
def test_decode_head_dim_256_rep_8_matches_jax(lengths):
    """K1's plain version at head_dim 256 on ragged lengths, against the
    model's decode, ``decode_ref`` and the Pallas decode in interpret
    mode."""
    rng = np.random.default_rng(256 + sum(lengths))
    B, T = len(lengths), 64
    q = _randn(rng, B, GEMMA_H, GEMMA_D)
    k, v = (_randn(rng, B, T, GEMMA_HKV, GEMMA_D) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lens)).numpy()
    model = _sdpa_chunked(jnp.asarray(q)[:, None], jnp.asarray(k),
                          jnp.asarray(v), causal=True,
                          q_offset=jnp.asarray(lens - 1), window=None,
                          chunk=512)[:, 0]
    np.testing.assert_allclose(got, np.asarray(model), **TOL)
    kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v))
    for want in (decode_ref(jnp.asarray(q), kt, vt, jnp.asarray(lens)),
                 flash_attention_decode(jnp.asarray(q), kt, vt,
                                        jnp.asarray(lens), block_k=16,
                                        interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_kernel_head_dims_cover_every_attention_config():
    """K1 and K2 take the head_dim of every shipped configuration with
    attention (all but the ssm family): 64, 112, 128 and gemma-2b's 256;
    its rep of 8 is within K1's bound."""
    import repro_torch.configs as TC
    assert kernel.HEAD_DIMS == (64, 112, 128, 256)
    dims = {}
    for name, cfg in TC.all_configs().items():
        if cfg.family != "ssm":
            dims[name] = cfg.head_dim
            assert cfg.head_dim in kernel.HEAD_DIMS, name
            assert cfg.num_heads // cfg.num_kv_heads <= kernel.MAX_REP
    assert dims["gemma_2b"] == 256
    # rows of every supported head_dim are whole 16-byte chunks (K1's
    # cp.async copies, K2's TMA strides), in bf16 and fp32
    assert all(d * 2 % 16 == 0 for d in kernel.HEAD_DIMS)
