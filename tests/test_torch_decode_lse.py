"""K1's log-sum-exp form and the merge of a cache sharded over T, on the
CPU, at fp32 (atol = rtol = 1e-5).

  * ``ref.decode_attention_lse`` (what the CPU runs for
    ``repro_torch::flash_decode_lse``): its log-sum-exp against JAX's
    ``logsumexp`` of ``decode_ref``'s logits (scaled, masked to -1e30;
    capped as the reference's ``_sdpa_chunked`` caps them), its output
    against ``decode_ref`` and the capped ``_sdpa_chunked``; a row of
    length 0 gives o = 0 and lse = -1e30, with no NaN;
  * ``distributed.local.merge_partials`` over 1, 2, 4 and 16 shards of
    the cache (each shard's lengths clipped as ``attend`` clips them,
    rows empty on some shards, one row empty on all) against whole-T
    attention and ``decode_ref``;
  * the op's dispatch (CPU -> plain, a fake tensor -> shapes), its FLOP
    formula, and the wrapper's refusal of CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import decode_ref  # noqa: E402
from repro.models.layers import _sdpa_chunked  # noqa: E402
from repro_torch.distributed.local import merge_partials  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
T = 64


def _randn(rng, *shape, gain=1.0):
    return (gain * rng.standard_normal(shape)).astype(np.float32)


def _inputs(seed, lengths, H, Hkv, D, gain=1.0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    return (_randn(rng, B, H, D, gain=gain), _randn(rng, B, T, Hkv, D),
            _randn(rng, B, T, Hkv, D), np.asarray(lengths, np.int32))


def _jax_lse(q, k, lengths, softcap):
    """JAX's logsumexp of ``decode_ref``'s logits, capped as
    ``_sdpa_chunked`` caps them (before the mask): (B, H)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(B, Hkv, H // Hkv, D) / np.sqrt(D)
    logits = jnp.einsum("bhrd,bkhd->bhrk", qg, jnp.asarray(k))
    if softcap:
        logits = jnp.tanh(logits / softcap) * softcap
    valid = jnp.arange(T)[None, :] < jnp.asarray(lengths)[:, None]
    logits = jnp.where(valid[:, None, None], logits, -1e30)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(B, H)


def _jax_out(q, k, v, lengths, softcap):
    """The reference's decode output: ``decode_ref`` without a cap, the
    capped ``_sdpa_chunked`` (one query at position length - 1) with."""
    if not softcap:
        kt, vt = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (k, v))
        return np.asarray(decode_ref(jnp.asarray(q), kt, vt,
                                     jnp.asarray(lengths)))
    return np.asarray(_sdpa_chunked(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        causal=True, q_offset=jnp.asarray(lengths - 1), window=None,
        chunk=512, softcap=softcap)[:, 0])


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("softcap", [0.0, 0.5])
@pytest.mark.parametrize("lengths", [[1, 17, 64], [64, 0, 40, 0]])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 16), (8, 2, 16), (8, 1, 64)])
def test_plain_lse_form_matches_jax(H, Hkv, D, lengths, softcap):
    q, k, v, lens = _inputs(100 * H + 10 * Hkv + len(lengths), lengths, H,
                            Hkv, D, gain=3.0)
    o, lse = ref.decode_attention_lse(*_t(q, k, v, lens), softcap)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (len(lengths), H, D) and lse.shape == o.shape[:2]
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    full = lens > 0
    want = _jax_lse(q, k, lens, softcap)
    np.testing.assert_allclose(lse.numpy()[full], want[full], **TOL)
    assert (lse.numpy()[~full] == ref.NEG_INF).all()
    assert (o.numpy()[~full] == 0).all()
    np.testing.assert_allclose(o.numpy()[full],
                               _jax_out(q, k, v, lens, softcap)[full], **TOL)
    # at fp32 the output is the one the form without the log-sum-exp gives
    plain = ref.decode_attention(*_t(q, k, v, lens), softcap)
    np.testing.assert_array_equal(o.numpy()[full], plain.numpy()[full])
    if softcap:                         # the cap bites
        free = _jax_lse(q, k, lens, 0.0)
        assert np.abs(free - want)[full].max() > 100 * TOL["atol"]


def test_bf16_inputs_give_float32_outputs():
    q, k, v, lens = _inputs(5, [9, 0, 64], 8, 2, 64)
    args = [t.to(torch.bfloat16) for t in _t(q, k, v)] + _t(lens)
    o, lse = ops.decode_attention_lse(*args)
    assert o.dtype == lse.dtype == torch.float32
    assert (o[1] == 0).all() and (lse[1] == ref.NEG_INF).all()
    want = ref.decode_attention(*args)
    torch.testing.assert_close(o[[0, 2]].to(torch.bfloat16), want[[0, 2]],
                               atol=1e-2, rtol=1e-2)


def _shards(q, k, v, lens, n, softcap):
    """Each of ``n`` T shards' (o, lse), the lengths clipped as
    ``distributed.local.attend`` clips them, stacked on dimension 0."""
    tl = T // n
    outs = [ref.decode_attention_lse(
        q, k[:, i * tl:(i + 1) * tl].contiguous(),
        v[:, i * tl:(i + 1) * tl].contiguous(),
        (lens - i * tl).clamp(0, tl).to(torch.int32), softcap)
        for i in range(n)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([m for _, m in outs]))


@pytest.mark.parametrize("softcap", [0.0, 0.5])
@pytest.mark.parametrize("shards", [1, 2, 4, 16])
def test_merge_over_t_shards_matches_whole_t(shards, softcap):
    """Rows end inside the first shard (3), on a shard boundary (32),
    inside a later one (37, 50), at the end (64); the last row is empty
    on every shard (an idle slot): 0, not NaN."""
    lengths = [3, 32, 37, 64, 50, 0]
    q, k, v, lens = _t(*_inputs(shards, lengths, 8, 2, 16, gain=3.0))
    o, lse = _shards(q, k, v, lens, shards, softcap)
    assert (lse == ref.NEG_INF).any() or shards == 1
    got = merge_partials(o, lse)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got[-1] == 0).all()
    want = ref.decode_attention(q, k, v, lens, softcap)
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1].numpy(), **TOL)
    np.testing.assert_allclose(
        got[:-1].numpy(),
        _jax_out(*(a.numpy() for a in (q, k, v, lens)), softcap)[:-1],
        **TOL)


def test_merge_weighs_an_empty_shard_nothing():
    """A shard with lse -1e30 and any output adds nothing; equal
    log-sum-exps average the outputs."""
    o = torch.stack([torch.full((2, 3, 4), 5.0), torch.full((2, 3, 4), 7.0)])
    lse = torch.stack([torch.zeros(2, 3), torch.full((2, 3), ref.NEG_INF)])
    assert (merge_partials(o, lse) == 5.0).all()
    assert (merge_partials(o, torch.zeros(2, 2, 3)) == 6.0).all()


def test_op_dispatch_fake_shapes_and_flops():
    q, k, v, lens = _t(*_inputs(3, [5, 64], 8, 2, 16))
    before = dict(kernel.LAUNCHES)
    o, lse = ops.decode_attention_lse(q, k, v, lens, softcap=0.5)
    po, plse = ref.decode_attention_lse(q, k, v, lens, 0.5)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert kernel.LAUNCHES == before
    assert set(kernel.LAUNCHES) == {"flash_decode", "flash_prefill",
                                    "flash_decode_lse"}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fo, flse = ops.decode_attention_lse(
            torch.empty(2, 8, 16, dtype=torch.bfloat16),
            torch.empty(2, T, 2, 16, dtype=torch.bfloat16),
            torch.empty(2, T, 2, 16, dtype=torch.bfloat16),
            torch.empty(2, dtype=torch.int32))
    assert fo.dtype == flse.dtype == torch.float32
    assert fo.shape == (2, 8, 16) and flse.shape == (2, 8)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        ops.decode_attention_lse(q, k, v, lens)
    flops, nbytes = cost.decode_lse(2, 8, 2, 16, 2 * T, 4)
    assert fc.get_total_flops() == flops == cost.decode(2, 8, 2, 16, 2 * T,
                                                        4)[0]
    # K1's bytes, its output float32 rather than q's dtype, and the lse
    assert nbytes == cost.decode(2, 8, 2, 16, 2 * T, 4)[1] + 4 * 2 * 8
    assert cost.decode_lse(2, 8, 2, 16, 2 * T, 2)[1] == cost.decode(
        2, 8, 2, 16, 2 * T, 2)[1] + 2 * 2 * 8 * 16 + 4 * 2 * 8


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 128)
    kv = torch.zeros(1, 8, 2, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_decode_lse(q, kv, kv, torch.ones(1, dtype=torch.int32))
    assert kernel._LIBS == {}


def test_an_empty_row_leaves_every_split_empty():
    """A shard that holds none of a row's tokens: every split K1 deals
    out is empty (each still takes its ticket, so the counters reset)."""
    for nsplit in (1, 7, kernel.MAX_SPLIT):
        assert all(end <= begin
                   for begin, end in kernel.split_bounds(0, nsplit))
