"""The chunk algebra of K4's prefill path (``rwkv6/csrc/wkv.cu``,
``wkv_chunk_kernel``), mirrored in plain fp32 PyTorch on the CPU and
held against the port's plain recurrence (``rwkv6.ref.wkv``) and the
JAX package's ``wkv_ref``; and the wrapper's choice of segments.

The kernel walks the tokens in steps of ``kernel.CHUNK`` (16), carrying
the state from step to step.  Within a step it never divides by a
product of decays: every decay it applies is a product of w over tokens
that lie between the two it connects, so each factor is at most 1 and a
fast channel (w near 0) underflows to 0 instead of overflowing.  With
t, s the token indices within the step and S the state before it:

  A_t = prod_{tau < t} w_tau           (decay from the step's start)
  B_s = prod_{s < tau < C} w_tau       (decay to the step's end)
  M[t, s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]   (s < t)
  M[t, t] = sum_i r_t[i] u[i] k_t[i]                           (bonus)
  y_t = (r_t * A_t) . S + sum_{s <= t} M[t, s] v_s
  S  <- diag(A_C) S + sum_s (k_s * B_s) v_s^T

A ragged last step is padded with r = k = v = 0 and w = 1, which leaves
the state as the unpadded recurrence leaves it.

Where B x H blocks would leave the card idle, the kernel also cuts the
sequence into segments (``kernel.segments``).  Each segment but the last
first makes its summary: its own contribution to the state at its end,
sum_s (k_s * D_s) v_s^T with D_s the product of w after s, walking blocks
of ``SB`` tokens backwards in quarters of 16 and carrying the decay of
what lies after, again by products of w; and its decay, the product of
its w.  Each segment then starts from the state carried over the
segments before it, S <- diag(a_j) S + summary_j, and runs the steps.

The cases run from a nonzero state, at ragged S, and at a wide spread of
decays (log(-log w) uniform in [-6, 2], so w from about 6e-4 to 0.9975),
where a factorisation through 1 / (prefix product of w) over a 64-token
chunk would overflow.
Tolerance: fp32 summation order, as ``WKV_TOL`` in ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.ref import wkv_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel, ref  # noqa: E402

WKV_TOL = dict(atol=1e-5, rtol=1e-5)
SB = 64                      # tokens a block of the kernel's summary


def chunked_wkv(r, k, v, w, u, state, C=kernel.CHUNK):
    """The kernel's algebra: r, k, v, w (B, S, H, P); u (H, P); state
    (B, H, P, P) [key x value], replaced in place.  -> y (B, S, H, P)."""
    B, S, H, P = r.shape
    pad = -S % C
    r, k, v = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
               for x in (r, k, v))
    w = torch.nn.functional.pad(w.float(), (0, 0, 0, 0, 0, pad), value=1.0)
    s = state.float().clone()
    uu = u.float()
    ys = []
    for c0 in range(0, S + pad, C):
        rc, kc, vc, wc = (x[:, c0:c0 + C].transpose(1, 2)
                          for x in (r, k, v, w))     # (B, H, C, P)
        # A_t: the products before token t; A[:, :, C] the whole step's
        A = torch.ones(B, H, C + 1, P)
        for t in range(C):
            A[:, :, t + 1] = A[:, :, t] * wc[:, :, t]
        # B_s: the products after token s, to the step's end
        Bs = torch.ones(B, H, C, P)
        for t in range(C - 2, -1, -1):
            Bs[:, :, t] = Bs[:, :, t + 1] * wc[:, :, t + 1]
        # M by direct products over the pairs of the step
        M = torch.zeros(B, H, C, C)
        for sj in range(C):
            M[:, :, sj, sj] = (rc[:, :, sj] * uu * kc[:, :, sj]).sum(-1)
            d = torch.ones(B, H, P)
            for t in range(sj + 1, C):
                M[:, :, t, sj] = (rc[:, :, t] * kc[:, :, sj] * d).sum(-1)
                d = d * wc[:, :, t]
        y = torch.einsum("bhtp,bhpq->bhtq", rc * A[:, :, :C], s) \
            + torch.einsum("bhts,bhsq->bhtq", M, vc)
        s = A[:, :, C, :, None] * s \
            + torch.einsum("bhsp,bhsq->bhpq", kc * Bs, vc)
        ys.append(y.transpose(1, 2))
    state.copy_(s)
    return torch.cat(ys, 1)[:, :S]


def summary(k, v, w, tb, te):
    """A segment's summary, as the kernel makes it: (sum_s (k_s * D_s)
    v_s^T (B, H, P, P) [key x value], the segment's decay (B, H, P))."""
    B, _, H, P = k.shape
    acc = torch.zeros(B, H, P, P)
    carry = torch.ones(B, H, P)
    for t0 in range(tb + (te - tb - 1) // SB * SB, tb - 1, -SB):
        n = min(SB, te - t0)
        kb = torch.zeros(B, SB, H, P)
        vb = torch.zeros(B, SB, H, P)
        wb = torch.ones(B, SB, H, P)
        kb[:, :n], vb[:, :n] = k[:, t0:t0 + n].float(), v[:, t0:t0 + n].float()
        wb[:, :n] = w[:, t0:t0 + n].float()
        q = SB // 4
        x = torch.zeros(B, SB, H, P)
        qd = []
        for qq in range(4):   # each quarter's chain, to its own end
            d = torch.ones(B, H, P)
            for t in range(qq * q + q - 1, qq * q - 1, -1):
                x[:, t] = kb[:, t] * d
                d = d * wb[:, t]
            qd.append(d)
        for qq in range(4):   # times the later quarters' and blocks' decay
            later = carry.clone()
            for q2 in range(3, qq, -1):
                later = later * qd[q2]
            x[:, qq * q:(qq + 1) * q] *= later[:, None]
        carry = carry * ((qd[0] * qd[1]) * (qd[2] * qd[3]))
        acc += torch.einsum("bshp,bshq->bhpq", x, vb)
    return acc, carry


def segmented_wkv(r, k, v, w, u, state, seglen):
    """The kernel's segments of ``seglen`` tokens: summaries, the carried
    start of each segment, and each segment's steps from it."""
    S = r.shape[1]
    nseg = -(-S // seglen)
    parts = [summary(k, v, w, j * seglen, min(S, (j + 1) * seglen))
             for j in range(nseg - 1)]
    ys = []
    for seg in range(nseg):
        tb, te = seg * seglen, min(S, (seg + 1) * seglen)
        s = state.float().clone()
        for acc, decay in parts[:seg]:
            s = decay[..., None] * s + acc
        ys.append(chunked_wkv(*(x[:, tb:te] for x in (r, k, v, w)), u, s))
    state.copy_(s)
    return torch.cat(ys, 1)


def _inputs(S, seed, B=2, H=3, P=16, wide=True):
    """r, k, v (x 0.5), a bonus u and a nonzero state; w = exp(-exp(ww))
    with ww uniform in [-6, 2] (wide) or the model's ~N(-2, 0.5)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
               for _ in range(3))
    ww = rng.uniform(-6.0, 2.0, (B, S, H, P)) if wide \
        else rng.standard_normal((B, S, H, P)) * 0.5 - 2.0
    w = np.exp(-np.exp(ww)).astype(np.float32)
    u = (rng.standard_normal((H, P)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, P)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "model"])
@pytest.mark.parametrize("S", [1, 13, 37, 200])
def test_chunk_algebra_matches_the_recurrence(S, wide):
    a = _inputs(S, seed=S + 1000 * wide, wide=wide)
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in a)
    s_chunk, s_ref = s0.clone(), s0.clone()
    y = chunked_wkv(r, k, v, w, u, s_chunk)
    want = ref.wkv(r, k, v, w, u, s_ref)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **WKV_TOL)
    np.testing.assert_allclose(s_chunk.numpy(), s_ref.numpy(), **WKV_TOL)
    jy, js = wkv_ref(*(jnp.asarray(x) for x in a))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s_chunk.numpy(), np.asarray(js), **WKV_TOL)


def test_wide_decays_do_reach_underflow():
    """The wide case does test the hazard: over 64 tokens (the chunk of
    the GLA-style kernels) the decay of some channels underflows fp32, so
    a chunk factored through 1 / (prefix product of w) would overflow.
    The kernel's steps of 16 with direct pair products never divide."""
    w = torch.from_numpy(_inputs(200, seed=1200)[3]).double()
    over64 = w[:, :192].reshape(2, 3, 64, 3, 16).prod(2)
    assert over64.min() < 1e-38


@pytest.mark.parametrize("S,seglen,wide", [
    pytest.param(200, 64, True, id="200-in-64s-wide"),
    pytest.param(200, 96, False, id="200-in-96s-model"),
    pytest.param(37, 16, True, id="37-in-16s-wide"),
    pytest.param(300, 80, True, id="300-in-80s-wide")])
def test_segments_match_the_recurrence(S, seglen, wide):
    a = _inputs(S, seed=S + seglen, wide=wide)
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in a)
    s_seg, s_ref = s0.clone(), s0.clone()
    y = segmented_wkv(r, k, v, w, u, s_seg, seglen)
    want = ref.wkv(r, k, v, w, u, s_ref)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **WKV_TOL)
    np.testing.assert_allclose(s_seg.numpy(), s_ref.numpy(), **WKV_TOL)
    jy, js = wkv_ref(*(jnp.asarray(x) for x in a))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **WKV_TOL)
    np.testing.assert_allclose(s_seg.numpy(), np.asarray(js), **WKV_TOL)


@pytest.mark.parametrize("B,H,S,resident", [
    (1, 40, 512, 264), (4, 40, 512, 264), (2, 40, 512, 264),
    (1, 40, 300, 264), (1, 40, 64, 264), (1, 40, 16, 264),
    (1, 40, 37, 264), (1, 1, 4096, 264), (8, 40, 512, 132)])
def test_segments_fill_one_wave_in_whole_steps(B, H, S, resident):
    """Whole steps; the last segment ends at S; the blocks fit in one wave
    (the grid barrier needs every block resident); no segment shorter
    than MIN_SEGMENT; and one segment when the rows fill the card."""
    nseg, seglen = kernel.segments(B, H, S, resident)
    assert seglen % kernel.CHUNK == 0
    assert (nseg - 1) * seglen < S <= nseg * seglen
    if nseg > 1:
        assert B * H * nseg <= resident
        assert seglen >= kernel.MIN_SEGMENT
    if 2 * B * H > resident:
        assert nseg == 1


def test_b1_serve_prompt_is_cut_into_six_segments():
    """rwkv6-3b's serve admission (B 1, 40 heads, 512 tokens) on an
    H100's 132 SMs at two blocks an SM: six segments of 96 tokens."""
    assert kernel.segments(1, 40, 512, 264) == (6, 96)
