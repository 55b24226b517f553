"""The chunked, differentiable WKV training scan (``ssm._wkv_chunked``)
against the per-token recurrence it replaces in training: the port's
``ssm._wkv_scan`` (its plain version) and the JAX package's
``repro.models.ssm._wkv_scan`` (a ``lax.scan``), at fp32 on the CPU.

Held: outputs and the final state, and the gradients of r, k, v, w, u
and the incoming state, from a nonzero state, at lengths that are and
are not multiples of the chunk (16), and at decays spread from 1e-30 to
1 - 1e-6 (all finite; a chunked form through 1 / (prefix product of w)
would overflow there).  Tolerance: fp32 summation order, relative to
each compared tensor's largest magnitude (WKV_TOL).

And the fault the chunked form repairs: the per-token scan dispatches
about ten ops a token and layer, so the dry run of rwkv6-3b's train_4k
cells (S 4096) took over an hour.  A training forward and backward of
the smoke time mix at S 64 and S 256, counted op by op under a
``TorchDispatchMode``, may grow by at most a few ops per added chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.models import ssm as SM  # noqa: E402

WKV_TOL = dict(atol=2e-6, rtol=1e-5)      # atol x the tensor's max |.|
B, H, P = 2, 3, 16


def _inputs(S, seed, decays="model"):
    """r, k, v (x 0.5), a bonus u, a nonzero state and w: the model's
    exp(-exp(N(-2, 0.5))), or log w uniform from log(1e-30) to
    log(1 - 1e-6) with both ends present ("wide")."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
               for _ in range(3))
    if decays == "wide":
        lw = rng.uniform(np.log(1e-30), np.log1p(-1e-6), (B, S, H, P))
        w = np.exp(lw)
        w.reshape(-1)[:2] = (1e-30, 1 - 1e-6)
    else:
        w = np.exp(-np.exp(rng.standard_normal((B, S, H, P)) * 0.5 - 2.0))
    u = (rng.standard_normal((H, P)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, P)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=WKV_TOL["rtol"],
                               atol=WKV_TOL["atol"] * scale, err_msg=what)


def _loss(y, s):
    """A scalar that weighs every output and state element differently."""
    wy = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
    ws = torch.linspace(0.5, -0.5, s.numel()).reshape(s.shape)
    return (y * wy).sum() + (s * ws).sum()


def _jax_loss(y, s):
    wy = jnp.linspace(-1.0, 1.0, y.size).reshape(y.shape)
    ws = jnp.linspace(0.5, -0.5, s.size).reshape(s.shape)
    return (y * wy).sum() + (s * ws).sum()


def _grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, s = fn(*ts)
    return (y.detach(), s.detach(),
            torch.autograd.grad(_loss(y, s), ts))


NAMES = ("r", "k", "v", "w", "u", "state")


@pytest.mark.parametrize("decays", ["model", "wide"])
@pytest.mark.parametrize("S", [1, 13, 16, 37, 64, 100])
def test_chunked_matches_the_recurrence_and_jax(S, decays):
    """Values and every gradient against the port's per-token scan and
    JAX's ``lax.scan``, from a nonzero state; S 1, 13, 37, 100 end in a
    ragged chunk."""
    a = _inputs(S, seed=S, decays=decays)
    y, s, g = _grads(SM._wkv_chunked, a)
    y0, s0, g0 = _grads(SM._wkv_scan, a)
    jy, js = JS._wkv_scan(*map(jnp.asarray, a))
    jg = jax.grad(lambda *x: _jax_loss(*JS._wkv_scan(*x)),
                  argnums=tuple(range(6)))(*map(jnp.asarray, a))
    assert y.shape == (B, S, H, P) and s.shape == (B, H, P, P)
    _close(y, y0, "y vs the port's scan")
    _close(s, s0, "state vs the port's scan")
    _close(y, jy, "y vs JAX")
    _close(s, js, "state vs JAX")
    for name, a_, b_, c_ in zip(NAMES, g, g0, jg):
        assert torch.isfinite(a_).all(), name
        _close(a_, b_, f"d{name} vs the port's scan")
        _close(a_, c_, f"d{name} vs JAX")


def test_wide_decays_underflow_without_overflow():
    """At the wide decays the product of w over a chunk underflows fp32
    (a form that divides by it would overflow), yet every output, state
    and gradient of the chunked form is finite and held."""
    a = _inputs(64, seed=7, decays="wide")
    w = torch.from_numpy(a[3]).double()
    assert float(w.reshape(B, 4, 16, H, P).prod(2).min()) < 1e-38
    assert float(w.min()) < 1.01e-30 and float(w.max()) > 1 - 2e-6
    y, s, g = _grads(SM._wkv_chunked, a)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert all(torch.isfinite(x).all() for x in g)


def test_an_exact_zero_decay_stays_finite():
    """w = 0 (exp(-exp(ww)) underflowed) erases the state exactly as the
    recurrence does; nothing becomes NaN."""
    r, k, v, w, u, s0 = _inputs(40, seed=8)
    w[:, 20, 1, 3] = 0.0
    a = (r, k, v, w, u, s0)
    y, s, g = _grads(SM._wkv_chunked, a)
    y0, s_0, _ = _grads(SM._wkv_scan, a)
    _close(y, y0, "y")
    _close(s, s_0, "state")
    assert all(torch.isfinite(x).all() for x in g)


def test_chunk_size_does_not_change_the_result():
    a = [torch.from_numpy(x) for x in _inputs(50, seed=9)]
    y16, s16 = SM._wkv_chunked(*a)
    for chunk in (4, 8, 32):
        y, s = SM._wkv_chunked(*a, chunk=chunk)
        _close(y, y16, f"y at chunk {chunk}")
        _close(s, s16, f"state at chunk {chunk}")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _time_mix_ops(S: int) -> int:
    """ATen ops of one training forward and backward of the smoke time
    mix (``train=True``) at sequence length S."""
    cfg = TC.get_smoke("rwkv6_3b")
    g = torch.Generator().manual_seed(0)
    p = {n: t.float().requires_grad_() if t.is_floating_point() else t
         for n, t in SM.init_rwkv6(cfg, g, torch.device("cpu")).items()}
    x = torch.randn(1, S, cfg.d_model, generator=g).requires_grad_()
    with _Count() as c:
        y, _ = SM.rwkv6_time_mix(p, x, cfg, train=True)
        y.square().sum().backward()
    return c.n


def test_dispatch_count_grows_by_a_few_ops_per_chunk():
    """S 64 -> 256 adds 12 chunks of 16 tokens (192 tokens): the chunked
    form adds a few ops per chunk (the state carry and its gradient),
    where the per-token scan adds dozens a token."""
    n64, n256 = _time_mix_ops(64), _time_mix_ops(256)
    per_chunk = (n256 - n64) / ((256 - 64) / 16)
    assert 0 < per_chunk <= 10, (n64, n256, per_chunk)
    chunked = SM._wkv_chunked
    try:
        SM._wkv_chunked = lambda *a, chunk=16: SM._wkv_scan(*a)
        per_token = (_time_mix_ops(256) - _time_mix_ops(64)) / (256 - 64)
    finally:
        SM._wkv_chunked = chunked
    assert per_token >= 10 and per_token > 50 * per_chunk / 16
