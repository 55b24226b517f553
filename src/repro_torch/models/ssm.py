"""State-space and RNN blocks — the PyTorch counterpart of
``repro/models/ssm.py``: Mamba2 (SSD) and RWKV6 (Finch).

Mamba2's prefill runs the chunked SSD scan through
``kernels.mamba2_ssd.ops`` (K5), carrying the cache's incoming state;
its decode (S == 1 with a state) is the O(1) recurrence in plain torch
ops, as in JAX.  RWKV6's time mix runs the WKV recurrence through
``kernels.rwkv6.ops`` (K4) at every length, decode included.

With ``train=True`` (no state) both blocks run training scans in plain
PyTorch instead, differentiated by autograd (the kernels' ops define no
backward): the reference's ``_ssd_chunk_scan``, and for RWKV6
``_wkv_chunked``, the chunked form of the reference's per-token
``_wkv_scan`` (which stays as its plain version).

Parameter dicts and state layouts are the JAX ones.  A ``state`` passed
to a block is a dict of per-layer views into the model's stacked cache
(``{"ssm": (B,H,N,P) fp32, "conv": (B,K-1,C)}`` for Mamba2,
``{"tm_x": (B,d), "wkv": (B,H,P,P) fp32}`` and the channel mix's
``(B,d)``); unlike JAX, which returns new state, the blocks write the
new state into those views IN PLACE and return them.  With
``state=None`` a block starts from zeros and returns no state.  The
JAX rounding points are kept: the decay ``w`` and Mamba2's ``xh * dt``
are fp32, the conv state is in the model dtype and both scan states
are fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard

from repro_torch.distributed import local as LD
from repro_torch.kernels.mamba2_ssd import ops as SSD
from repro_torch.kernels.rwkv6 import ops as WKV
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal

Params = Dict[str, Any]


def _uniform(shape, g: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device,
                      dtype=torch.float32).to(dtype)


# ===================================================================== #
# Mamba2 (SSD)
# ===================================================================== #
def init_mamba2(cfg: ModelConfig, g: torch.Generator,
                device: torch.device) -> Params:
    d, di, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    dt, f32 = cfg.torch_dtype, torch.float32
    return {
        # projections: z (gate), x, B, C, dt
        "in_proj": _normal((d, 2 * di + 2 * N + H), 1.0 / math.sqrt(d), g,
                           dt, device),
        "conv_w": _normal((cfg.conv_width, di + 2 * N), 0.1, g, dt, device),
        "conv_b": torch.zeros(di + 2 * N, dtype=dt, device=device),
        "A_log": torch.zeros(H, dtype=f32, device=device),
        "D": torch.ones(H, dtype=f32, device=device),
        "dt_bias": torch.zeros(H, dtype=f32, device=device),
        "out_norm": torch.ones(di, dtype=dt, device=device),
        "out_proj": _normal((di, d), 1.0 / math.sqrt(di), g, dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C); state:
    (B, K-1, C), the previous tokens.  Returns (out, the last K-1
    tokens) — the second a new tensor."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, S+K-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype), xp[:, S:]


def _ssd_chunk_scan(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                    a_log: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the reference's ``_ssd_chunk_scan``).  xh: (B, S, H,
    P) dt-scaled inputs; B_/C_: (B, S, N); a_log: (B, S, H) log decay
    (negative); h0: (B, H, N, P) incoming state (zeros when None).
    Returns (y (B, S, H, P) fp32, final state)."""
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"{S} tokens do not split into chunks of {chunk}")
    nC = S // chunk
    xh = xh.reshape(Bb, nC, chunk, H, P)
    Bc = B_.reshape(Bb, nC, chunk, N)
    Cc = C_.reshape(Bb, nC, chunk, N)
    cum = torch.cumsum(a_log.reshape(Bb, nC, chunk, H), dim=2)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    h = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    ys = []
    for c in range(nC):
        xc = xh[:, c].float()
        bc, cc, cm = Bc[:, c].float(), Cc[:, c].float(), cum[:, c]
        # intra-chunk: L[t, s] = exp(cum_t - cum_s) for s <= t.  The
        # reference masks after the exp; masking the exponent (exp(-inf)
        # = 0) gives the same values and no inf * 0 in the gradient
        diff = cm[:, :, None, :] - cm[:, None, :, :]            # (B,Q,Q,H)
        Lm = torch.exp(torch.where(mask, diff, -torch.inf))
        cb = torch.einsum("bqn,bsn->bqs", cc, bc)
        y = torch.einsum("bqsh,bshp->bqhp", cb[..., None] * Lm, xc)
        # this chunk's contribution to the state
        dec = torch.exp(cm[:, -1, None, :] - cm)                # (B,Q,H)
        st = torch.einsum("bsh,bsn,bshp->bhnp", dec, bc, xc)
        # the incoming state's: y_state[t] = C_t . (exp(cum_t) h)
        y_state = torch.einsum("bqn,bqh,bhnp->bqhp", cc, torch.exp(cm), h)
        h = torch.exp(cm[:, -1])[:, :, None, None] * h + st
        ys.append(y + y_state)
    return torch.stack(ys, dim=1).reshape(Bb, S, H, P), h


def mamba2(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
           state: Optional[Dict[str, torch.Tensor]] = None,
           train: bool = False
           ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 mixer.  ``state`` = {"ssm": (B,H,N,P) fp32, "conv":
    (B,K-1,C)}, updated in place; None for a fresh sequence.  ``train``
    (no state): the scan is ``_ssd_chunk_scan`` over 128-token chunks,
    zero-padded, as the reference trains."""
    if train and state is not None:
        raise ValueError("the training form takes no state")
    B, S, d = x.shape
    di, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    proj = x @ p["in_proj"]                            # (B,S,2di+2N+H)
    z, xs, Bv, Cv, dt_raw = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bv, Cv], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        state["conv"] if state is not None else None)
    conv_out = F.silu(conv_out)
    xs, Bv, Cv = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                         # (H,) negative
    a_log = dt * A                                     # (B,S,H) log decay
    xh = xs.reshape(B, S, H, P)
    xh_dt = xh.float() * dt[..., None]

    if S == 1 and state is not None:
        # recurrent decode step
        h = state["ssm"]                               # (B,H,N,P)
        a = torch.exp(a_log[:, 0])                     # (B,H)
        h_new = h * a[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bv[:, 0].float(), xh_dt[:, 0])
        y = torch.einsum("bn,bhnp->bhp", Cv[:, 0].float(), h_new)[:, None]
        h.copy_(h_new)
    elif train:
        pad = (-S) % 128
        y, _ = _ssd_chunk_scan(F.pad(xh_dt, (0, 0, 0, 0, 0, pad)),
                               F.pad(Bv, (0, 0, 0, pad)),
                               F.pad(Cv, (0, 0, 0, pad)),
                               F.pad(a_log, (0, 0, 0, pad)), 128)
        y = y[:, :S]
    else:
        # the chunked scan from the incoming SSM state (zeros for a fresh
        # sequence); K5 takes the ragged tail itself
        h = state["ssm"] if state is not None else torch.zeros(
            (B, H, N, P), dtype=torch.float32, device=x.device)
        y = SSD.ssd(xh_dt, Bv, Cv, a_log, h, chunk=128)
    if state is not None:
        state["conv"].copy_(new_conv)

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMS norm (mamba2 style)
    y32 = y.float() * F.silu(z.float())
    var = y32.square().mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)
         * p["out_norm"].float()).to(x.dtype)
    # on DTensors the partial sums over a sharded d_inner added at once
    return LD.reduced(LD.matmul(y, p["out_proj"])), state


def make_mamba2_state(cfg: ModelConfig, batch: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    L = cfg.num_layers
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    C = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((L, batch, H, N, P), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, C),
                            dtype=cfg.torch_dtype, device=device),
    }


# ===================================================================== #
# RWKV6 (Finch)
# ===================================================================== #
def init_rwkv6(cfg: ModelConfig, g: torch.Generator,
               device: torch.device) -> Params:
    d, P, H, f = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_heads, cfg.d_ff
    dt, f32 = cfg.torch_dtype, torch.float32
    s = 1.0 / math.sqrt(d)
    lora = max(32, d // 64)
    return {
        # time-mix
        "mu": _uniform((5, d), g, dt, device),         # r, k, v, w, g
        "w_r": _normal((d, d), s, g, dt, device),
        "w_k": _normal((d, d), s, g, dt, device),
        "w_v": _normal((d, d), s, g, dt, device),
        "w_g": _normal((d, d), s, g, dt, device),
        "w_o": _normal((d, d), s, g, dt, device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((d,), -2.0, dtype=f32, device=device),
        "w_lora_a": _normal((d, lora), s, g, dt, device),
        "w_lora_b": _normal((lora, d), 0.01, g, dt, device),
        "u": torch.zeros((H, P), dtype=f32, device=device),   # bonus
        "ln_x": torch.ones(d, dtype=dt, device=device),       # per-head norm
        # channel-mix
        "mu_c": _uniform((2, d), g, dt, device),
        "ck": _normal((d, f), s, g, dt, device),
        "cv": _normal((f, d), 1.0 / math.sqrt(f), g, dt, device),
        "cr": _normal((d, d), s, g, dt, device),
    }


def _heads(y: torch.Tensor, H: int, P: int) -> torch.Tensor:
    """(B, S, H*P) -> (B, S, H, P); a DTensor sharded over heads that do
    not split evenly is gathered first."""
    if LD.is_dtensor(y):
        y = LD.splittable(y, 2, H)
    return y.view(*y.shape[:2], H, P)


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = last (carried across steps)."""
    if x.shape[1] == 1:
        return last[:, None]
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 linear attention, one token at a time (the reference's
    ``_wkv_scan``).  r, k, v: (B, S, H, P); w: (B, S, H, P) decay in
    (0, 1); u: (H, P) bonus; state: (B, H, P, P) [key x value].
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1}
    + k_t v_t^T.  Returns (y (B, S, H, P) fp32, final state)."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]               # (B,H,P,P)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt,
                               s + u[None, :, :, None] * kv))
        s = w[:, t][..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _chunk_masks(C: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The 0/1 matrix whose rows pick, from a chunk's C tokens, those
    each decay of ``_wkv_chunked`` spans, and the (t, s) pairs it
    lists.  Rows: for t = 0..C the tokens before t (the last row the
    whole chunk); for s < C those after s; for each pair s < t those
    strictly between."""
    ar = torch.arange(C, device=device)
    it, is_ = torch.tril_indices(C, C, -1, device=device)
    before = ar[None, :] < torch.arange(C + 1, device=device)[:, None]
    after = ar[None, :] > ar[:, None]
    between = (ar[None, :] > is_[:, None]) & (ar[None, :] < it[:, None])
    return torch.cat([before, after, between]).float(), it, is_


def _wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_wkv_scan`` in chunks of ``chunk`` tokens, the algebra of K4's
    chunk kernel (``kernels/rwkv6/csrc/wkv.cu``) in plain differentiable
    PyTorch: the training form.  Same arguments and result.

    With t, s tokens of one chunk, S the state before it, A_t the decay
    from the chunk's start to t, B_s from s to its end:
      y_t = (r_t * A_t) . S + sum_{s<t} M[t,s] v_s + (r_t . (u * k_t)) v_t
      M[t,s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]
      S <- diag(A_C) S + sum_s (k_s * B_s) v_s^T
    Every decay is exp of a sum of log w over exactly the tokens it
    spans (one matmul with ``_chunk_masks``): nothing divides by a
    product of decays, no exp takes a positive argument, and a fast
    channel underflows to 0 as in the recurrence.  The terms inside the
    chunks are computed for all chunks at once; only the carry of the
    (B, H, P, P) state walks the chunks, one op each.  A ragged tail is
    padded with k = 0 and w = 1, which leaves the state unchanged.  The
    (pair, channel) tensors are chunk / 2 times the size of r."""
    B, S, H, P = r.shape
    C = chunk
    pad = -S % C
    nC = (S + pad) // C

    def chunks(x, value=0.0):     # (B, S, H, P) -> (C, B, nC, H, P) fp32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad), value=value)
        return x.view(B, nC, C, H, P).permute(2, 0, 1, 3, 4)

    r, k, v = chunks(r), chunks(k), chunks(v)
    w = chunks(w, 1.0)
    # log w; an exact 0 (fp32 underflow of exp(-exp(ww))) gets a finite
    # log whose exp is 0 over any span that holds it
    live = w > 0
    lw = torch.where(live, torch.log(torch.where(live, w, 1.0)), -1e4)
    masks, it, is_ = _chunk_masks(C, w.device)
    dec = torch.exp((masks @ lw.reshape(C, -1)).view(-1, B, nC, H, P))
    A, A_C = dec[:C], dec[C]
    Bd, D = dec[C + 1:2 * C + 1], dec[2 * C + 1:]
    # each chunk's own contribution to the state at its end
    U = torch.einsum("sbchp,sbchq->bchpq", k * Bd, v)
    # the carry: S_{c+1} = diag(A_C[c]) S_c + U[c]
    s = state.float()
    starts = []
    for a_c, u_c in zip(A_C[..., None].unbind(1), U.unbind(1)):
        starts.append(s)
        s = torch.addcmul(u_c, a_c, s)
    y = torch.einsum("tbchp,bchpq->tbchq", r * A, torch.stack(starts, 1))
    # inside the chunks: M over the pairs s < t, the bonus on t = s
    M = torch.cat([(r[it] * k[is_] * D).sum(-1),
                   (r * u * k).sum(-1)])              # (pairs + C, B, nC, H)
    ar = torch.arange(C, device=w.device)
    Mts = M.new_zeros((C, C) + M.shape[1:]).index_put(
        (torch.cat([it, ar]), torch.cat([is_, ar])), M)
    y = y + torch.einsum("tsbch,sbchq->tbchq", Mts, v)
    y = y.permute(1, 2, 0, 3, 4).reshape(B, nC * C, H, P)
    return y[:, :S], s


def _group_norm(y: torch.Tensor) -> torch.Tensor:
    """The time mix's norm of each head (population variance) of y (B,
    S, H, P), flattened to (B, S, H P)."""
    var, mean = torch.var_mean(y, dim=-1, keepdim=True, correction=0)
    return ((y - mean) * torch.rsqrt(var + 64e-5)).flatten(2)


def _wkv_train_local(r, k, v, w, u, state) -> torch.Tensor:
    """``_group_norm`` of ``_wkv_chunked``'s output on DTensors, each rank
    on its shards (its rows or heads; anything else gathered) on local
    tensors, not through DTensor's dispatch of each op.  The norm and
    the flattening of the heads run locally too: DTensor's backward of
    that view cannot split a d sharded where the heads do not divide."""
    mesh = r.device_mesh
    seq = LD.mapped(r.placements, {0: 0, 2: 2})
    u_to = LD.mapped(seq, {2: 0})
    u_grad = tuple(Partial() if isinstance(p, Shard) and p.dim == 0 else q
                   for p, q in zip(seq, u_to))
    return LD.local_call(
        lambda *a: _group_norm(_wkv_chunked(*a)[0]), mesh,
        [(r, seq), (k, seq), (v, seq), (w, seq), (u, u_to, u_grad),
         (state, LD.mapped(seq, {0: 0, 2: 1}))],
        [(seq, r.shape[:2] + (r.shape[2] * r.shape[3],))])


def rwkv6_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   train: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """RWKV6 time mix.  ``state`` = {"tm_x": (B,d), "wkv": (B,H,P,P)
    fp32}, updated in place; None for a fresh sequence.  ``train`` (no
    state): the recurrence in chunks, ``_wkv_chunked`` (the reference
    trains through its per-token ``_wkv_scan``, kept here as the plain
    version the chunked form is held against)."""
    if train and state is not None:
        raise ValueError("the training form takes no state")
    B, S, d = x.shape
    H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
    last = state["tm_x"] if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, last)
    mu = p["mu"]
    xr = x + (prev - x) * mu[0]
    xk = x + (prev - x) * mu[1]
    xv = x + (prev - x) * mu[2]
    xw = x + (prev - x) * mu[3]
    xg = x + (prev - x) * mu[4]
    mm = LD.matmul
    r = _heads(mm(xr, p["w_r"]), H, P)
    k = _heads(mm(xk, p["w_k"]), H, P)
    v = _heads(mm(xv, p["w_v"]), H, P)
    g = F.silu(mm(xg, p["w_g"]))
    # data-dependent decay (the RWKV6 contribution), fp32
    ww = p["w0"] + mm(torch.tanh(mm(xw, p["w_lora_a"])),
                      p["w_lora_b"]).float()
    w = _heads(torch.exp(-torch.exp(ww)), H, P)       # in (0, 1)
    s = state["wkv"] if state is not None else \
        torch.zeros((B, H, P, P), dtype=torch.float32, device=x.device)
    if train and LD.is_dtensor(r):
        yh = _wkv_train_local(r, k, v, w, p["u"], s)
    elif train:
        yh = _group_norm(_wkv_chunked(r, k, v, w, p["u"], s)[0])
    else:
        yh = _group_norm(WKV.wkv(r, k, v, w, p["u"], s))  # s -> final state
    y = yh * p["ln_x"].float()
    out = LD.reduced(mm(y.to(x.dtype) * g, p["w_o"]))
    if state is not None:
        state["tm_x"].copy_(x[:, -1])
    return out, state


def rwkv6_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """RWKV6 channel mix (relu^2).  ``state`` (B,d) is the last token,
    updated in place; None for a fresh sequence."""
    B, S, d = x.shape
    last = state if state is not None else \
        torch.zeros((B, d), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, last)
    xk = x + (prev - x) * p["mu_c"][0]
    xr = x + (prev - x) * p["mu_c"][1]
    mm = LD.matmul
    k = torch.square(F.relu(mm(xk, p["ck"])))
    kv = mm(k, p["cv"])
    out = LD.reduced(torch.sigmoid(mm(xr, p["cr"])) * kv)
    if state is not None:
        state.copy_(x[:, -1])
    return out, state


def make_rwkv6_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    L = cfg.num_layers
    H, P, d = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    dt = cfg.torch_dtype
    return {
        "tm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
        "wkv": torch.zeros((L, batch, H, P, P), dtype=torch.float32,
                           device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
    }
