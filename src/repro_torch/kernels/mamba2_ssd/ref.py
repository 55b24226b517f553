"""Plain PyTorch Mamba2 SSD chunked scan — the semantics of the model's
``_ssd_chunk_scan`` (``repro/models/ssm.py``), including its incoming
state ``h0``.

The sequence is zero-padded to whole chunks (x = B = C = 0, a_log = 0:
a padded token decays nothing and adds nothing, so the final state is
that of the unpadded recurrence), then each chunk forms the masked
C.B^T decay matrix, its product with x, the incoming-state term, and the
state carried to the next chunk, all in fp32.  It runs on whatever
device its inputs are on; ``ops`` sends only CPU tensors here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        a_log: torch.Tensor, h: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """xh: (B, S, H, P) dt-scaled inputs; B_/C_: (B, S, N); a_log:
    (B, S, H) log decay (negative); h: (B, H, N, P) fp32 incoming state,
    replaced IN PLACE by the final state.  Returns y (B, S, H, P) fp32."""
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    pad = (-S) % chunk
    xh, B_, C_, a_log = xh.float(), B_.float(), C_.float(), a_log.float()
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
    nC = (S + pad) // chunk
    xc_all = xh.reshape(Bb, nC, chunk, H, P)
    bc_all = B_.reshape(Bb, nC, chunk, N)
    cc_all = C_.reshape(Bb, nC, chunk, N)
    cum_all = torch.cumsum(a_log.reshape(Bb, nC, chunk, H), dim=2)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    hs = h.float()
    ys = []
    for c in range(nC):
        xc, bc, cc, cm = xc_all[:, c], bc_all[:, c], cc_all[:, c], \
            cum_all[:, c]
        # intra-chunk: L[t, s] = exp(cum_t - cum_s) for s <= t (a select:
        # for s > t the exponential may be inf)
        diff = cm[:, :, None, :] - cm[:, None, :, :]           # (B,Q,Q,H)
        Lm = torch.where(mask, torch.exp(diff), 0.0)
        cb = torch.einsum("bqn,bsn->bqs", cc, bc)              # (B,Q,Q)
        y = torch.einsum("bqsh,bshp->bqhp", cb[..., None] * Lm, xc)
        dec = torch.exp(cm[:, -1:, :] - cm)                     # (B,Q,H)
        st = torch.einsum("bsh,bsn,bshp->bhnp", dec, bc, xc)   # (B,H,N,P)
        # the incoming state's share: y_state[t] = C_t . (exp(cum_t) h)
        y_state = torch.einsum("bqn,bqh,bhnp->bqhp", cc, torch.exp(cm), hs)
        hs = torch.exp(cm[:, -1])[:, :, None, None] * hs + st
        ys.append(y + y_state)
    h.copy_(hs)
    return torch.cat(ys, dim=1)[:, :S]
