"""Public wrappers for the kernels, in the models' layouts.

Dispatch is by the tensors' device: a CUDA tensor goes to the Hopper kernel
(or the call raises), a CPU tensor to the kernel's plain PyTorch version.
There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import ssd_scan as _ssd
from . import stream as _stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, S, H, D)-layout flash attention (matches models.attention)."""
    out = _fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   block_q=block_q, block_k=block_k)
    return out.transpose(1, 2)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of a (B, L, H, ...) tensor by ``pad`` rows.  A tensor
    broadcast over heads (stride 0 on axis 2) stays a broadcast view."""
    widths = [0, 0] * (t.dim() - 2) + [0, pad]
    if t.dim() == 4 and t.stride(2) == 0:
        return F.pad(t[:, :, :1], widths).expand(-1, -1, t.shape[2], -1)
    return F.pad(t, widths)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None):
    """Full SSD scan = the intra-chunk kernel (K4) + the inter-chunk
    recurrence in torch ops.  Differentiable end to end: K5 is the
    intra-chunk pass's backward, autograd does the rest (the recurrence,
    ``y_off``, the padding and the head broadcast); the gradient of ``y``
    reaches K5 through its strides.

    x: (B,L,H,P); dt: (B,L,H) post-softplus, in x's dtype; A: (H,);
    Bm, Cm: (B,L,H,N) (head-broadcast; a stride-0 ``expand`` is not copied);
    initial_state: (B,H,P,N) or None.  Returns (y (B,L,H,P), final_state
    (B,H,P,N)), both in x's dtype; the recurrence and ``y_off`` are in f32.
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x, dt, Bm, Cm = (_pad_seq(t, pad) for t in (x, dt, Bm, Cm))
    Lp = L + pad
    nc = Lp // Q
    xc = x.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, H, N)
    Cc = Cm.reshape(B, nc, Q, H, N)

    y_diag, states, gamma = _ssd.ssd_chunk(xc, dtc, A, Bc, Cc)

    # inter-chunk recurrence over nc (lax.scan in the reference): prev[:, c]
    # is the state entering chunk c, (B,H,N,P) in f32; autograd carries the
    # gradients of states and gamma back through it
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None
         else initial_state.transpose(-1, -2).float())
    prevs = []
    for c in range(nc):
        prevs.append(s)
        s = s * gamma[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prevs, dim=1)

    # inter-chunk output: exp(cs_i) * C_i . prev_state
    cs = torch.cumsum(dtc.float() * A.float(), dim=2)         # (B,nc,Q,H)
    if Cc.stride(3) == 0:       # one C broadcast over the heads: no copies
        y_off = torch.einsum("bcin,bchnp->bcihp", Cc[:, :, :, 0].float(), prev)
    else:
        y_off = torch.einsum("bcihn,bchnp->bcihp", Cc.float(), prev)
    y_off = y_off * torch.exp(cs)[..., None]

    y = (y_diag.float() + y_off).reshape(B, Lp, H, P)[:, :L]
    return y.to(x.dtype), s.transpose(-1, -2).to(x.dtype)



# K1 and K2, dispatched by device (see kernels/stream.py)
elementwise = _stream.elementwise
stream_triad = _stream.stream_triad
