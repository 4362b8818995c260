"""Plain PyTorch oracles for the kernels (independent formulations)."""
from __future__ import annotations

import math
from typing import Optional

import torch

# K1's and K2's plain versions are the references of the Table-1
# expressions and of STREAM Triad: one body each, in stream.py.
from .stream import elementwise_plain as elementwise_ref  # noqa: F401
from .stream import stream_triad_plain as stream_triad_ref  # noqa: F401


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Naive O(S^2) attention.  q: (B,H,Sq,D); k,v: (B,KVH,Sk,D)."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    kr = torch.repeat_interleave(k, G, dim=1)
    vr = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            initial_state: Optional[torch.Tensor] = None):
    """Sequential (token-by-token) SSD recurrence, in f32.

    x: (B,L,H,P); dt: (B,L,H); A: (H,); Bm, Cm: (B,L,H,N) (head-broadcast).
    Returns (y (B,L,H,P), final_state (B,H,P,N)), both in x's dtype.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(L):
        da = torch.exp(dtf[:, t] * Af)                        # (B,H)
        upd = (dtf[:, t, :, None] * Bf[:, t])[:, :, None, :] \
            * xf[:, t, :, :, None]                            # (B,H,P,N)
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(xf.shape)
    return y.to(x.dtype), state.to(x.dtype)

