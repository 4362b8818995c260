"""Plain PyTorch oracles for the kernels (independent formulations)."""
from __future__ import annotations

import math

import torch


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
