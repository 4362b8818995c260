"""Public wrappers for the kernels, in the models' layouts.

Dispatch is by the tensors' device: a CUDA tensor goes to the Hopper kernel
(or the call raises), a CPU tensor to the kernel's plain PyTorch version.
There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, S, H, D)-layout flash attention (matches models.attention)."""
    out = _fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   block_q=block_q, block_k=block_k)
    return out.transpose(1, 2)
