"""GQA attention: train/prefill (naive, blocked, flash) + cached decode.

Counterpart of ``repro.models.attention`` for self-attention:

* ``blocked_attention`` — online softmax over KV blocks in plain PyTorch, the
  reference's default path;
* ``impl="flash"`` — ``kernels.ops.flash_attention``: the Hopper kernel for
  CUDA tensors, its plain version for CPU tensors;
* ``decode_attention`` — single-token attention against a KV cache.

Where the reference asks XLA for f32 products of low-precision operands
(``preferred_element_type=f32``), the port upcasts the operands: the products
of bf16 values are exact in f32, so only the summation order differs.
Masked scores are the finite -1e30 (never -inf) and ``l`` is clamped at
1e-30; a fully masked tile then contributes exactly 0 and nothing is NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import apply_rope
from .params import P

NEG_INF = -1e30


def attn_params(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = P((h, hd), ("heads", "head_dim"), "zeros")
        out["bk"] = P((kv, hd), ("kv_heads", "head_dim"), "zeros")
        out["bv"] = P((kv, hd), ("kv_heads", "head_dim"), "zeros")
    return out


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    k, v = project_kv(p, x)
    return q, k, v


def project_kv(p: dict, x: torch.Tensor):
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return k, v


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); H % KVH == 0.
    Returns (B, Sq, H, D).  fp32 accumulation.  K/V are zero-padded to a
    block multiple and the padding masked, as in the reference (a row that
    sees no key then averages V over the padded length, as there).
    """
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = (q * scale).reshape(B, Sq, KVH, G, D).float()
    block = min(block, max(Sk, 1))
    qpos = q_offset + torch.arange(Sq, device=q.device)

    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32, device=q.device)
    pad = (0, 0, 0, 0, 0, (-Sk) % block)
    kp, vp = F.pad(k, pad), F.pad(v, pad)
    for k0 in range(0, Sk, block):
        kb, vb = kp[:, k0:k0 + block], vp[:, k0:k0 + block]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        kpos = torch.arange(k0, k0 + block, device=q.device)
        invalid = kpos >= Sk
        if causal:
            invalid = invalid[None, :] | (qpos[:, None] < kpos[None, :])
        s = s.masked_fill(invalid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)   # (B,KVH,G,Sq,D)->(B,Sq,H,D)
    return out.to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Reference O(S^2)-memory attention (oracle for tests)."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, D) / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length: int) -> torch.Tensor:
    """q: (B, 1, H, D) against cache (B, Smax, KVH, D); positions >= length
    are masked.  fp32 softmax."""
    B, _, H, D = q.shape
    Smax, KVH = cache_k.shape[1], cache_k.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), cache_k.float())
    invalid = torch.arange(Smax, device=q.device) >= length
    s = s.masked_fill(invalid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    mode: str,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    cache_pos: Optional[int] = None,
                    causal: bool = True,
                    impl: str = "blocked",
                    kv_block: int = 1024):
    """Self-attention sub-block: projections + rope + core + output proj.

    Returns (out, new_cache).  ``mode`` is train | prefill | decode.  Prefill
    returns the prompt's {k, v}.  Decode writes the new token's K/V into
    ``cache`` (one layer's (B, Smax, KVH, D) views) IN PLACE at ``cache_pos``
    — the reference returns an updated copy; writing in place saves copying
    every layer's cache on every token — and returns ``cache``.
    """
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        ck, cv = cache["k"], cache["v"]
        if cache_pos + S > ck.shape[1]:
            raise ValueError(f"decode at position {cache_pos} overruns a "
                             f"cache of {ck.shape[1]}")
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        new_cache = cache
        out = decode_attention(q, ck, cv, cache_pos + 1)
    else:  # train / prefill
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        if impl == "naive":
            out = naive_attention(q, k, v, causal=causal)
        elif impl == "flash":
            out = kops.flash_attention(q, k, v, causal=causal)
        elif impl == "blocked":
            out = blocked_attention(q, k, v, causal=causal, block=kv_block)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")

    H, D = out.shape[2], out.shape[3]
    y = out.reshape(B, S, H * D) @ p["wo"].reshape(H * D, -1)
    return y, new_cache
