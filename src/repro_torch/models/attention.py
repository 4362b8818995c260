"""GQA attention: train/prefill (naive, blocked, flash) + cached decode.

Counterpart of ``repro.models.attention``, self- and cross-attention:

* ``blocked_attention`` — online softmax over KV blocks in plain PyTorch, the
  reference's default path;
* ``impl="flash"`` — ``kernels.ops.flash_attention``: the Hopper kernel for
  CUDA tensors, its plain version for CPU tensors;
* ``decode_attention`` — single-token attention against a KV cache;
* ``quantize_kv`` / ``decode_attention_q8`` — the int8 KV cache: per-(token,
  head) symmetric int8 values with f16 scales, which decode applies to the
  scores and the probabilities (the int8 tensors feed the products as they
  are, never dequantized first).

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


def project_q(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    return q


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    k, v = project_kv(p, x)
    return project_q(p, x), k, v


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


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of a K/V tensor
    (..., S, KV, HD) -> (int8 tensor, f16 scale (..., S, KV)).  The scale is
    max|x| times the f32 reciprocal of 127, as XLA compiles the reference's
    ``/ 127.0``, so both give the same bits."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) * (1.0 / 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def decode_attention_q8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        length: int) -> torch.Tensor:
    """Decode attention over an int8-quantized cache: q (B, 1, H, D), ck/cv
    (B, Smax, KVH, D) int8, scales (B, Smax, KVH).  The key scales multiply
    the scores and the value scales the probabilities, as in the reference,
    so the int8 values enter the products as they are; f32 throughout."""
    B, _, H, D = q.shape
    Smax, KVH = ck.shape[1], ck.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), ck.float())
    s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    invalid = torch.arange(Smax, device=q.device) >= length
    s = s.masked_fill(invalid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhgk,bkhd->bhgd", p, cv.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _write(buf: torch.Tensor, pos: int, x: torch.Tensor) -> None:
    """``buf[:, pos:pos + S] = x``, in place, in ``buf``'s dtype."""
    S = x.shape[1]
    if pos + S > buf.shape[1]:
        raise ValueError(f"decode at position {pos} overruns a cache of "
                         f"{buf.shape[1]}")
    buf[:, pos:pos + S] = x.to(buf.dtype)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    mode: str,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    cache_pos: Optional[int] = None,
                    cross_x: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    impl: str = "blocked",
                    kv_block: int = 1024):
    """Full attention sub-block: projections + rope + core + output proj.

    Returns (out, new_cache).  ``mode`` is train | prefill | decode.

    Self-attention: prefill returns the prompt's {k, v}.  Decode writes the
    new token's K/V into ``cache`` (one layer's (B, Smax, KVH, D) views) IN
    PLACE at ``cache_pos`` — the reference returns an updated copy; writing
    in place saves copying every layer's cache on every token — and returns
    ``cache``.  A cache with ``k_scale``/``v_scale`` is the int8 cache: the
    token's K/V go in quantized, with their f16 scales, and decode runs
    ``decode_attention_q8``.

    Cross-attention (``cross_x`` given, or a cache marked ``"cross"``): no
    rope; train and prefill project K/V from ``cross_x`` (the encoder's
    output), return them as the cross cache {k, v} and attend without a
    mask through ``blocked_attention`` (``naive_attention`` for
    ``impl="naive"``), never flash, as in the reference; decode attends over
    the whole cross cache and never writes it.
    """
    B, S, _ = x.shape
    if cross_x is not None or (cache is not None and cache.get("cross", False)):
        out, new_cache = _cross_attention(p, x, mode, cross_x, cache, impl,
                                          kv_block)
    else:
        out, new_cache = _self_attention(p, x, cfg, mode, positions, cache,
                                         cache_pos, causal, impl, kv_block)
    H, D = out.shape[2], out.shape[3]
    y = out.reshape(B, S, H * D) @ p["wo"].reshape(H * D, -1)
    return y, new_cache


def _cross_attention(p: dict, x: torch.Tensor, mode: str,
                     cross_x: Optional[torch.Tensor], cache: Optional[dict],
                     impl: str, kv_block: int):
    """The core of cross-attention (``attention_block``): (out, cache)."""
    q = project_q(p, x)
    if cross_x is not None:            # train / prefill: the cross cache
        k, v = project_kv(p, cross_x)
        new_cache = {"k": k, "v": v}
    else:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    if mode == "decode":
        out = decode_attention(q, k, v, k.shape[1])
    elif impl == "naive":
        out = naive_attention(q, k, v, causal=False)
    else:
        out = blocked_attention(q, k, v, causal=False, block=kv_block)
    return out, new_cache


def _self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: str,
                    positions: Optional[torch.Tensor], cache: Optional[dict],
                    cache_pos: Optional[int], causal: bool, impl: str,
                    kv_block: int):
    """The core of self-attention (``attention_block``): (out, cache)."""
    q, k, v = project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        new_cache = cache
        if "k_scale" in cache:                     # int8-quantized cache
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                _write(cache[name], cache_pos, val)
            out = decode_attention_q8(q, cache["k"], cache["v"],
                                      cache["k_scale"], cache["v_scale"],
                                      cache_pos + 1)
        else:
            _write(cache["k"], cache_pos, k)
            _write(cache["v"], cache_pos, v)
            out = decode_attention(q, cache["k"], cache["v"], cache_pos + 1)
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
    return out, new_cache
