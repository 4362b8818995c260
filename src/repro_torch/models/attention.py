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
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..core import aten
from ..kernels import ops as kops
from ..parallel.sharding import (contiguous_stride, current_rules,
                                 full_value, local_einsum,
                                 local_shape_and_offset, lsc, matmul,
                                 sum_grad)
from .layers import apply_rope
from .params import P

NEG_INF = -1e30


def _attn_seq_axis(q_shape) -> str:
    """'sp_seq' when neither heads nor head_dim can ride the tensor axis:
    attention activations then shard their sequence instead."""
    rules = current_rules()
    if rules is None:
        return "seq"
    spec = rules.act_spec(("batch", "seq", "heads", "head_dim"), q_shape)
    return "seq" if spec[2] is not None else "sp_seq"


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


def _sharded(t: DTensor, dim: int) -> bool:
    return any(p.is_shard(dim) for p in t.placements)


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """A decode step's ``q`` (B, 1, H, D) ready to split its heads into
    (KV heads, group): on a mesh torch 2.11's DTensor splits a sharded dim
    only where its leading part divides the mesh dim, so the heads are
    gathered first on a mesh dim the KV heads do not divide (the
    reference's layout constraint on the grouped query drops that axis
    too).  The prefill and training paths attend on each rank's heads
    instead (``_on_local_heads``)."""
    if not isinstance(q, DTensor):
        return q
    mesh = q.device_mesh
    pl = [Replicate() if p.is_shard(2) and kv_heads % mesh.size(i) else p
          for i, p in enumerate(q.placements)]
    return q if pl == list(q.placements) else q.redistribute(mesh, pl)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul.  A weight on a mesh whose
    head dim k is sharded and whose heads h are not (the 'head_dim'
    fallback, where the heads do not divide the model axis) is flattened
    k-major: DTensor flattens dims only when the sharded one leads."""
    d, h, k = w.shape
    if isinstance(w, DTensor) and _sharded(w, 2) and not _sharded(w, 1):
        y = matmul(x, w.transpose(1, 2).reshape(d, k * h))
        return y.unflatten(-1, (k, h)).transpose(-1, -2)
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


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


def _on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``fn(q, k, v)`` on each rank's query heads, for a ``q`` whose heads a
    mesh dim shards that the KV heads do not divide (chatglm3-6b's 2,
    nemotron-4-340b's, qwen1.5-110b's and grok-1-314b's 8 over the 16-way
    'model' axis); None for any other ``q``.

    Splitting such heads into (KV heads, group) is a view torch 2.11's
    DTensor refuses (2.13 makes it a strided shard).  Instead K and V are
    gathered on that mesh dim (their heads, or the head dim they shard
    there), and each rank attends with its local query heads against the
    KV heads those read: head h reads KV head h // G, and the rank's
    coordinate gives its heads' range.  The batch stays sharded as q's.
    The gradient of K and V is summed over the heads' mesh dims."""
    if not isinstance(q, DTensor):
        return None
    mesh, KVH = q.device_mesh, k.shape[2]
    heads = [m for m, p in enumerate(q.placements) if p.is_shard(2)]
    if not any(KVH % mesh.size(m) for m in heads) or any(
            p.is_shard() and p.dim not in (0, 2) for p in q.placements):
        return None
    G = q.shape[2] // KVH
    (*_, Hl, _), (*_, h0, _) = local_shape_and_offset(q.shape, mesh,
                                                      q.placements)
    if not (h0 // G == (h0 + Hl - 1) // G or (h0 % G == 0 and Hl % G == 0)):
        return None                    # heads straddling a group's edge
    kv_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in q.placements]
    kl, vl = (sum_grad(_full_heads(t, mesh, kv_pl).to_local(), mesh, heads)
              [:, :, h0 // G:(h0 + Hl - 1) // G + 1] for t in (k, v))
    out = fn(q.to_local(), kl, vl).contiguous()   # the global stride's layout
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape, stride=q.stride())


def _full_heads(t, mesh, placements):
    """``t`` (a DTensor or a plain tensor, replicated) redistributed to
    ``placements``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B, Sq, H, D); k, v: (B, Sk, KVH, D); H % KVH == 0.
    Returns (B, Sq, H, D).  fp32 accumulation.  K/V are zero-padded to a
    block multiple and the padding masked, as in the reference (a row that
    sees no key then averages V over the padded length, as there).  On a
    mesh whose heads the KV heads do not divide, each rank attends with
    its own heads (``_on_local_heads``).
    """
    local = _on_local_heads(
        lambda *a: blocked_attention(*a, causal=causal, q_offset=q_offset,
                                     block=block), q, k, v)
    if local is not None:
        return local
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qg = (q * scale).reshape(B, Sq, KVH, G, D).float()
    block = min(block, max(Sk, 1))
    qpos = q_offset + torch.arange(Sq, device=q.device)

    if isinstance(qg, DTensor):
        m, l, acc = _initial_carry(qg)
    else:
        m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, G, Sq, D), dtype=torch.float32,
                          device=q.device)
    pad = (0, 0, 0, 0, 0, (-Sk) % block)
    kp, vp = F.pad(k, pad), F.pad(v, pad)
    nb = kp.shape[1] // block

    def step(carry, i, kb, vb, qg, qpos):
        m, l, acc = carry
        s = local_einsum("bqhgd,bkhd->bhgqk", qg, kb.float())
        kpos = torch.arange(i * block, (i + 1) * block, device=q.device)
        invalid = kpos >= Sk
        if causal:
            invalid = invalid[None, :] | (qpos[:, None] < kpos[None, :])
        s = s.masked_fill(invalid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = local_einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        return (m_new, l, acc * alpha[..., None] + pv), None

    # the KV blocks stacked (nb, B, block, KVH, D) and scanned, as the
    # reference's lax.scan (core.aten.repeat)
    (m, l, acc), _ = aten.repeat(
        step, nb, (m, l, acc), xs=(_blocks(kp, nb), _blocks(vp, nb)),
        consts=(qg, qpos))
    acc, (m, l) = aten.with_carry_grad(acc, (m, l))
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)   # (B,KVH,G,Sq,D)->(B,Sq,H,D)
    return out.to(q.dtype)


def _initial_carry(qg: DTensor):
    """The online softmax's m, l (B, KVH, G, Sq) and acc (B, KVH, G, Sq, D)
    for ``qg`` (B, Sq, KVH, G, D) on a mesh: DTensors sharded as ``qg``
    shards the dims they share (its batch, KV heads and query positions),
    each rank allocating its local shape only, as the reference's scan
    carries them in the body's sharding."""
    mesh = qg.device_mesh
    B, Sq, KVH, G, D = qg.shape
    out = []
    for dims, value in (((0, 2, 3, 1), NEG_INF), ((0, 2, 3, 1), 0.0),
                        ((0, 2, 3, 1, 4), 0.0)):
        shape = tuple(qg.shape[d] for d in dims)
        pls = [Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
               else Replicate() for p in qg.placements]
        local, _ = local_shape_and_offset(shape, mesh, pls)
        t = torch.full(local, value, dtype=torch.float32,
                       device=qg.to_local().device)
        out.append(DTensor.from_local(t, mesh, pls, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=contiguous_stride(shape)))
    return tuple(out)


def _blocks(t: torch.Tensor, nb: int) -> torch.Tensor:
    """(B, nb x block, KVH, D) -> (nb, B, block, KVH, D), a view; each
    block is the slice ``t[:, i * block:(i + 1) * block]``.  A DTensor
    whose sequence is sharded (the sequence-parallel archs' K and V) is
    gathered on it first, once, where slicing each block would."""
    if isinstance(t, DTensor) and any(p.is_shard(1) for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(1) else p for p in t.placements])
    return t.unflatten(1, (nb, t.shape[1] // nb)).movedim(1, 0)


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
    cache_k = lsc(cache_k, "batch", "kvseq", "kv_heads", "head_dim")
    cache_v = lsc(cache_v, "batch", "kvseq", "kv_heads", "head_dim")
    qg = _grouped(q, KVH).reshape(B, KVH, G, D) / math.sqrt(D)
    qg = lsc(qg, "batch", "kv_heads", "q_group", "head_dim")
    s = local_einsum("bhgd,bkhd->bhgk", qg.float(), cache_k.float())
    s = lsc(s, "batch", "kv_heads", "q_group", "kvseq")
    invalid = torch.arange(Smax, device=q.device) >= length
    s = s.masked_fill(invalid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = lsc(p, "batch", "kv_heads", "q_group", "kvseq")
    out = local_einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype), cache_v)
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
    ck = lsc(ck, "batch", "kvseq", "kv_heads", "head_dim")
    cv = lsc(cv, "batch", "kvseq", "kv_heads", "head_dim")
    qg = _grouped(q, KVH).reshape(B, KVH, G, D) / math.sqrt(D)
    qg = lsc(qg, "batch", "kv_heads", "q_group", "head_dim")
    s = local_einsum("bhgd,bkhd->bhgk", qg.float(), ck.float())
    s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    s = lsc(s, "batch", "kv_heads", "q_group", "kvseq")
    invalid = torch.arange(Smax, device=q.device) >= length
    s = s.masked_fill(invalid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    p = lsc(p, "batch", "kv_heads", "q_group", "kvseq")
    out = local_einsum("bhgk,bkhd->bhgd", p, cv.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _write(buf: torch.Tensor, pos: int, x: torch.Tensor) -> None:
    """``buf[:, pos:pos + S] = x``, in place, in ``buf``'s dtype.

    A DTensor ``buf`` (a cache on a mesh, its sequence sharded on 'kvseq')
    is written shard by shard: each rank copies the rows of ``x`` that fall
    in its own slice of ``buf`` into its local tensor, since a slice across
    a sharded dim cannot be assigned in place through DTensor's dispatch."""
    S = x.shape[1]
    if pos + S > buf.shape[1]:
        raise ValueError(f"decode at position {pos} overruns a cache of "
                         f"{buf.shape[1]}")
    if not isinstance(buf, DTensor):
        buf[:, pos:pos + S] = x.to(buf.dtype)
        return
    full = full_value(x)                        # a collective: every rank
    shape, off = local_shape_and_offset(buf.shape, buf.device_mesh,
                                        buf.placements)
    lo, hi = max(pos, off[1]), min(pos + S, off[1] + shape[1])
    if lo >= hi:
        return
    rows = [slice(o, o + n) for o, n in zip(off, shape)]
    rows[1] = slice(lo - pos, hi - pos)
    buf.to_local()[:, lo - off[1]:hi - off[1]] = full[tuple(rows)].to(
        buf.dtype)


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
    out = lsc(out, "batch", _attn_seq_axis(out.shape), "heads", "head_dim")
    wo = p["wo"]
    if isinstance(wo, DTensor) and _sharded(wo, 1) and not _sharded(wo, 0):
        # the 'head_dim' fallback: flattened head-dim-major, as in _proj
        y = matmul(out.transpose(2, 3).reshape(B, S, D * H),
                   wo.transpose(0, 1).reshape(D * H, -1))
    else:
        y = matmul(out.reshape(B, S, H * D), wo.reshape(H * D, -1))
    return lsc(y, "batch", "rseq", "embed"), new_cache


def _cross_attention(p: dict, x: torch.Tensor, mode: str,
                     cross_x: Optional[torch.Tensor], cache: Optional[dict],
                     impl: str, kv_block: int):
    """The core of cross-attention (``attention_block``): (out, cache)."""
    q = project_q(p, x)
    q = lsc(q, "batch", _attn_seq_axis(q.shape), "heads", "head_dim")
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
    q = lsc(q, "batch", _attn_seq_axis(q.shape), "heads", "head_dim")
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
