"""Flash attention forward (online softmax, causal, GQA) over (B, H, S, D).

Counterpart of ``repro.kernels.flash_attention``.  Two versions of one
function live here:

* the CUDA kernel ``csrc/flash_attention.cu`` (Hopper, built by ``_build``;
  bf16 on the tensor cores, f32 as exact f32 FMAs), launched for tensors on
  a CUDA device;
* ``flash_attention_plain``, the same online softmax over K blocks in plain
  PyTorch with the same -1e30 mask semantics, used for tensors on the CPU and
  as the kernel's yardstick on the card.

Both are the two implementations of one ``torch.library`` custom op,
``torch.ops.repro_torch.flash_attention``, so that a step captured with
``make_fx`` (``core.aten``) keeps each call as one node; its fake
implementation gives the output's shape, dtype and strides.  Dispatch is
by the tensors' device and never falls back: a CUDA tensor launches the
kernel or raises.  ``flash_attention_bhsd.launches`` counts kernel
launches.  The kernel has no backward (nor has the reference's): on CUDA,
a call that would need a gradient raises instead of returning a result
without one; on the CPU the op's backward differentiates the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,Sq,D) and k, v (B,KVH,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if k.shape[2] == 0:
        raise ValueError("attention over an empty key sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"want float32 or bfloat16 for q, k, v alike; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same tiles, all math in f32."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    G = H // KVH
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, KVH, G, Sq, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, KVH, G, Sq, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = qf[:, :, :, q0:q0 + block_q]
        q1 = q0 + qb.shape[3]
        qpos = torch.arange(q0, q1, device=q.device)
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, Sk, block_k):
            if causal and k0 >= q1:
                break           # wholly above the diagonal: contributes 0
            kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
            if causal:
                kpos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                        p, vb)
            m = m_new
        out[:, :, :, q0:q0 + block_q] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


def _launch(q, k, v, out, causal: bool) -> None:
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention").lib
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], D, B, H, KVH, Sq, Sk, strides,
        1.0 / math.sqrt(D), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    flash_attention_bhsd.launches += 1


def _device_type(t: torch.Tensor) -> str:
    return t.device.type


def _out_like(q: torch.Tensor) -> torch.Tensor:
    """The output of q's device: on CUDA laid out (B, Sq, H, D) in memory,
    as the kernel writes it; on the CPU contiguous, as the plain version
    returns it."""
    B, H, Sq, D = q.shape
    if q.device.type == "cuda":
        return torch.empty((B, Sq, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    return torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, block_q: int, block_k: int) -> torch.Tensor:
    """K3 as one op: the plain version on the CPU (below), the kernel on
    CUDA (``_flash_cuda``)."""
    return flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                 block_k=block_k)


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, block_q, block_k):
    D = q.shape[3]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"not {D}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    out = _out_like(q)
    if q.dtype == torch.bfloat16 and any(      # 16-byte vector loads
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v, out)):
        raise ValueError("bf16 q, k, v must be 16-byte aligned with "
                         "strides in multiples of 8 elements")
    _launch(q, k, v, out, causal)
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, block_q, block_k):
    return _out_like(q)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, block_q, block_k = inputs
    ctx.save_for_backward(q, k, v)
    ctx.args = (causal, block_q, block_k)


def _flash_backward(ctx, grad):
    """The CPU's gradient: autograd through the plain version.  CUDA calls
    never get here (``flash_attention_bhsd`` refuses them a gradient)."""
    q, k, v = ctx.saved_tensors
    if q.device.type != "cpu":
        raise RuntimeError("the flash attention kernel (K3) has no backward")
    causal, block_q, block_k = ctx.args
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, block_q=block_q,
                                    block_k=block_k)
        grads = torch.autograd.grad(out, leaves, grad)
    return (*grads, None, None, None)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KVH, Sk, D).  Returns (B, H, Sq, D).

    Query head h reads KV head h // (H // KVH).  The causal mask is
    ``qpos >= kpos`` aligned top-left.  Output in q's dtype.  On the CPU
    ``block_q``/``block_k`` set the plain version's tiles; the CUDA kernel
    uses its own tiles for each head dim (the result does not depend on the
    tiling beyond rounding).  Any strides are accepted as long as the last
    dimension is contiguous; on CUDA the output is laid out (B, Sq, H, D) in
    memory, so the models' layout costs no copy.
    """
    _check(q, k, v)
    device = _device_type(q)
    if device not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    if device == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        # the kernel has no backward: refuse the gradient here, not when a
        # backward reaches it
        raise RuntimeError(
            "the flash attention kernel (K3) has no backward, as in the "
            "reference; train with attn_impl='blocked', or run it under "
            "torch.no_grad()")
    return _flash_op(q, k, v, causal, block_q, block_k)


flash_attention_bhsd.launches = 0
