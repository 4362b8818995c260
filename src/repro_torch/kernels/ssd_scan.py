"""Mamba2 SSD intra-chunk pass (K4) over (B, nc, Q, H, .) chunks.

Counterpart of ``repro.kernels.ssd_scan`` (its forward, ``ssd_chunk_pallas``).
Per (batch, chunk, head) cell it computes the cumulative decay
``cs = cumsum(dt * A)``, the intra-chunk output
``y[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j``, the chunk's end
state ``sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j`` and its decay
``gamma = exp(cs_last)``.  Two versions of one function live here:

* the CUDA kernel ``csrc/ssd_scan.cu`` (Hopper, built by ``_build``; every
  product on the bf16 tensor cores, its f32 operands split into hi and lo
  bf16 halves; C·Bᵀ formed once for the heads that share B and C), launched
  for tensors on a CUDA device;
* ``ssd_chunk_plain``, the same function in plain PyTorch with all math in
  f32, used for tensors on the CPU and as the kernel's yardstick on the card.

Both follow the reference's kernel path, not its chunked jnp path
(``models.ssm.ssd_chunked``), which rounds M to x's dtype in bf16.  Dispatch
is by the tensors' device and never falls back: a CUDA tensor launches the
kernel or raises.  ``ssd_chunk.launches`` counts kernel launches.  The two
versions are the two implementations of the ``torch.library`` custom op
``torch.ops.repro_torch.ssd_chunk_fwd``, so that a step captured with
``make_fx`` (``core.aten``) keeps each call as one node; its fake
implementation gives the outputs' shapes, dtypes and strides.

``ssd_chunk`` is differentiable (the reference's custom VJP of
``ssd_chunks_flat``): its backward is K5, the counterpart of
``ssd_chunk_bwd_pallas``, again in two versions of one function, the CUDA
kernel ``csrc/ssd_scan_bwd.cu`` for CUDA tensors and ``ssd_chunk_bwd_plain``
for CPU tensors, the two implementations of the custom op
``torch.ops.repro_torch.ssd_chunk_bwd``.  Autograd never differentiates the
plain forward, so the CPU runs the same backward plumbing as the card.
``ssd_chunk_bwd.launches`` counts K5's launches (one per backward).  The
ops' outputs are fresh contiguous tensors on both devices; their inputs go
in as they are, so a head-broadcast B or C reaches the kernels as a
stride-0 view.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_Q, MAX_P, MAX_N = 256, 128, 256      # the kernel's limits


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 5 or dt.dim() != 4 or A.dim() != 1:
        raise ValueError(f"want x (B,nc,Q,H,P), dt (B,nc,Q,H), A (H,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}")
    B, nc, Q, H, _ = x.shape
    if dt.shape != (B, nc, Q, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} or A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if Bm.dim() != 5 or Bm.shape[:4] != (B, nc, Q, H) or Cm.shape != Bm.shape:
        raise ValueError(f"want Bm, Cm (B,nc,Q,H,N) alike; got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if not (x.dtype == dt.dtype == Bm.dtype == Cm.dtype) \
            or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"want float32 or bfloat16 for x, dt, Bm, Cm alike; got "
                        f"{x.dtype}, {dt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, Bm, Cm on different devices")


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor):
    """Plain PyTorch version of the kernel: all math in f32, masked entries
    selected away (exp(cs_i - cs_j) overflows above the diagonal)."""
    Q = x.shape[2]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    cs = torch.cumsum(dtf * A.float(), dim=2)                 # (B,nc,Q,H)
    csh = cs.transpose(2, 3)                                  # (B,nc,H,Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)       # (B,nc,H,Q,Q)
    decay = torch.exp(csh[..., :, None] - csh[..., None, :])
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    M = torch.where(tril, scores * decay * dtf.transpose(2, 3)[..., None, :],
                    0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", M, xf).to(x.dtype)
    w = torch.exp(cs[:, :, -1:] - cs) * dtf                   # (B,nc,Q,H)
    states = torch.einsum("bcjhn,bcjhp->bchnp", Bf * w[..., None], xf)
    gamma = torch.exp(cs[:, :, -1])                           # (B,nc,H)
    return y, states, gamma


def _launch(x, dt, A, Bm, Cm, y, states, gamma) -> None:
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    lib = _build.load("ssd_scan").lib
    strides = (ctypes.c_longlong * 16)(
        *(s for t in (x, dt, Bm, Cm) for s in t.stride()[:4]))
    err = lib.repro_ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(), gamma.data_ptr(),
        _DTYPE_CODES[x.dtype], B, nc, Q, H, P, N, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan kernel failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    ssd_chunk.launches += 1


def _forward(x, dt, A, Bm, Cm):
    _check(x, dt, A, Bm, Cm)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    return _ssd_fwd_op(x, dt, A, Bm, Cm)


def _fwd_outputs(x, N: int):
    B, nc, Q, H, P = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((B, nc, H, N, P), dtype=torch.float32,
                        device=x.device),
            torch.empty((B, nc, H), dtype=torch.float32, device=x.device))


@torch.library.custom_op("repro_torch::ssd_chunk_fwd", mutates_args=(),
                         device_types="cpu")
def _ssd_fwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 as one op: the plain version on the CPU, the kernel on CUDA."""
    return tuple(t.contiguous() for t in ssd_chunk_plain(x, dt, A, Bm, Cm))


@_ssd_fwd_op.register_kernel("cuda")
def _ssd_fwd_cuda(x, dt, A, Bm, Cm):
    _check_kernel_shapes(x, Bm, Cm)
    y, states, gamma = _fwd_outputs(x, Bm.shape[-1])
    _launch(x, dt, A.float().contiguous(), Bm, Cm, y, states, gamma)
    return y, states, gamma


@_ssd_fwd_op.register_fake
def _ssd_fwd_fake(x, dt, A, Bm, Cm):
    return _fwd_outputs(x, Bm.shape[-1])


def _check_kernel_shapes(x, Bm, Cm) -> None:
    P, Q, N = x.shape[-1], x.shape[2], Bm.shape[-1]
    if Q > MAX_Q or P > MAX_P or N > MAX_N:
        raise ValueError(f"the CUDA kernels take Q <= {MAX_Q}, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got Q={Q}, P={P}, N={N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the last dimension of x, Bm and Cm must be "
                         "contiguous")


# ------------------------------------------------------------ backward (K5)
def ssd_chunk_bwd_plain(x, dt, A, Bm, Cm, dy, dstates, dgamma):
    """Plain PyTorch version of K5, the math of the reference's
    ``_ssd_chunk_bwd_kernel`` in f32 over the (B, nc, Q, H, .) layout.

    Recomputes cs, the decay matrix Γ, s = C Bᵀ and M, then forms the
    cotangents of x, dt, B, C and, per (batch, chunk, head) cell, of A.
    Returns (dx in x's dtype, ddt (B,nc,Q,H), dB and dC (B,nc,Q,H,N) per
    head, da (B,nc,H)), all but dx in f32.  Given f64 inputs it works and
    returns in f64: the yardstick chip_smoke.py holds both versions to.
    """
    Q = x.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    cell = lambda t: t.to(acc).transpose(2, 3)      # noqa: E731  (B,nc,H,Q,.)
    xf, dtf, Bf, Cf, dyf = (cell(t) for t in (x, dt, Bm, Cm, dy))
    Af = A.to(acc)[:, None]                                   # (H, 1)
    ds = dstates.to(acc)                                      # (B,nc,H,N,P)
    cs = torch.cumsum(dtf * Af, dim=-1)                       # (B,nc,H,Q)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    G = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    s = Cf @ Bf.transpose(-1, -2)
    K = s * G
    dtj = dtf[..., None, :]
    M = K * dtj
    dM = dyf @ xf.transpose(-1, -2)
    dx = M.transpose(-1, -2) @ dyf
    U = dM * K
    T1 = U * dtj                                              # dM∘M
    dcs = T1.sum(-1) - T1.sum(-2)
    ddt = U.sum(-2)
    V = dM * G * dtj                                          # ds
    dC = V @ Bf
    dB = V.transpose(-1, -2) @ Cf
    # the state path: state = Bᵀ diag(w) X, w = exp(cs_last - cs) dt
    expw = torch.exp(cs[..., -1:] - cs)
    w = expw * dtf
    R = Bf @ ds                                               # (Q, P)
    dx = dx + w[..., None] * R
    dw = (R * xf).sum(-1)
    dB = dB + (w[..., None] * xf) @ ds.transpose(-1, -2)
    dcs = dcs - dw * w
    last = (dw * w).sum(-1) + dgamma.to(acc) * torch.exp(cs[..., -1])
    dcs = torch.cat([dcs[..., :-1], dcs[..., -1:] + last[..., None]], dim=-1)
    # the cumsum's transpose, and A
    ddA = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = ddt + dw * expw + ddA * Af
    da = (ddA * dtf).sum(-1)
    back = lambda t: t.transpose(2, 3).contiguous()           # noqa: E731
    return back(dx).to(x.dtype), back(ddt), back(dB), back(dC), da


def _launch_bwd(x, dt, A, Bm, Cm, dy, dstates, dgamma, outs, scratch) -> None:
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    lib = _build.load("ssd_scan_bwd").lib
    strides = (ctypes.c_longlong * 20)(
        *(s for t in (x, dt, Bm, Cm, dy) for s in t.stride()[:4]))
    err = lib.repro_ssd_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), dstates.data_ptr(), dgamma.data_ptr(),
        *(t.data_ptr() for t in outs), scratch.data_ptr(),
        _DTYPE_CODES[x.dtype], B, nc, Q, H, P, N, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan backward kernel failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    ssd_chunk_bwd.launches += 1


def ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates, dgamma):
    """K5: the intra-chunk pass's backward (the reference's
    ``ssd_chunk_bwd_pallas``), in the port's (B, nc, Q, H, .) layout.

    x, dt, A, Bm, Cm as for ``ssd_chunk``; dy (B,nc,Q,H,P) in x's dtype;
    dstates (B,nc,H,N,P) and dgamma (B,nc,H) in f32.  Returns (dx in x's
    dtype, ddt (B,nc,Q,H), dB and dC (B,nc,Q,H,N) per head, da (B,nc,H)),
    all but dx in f32 and contiguous.

    On CUDA, x, dt, Bm, Cm and dy go in through their strides (a
    head-broadcast B or C is not copied); dy is made contiguous only if its
    last dimension is not.  dstates and dgamma are made contiguous.
    """
    _check(x, dt, A, Bm, Cm)
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dstates.shape != (B, nc, H, N, P) or dgamma.shape != (B, nc, H) \
            or dstates.dtype != torch.float32 or dgamma.dtype != torch.float32:
        raise ValueError(f"want f32 dstates (B,nc,H,N,P) and dgamma (B,nc,H); "
                         f"got {tuple(dstates.shape)} {dstates.dtype}, "
                         f"{tuple(dgamma.shape)} {dgamma.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    return _ssd_bwd_op(x, dt, A, Bm, Cm, dy, dstates, dgamma)


def _bwd_outputs(x, N: int):
    B, nc, Q, H, P = x.shape
    dev = x.device
    return (torch.empty(x.shape, dtype=x.dtype, device=dev),
            torch.empty((B, nc, Q, H), dtype=torch.float32, device=dev),
            torch.empty((B, nc, Q, H, N), dtype=torch.float32, device=dev),
            torch.empty((B, nc, Q, H, N), dtype=torch.float32, device=dev),
            torch.empty((B, nc, H), dtype=torch.float32, device=dev))


@torch.library.custom_op("repro_torch::ssd_chunk_bwd", mutates_args=(),
                         device_types="cpu")
def _ssd_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                dstates: torch.Tensor, dgamma: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """K5 as one op: the plain version on the CPU, the kernel on CUDA."""
    return ssd_chunk_bwd_plain(x, dt, A, Bm, Cm, dy, dstates, dgamma)


@_ssd_bwd_op.register_kernel("cuda")
def _ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, dstates, dgamma):
    _check_kernel_shapes(x, Bm, Cm)
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    B, nc, Q, H, _ = x.shape
    outs = _bwd_outputs(x, Bm.shape[-1])
    n_tiles = -(-Q // 64)
    # per cell, in f64: dw, column sums of U and of dM∘M, and one slot of row
    # sums of dM∘M per column tile (the kernel's layout; see ssd_scan_bwd.cu)
    scratch = torch.empty((B * nc * H, 3 + n_tiles, Q), dtype=torch.float64,
                          device=x.device)
    _launch_bwd(x, dt, A.float().contiguous(), Bm, Cm, dy,
                dstates.contiguous(), dgamma.contiguous(), outs, scratch)
    return outs


@_ssd_bwd_op.register_fake
def _ssd_bwd_fake(x, dt, A, Bm, Cm, dy, dstates, dgamma):
    return _bwd_outputs(x, Bm.shape[-1])


ssd_chunk_bwd.launches = 0


class _SSDChunk(torch.autograd.Function):
    """K4 forward, K5 backward; the reference's ``_chunks_fwd`` and
    ``_chunks_bwd`` with their casts."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _forward(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstates, dgamma):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if not any(ctx.needs_input_grad):
            return (None,) * 5
        dx, ddt, dB, dC, da = ssd_chunk_bwd(
            x, dt, A, Bm, Cm, dy.to(x.dtype), dstates.float(), dgamma.float())
        # per-head dB, dC in the inputs' dtype: a head-broadcast input's
        # expand then sums them over the heads, as the transpose of the
        # reference's jnp.repeat does; dA summed over batch and chunks
        grads = (dx, ddt.to(dt.dtype), da.sum((0, 1)).to(A.dtype),
                 dB.to(Bm.dtype), dC.to(Cm.dtype))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """Intra-chunk SSD pass (the reference's ``ssd_chunk_pallas``).

    x: (B, nc, Q, H, P); dt: (B, nc, Q, H) (post-softplus); A: (H,);
    Bm, Cm: (B, nc, Q, H, N) (already broadcast from groups).  x, dt, Bm and
    Cm share one dtype, float32 or bfloat16.  Returns (y_diag (B,nc,Q,H,P) in
    x's dtype, states (B,nc,H,N,P) f32, gamma (B,nc,H) f32).  Differentiable:
    the backward is K5 (``ssd_chunk_bwd``).

    On CUDA the inputs go in through their strides (the last dimension of x,
    Bm and Cm contiguous), so (B, L, H, .) tensors reshaped to chunks and a
    head-broadcast ``expand`` of B or C cost no copy; Q <= 256, P <= 128 and
    N <= 256.  The kernel factors exp(cs_i - cs_j) as a_i b_j below the
    diagonal 64 x 64 tile, which keeps both factors <= 1 where cs does not
    rise (dt * A <= 0, as the models' dt >= 0 and A < 0 give); it checks
    that per head and computes a head where it fails entry by entry.  Such
    a head's outputs are finite, and its states, gamma and bf16 y hold
    their usual tolerance of the plain version; its y from float32 inputs
    may not.  Where cs rises nothing decays, and the ~16 bits that the
    tensor cores' hi + lo halves keep of C, B, M and x add up to about 1e-3
    of y: with A = 0.002 and 0.005 (Q 256) y misses its 1e-3 by up to 1.7
    times, where the plain version stays within a tenth of it.
    """
    return _SSDChunk.apply(x, dt, A, Bm, Cm)


ssd_chunk.launches = 0
