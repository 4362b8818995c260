"""Mamba2 SSD intra-chunk pass (K4) over (B, nc, Q, H, .) chunks.

Counterpart of ``repro.kernels.ssd_scan`` (its forward, ``ssd_chunk_pallas``).
Per (batch, chunk, head) cell it computes the cumulative decay
``cs = cumsum(dt * A)``, the intra-chunk output
``y[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j``, the chunk's end
state ``sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j`` and its decay
``gamma = exp(cs_last)``.  Two versions of one function live here:

* the CUDA kernel ``csrc/ssd_scan.cu`` (Hopper, built by ``_build``; f32
  FMAs on the CUDA cores for f32 and bf16 inputs alike), launched for tensors
  on a CUDA device;
* ``ssd_chunk_plain``, the same function in plain PyTorch with all math in
  f32, used for tensors on the CPU and as the kernel's yardstick on the card.

Both follow the reference's kernel path, not its chunked jnp path
(``models.ssm.ssd_chunked``), which rounds M to x's dtype in bf16.  Dispatch
is by the tensors' device and never falls back: a CUDA tensor launches the
kernel or raises.  ``ssd_chunk.launches`` counts kernel launches.
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


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """Intra-chunk SSD pass (the reference's ``ssd_chunk_pallas``).

    x: (B, nc, Q, H, P); dt: (B, nc, Q, H) (post-softplus); A: (H,);
    Bm, Cm: (B, nc, Q, H, N) (already broadcast from groups).  x, dt, Bm and
    Cm share one dtype, float32 or bfloat16.  Returns (y_diag (B,nc,Q,H,P) in
    x's dtype, states (B,nc,H,N,P) f32, gamma (B,nc,H) f32).

    On CUDA the inputs go in through their strides (the last dimension of x,
    Bm and Cm contiguous), so (B, L, H, .) tensors reshaped to chunks and a
    head-broadcast ``expand`` of B or C cost no copy; Q <= 256, P <= 128 and
    N <= 256.
    """
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    if Q > MAX_Q or P > MAX_P or N > MAX_N:
        raise ValueError(f"the CUDA kernel takes Q <= {MAX_Q}, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got Q={Q}, P={P}, N={N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the last dimension of x, Bm and Cm must be "
                         "contiguous")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=x.device)
    gamma = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
    _launch(x, dt, A.float().contiguous(), Bm, Cm, y, states, gamma)
    return y, states, gamma


ssd_chunk.launches = 0
