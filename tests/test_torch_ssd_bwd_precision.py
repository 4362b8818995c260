"""The rounding scheme of the tensor-core K5 (``csrc/ssd_scan_bwd.cu``),
emulated in plain PyTorch on the CPU, against the same math in f64.

On the card every product of K5 runs on bf16 tensor cores with f32
accumulation.  s = C Bᵀ and dM = dy xᵀ take bf16 inputs as they are; the f32
operands M, V and dS are split into hi = bf16(v) and lo = bf16(v - hi), and
each product runs for hi and for lo against the same bf16 operand.  The f32
instance (f32 inputs) splits its inputs too and sums hi·hi + hi·lo + lo·hi.
Here the same splits are made, and each product is an f32 matmul of
bf16-valued tensors (exact products, f32 sums), and the sums of U = dM∘s∘G
and dM∘M by row and column, with all that follows them, in f64 as K5 takes
them, at mamba2-1.3b's and zamba2-1.2b's chunk shapes (Q 256, P 64, N 128
and 64; B and C shared by the heads or not) with the reference test's dt
and A.  The result is held within the tolerance that the cuda
tests and ``chip_smoke.py`` hold K5 to against f64: dx in bf16 within
2e-2 + 2e-2|f64|; the f32 outputs within 1e-3 + 1e-3|f64| plus 1e-4 of the
largest |f64| of the (batch, chunk, head) cell (da: of the head).  So the
scheme is shown to fit that tolerance without the card.  A single rounding
of M and V to bf16 is shown not to.
"""
import numpy as np
import pytest
import torch

from _ssd_split import (inputs, one, one_torch_thread,  # noqa: F401
                        prod as prod_tc, split as _split, worst_share)
from repro_torch.kernels import ssd_scan as ssd


def _inputs(seed, dtype, **shape):
    """x, dt, A, B, C (the reference test's distributions) and dy, dS, dg"""
    return inputs(seed, dtype, cotangents=True, **shape)


def _emulated(x, dt, A, Bm, Cm, dy, dstates, dgamma, split=_split):
    """K5's arithmetic on the card, product by product, in K5's outputs'
    layout.  ``split`` makes the (hi, lo) pair of an f32 operand."""
    f32_inputs = x.dtype == torch.float32
    cell = lambda t: t.float().transpose(2, 3)      # noqa: E731  (B,nc,H,Q,.)
    xf, dtf, Bf, Cf, dyf = (cell(t) for t in (x, dt, Bm, Cm, dy))

    def prod(a, b, a_split, b_split):
        """a @ b as K5 runs it: a split operand (hi, lo) against a bf16 one,
        or, with f32 inputs, both split and hi·hi + hi·lo + lo·hi."""
        return prod_tc(a, b, split if a_split else None,
                       _split if b_split else None)

    Af = A.float()[:, None]
    ds = dstates.float()
    cs = torch.cumsum(dtf * Af, dim=-1)
    Q = x.shape[2]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    G = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    s = prod(Cf, Bf.transpose(-1, -2), f32_inputs, f32_inputs)
    dM = prod(dyf, xf.transpose(-1, -2), f32_inputs, f32_inputs)
    dtj = dtf[..., None, :]
    K = s * G
    M = K * dtj
    U = dM * K
    T1 = U * dtj
    V = dM * G * dtj
    # the f32 operand (M, V, dS) is split; the input side only with f32 inputs
    dx = prod(M.transpose(-1, -2), dyf, True, f32_inputs)
    dB = prod(V.transpose(-1, -2), Cf, True, f32_inputs)
    dC = prod(V, Bf, True, f32_inputs)
    R = prod(ds.transpose(-1, -2), Bf.transpose(-1, -2), True,
             f32_inputs).transpose(-1, -2)                     # B dS
    xs = prod(ds, xf.transpose(-1, -2), True,
              f32_inputs).transpose(-1, -2)                    # x dSᵀ
    x_eff = sum(_split(xf)) if f32_inputs else xf
    expw = torch.exp(cs[..., -1:] - cs)
    w = expw * dtf
    dx = dx + w[..., None] * R
    dB = dB + w[..., None] * xs
    dw = (R * x_eff).sum(-1)
    # K5 sums U and T by row and column, and finishes, in f64
    Ud, Td, dwd, wd = U.double(), T1.double(), dw.double(), w.double()
    dcs = Td.sum(-1) - Td.sum(-2) - dwd * wd
    last = (dwd * wd).sum(-1) + dgamma.float() * torch.exp(cs[..., -1])
    dcs = torch.cat([dcs[..., :-1], dcs[..., -1:] + last[..., None]], dim=-1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = (Ud.sum(-2) + dwd * expw + ddA * Af).float()
    da = (ddA * dtf).sum(-1).float()
    back = lambda t: t.transpose(2, 3).contiguous()           # noqa: E731
    return back(dx).to(x.dtype), back(ddt), back(dB), back(dC), da


def _share_of_tolerance(got, exact, dtype):
    """The largest |err| / allowed over K5's outputs (the cuda tests' rule)."""

    def allowed(i, e):
        if i == 0 and dtype == torch.bfloat16:
            return 2e-2 * (1 + np.abs(e))
        group = {4: (0, 1), 1: (2,)}.get(i, (2, 4))   # head or cell
        return 1e-3 * (1 + np.abs(e)) + 1e-4 * np.abs(e).max(group, keepdims=True)
    return worst_share(got, exact, allowed)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("N", [128, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_split_scheme_holds_the_k5_tolerance(dtype, N, shared):
    args = _inputs(20 + N, dtype, N=N, shared=shared)
    got = _emulated(*args)
    exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in args))
    assert all(torch.isfinite(g).all() for g in got)
    assert got[0].dtype == dtype
    assert _share_of_tolerance(got, exact, dtype) <= 1.0


def test_split_scheme_matches_the_plain_version_at_small_shapes():
    """Where the chunk is one tile (Q 48, N 16, P 8), the emulation and the
    plain f32 version agree within the same tolerance of f64."""
    args = _inputs(3, torch.float32, Q=48, H=2, P=8, N=16)
    exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in args))
    assert _share_of_tolerance(_emulated(*args), exact, torch.float32) <= 1.0
    assert _share_of_tolerance(ssd.ssd_chunk_bwd_plain(*args), exact,
                               torch.float32) <= 1.0


def test_single_bf16_rounding_of_m_and_v_does_not_hold():
    """Why K5 splits: M, V and dS rounded once to bf16 leave the f32 outputs
    outside the tolerance at mamba2-1.3b's chunk shape."""
    args = _inputs(21, torch.bfloat16)
    exact = ssd.ssd_chunk_bwd_plain(*(t.double() for t in args))
    assert _share_of_tolerance(_emulated(*args, split=one), exact,
                               torch.bfloat16) > 1.0
