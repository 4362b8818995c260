"""The least time the H100 could take for K4's and K5's work.

One copy of the arithmetic that ``chip_smoke.py`` (phases 10, 14 and 32)
and ``tools/ssd_kernel_cost_torch.py`` hold the SSD kernels against.  A
bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and its
products over the tensor cores' bf16 rate.  Both kernels take their f32
operands (M, w∘x; V, dS) as two bf16 halves (hi, lo), so those products
count twice; the bound of the first designs, those products as f32 FMAs
on the CUDA cores, is returned beside it (``cuda_core_s``).

Shapes are the kernels': batch ``B``, sequence ``L`` (``L // Q`` chunks of
``Q``), ``H`` heads of width ``P``, state ``N``, ``G`` groups of B and C;
``itemsize`` is the bytes of an element of x, dt, B and C (and of dx).
"""
from __future__ import annotations

from dataclasses import dataclass

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12         # CUDA-core FMAs (the bounds' f32 variants)
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Bound:
    flops_cb: float            # exact bf16 x bf16 products (C.B^T, dM)
    flops_f32: float           # products with an f32 operand (hi and lo)
    bytes: float               # each input read once, each output written
    ops_s: float               # tensor-core time: cb + 2 x f32 over bf16
    bytes_s: float             # bytes over the HBM rate
    cuda_core_s: float         # the f32 products as FMAs on the CUDA cores

    @property
    def bound_ms(self) -> float:
        return max(self.ops_s, self.bytes_s) * 1e3

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_s >= self.bytes_s else "bytes"

    @property
    def flops(self) -> float:
        return self.flops_cb + self.flops_f32


def _bound(flops_cb: float, flops_f32: float, nbytes: float) -> Bound:
    return Bound(flops_cb=flops_cb, flops_f32=flops_f32, bytes=nbytes,
                 ops_s=(flops_cb + 2 * flops_f32) / PEAK_BF16_FLOPS,
                 bytes_s=nbytes / HBM_BYTES_PER_S,
                 cuda_core_s=max(flops_cb / PEAK_BF16_FLOPS,
                                 flops_f32 / PEAK_F32_FLOPS))


def ssd_chunk_fwd_bound(B: int, L: int, H: int, P: int, N: int, Q: int,
                        G: int = 1, itemsize: int = 2) -> Bound:
    """K4: y_diag, the chunks' end states and gamma.  C_i.B_j does not
    depend on the head: once per (batch, chunk, group), exact bf16
    products; M.X and the state B^T (w X) per head take an f32 operand."""
    nc = L // Q
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2                 # causal (i, j) pairs
    flops_cb = B * nc * G * 2 * pairs * N
    flops_f32 = cells * (2 * pairs * P + 2 * Q * N * P)
    nbytes = (2 * itemsize * B * L * H * P     # x read, y_diag written
              + itemsize * B * L * H           # dt
              + 2 * itemsize * B * L * G * N   # B, C
              + 4 * H                          # A
              + 4 * cells * N * P + 4 * cells)  # states, gamma (f32)
    return _bound(flops_cb, flops_f32, nbytes)


def ssd_chunk_bwd_bound(B: int, L: int, H: int, P: int, N: int, Q: int,
                        G: int = 1, itemsize: int = 2) -> Bound:
    """K5: dx, ddt, dB, dC and dA.  Exact bf16 products: C B^T once per
    group and dM = dy x^T per head; products with an f32 operand (M, V or
    dS) per head over the causal pairs: M^T dy, V B, V^T C; and B dS,
    (w x) dS^T."""
    nc = L // Q
    cells = B * nc * H
    pairs = Q * (Q + 1) // 2
    flops_cb = B * nc * G * 2 * pairs * N + cells * 2 * pairs * P
    flops_f32 = cells * (2 * pairs * (P + 2 * N) + 2 * 2 * Q * N * P)
    nbytes = (3 * itemsize * B * L * H * P         # x, dy read, dx written
              + itemsize * B * L * H + 4 * B * L * H  # dt read, ddt written
              + 2 * itemsize * B * L * G * N       # B, C
              + 4 * H                              # A
              + 4 * cells * N * P + 4 * cells      # dS, dgamma
              + 2 * 4 * B * L * H * N              # dB, dC per head, f32
              + 4 * cells)                         # da
    return _bound(flops_cb, flops_f32, nbytes)
