// Intra-chunk SSD (Mamba2 state-space duality) backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_chunk_bwd_kernel`, reached through
// `ssd_chunk_bwd_pallas` (the custom VJP `_chunks_bwd` of `ssd_chunks_flat`) in
// src/repro/kernels/ssd_scan.py.  It computes the same function.  For each
// (batch b, chunk c, head h), from the chunk's Q rows of x, dy (Q,P), dt (Q),
// B, C (Q,N), the scalar A[h], the state's cotangent dS (N,P) and gamma's dg,
// all in f32, with cs = cumsum(dt A), G[i,j] = exp(cs_i - cs_j) for j <= i
// (else 0), s = C Bᵀ, M = s∘G∘dt_j and dM = dy xᵀ:
//   dx    = Mᵀ dy + w∘(B dS)                 w_j = exp(cs_last - cs_j) dt_j
//   dB    = Vᵀ C + w∘(x dSᵀ)                 V = dM∘G∘dt_j
//   dC    = V B
//   dcs_i = rowsum_i(dM∘M) - colsum_i(dM∘M) - dw_i w_i,   dw = rowsum(B dS ∘ x),
//           plus sum_j dw_j w_j + dg exp(cs_last) at i = Q-1
//   ddA   = reverse cumsum of dcs
//   ddt_j = colsum_j(dM∘s∘G) + dw_j exp(cs_last - cs_j) + ddA_j A
//   da    = sum_j ddA_j dt_j                 (per cell; summed by the caller)
// dx is stored in x's dtype, the rest in f32; dB and dC per head.
//
// What bounds it on this card.  At mamba2-1.3b's training shape (B 4, nc 8,
// Q 256, H 64, P 64, N 128, bf16, B and C shared by the heads) the products
// it needs come to ~130 GFLOP on the bf16 tensor cores when each one with an
// f32 operand counts twice (below), 0.13 ms at 989 TFLOP/s, and the ~813 MB
// that must move (two thirds of it dB and dC, written per head in f32) take
// 0.24 ms at 3.35 TB/s: bound by bytes.
//
// What the design does about it:
//   * Every product runs on `wgmma` (hopper.cuh): bf16 operands from
//     128-byte-swizzled shared-memory tiles or registers, f32 accumulators.
//     s = C Bᵀ and dM = dy xᵀ take the bf16 inputs as they are (exact
//     products; the autograd Function rounds dy to x's dtype).  The f32
//     operands M, V and dS are split into hi = bf16(v) and lo = bf16(v - hi)
//     and each product runs twice, hi and lo, against the same bf16 operand:
//     ~16 mantissa bits, never a single rounding of M or V.  The f32
//     instance (f32 inputs) splits its inputs too and sums hi·hi + hi·lo +
//     lo·hi.  w is applied afterwards as a row scale: dx = w∘(B dS) + ...,
//     dB = w∘(x dSᵀ) + ....
//   * Two kinds of CTA, one warpgroup (128 threads) each, over 64 x 64 tiles
//     of the (Q,Q) matrices, which at Q = 256 do not fit in shared memory:
//       - column CTAs (`ssd_bwd_col_kernel`), one per (cell, column tile j,
//         part of dB), loop over the row tiles i >= j.  Per tile pair, in
//         two 32-column halves, they form sᵀ and dMᵀ (rows j, columns i)
//         once, and from them
//         Mᵀ and Vᵀ as register A fragments, which feed both dx_j += Mᵀ dy_i
//         and dB_j += Vᵀ C_i, plus the sums of dM∘s∘G and dM∘M that ddt and
//         dcs need; before the loop they form B_j dS (into dx) and x_j dSᵀ
//         (into dB) and dw;
//       - row CTAs (`ssd_bwd_row_kernel`), one per (cell, row tile i, part),
//         loop over the column tiles j <= i, form dM (rows i) and V, and sum
//         dC_i += V B_j.
//     So dM is formed twice per tile pair (once in each kind: dC needs V in
//     the other orientation, as an A fragment of its own) and s once per
//     tile pair and head.  With B and C shared by the heads (stride 0), s is
//     the same for every head; forming it once per (batch, chunk) is not done
//     here (it is ~12 % of the tensor-core work the kernel runs at mamba2's
//     shape).
//     Both kinds launch heaviest first; a finishing launch, one warp per
//     cell, adds up the row sums of dM∘M, forms dcs with the state and gamma
//     terms, its reverse cumsum, ddt and da.  The partial sums go through an
//     f64 scratch of (3 + tiles) x Q per cell, one slot per column tile: no
//     atomics, so the sum order is fixed and two runs give the same bits.
//     The sums of U and dM∘M over a row or a column, and all that the
//     finishing launch adds up, are taken in f64: dcs is the difference of
//     two such sums, and da adds up 256 of them, so f32 rounding there would
//     reach the tolerance at Q = 256 (the products stay f32).
//   * Loads: bf16 tiles go by `cp.async` straight into the swizzled layout,
//     the next row or column tile's while this one's products run (two
//     stages); f32 tiles are split to hi/lo bf16 on the way in (one stage).
//     A stride-0 head broadcast of B or C is read through its strides at no
//     copy.  Tiles that fall out of Q, N or P load as zeros.
//   * Entries above the diagonal are selected away, never multiplied by a
//     mask: exp(cs_i - cs_j) overflows there, and inf * 0 is NaN.  Only the
//     diagonal (and a ragged) tile pair is masked; below it G = a_i b_j,
//     a_i = exp(cs_i - c) and b_j = exp(c - cs_j) with c = cs at the last
//     row of tile j (both <= 1), so a tile pair takes 64 + 64 exponentials,
//     not 4096.  They come from __expf (ex2.approx; ~1e-6 relative, far
//     inside the tolerance).
//   * Every wgmma is issued between a fence and a commit, none on a branch
//     of its own, so ptxas does not serialize them (C7520); descriptors are
//     built where they are used (hopper.cuh), and the column CTA works in
//     32-column halves, so no instance spills.
//   * Any Q <= 256 (rows past Q load as zeros and are not stored), P <= 128
//     and N <= 256 (zero-padded to 64 / 128 and 64 / 128 / 256 columns).
//     dB and dC go in parts of at most 128 columns (64 where P = 128, whose
//     dx accumulator leaves no registers for more).  The column CTA of part
//     0 forms s, M and dx and stores dx and the sums; those of the other
//     parts, a launch of their own, form only dMᵀ and V for their columns
//     of dB (no B_j dS, no s), and each row CTA forms dM for its part of dC.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernels launch on the caller's stream, allocate nothing, and
// the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

using namespace hopper;
using namespace ssd;

constexpr int kThreads = 128;           // one warpgroup a CTA
constexpr int kTile = 64;               // rows and columns of a tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kRedStride = kTile + 8;   // a row of red: 2-way bank conflicts at most
// Params::vec bits: the tensor takes 16-byte loads
constexpr int kVecX = 1, kVecB = 2, kVecC = 4, kVecDy = 8, kVecDs = 16;

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dstates;   // (B,nc,H,N,P)
  const float* dgamma;    // (B,nc,H)
  void* dx;               // (B,nc,Q,H,P), x's dtype
  float* ddt;             // (B,nc,Q,H)
  float* dB;              // (B,nc,Q,H,N)
  float* dC;              // (B,nc,Q,H,N)
  float* da;              // (B,nc,H)
  double* scratch;        // (B*nc*H, 3 + tiles, Q)
  int B, nc, Q, H, P, N;
  long long x_s[4], dt_s[4], b_s[4], c_s[4], dy_s[4];  // (batch, chunk, row, head)
  long long ds_s[4];      // dstates as (batch, chunk, row n, head)
  int vec;
};

__host__ __device__ __forceinline__ int n_tiles(int Q) { return (Q + kTile - 1) / kTile; }

__device__ __forceinline__ long long out_row(const Params& p, int b, int c, int q, int h) {
  return ((static_cast<long long>(b) * p.nc + c) * p.Q + q) * p.H + h;
}

// Per-cell f64 scratch slots: 0 dw, 1 column sums of U = dM∘s∘G, 2 column
// sums of dM∘M, 3 + t the row sums of dM∘M over column tile t.
__device__ __forceinline__ double* scratch_slot(const Params& p, long long cell, int slot) {
  return p.scratch + (cell * (3 + n_tiles(p.Q)) + slot) * p.Q;
}

// dts[q] = dt, cs[q] = cumsum(dt * A) for the chunk's rows: each lane of
// warp 0 sums 8 consecutive rows, then the lanes' totals are scanned with
// shuffles (the same scan as the forward kernel's).
template <typename T>
__device__ void chunk_cumsum(const Params& p, int b, int c, int h, float* dts, float* cs) {
  const int tid = threadIdx.x, Q = p.Q;
  const T* dtg = static_cast<const T*>(p.dt);
  const float A = p.A[h];
  constexpr int kPer = kMaxQ / kThreads;   // the loads are issued before the stores
  float dtv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = tid + k * kThreads;
    dtv[k] = q < Q ? to_f32(dtg[at(p.dt_s, b, c, q, h)]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (tid + k * kThreads < Q) dts[tid + k * kThreads] = dtv[k];
  __syncthreads();
  if (tid < 32) {
    constexpr int kRun = kMaxQ / 32;
    float run = 0.f, v[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = tid * kRun + k;
      run += q < Q ? dts[q] * A : 0.f;
      v[k] = run;
    }
    float tot = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, tot, off);
      if (tid >= off) tot += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, tot, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = tid * kRun + k;
      if (q < Q) cs[q] = excl + v[k];
    }
  }
  __syncthreads();
}

// Rows q0 .. q0 + ROWS - 1 of a (batch, chunk, row, head, feature) tensor
// read through its strides, features f0 .. f0 + 8 PIECES - 1, into the
// swizzled bf16 tile at `hi`; an f32 tensor also writes the low halves of
// its split at `lo`.  Rows past Q and features past F are zero.  vec: the
// tensor takes 16-byte accesses (aligned base and strides, F % 8 == 0); bf16
// tiles then go by cp.async (the caller commits and waits).  Otherwise a
// thread loads up to U of its 16-byte pieces into registers before it
// converts and stores any of them, so U loads are in flight at once (the
// stores to shared memory are asm with a memory clobber, which no load
// moves across).
template <typename T, int ROWS, int PIECES, int U>
__device__ __forceinline__ void load_tile(uint32_t hi, uint32_t lo, const T* g,
                                          const long long s[4], int b, int c, int h, int q0,
                                          int Q, int f0, int F, bool vec) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kPer = ROWS * PIECES / kThreads;   // a thread's pieces
  constexpr int kU = kPer < U ? kPer : U;
  static_assert(ROWS * PIECES % kThreads == 0 && kPer % kU == 0, "whole batches");
  const auto where = [&](int i, int& r, int& k, int& q, int& f) {
    const int idx = threadIdx.x + i * kThreads;
    r = idx / PIECES;
    k = idx % PIECES;
    q = q0 + r;
    f = f0 + 8 * k;
  };
  if constexpr (!kSplit) {
    if (vec) {
#pragma unroll 4
      for (int i = 0; i < kPer; ++i) {   // (not all at once: their addresses take registers)
        int r, k, q, f;
        where(i, r, k, q, f);
        const bool in = q < Q && f < F;
        cp_async16(hi + swz(ROWS, r, k), in ? g + at(s, b, c, q, h) + f : g, in ? 16 : 0);
      }
      return;
    }
  }
#pragma unroll 1
  for (int i0 = 0; i0 < kPer; i0 += kU) {
    float v[kU][8];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int r, k, q, f;
      where(i0 + u, r, k, q, f);
      const bool in = q < Q && f < F;
      const T* src = in ? g + at(s, b, c, q, h) + f : g;
      if (vec && in) {
        load8(v[u], src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = in && f + e < F ? to_f32(src[e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int r, k, q, f;
      where(i0 + u, r, k, q, f);
      uint32_t h4[4], l4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split2(v[u][2 * e], v[u][2 * e + 1], h4[e], l4[e]);
      st_shared_v4(hi + swz(ROWS, r, k), h4);
      if constexpr (kSplit) st_shared_v4(lo + swz(ROWS, r, k), l4);
    }
  }
}

// Batches of load_tile: prologue tiles (registers to spare), and tiles loaded
// while accumulators are live (one piece at a time: registers that even the
// untaken synchronous path of a bf16 CTA would reserve).
constexpr int kBatchWide = 8, kBatchLive = 1;

// Shared memory of the two CTA kinds (bytes from a 1024-aligned base).  A
// bf16 tile of 64 rows x F features takes 128 F bytes; f32 inputs keep two
// (hi, lo), one after the other.  dS is always split.
template <typename T, int PT, int NT> struct Shape {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr uint32_t S = kSplit ? 2 : 1;          // copies of an input tile
  // dB, dC columns a CTA: at most 128, and 64 where P = 128, whose dx
  // accumulator leaves no registers for 128 columns of dB
  static constexpr int NB = PT == 128 ? 64 : (NT < 128 ? NT : 128);
  static constexpr int NPART = NT / NB;
  static constexpr int STAGES = kSplit ? 1 : 2;          // row/column tiles in flight
  static constexpr uint32_t XT = kTile * PT * 2;         // x or dy tile
  static constexpr uint32_t NTT = kTile * NT * 2;        // B or C tile, all of N
  static constexpr uint32_t NBT = kTile * NB * 2;        // B tile, one part
  static constexpr uint32_t DS = NB * PT * 2;            // one half of a dS slab
};

// Column CTA: x_j, B_j; then a ring of (dy_i, C_i) stages, which first holds
// a dS slab (hi, lo); then each thread's f64 sums of U and T over its two
// rows (colacc), dts, cs, w, and red: per (warp, lane / 4), the sums of T
// over the thread's two rows for each of the tile's 64 columns.
template <typename T, int PT, int NT> struct ColLayout : Shape<T, PT, NT> {
  using S_ = Shape<T, PT, NT>;
  static constexpr uint32_t STAGE = S_::S * (S_::XT + S_::NTT);
  static constexpr uint32_t X_OFF = 0, B_OFF = S_::S * S_::XT, RING_OFF = B_OFF + S_::S * S_::NTT;
  static constexpr uint32_t RING =
      S_::STAGES * STAGE > 2 * S_::DS ? S_::STAGES * STAGE : 2 * S_::DS;
  static constexpr uint32_t ACC_OFF = RING_OFF + RING, F_OFF = ACC_OFF + 8 * 4 * kThreads;
  static constexpr size_t kBytes = F_OFF + 4 * (2 * kMaxQ + kTile + 32 * kRedStride) + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};

// Row CTA: dy_i; then a ring of (x_j, B_j part) stages; then dts, cs.
template <typename T, int PT, int NT> struct RowLayout : Shape<T, PT, NT> {
  using S_ = Shape<T, PT, NT>;
  static constexpr uint32_t STAGE = S_::S * (S_::XT + S_::NBT);
  static constexpr uint32_t RING_OFF = S_::S * S_::XT;
  static constexpr uint32_t F_OFF = RING_OFF + S_::STAGES * STAGE;
  static constexpr size_t kBytes = F_OFF + 4 * 2 * kMaxQ + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};

// ---- column CTAs: (cell, column tile j, part of dB).  kDx: the CTA of part
// 0, which forms s, M and dx and stores dx, dw and the sums; otherwise (NPART
// > 1, a launch of its own) the CTA of part 1, 2, ..., which forms only dMᵀ
// and V for its part of dB.
template <typename T, int PT, int NT, bool kDx>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_col_kernel(const Params p) {
  using L = ColLayout<T, PT, NT>;
  constexpr bool kSplit = L::kSplit;
  constexpr int NB = L::NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  unsigned char* gen = smem_raw + (base - raw);   // generic pointer to base
  float* dts = reinterpret_cast<float*>(gen + L::F_OFF);
  float* cs = dts + kMaxQ;
  float* wj = cs + kMaxQ;
  float* red = wj + kTile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H, b = blockIdx.y;
  constexpr int kOthers = L::NPART > 1 ? L::NPART - 1 : 1;   // parts without dx
  const int jt = kDx ? blockIdx.z : blockIdx.z / kOthers;        // heaviest first
  const int part = kDx ? 0 : 1 + static_cast<int>(blockIdx.z) % kOthers;
  const int Q = p.Q, N = p.N, P = p.P, nt = n_tiles(Q);
  const int j0 = jt * kTile;
  const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h;
  const int r0 = 16 * warp + lane / 4;    // the thread's tile rows r0, r0 + 8
  const int cq = 2 * (lane % 4);          // its first column of each 8-column block
  const T* xg = static_cast<const T*>(p.x);
  const T* bg = static_cast<const T*>(p.Bm);
  const T* cg = static_cast<const T*>(p.Cm);
  const T* dyg = static_cast<const T*>(p.dy);
  const uint32_t xt = base + L::X_OFF, bt = base + L::B_OFF, ring = base + L::RING_OFF;

  load_tile<T, kTile, PT / 8, kBatchWide>(xt, xt + L::XT, xg, p.x_s, b, c, h, j0, Q, 0, P,
                                          p.vec & kVecX);
  if constexpr (kDx)
    load_tile<T, kTile, NT / 8, kBatchWide>(bt, bt + L::NTT, bg, p.b_s, b, c, h, j0, Q, 0, N,
                                            p.vec & kVecB);
  cp_async_commit();
  chunk_cumsum<T>(p, b, c, h, dts, cs);
  const float cs_last = cs[Q - 1];
  if (tid < kTile) wj[tid] = j0 + tid < Q ? expf(cs_last - cs[j0 + tid]) * dts[j0 + tid] : 0.f;

  // kDx: dx = B_j dS over the N / NB slabs of dS, the dB part's slab last;
  // then dB = x_j dS_partᵀ from that slab (the only slab the other parts load)
  float dx[PT / 2], db[NB / 2];
  for (int k = kDx ? 0 : L::NPART - 1; k < L::NPART; ++k) {
    const int ns = (part + 1 + k) % L::NPART;
    __syncthreads();  // the previous slab is read
    load_tile<float, NB, PT / 8, kBatchWide>(ring, ring + L::DS, p.dstates, p.ds_s, b, c, h,
                                             ns * NB, N, 0, P, p.vec & kVecDs);
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if constexpr (kDx) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NB / 16; ++kk) {
        const int ka = ns * (NB / 16) + kk;
        const uint64_t a = desc_k(bt, kTile, ka), d_hi = desc_mn(ring, NB, kk);
        Wgmma<PT>::template ss<1>(dx, a, d_hi, k > 0 || kk > 0);
        Wgmma<PT>::template ss<1>(dx, a, desc_mn(ring + L::DS, NB, kk), 1);
        if constexpr (kSplit)
          Wgmma<PT>::template ss<1>(dx, desc_k(bt + L::NTT, kTile, ka), d_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<PT / 2>(dx);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PT / 16; ++kk) {
    const uint64_t a = desc_k(xt, kTile, kk), d_hi = desc_k(ring, NB, kk);
    Wgmma<NB>::template ss<0>(db, a, d_hi, kk > 0);
    Wgmma<NB>::template ss<0>(db, a, desc_k(ring + L::DS, NB, kk), 1);
    if constexpr (kSplit) Wgmma<NB>::template ss<0>(db, desc_k(xt + L::XT, kTile, kk), d_hi, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<NB / 2>(db);

  // dw_j = (B_j dS)_j . x_j; then dx and dB start as w∘(B dS) and w∘(x dSᵀ)
  if constexpr (kDx) {
    const unsigned char* xs = gen + L::X_OFF;
    float dw[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < PT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), col = 8 * jj + cq + (e & 1);
        const uint32_t off = swz(kTile, r, col >> 3) + 2 * (col & 7);
        float xv = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xs + off));
        if constexpr (kSplit)
          xv += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(xs + L::XT + off));
        dw[e >> 1] = fmaf(dx[4 * jj + e], xv, dw[e >> 1]);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dw[u] += __shfl_xor_sync(0xffffffffu, dw[u], 1);
      dw[u] += __shfl_xor_sync(0xffffffffu, dw[u], 2);
      const int q = j0 + r0 + 8 * u;
      if (lane % 4 == 0 && q < Q) scratch_slot(p, cell, 0)[q] = dw[u];
    }
    const float w0 = wj[r0], w1 = wj[r0 + 8];
#pragma unroll
    for (int jj = 0; jj < PT / 8; ++jj) {
      dx[4 * jj] *= w0; dx[4 * jj + 1] *= w0; dx[4 * jj + 2] *= w1; dx[4 * jj + 3] *= w1;
    }
  }
  {
    const float w0 = wj[r0], w1 = wj[r0 + 8];
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj) {
      db[4 * jj] *= w0; db[4 * jj + 1] *= w0; db[4 * jj + 2] *= w1; db[4 * jj + 3] *= w1;
    }
  }

  // the row tiles i >= j: stage s holds dy_i (hi, lo) then C_i (hi, lo)
  const auto load_i = [&](int it, uint32_t st) {
    const uint32_t c_hi = st + L::S * L::XT;
    load_tile<T, kTile, PT / 8, kBatchLive>(st, st + L::XT, dyg, p.dy_s, b, c, h, it * kTile, Q,
                                            0, P, p.vec & kVecDy);
    load_tile<T, kTile, NT / 8, kBatchLive>(c_hi, c_hi + L::NTT, cg, p.c_s, b, c, h, it * kTile,
                                            Q, 0, N, p.vec & kVecC);
  };
  // the thread's f64 sums of U and T over its rows r0, r0 + 8 (f64: dcs
  // cancels them), in shared memory: registers are short
  double* colacc = reinterpret_cast<double*>(gen + L::ACC_OFF) + tid;   // [4][kThreads]
  if constexpr (kDx) {
#pragma unroll
    for (int k = 0; k < 4; ++k) colacc[k * kThreads] = 0.0;
  }
  // cs and dt of the thread's rows (garbage past Q, where nothing is used);
  // for the tile pairs below the diagonal tile, G = a_i b_j with a_i =
  // exp(cs_i - c), b_j = exp(c - cs_j) and c = cs at the tile's last row j:
  // both factors <= 1 (A < 0, dt > 0), and half the exponentials
  const float cs_j[2] = {cs[j0 + r0], cs[j0 + r0 + 8]}, dt_j[2] = {dts[j0 + r0], dts[j0 + r0 + 8]};
  const float c_end = cs[min(j0 + kTile, Q) - 1];
  const float b_j[2] = {__expf(c_end - cs_j[0]), __expf(c_end - cs_j[1])};
  const float bdt_j[2] = {b_j[0] * dt_j[0], b_j[1] * dt_j[1]};
  __syncthreads();  // the dS slab in the ring is read
  if constexpr (L::STAGES == 2) {
    load_i(jt, ring);
    cp_async_commit();
  }
  for (int it = jt; it < nt; ++it) {
    const int i0 = it * kTile;
    const uint32_t st = ring + (L::STAGES == 2 ? ((it - jt) & 1) : 0) * L::STAGE;
    if constexpr (L::STAGES == 2) {
      if (it + 1 < nt) {
        load_i(it + 1, ring + ((it - jt + 1) & 1) * L::STAGE);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_i(it, st);
      cp_async_commit();
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const bool full = it > jt && i0 + kTile <= Q;   // no entry of the pair is masked

    // per half of the row tile (32 columns i): sᵀ = B_j C_iᵀ and dMᵀ = x_j
    // dy_iᵀ (rows j, columns i); from them Mᵀ and Vᵀ as A fragments, U =
    // dM∘s∘G and T = dM∘M where j <= i < Q (selected: exp overflows above
    // the diagonal), summed by row j (the thread's two rows) and, through
    // red, by column i; then dx_j += Mᵀ dy_i and dB_j += Vᵀ C_i (the part's
    // columns), hi and lo.  Halves keep the live registers under 255.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t rows = half * 32 * 128;   // byte offset of row 32 half
      const uint32_t dyt = st, ct = st + L::S * L::XT;
      float s[16], dm[16];
      wgmma_fence();
      if constexpr (kDx) {
#pragma unroll
        for (int kk = 0; kk < NT / 16; ++kk) {
          const uint64_t a = desc_k(bt, kTile, kk), bb = desc_k(ct + rows, kTile, kk);
          Wgmma<32>::template ss<0>(s, a, bb, kk > 0);
          if constexpr (kSplit) {
            Wgmma<32>::template ss<0>(s, a, desc_k(ct + L::NTT + rows, kTile, kk), 1);
            Wgmma<32>::template ss<0>(s, desc_k(bt + L::NTT, kTile, kk), bb, 1);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        const uint64_t a = desc_k(xt, kTile, kk), bb = desc_k(dyt + rows, kTile, kk);
        Wgmma<32>::template ss<0>(dm, a, bb, kk > 0);
        if constexpr (kSplit) {
          Wgmma<32>::template ss<0>(dm, a, desc_k(dyt + L::XT + rows, kTile, kk), 1);
          Wgmma<32>::template ss<0>(dm, desc_k(xt + L::XT, kTile, kk), bb, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDx) reg_fence<16>(s);
      reg_fence<16>(dm);

      uint32_t mh[2][4], ml[2][4], vh[2][4], vl[2][4];
      float sumU[2] = {0.f, 0.f}, sumT[2] = {0.f, 0.f};   // this half's, by row
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 32 * half + 8 * jj + cq;   // the thread's columns col, col + 1
        float m4[4], v4[4], t4[4];
        if (full) {
          const float a[2] = {__expf(cs[i0 + col] - c_end), __expf(cs[i0 + col + 1] - c_end)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = e >> 1;
            if constexpr (kDx) {
              const float sa = s[4 * jj + e] * a[e & 1];
              const float uu = dm[4 * jj + e] * sa * b_j[u];
              m4[e] = sa * bdt_j[u];
              t4[e] = uu * dt_j[u];
              sumU[u] += uu;
              sumT[u] += t4[e];
            }
            v4[e] = dm[4 * jj + e] * a[e & 1] * bdt_j[u];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = e >> 1;
            const int qj = j0 + r0 + 8 * u, qi = i0 + col + (e & 1);
            float m = 0.f, v = 0.f, t = 0.f;
            if (qj <= qi && qi < Q) {
              const float g = __expf(cs[qi] - cs_j[u]), dtj = dt_j[u];
              if constexpr (kDx) {
                const float k = s[4 * jj + e] * g;
                const float uu = dm[4 * jj + e] * k;
                m = k * dtj;
                t = uu * dtj;
                sumU[u] += uu;
                sumT[u] += t;
              }
              v = dm[4 * jj + e] * g * dtj;
            }
            m4[e] = m;
            v4[e] = v;
            t4[e] = t;
          }
        }
        if constexpr (kDx) {
          float* rt = red + (warp * 8 + lane / 4) * kRedStride + col;
          rt[0] = t4[0] + t4[2];
          rt[1] = t4[1] + t4[3];
          pack_frag(mh, ml, jj, m4);
        }
        pack_frag(vh, vl, jj, v4);
      }
      if constexpr (kDx) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          colacc[u * kThreads] += sumU[u];
          colacc[(2 + u) * kThreads] += sumT[u];
        }
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * half + kk;   // the k-step over the tile's rows i
        if constexpr (kDx) {
          const uint64_t d = desc_mn(dyt, kTile, ks);
          Wgmma<PT>::template rs<1>(dx, mh[kk], d);
          Wgmma<PT>::template rs<1>(dx, ml[kk], d);
          if constexpr (kSplit)
            Wgmma<PT>::template rs<1>(dx, mh[kk], desc_mn(dyt + L::XT, kTile, ks));
        }
        const uint64_t e = desc_mn(ct + part * NB * 128, kTile, ks);
        Wgmma<NB>::template rs<1>(db, vh[kk], e);
        Wgmma<NB>::template rs<1>(db, vl[kk], e);
        if constexpr (kSplit)
          Wgmma<NB>::template rs<1>(db, vh[kk], desc_mn(ct + L::NTT + part * NB * 128, kTile, ks));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDx) reg_fence<PT / 2>(dx);
      reg_fence<NB / 2>(db);
    }
    __syncthreads();  // red is written; the stage is read
    // the row sums of T over the tile's 64 columns j, for the 64 rows i: the
    // 32 partial rows of red in a fixed order
    if (kDx && tid < kTile && i0 + tid < Q) {
      double sum = 0.0;
      for (int k = 0; k < 32; ++k) sum += red[k * kRedStride + tid];
      scratch_slot(p, cell, 3 + jt)[i0 + tid] = sum;
    }
  }

  // the column sums of U and T over every row tile i, for the thread's rows
  if constexpr (kDx) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      double colU = colacc[u * kThreads], colT = colacc[(2 + u) * kThreads];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        colU += __shfl_xor_sync(0xffffffffu, colU, off);
        colT += __shfl_xor_sync(0xffffffffu, colT, off);
      }
      const int q = j0 + r0 + 8 * u;
      if (lane % 4 == 0 && q < Q) {
        scratch_slot(p, cell, 1)[q] = colU;
        scratch_slot(p, cell, 2)[q] = colT;
      }
    }
  }
  T* dxg = static_cast<T*>(p.dx);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = j0 + r0 + 8 * u;
    if (q >= Q) continue;
    const long long row = out_row(p, b, c, q, h);
    if constexpr (kDx) {
#pragma unroll
      for (int jj = 0; jj < PT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pp = 8 * jj + cq + e;
          if (pp < P) store(dxg + row * P + pp, dx[4 * jj + 2 * u + e]);
        }
    }
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj) {
      const int n = part * NB + 8 * jj + cq;
      float* dst = p.dB + row * N + n;
      if ((N & 1) == 0 && n < N) {
        *reinterpret_cast<float2*>(dst) = make_float2(db[4 * jj + 2 * u], db[4 * jj + 2 * u + 1]);
      } else {
        if (n < N) dst[0] = db[4 * jj + 2 * u];
        if (n + 1 < N) dst[1] = db[4 * jj + 2 * u + 1];
      }
    }
  }
}

// ---- row CTAs: (cell, row tile i, part of dC); dC_i = sum_j<=i V B_j.
template <typename T, int PT, int NT>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_row_kernel(const Params p) {
  using L = RowLayout<T, PT, NT>;
  constexpr bool kSplit = L::kSplit;
  constexpr int NB = L::NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* dts = reinterpret_cast<float*>(smem_raw + (base - raw) + L::F_OFF);
  float* cs = dts + kMaxQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H, b = blockIdx.y;
  const int Q = p.Q, N = p.N, P = p.P, nt = n_tiles(Q);
  const int it = nt - 1 - static_cast<int>(blockIdx.z) / L::NPART;  // heaviest first
  const int part = blockIdx.z % L::NPART;
  const int i0 = it * kTile;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const T* xg = static_cast<const T*>(p.x);
  const T* bg = static_cast<const T*>(p.Bm);
  const T* dyg = static_cast<const T*>(p.dy);
  const uint32_t dyt = base, ring = base + L::RING_OFF;

  load_tile<T, kTile, PT / 8, kBatchWide>(dyt, dyt + L::XT, dyg, p.dy_s, b, c, h, i0, Q, 0, P,
                                          p.vec & kVecDy);
  // stage s holds x_j (hi, lo) then the part's columns of B_j (hi, lo)
  const auto load_j = [&](int jt, uint32_t st) {
    const uint32_t b_hi = st + L::S * L::XT;
    load_tile<T, kTile, PT / 8, kBatchLive>(st, st + L::XT, xg, p.x_s, b, c, h, jt * kTile, Q,
                                            0, P, p.vec & kVecX);
    load_tile<T, kTile, NB / 8, kBatchLive>(b_hi, b_hi + L::NBT, bg, p.b_s, b, c, h, jt * kTile,
                                            Q, part * NB, N, p.vec & kVecB);
  };
  if constexpr (L::STAGES == 2) {
    load_j(0, ring);
    cp_async_commit();
  }
  chunk_cumsum<T>(p, b, c, h, dts, cs);

  float dc[NB / 2];
#pragma unroll
  for (int k = 0; k < NB / 2; ++k) dc[k] = 0.f;
  const float cs_i[2] = {cs[i0 + r0], cs[i0 + r0 + 8]};   // the thread's rows
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const uint32_t st = ring + (L::STAGES == 2 ? (jt & 1) : 0) * L::STAGE;
    if constexpr (L::STAGES == 2) {
      if (jt + 1 <= it) {
        load_j(jt + 1, ring + ((jt + 1) & 1) * L::STAGE);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_j(jt, st);
      cp_async_commit();
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t xt = st, bt = st + L::S * L::XT;

    // dM = dy_i x_jᵀ (rows i, columns j)
    float dm[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PT / 16; ++kk) {
      const uint64_t a = desc_k(dyt, kTile, kk), bb = desc_k(xt, kTile, kk);
      Wgmma<64>::template ss<0>(dm, a, bb, kk > 0);
      if constexpr (kSplit) {
        Wgmma<64>::template ss<0>(dm, a, desc_k(xt + L::XT, kTile, kk), 1);
        Wgmma<64>::template ss<0>(dm, desc_k(dyt + L::XT, kTile, kk), bb, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<32>(dm);

    // V = dM∘G∘dt_j where j <= i < Q, as A fragments; below the diagonal
    // tile G = a_i b_j as in the column CTAs, c = cs at the tile's last row j
    uint32_t vh[4][4], vl[4][4];
    const bool full = jt < it && i0 + kTile <= Q;
    const float c_end = cs[j0 + kTile - 1];
    const float a_i[2] = {__expf(cs_i[0] - c_end), __expf(cs_i[1] - c_end)};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float v4[4];
      if (full) {
        const int qj = j0 + 8 * jj + cq;
        const float bdt[2] = {__expf(c_end - cs[qj]) * dts[qj],
                              __expf(c_end - cs[qj + 1]) * dts[qj + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) v4[e] = dm[4 * jj + e] * a_i[e >> 1] * bdt[e & 1];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, qi = i0 + r0 + 8 * u, qj = j0 + 8 * jj + cq + (e & 1);
          v4[e] = qj <= qi && qi < Q ? dm[4 * jj + e] * __expf(cs_i[u] - cs[qj]) * dts[qj] : 0.f;
        }
      }
      pack_frag(vh, vl, jj, v4);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc_mn(bt, kTile, kk);
      Wgmma<NB>::template rs<1>(dc, vh[kk], d);
      Wgmma<NB>::template rs<1>(dc, vl[kk], d);
      if constexpr (kSplit) Wgmma<NB>::template rs<1>(dc, vh[kk], desc_mn(bt + L::NBT, kTile, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<NB / 2>(dc);
    __syncthreads();  // the stage is read
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int q = i0 + r0 + 8 * u;
    if (q >= Q) continue;
    float* dst0 = p.dC + out_row(p, b, c, q, h) * N;
#pragma unroll
    for (int jj = 0; jj < NB / 8; ++jj) {
      const int n = part * NB + 8 * jj + cq;
      if ((N & 1) == 0 && n < N) {
        *reinterpret_cast<float2*>(dst0 + n) =
            make_float2(dc[4 * jj + 2 * u], dc[4 * jj + 2 * u + 1]);
      } else {
        if (n < N) dst0[n] = dc[4 * jj + 2 * u];
        if (n + 1 < N) dst0[n + 1] = dc[4 * jj + 2 * u + 1];
      }
    }
  }
}

// ---- one warp per cell: dcs, its reverse cumsum, ddt and da.
template <typename T>
__global__ void __launch_bounds__(32) ssd_bwd_finish_kernel(const Params p) {
  constexpr int kPer = kMaxQ / 32;
  __shared__ float dt_row[kMaxQ], cs_row[kMaxQ];   // the lane's rows, out of registers
  const int lane = threadIdx.x;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int b = blockIdx.z;
  const int Q = p.Q;
  const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h;
  const T* dtg = static_cast<const T*>(p.dt);
  const float A = p.A[h];

  // cs of this lane's 8 rows, scanned across the warp
  float dtv[kPer], cs[kPer];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = lane * kPer + k;
    dtv[k] = q < Q ? to_f32(dtg[at(p.dt_s, b, c, q, h)]) : 0.f;
    run += dtv[k] * A;
    cs[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) cs[k] += excl;
  const int last = Q - 1;
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (k == last % kPer) mine = cs[k];
  const float cs_last = __shfl_sync(0xffffffffu, mine, last / kPer);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    dt_row[lane * kPer + k] = dtv[k];
    cs_row[lane * kPer + k] = cs[k];
  }

  // the sums of dM∘M and what follows them in f64: dcs is a difference of
  // two large sums, and its reverse cumsum and da add 256 of them up
  const double* dw = scratch_slot(p, cell, 0);
  const double* colU = scratch_slot(p, cell, 1);
  const double* colT = scratch_slot(p, cell, 2);
  double dcs[kPer];
  double dww = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = lane * kPer + k;
    dcs[k] = 0.0;
    if (q < Q) {
      double rowT = 0.0;
      for (int t = 0; t <= q / kTile; ++t) rowT += scratch_slot(p, cell, 3 + t)[q];
      const double w = expf(cs_last - cs_row[q]) * dt_row[q];
      dcs[k] = rowT - colT[q] - dw[q] * w;
      dww = fma(dw[q], w, dww);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dww += __shfl_xor_sync(0xffffffffu, dww, off);
  if (lane == last / kPer) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k == last % kPer) dcs[k] += dww + p.dgamma[cell] * expf(cs_last);
  }

  // ddA = reverse cumsum of dcs: suffix sums in the lane (in place), then
  // across lanes
  double s = 0.0;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    s += dcs[k];
    dcs[k] = s;
  }
  double tail = s;  // inclusive suffix scan of the lanes' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, tail, off);
    if (lane + off < 32) tail += o;
  }
  double after = __shfl_down_sync(0xffffffffu, tail, 1);
  if (lane == 31) after = 0.0;

  double da = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = lane * kPer + k;
    if (q >= Q) continue;
    const double ddA = dcs[k] + after;
    p.ddt[((static_cast<long long>(b) * p.nc + c) * Q + q) * p.H + h] =
        static_cast<float>(colU[q] + dw[q] * expf(cs_last - cs_row[q]) + ddA * A);
    da = fma(ddA, static_cast<double>(dt_row[q]), da);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0) p.da[cell] = static_cast<float>(da);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int PT, int NT>
cudaError_t launch_tiles(const Params& p, cudaStream_t stream) {
  using CL = ColLayout<T, PT, NT>;
  using RL = RowLayout<T, PT, NT>;
  const int nt = n_tiles(p.Q);
  cudaError_t err = allow_smem(ssd_bwd_col_kernel<T, PT, NT, true>, CL::kBytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_col_kernel<T, PT, NT, true>
      <<<dim3(p.nc * p.H, p.B, nt), kThreads, CL::kBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (CL::NPART > 1) {   // the other parts of dB
    if ((err = allow_smem(ssd_bwd_col_kernel<T, PT, NT, false>, CL::kBytes)) != cudaSuccess)
      return err;
    ssd_bwd_col_kernel<T, PT, NT, false>
        <<<dim3(p.nc * p.H, p.B, nt * (CL::NPART - 1)), kThreads, CL::kBytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = allow_smem(ssd_bwd_row_kernel<T, PT, NT>, RL::kBytes)) != cudaSuccess) return err;
  ssd_bwd_row_kernel<T, PT, NT>
      <<<dim3(p.nc * p.H, p.B, nt * CL::NPART), kThreads, RL::kBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // after the column CTAs on the same stream: reads their scratch
  ssd_bwd_finish_kernel<T><<<dim3(p.nc * p.H, 1, p.B), 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// P and N zero-padded to 64 or 128, and 64, 128 or 256 columns.
template <typename T, int PT>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  if (p.N <= 64) return launch_tiles<T, PT, 64>(p, stream);
  if (p.N <= 128) return launch_tiles<T, PT, 128>(p, stream);
  return launch_tiles<T, PT, 256>(p, stream);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.P <= 64 ? launch_p<T, 64>(p, stream) : launch_p<T, 128>(p, stream);
}

// Dynamic shared memory of a column (kind 0) or row (kind 1) CTA.
template <typename T, int PT, int NT>
int smem_bytes(int kind) {
  return static_cast<int>(kind == 0 ? ColLayout<T, PT, NT>::kBytes : RowLayout<T, PT, NT>::kBytes);
}

template <typename T, int PT>
int smem_bytes_p(int N, int kind) {
  if (N <= 64) return smem_bytes<T, PT, 64>(kind);
  if (N <= 128) return smem_bytes<T, PT, 128>(kind);
  return smem_bytes<T, PT, 256>(kind);
}

template <typename T>
int smem_bytes_t(int P, int N, int kind) {
  return P <= 64 ? smem_bytes_p<T, 64>(N, kind) : smem_bytes_p<T, 128>(N, kind);
}

template <int PT>
int parts_p(int N) {
  return N <= 64 ? Shape<float, PT, 64>::NPART
                 : N <= 128 ? Shape<float, PT, 128>::NPART : Shape<float, PT, 256>::NPART;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, Bm, Cm, dy and dx alike; A,
// dstates, dgamma and every other output are f32.  x, dy (B,nc,Q,H,P), dt
// (B,nc,Q,H), Bm and Cm (B,nc,Q,H,N) are read through `strides`: 20 element
// strides, the (batch, chunk, row, head) strides of x, dt, Bm, Cm and dy in
// that order; the last dimension of x, dy, Bm and Cm is contiguous.  dstates
// (B,nc,H,N,P) and dgamma (B,nc,H) are contiguous.  dx (B,nc,Q,H,P), ddt
// (B,nc,Q,H), dB and dC (B,nc,Q,H,N) and da (B,nc,H) are written contiguous;
// scratch holds B*nc*H*(3 + ceil(Q/64))*Q doubles.  Q <= 256, P <= 128,
// N <= 256.
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* dy, const void* dstates,
                                   const void* dgamma, void* dx, void* ddt, void* dB, void* dC,
                                   void* da, void* scratch, int dtype, int B, int nc, int Q,
                                   int H, int P, int N, const long long* strides, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || (dtype != 0 && dtype != 1) || B > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.dy = dy;
  p.dstates = static_cast<const float*>(dstates);
  p.dgamma = static_cast<const float*>(dgamma);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.da = static_cast<float*>(da);
  p.scratch = static_cast<double*>(scratch);
  p.B = B;
  p.nc = nc;
  p.Q = Q;
  p.H = H;
  p.P = P;
  p.N = N;
  for (int k = 0; k < 4; ++k) {
    p.x_s[k] = strides[k];
    p.dt_s[k] = strides[4 + k];
    p.b_s[k] = strides[8 + k];
    p.c_s[k] = strides[12 + k];
    p.dy_s[k] = strides[16 + k];
  }
  const long long NP = static_cast<long long>(N) * P;
  p.ds_s[0] = nc * H * NP;
  p.ds_s[1] = H * NP;
  p.ds_s[2] = P;
  p.ds_s[3] = NP;
  const int elem = dtype == 0 ? 4 : 2;
  p.vec = (takes_vec(x, p.x_s, P, elem) ? kVecX : 0) | (takes_vec(Bm, p.b_s, N, elem) ? kVecB : 0) |
          (takes_vec(Cm, p.c_s, N, elem) ? kVecC : 0) |
          (takes_vec(dy, p.dy_s, P, elem) ? kVecDy : 0) |
          (takes_vec(dstates, p.ds_s, P, 4) ? kVecDs : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
}

// The parts that the column and row CTAs split dB and dC into (each part's
// CTAs form their own dM; only part 0's column CTA forms s) for P and N, or
// -1.
extern "C" int repro_ssd_chunk_bwd_parts(int P, int N) {
  if (P <= 0 || P > kMaxP || N <= 0 || N > kMaxN) return -1;
  return P <= 64 ? parts_p<64>(N) : parts_p<128>(N);
}

// Dynamic shared memory (bytes) of a column (kind 0) or row (kind 1) CTA of
// the instance that takes dtype, P and N, or -1.
extern "C" int repro_ssd_chunk_bwd_smem_bytes(int dtype, int P, int N, int kind) {
  if (P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || (dtype != 0 && dtype != 1) ||
      (kind != 0 && kind != 1))
    return -1;
  return dtype == 0 ? smem_bytes_t<float>(P, N, kind) : smem_bytes_t<__nv_bfloat16>(P, N, kind);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
