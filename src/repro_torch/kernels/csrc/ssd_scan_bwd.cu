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
// What bounds it on this card.  At mamba2-1.3b's training shapes (Q = 256,
// N = 128, P = 64) a cell needs about 59 MFLOP of f32 products for 0.35 MB of
// traffic, so it is bound by arithmetic.  This version runs f32 FMAs on the
// CUDA cores (67 TFLOP/s peak); the tensor cores are for a later version.
//
// What the design does about the card:
//   * The TPU kernel holds seven (Q,Q) matrices in VMEM.  At Q = 256 each is
//     256 KB of f32, over a block's 227 KB.  Here, flash-attention-backward
//     style, each block recomputes 64 x 64 tiles of the matrices it needs:
//       - `dx` blocks, one per 64-column tile j, loop over the row tiles i >= j
//         forming s, dM, M and U = dM∘s∘G, and sum dx = Mᵀ dy (after the
//         state term), the column sums of U and of dM∘M, and each row tile's
//         partial row sums of dM∘M;
//       - `dB` blocks (column tiles, looping down) sum Vᵀ C after w∘(x dSᵀ),
//         and `dC` blocks (row tiles, looping left) sum V B;
//       - a finishing launch, one warp per cell, adds up the row sums, forms
//         dcs with the state and gamma terms, its reverse cumsum, ddt and da.
//     The partial sums go through an f32 scratch of (3 + tiles) x Q per cell,
//     one slot per column tile: no atomics, so the sum order is fixed.
//   * exp(cs_i - cs_j) above the diagonal can overflow to inf, and inf * 0 is
//     NaN, so masked entries are selected away, never multiplied by a mask.
//   * Any Q <= 256: rows past Q load as zeros and are not stored.
//   * x, dt, B, C and dy are read through (batch, chunk, row, head) element
//     strides with the last dimension contiguous: the models' (B,L,H,.)
//     tensors need no transposed copy and a head-broadcast B or C (stride 0
//     over heads) costs no copy.  dS and dg are contiguous.
//   * Shared-memory rows are padded (N+1, P+1 floats; 64+16 for a tile of G
//     products) so that the inner loops' reads hit distinct banks or broadcast.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernels launch on the caller's stream, allocate nothing, and
// the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows and columns of a tile
constexpr int kGrid = 16;               // the threads form a 16 x 16 grid
constexpr int kRows = kTile / kGrid;    // tile rows per thread
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kES = kTile + 16;         // row stride of a product tile in smem
constexpr int kDsCols = 16;             // dS columns per pass in the dB blocks

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
  float* scratch;         // (B*nc*H, 3 + tiles, Q)
  int B, nc, Q, H, P, N;
  long long x_s[4], dt_s[4], b_s[4], c_s[4], dy_s[4];  // (batch, chunk, row, head)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* ptr, float v) { *ptr = v; }
__device__ __forceinline__ void store(__nv_bfloat16* ptr, float v) { *ptr = __float2bfloat16_rn(v); }

__device__ __forceinline__ long long at(const long long s[4], int b, int c, int q, int h) {
  return b * s[0] + c * s[1] + q * s[2] + h * s[3];
}

__device__ __forceinline__ int n_tiles(int Q) { return (Q + kTile - 1) / kTile; }

// Per-cell scratch slots: 0 dw, 1 column sums of U, 2 column sums of dM∘M,
// 3 + t the row sums of dM∘M over column tile t.
__device__ __forceinline__ float* scratch_slot(const Params& p, long long cell, int slot) {
  return p.scratch + (cell * (3 + n_tiles(p.Q)) + slot) * p.Q;
}

// dts[q] = dt, cs[q] = cumsum(dt * A) for the chunk's rows, with 256 threads:
// each lane of warp 0 sums 8 consecutive rows, then the lanes' totals are
// scanned with shuffles (the same scan as the forward kernel's).
template <typename T>
__device__ void chunk_cumsum(const Params& p, int b, int c, int h, float* dts, float* cs) {
  const int tid = threadIdx.x, Q = p.Q;
  const T* dtg = static_cast<const T*>(p.dt);
  const float A = p.A[h];
  for (int q = tid; q < Q; q += kThreads) dts[q] = to_f32(dtg[at(p.dt_s, b, c, q, h)]);
  __syncthreads();
  if (tid < 32) {
    constexpr int kPer = kMaxQ / 32;
    float v[kPer];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int q = tid * kPer + k;
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
    for (int k = 0; k < kPer; ++k) {
      const int q = tid * kPer + k;
      if (q < Q) cs[q] = excl + v[k];
    }
  }
  __syncthreads();
}

// Rows q0..q0+63 of a (B,nc,Q,H,F) input into smem rows of `stride` floats;
// rows past Q and columns past F are zero.
template <typename T>
__device__ void load_tile(float* dst, int stride, const void* src, const long long s[4], int b,
                          int c, int h, int q0, int Q, int F) {
  const T* g = static_cast<const T*>(src);
  for (int idx = threadIdx.x; idx < kTile * stride; idx += kThreads) {
    const int r = idx / stride, f = idx % stride;
    const int q = q0 + r;
    dst[idx] = q < Q && f < F ? to_f32(g[at(s, b, c, q, h) + f]) : 0.f;
  }
}

// Sums of a value over the 16 lanes that share a tile row (tid / 16).
__device__ __forceinline__ float row_lanes_sum(float v) {
#pragma unroll
  for (int off = kGrid / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- dx blocks: one per 64-column tile j (blockIdx.y), heaviest first.
// PJ = ceil(P / 16): output columns per thread.
template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_kernel(const Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tr = tid / kGrid, tc = tid % kGrid;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int b = blockIdx.z;
  const int Q = p.Q, N = p.N, P = p.P;
  const int nt = n_tiles(Q);
  const int jt = blockIdx.y, j0 = jt * kTile;
  const int CS = N + 1, XS = P + 1;
  const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h;

  float* dts = smem;
  float* cs = dts + kMaxQ;
  float* wj = cs + kMaxQ;                 // w of the tile's columns
  float* Bj = wj + kTile;                 // (64, N+1)
  float* Xj = Bj + kTile * CS;            // (64, P+1)
  float* Ci = Xj + kTile * XS;            // (64, N+1)
  float* DYi = Ci + kTile * CS;           // (64, P+1); dS rows first
  float* Es = DYi + kTile * XS;           // (64, 64+16): M, then reductions

  chunk_cumsum<T>(p, b, c, h, dts, cs);
  const float cs_last = cs[Q - 1];
  load_tile<T>(Bj, CS, p.Bm, p.b_s, b, c, h, j0, Q, N);
  load_tile<T>(Xj, XS, p.x, p.x_s, b, c, h, j0, Q, P);
  for (int r = tid; r < kTile; r += kThreads) {
    const int q = j0 + r;
    wj[r] = q < Q ? expf(cs_last - cs[q]) * dts[q] : 0.f;
  }

  // R = B_j dS, 64 state rows at a time through the dy buffer
  float acc[kRows][PJ];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int k = 0; k < PJ; ++k) acc[a][k] = 0.f;
  const float* dS = p.dstates + cell * N * P;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * XS; idx += kThreads) {
      const int r = idx / XS, pp = idx % XS;
      DYi[idx] = n0 + r < N && pp < P ? dS[(n0 + r) * P + pp] : 0.f;
    }
    __syncthreads();
    const int nn_end = min(kTile, N - n0);
#pragma unroll 4
    for (int nn = 0; nn < nn_end; ++nn) {
      float bv[kRows], dv[PJ];
#pragma unroll
      for (int a = 0; a < kRows; ++a) bv[a] = Bj[(tr + kGrid * a) * CS + n0 + nn];
#pragma unroll
      for (int k = 0; k < PJ; ++k) {
        const int pp = tc + kGrid * k;
        dv[k] = pp < P ? DYi[nn * XS + pp] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int k = 0; k < PJ; ++k) acc[a][k] = fmaf(bv[a], dv[k], acc[a][k]);
    }
  }
  // dw_j = R_j . x_j; then dx starts as w_j R_j
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = tr + kGrid * a;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < PJ; ++k) {
      const int pp = tc + kGrid * k;
      if (pp < P) part = fmaf(acc[a][k], Xj[r * XS + pp], part);
    }
    part = row_lanes_sum(part);
    if (tc == 0 && j0 + r < Q) scratch_slot(p, cell, 0)[j0 + r] = part;
#pragma unroll
    for (int k = 0; k < PJ; ++k) acc[a][k] *= wj[r];
  }

  float colU[kRows], colT[kRows];  // this thread's columns tc + 16 * bb
#pragma unroll
  for (int bb = 0; bb < kRows; ++bb) colU[bb] = colT[bb] = 0.f;

  for (int it = jt; it < nt; ++it) {
    const int i0 = it * kTile;
    __syncthreads();  // the previous tile's Ci, DYi, Es (or dS) are read
    load_tile<T>(Ci, CS, p.Cm, p.c_s, b, c, h, i0, Q, N);
    load_tile<T>(DYi, XS, p.dy, p.dy_s, b, c, h, i0, Q, P);
    __syncthreads();

    float s[kRows][kRows], dm[kRows][kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) s[a][bb] = dm[a][bb] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[kRows], bv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) cv[a] = Ci[(tr + kGrid * a) * CS + n];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) bv[bb] = Bj[(tc + kGrid * bb) * CS + n];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) s[a][bb] = fmaf(cv[a], bv[bb], s[a][bb]);
    }
#pragma unroll 4
    for (int pp = 0; pp < P; ++pp) {
      float yv[kRows], xv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) yv[a] = DYi[(tr + kGrid * a) * XS + pp];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) xv[bb] = Xj[(tc + kGrid * bb) * XS + pp];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) dm[a][bb] = fmaf(yv[a], xv[bb], dm[a][bb]);
    }

    // M, U = dM∘s∘G and T = dM∘M where j <= i < Q (selected: exp overflows
    // above the diagonal)
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = tr + kGrid * a;
      const int qi = i0 + r;
      float rowT = 0.f;
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) {
        const int col = tc + kGrid * bb;
        const int qj = j0 + col;
        float m = 0.f;
        if (qj <= qi && qi < Q) {
          const float k = s[a][bb] * expf(cs[qi] - cs[qj]);
          const float u = dm[a][bb] * k;
          m = k * dts[qj];
          colU[bb] += u;
          colT[bb] = fmaf(u, dts[qj], colT[bb]);
          rowT = fmaf(u, dts[qj], rowT);
        }
        Es[r * kES + col] = m;
      }
      rowT = row_lanes_sum(rowT);
      if (tc == 0 && qi < Q) scratch_slot(p, cell, 3 + jt)[qi] = rowT;
    }
    __syncthreads();

    // dx_j += sum_i M[i,j] dy_i
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float mv[kRows], yv[PJ];
#pragma unroll
      for (int a = 0; a < kRows; ++a) mv[a] = Es[ii * kES + tr + kGrid * a];
#pragma unroll
      for (int k = 0; k < PJ; ++k) {
        const int pp = tc + kGrid * k;
        yv[k] = pp < P ? DYi[ii * XS + pp] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int k = 0; k < PJ; ++k) acc[a][k] = fmaf(mv[a], yv[k], acc[a][k]);
    }
  }

  // column sums over the 16 thread rows, through Es
  __syncthreads();
  float* redU = Es;
  float* redT = Es + kGrid * kTile;
#pragma unroll
  for (int bb = 0; bb < kRows; ++bb) {
    redU[tr * kTile + tc + kGrid * bb] = colU[bb];
    redT[tr * kTile + tc + kGrid * bb] = colT[bb];
  }
  __syncthreads();
  if (tid < kTile && j0 + tid < Q) {
    float u = 0.f, t = 0.f;
    for (int k = 0; k < kGrid; ++k) {
      u += redU[k * kTile + tid];
      t += redT[k * kTile + tid];
    }
    scratch_slot(p, cell, 1)[j0 + tid] = u;
    scratch_slot(p, cell, 2)[j0 + tid] = t;
  }

  T* dxg = static_cast<T*>(p.dx);
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qj = j0 + tr + kGrid * a;
    if (qj >= Q) continue;
    const long long row = ((static_cast<long long>(b) * p.nc + c) * Q + qj) * p.H + h;
#pragma unroll
    for (int k = 0; k < PJ; ++k) {
      const int pp = tc + kGrid * k;
      if (pp < P) store(dxg + row * P + pp, acc[a][k]);
    }
  }
}

// ---- dB blocks (blockIdx.y < tiles: column tile j, looping over i >= j) and
// dC blocks (the rest: row tile i, looping over j <= i; heaviest first).
// NJ = ceil(N / 16): output columns per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dbc_kernel(const Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tr = tid / kGrid, tc = tid % kGrid;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int b = blockIdx.z;
  const int Q = p.Q, N = p.N, P = p.P;
  const int nt = n_tiles(Q);
  const bool is_db = static_cast<int>(blockIdx.y) < nt;
  const int t = is_db ? blockIdx.y : nt - 1 - (blockIdx.y - nt);
  const int t0 = t * kTile;
  const int CS = N + 1, XS = P + 1;
  const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h;

  float* dts = smem;
  float* cs = dts + kMaxQ;
  float* wj = cs + kMaxQ;
  float* Fx = wj + kTile;                 // (64, P+1): x_j (dB) or dy_i (dC), fixed
  float* Mv = Fx + kTile * XS;            // (64, P+1): dy_i (dB) or x_j (dC), moving
  float* Ys = Mv + kTile * XS;            // (64, N+1): C_i (dB) or B_j (dC); dS first
  float* Es = Ys + kTile * CS;            // (64, 64+16): V[i][j]

  chunk_cumsum<T>(p, b, c, h, dts, cs);
  const float cs_last = cs[Q - 1];

  float acc[kRows][NJ];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int k = 0; k < NJ; ++k) acc[a][k] = 0.f;

  if (is_db) {
    load_tile<T>(Fx, XS, p.x, p.x_s, b, c, h, t0, Q, P);
    for (int r = tid; r < kTile; r += kThreads) {
      const int q = t0 + r;
      wj[r] = q < Q ? expf(cs_last - cs[q]) * dts[q] : 0.f;
    }
    // dB_j starts as w_j x_j dSᵀ, 16 columns of dS (all N rows) at a time
    const float* dS = p.dstates + cell * N * P;
    for (int p0 = 0; p0 < P; p0 += kDsCols) {
      __syncthreads();
      for (int idx = tid; idx < N * (kDsCols + 1); idx += kThreads) {
        const int n = idx / (kDsCols + 1), pp = idx % (kDsCols + 1);
        Ys[idx] = pp < kDsCols && p0 + pp < P ? dS[n * P + p0 + pp] : 0.f;
      }
      __syncthreads();
      const int pp_end = min(kDsCols, P - p0);
      for (int pp = 0; pp < pp_end; ++pp) {
        float xv[kRows], dv[NJ];
#pragma unroll
        for (int a = 0; a < kRows; ++a) xv[a] = Fx[(tr + kGrid * a) * XS + p0 + pp];
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int n = tc + kGrid * k;
          dv[k] = n < N ? Ys[n * (kDsCols + 1) + pp] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int k = 0; k < NJ; ++k) acc[a][k] = fmaf(xv[a], dv[k], acc[a][k]);
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int k = 0; k < NJ; ++k) acc[a][k] *= wj[tr + kGrid * a];
  } else {
    load_tile<T>(Fx, XS, p.dy, p.dy_s, b, c, h, t0, Q, P);
  }

  const int u_begin = is_db ? t : 0, u_end = is_db ? nt : t + 1;
  for (int u = u_begin; u < u_end; ++u) {
    const int i0 = is_db ? u * kTile : t0;   // rows of V
    const int j0 = is_db ? t0 : u * kTile;   // columns of V
    __syncthreads();  // the previous tile's Mv, Ys, Es (or dS) are read
    if (is_db) {
      load_tile<T>(Mv, XS, p.dy, p.dy_s, b, c, h, i0, Q, P);
      load_tile<T>(Ys, CS, p.Cm, p.c_s, b, c, h, i0, Q, N);
    } else {
      load_tile<T>(Mv, XS, p.x, p.x_s, b, c, h, j0, Q, P);
      load_tile<T>(Ys, CS, p.Bm, p.b_s, b, c, h, j0, Q, N);
    }
    __syncthreads();
    const float* DYs = is_db ? Mv : Fx;
    const float* Xs = is_db ? Fx : Mv;

    // V[i,j] = (dy_i . x_j) G[i,j] dt_j where j <= i < Q
    float dm[kRows][kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) dm[a][bb] = 0.f;
#pragma unroll 4
    for (int pp = 0; pp < P; ++pp) {
      float yv[kRows], xv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) yv[a] = DYs[(tr + kGrid * a) * XS + pp];
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) xv[bb] = Xs[(tc + kGrid * bb) * XS + pp];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int bb = 0; bb < kRows; ++bb) dm[a][bb] = fmaf(yv[a], xv[bb], dm[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = tr + kGrid * a;
      const int qi = i0 + r;
#pragma unroll
      for (int bb = 0; bb < kRows; ++bb) {
        const int col = tc + kGrid * bb;
        const int qj = j0 + col;
        float v = 0.f;
        if (qj <= qi && qi < Q) v = dm[a][bb] * expf(cs[qi] - cs[qj]) * dts[qj];
        Es[r * kES + col] = v;
      }
    }
    __syncthreads();

    if (is_db) {  // dB_j += sum_i V[i,j] C_i
#pragma unroll 4
      for (int ii = 0; ii < kTile; ++ii) {
        float vv[kRows], yv[NJ];
#pragma unroll
        for (int a = 0; a < kRows; ++a) vv[a] = Es[ii * kES + tr + kGrid * a];
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int n = tc + kGrid * k;
          yv[k] = n < N ? Ys[ii * CS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int k = 0; k < NJ; ++k) acc[a][k] = fmaf(vv[a], yv[k], acc[a][k]);
      }
    } else {      // dC_i += sum_j V[i,j] B_j
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        float vv[kRows], yv[NJ];
#pragma unroll
        for (int a = 0; a < kRows; ++a) vv[a] = Es[(tr + kGrid * a) * kES + jj];
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int n = tc + kGrid * k;
          yv[k] = n < N ? Ys[jj * CS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int k = 0; k < NJ; ++k) acc[a][k] = fmaf(vv[a], yv[k], acc[a][k]);
      }
    }
  }

  float* out = is_db ? p.dB : p.dC;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int q = t0 + tr + kGrid * a;
    if (q >= Q) continue;
    const long long row = ((static_cast<long long>(b) * p.nc + c) * Q + q) * p.H + h;
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      const int n = tc + kGrid * k;
      if (n < N) out[row * N + n] = acc[a][k];
    }
  }
}

// ---- one warp per cell: dcs, its reverse cumsum, ddt and da.
template <typename T>
__global__ void __launch_bounds__(32) ssd_bwd_finish_kernel(const Params p) {
  constexpr int kPer = kMaxQ / 32;
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

  const float* dw = scratch_slot(p, cell, 0);
  const float* colU = scratch_slot(p, cell, 1);
  const float* colT = scratch_slot(p, cell, 2);
  float dcs[kPer], expw[kPer], dwv[kPer];
  float dww = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = lane * kPer + k;
    dcs[k] = expw[k] = dwv[k] = 0.f;
    if (q < Q) {
      float rowT = 0.f;
      for (int t = 0; t <= q / kTile; ++t) rowT += scratch_slot(p, cell, 3 + t)[q];
      expw[k] = expf(cs_last - cs[k]);
      dwv[k] = dw[q];
      const float w = expw[k] * dtv[k];
      dcs[k] = rowT - colT[q] - dwv[k] * w;
      dww = fmaf(dwv[k], w, dww);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dww += __shfl_xor_sync(0xffffffffu, dww, off);
  if (lane == last / kPer) {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k == last % kPer) dcs[k] += dww + p.dgamma[cell] * expf(cs_last);
  }

  // ddA = reverse cumsum of dcs: suffix sums in the lane, then across lanes
  float suf[kPer];
  float s = 0.f;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    s += dcs[k];
    suf[k] = s;
  }
  float tail = s;  // inclusive suffix scan of the lanes' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, tail, off);
    if (lane + off < 32) tail += o;
  }
  float after = __shfl_down_sync(0xffffffffu, tail, 1);
  if (lane == 31) after = 0.f;

  float da = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = lane * kPer + k;
    if (q >= Q) continue;
    const float ddA = suf[k] + after;
    p.ddt[((static_cast<long long>(b) * p.nc + c) * Q + q) * p.H + h] =
        colU[q] + dwv[k] * expw[k] + ddA * A;
    da = fmaf(ddA, dtv[k], da);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) da += __shfl_xor_sync(0xffffffffu, da, off);
  if (lane == 0) p.da[cell] = da;
}

size_t dx_smem_bytes(int N, int P) {
  return sizeof(float) *
         (2 * kMaxQ + kTile + 2 * kTile * (N + 1) + 2 * kTile * (P + 1) + kTile * kES);
}

// Ys (64 x (N+1)) also holds the N x 17 slices of dS.
size_t dbc_smem_bytes(int N, int P) {
  return sizeof(float) *
         (2 * kMaxQ + kTile + 2 * kTile * (P + 1) + kTile * (N + 1) + kTile * kES);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int PJ>
cudaError_t launch_dx(const Params& p, cudaStream_t stream) {
  const size_t smem = dx_smem_bytes(p.N, p.P);
  cudaError_t err = allow_smem(ssd_bwd_dx_kernel<T, PJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nc * p.H, (p.Q + kTile - 1) / kTile, p.B);
  ssd_bwd_dx_kernel<T, PJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dbc(const Params& p, cudaStream_t stream) {
  const size_t smem = dbc_smem_bytes(p.N, p.P);
  cudaError_t err = allow_smem(ssd_bwd_dbc_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nc * p.H, 2 * ((p.Q + kTile - 1) / kTile), p.B);
  ssd_bwd_dbc_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (p.P <= 16) err = launch_dx<T, 1>(p, stream);
  else if (p.P <= 32) err = launch_dx<T, 2>(p, stream);
  else if (p.P <= 64) err = launch_dx<T, 4>(p, stream);
  else err = launch_dx<T, 8>(p, stream);
  if (err != cudaSuccess) return err;
  if (p.N <= 16) err = launch_dbc<T, 1>(p, stream);
  else if (p.N <= 32) err = launch_dbc<T, 2>(p, stream);
  else if (p.N <= 64) err = launch_dbc<T, 4>(p, stream);
  else if (p.N <= 128) err = launch_dbc<T, 8>(p, stream);
  else err = launch_dbc<T, 16>(p, stream);
  if (err != cudaSuccess) return err;
  // after the dx blocks on the same stream: reads their scratch
  ssd_bwd_finish_kernel<T><<<dim3(p.nc * p.H, 1, p.B), 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, Bm, Cm, dy and dx alike; A,
// dstates, dgamma and every other output are f32.  x, dy (B,nc,Q,H,P), dt
// (B,nc,Q,H), Bm and Cm (B,nc,Q,H,N) are read through `strides`: 20 element
// strides, the (batch, chunk, row, head) strides of x, dt, Bm, Cm and dy in
// that order; the last dimension of x, dy, Bm and Cm is contiguous.  dstates
// (B,nc,H,N,P) and dgamma (B,nc,H) are contiguous.  dx (B,nc,Q,H,P), ddt
// (B,nc,Q,H), dB and dC (B,nc,Q,H,N) and da (B,nc,H) are written contiguous;
// scratch holds B*nc*H*(3 + ceil(Q/64))*Q floats.  Q <= 256, P <= 128,
// N <= 256.
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, const void* dy, const void* dstates,
                                   const void* dgamma, void* dx, void* ddt, void* dB, void* dC,
                                   void* da, void* scratch, int dtype, int B, int nc, int Q,
                                   int H, int P, int N, const long long* strides, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || (dtype != 0 && dtype != 1))
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
  p.scratch = static_cast<float*>(scratch);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
