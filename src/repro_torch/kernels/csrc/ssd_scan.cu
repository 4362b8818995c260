// Intra-chunk SSD (Mamba2 state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel`, reached through
// `_chunks_fwd_impl` (entries `ssd_chunk_pallas`, `ssd_chunks_flat`) in
// src/repro/kernels/ssd_scan.py.  It computes the same function.  For each
// (batch b, chunk c, head h), from the chunk's Q rows of x (Q,P), dt (Q), B and
// C (Q,N) and the scalar A[h], all in f32:
//   cs     = cumsum(dt * A)                                            (Q,)
//   y_diag = M x,  M[i,j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0
//   state  = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j                (N,P)
//   gamma  = exp(cs_last)
// y_diag is stored in x's dtype, state and gamma in f32.
//
// What bounds it on this card.  At mamba2-1.3b's prefill shapes (Q = 256,
// N = 128, P = 64) a cell does 2*(Q(Q+1)/2)*(N+P) + 2*Q*N*P = 16.8 MFLOP for
// about 100 KB of distinct input and output, so it is bound by arithmetic.  This
// version runs f32 FMAs on the CUDA cores, whose peak (67 TFLOP/s) sets its
// least time; bf16 tensor cores (mma.sync, wgmma) are for a later version.
//
// What the design does about the card:
//   * The TPU kernel holds the whole (Q,Q) score matrix in VMEM.  At Q = 256
//     that is 256 KB of f32, more than the 227 KB a block may use.  Here a
//     block computes one 64-row tile of y_diag and loops over the 64-column
//     tiles at or left of the diagonal (tiles wholly above it are never
//     formed); other blocks of the same cell each compute 64 rows of the
//     state.  A cell's blocks share nothing, so each computes cs for the whole
//     chunk (Q <= 256 floats in shared memory) first, by a warp-wide scan.
//   * exp(cs_i - cs_j) for j > i can overflow to inf, and inf * 0 is NaN, so
//     masked entries of M are selected away, never multiplied by a 0/1 mask.
//   * Any Q <= 256: rows past Q load as zeros and are not stored.
//   * Inputs are read through (batch, chunk, row, head) element strides with
//     the last dimension contiguous, so the models' (B,L,H,.) tensors need no
//     transposed copy, and a head-broadcast B or C (stride 0 over heads, as
//     `expand` gives) costs no copy.  A is read per head, not tiled.
//   * Shared-memory rows are padded (N+1 floats; 64+16 for M) so that the
//     inner loops' reads hit distinct banks or broadcast.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernel launches on the caller's stream, allocates nothing, and
// the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows and columns of a tile
constexpr int kGrid = 16;               // the threads form a 16 x 16 grid
constexpr int kRows = kTile / kGrid;    // tile rows (and M columns) per thread
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kMS = kTile + 16;         // row stride of M in shared memory

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* states;
  float* gamma;
  int B, nc, Q, H, P, N;
  long long x_s[4], dt_s[4], b_s[4], c_s[4];  // (batch, chunk, row, head) strides
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* ptr, float v) { *ptr = v; }
__device__ __forceinline__ void store(__nv_bfloat16* ptr, float v) { *ptr = __float2bfloat16_rn(v); }

__device__ __forceinline__ long long at(const long long s[4], int b, int c, int q, int h) {
  return b * s[0] + c * s[1] + q * s[2] + h * s[3];
}

// PJ = ceil(P / 16): output columns per thread.
template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) ssd_chunk_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* dts = smem;           // dt of the chunk's rows, f32
  float* cs = dts + kMaxQ;     // cumsum(dt * A)
  float* work = cs + kMaxQ;

  const int tid = threadIdx.x;
  const int tr = tid / kGrid, tc = tid % kGrid;
  const int c = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int b = blockIdx.z;
  const int Q = p.Q, N = p.N, P = p.P;
  const int n_row_tiles = (Q + kTile - 1) / kTile;

  const T* xg = static_cast<const T*>(p.x);
  const T* dtg = static_cast<const T*>(p.dt);
  const T* bg = static_cast<const T*>(p.Bm);
  const T* cg = static_cast<const T*>(p.Cm);

  // cs = cumsum(dt * A): each lane of warp 0 sums 8 consecutive rows, then
  // the lanes' totals are scanned with shuffles.
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

  const int by = blockIdx.y;
  if (by < n_row_tiles) {
    // ---- one 64-row tile of y_diag; the heaviest tiles are scheduled first
    const int t = n_row_tiles - 1 - by;
    const int i0 = t * kTile;
    const int CS = N + 1;
    float* Cs = work;
    float* Bs = Cs + kTile * CS;
    float* Xs = Bs + kTile * CS;
    float* Ms = Xs + kTile * P;

    for (int idx = tid; idx < kTile * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      const int q = i0 + r;
      Cs[r * CS + n] = q < Q ? to_f32(cg[at(p.c_s, b, c, q, h) + n]) : 0.f;
    }
    float acc[kRows][PJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

    for (int jt = 0; jt <= t; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();  // Cs is written; the previous tile's Bs, Xs, Ms are read
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int q = j0 + r;
        Bs[r * CS + n] = q < Q ? to_f32(bg[at(p.b_s, b, c, q, h) + n]) : 0.f;
      }
      for (int idx = tid; idx < kTile * P; idx += kThreads) {
        const int r = idx / P, pp = idx % P;
        const int q = j0 + r;
        Xs[r * P + pp] = q < Q ? to_f32(xg[at(p.x_s, b, c, q, h) + pp]) : 0.f;
      }
      __syncthreads();

      // scores C_i . B_j for this thread's 4 x 4 entries of the tile
      float s[kRows][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRows], bv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) cv[i] = Cs[(tr + kGrid * i) * CS + n];
#pragma unroll
        for (int j = 0; j < kRows; ++j) bv[j] = Bs[(tc + kGrid * j) * CS + n];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }

      // M = scores * exp(cs_i - cs_j) * dt_j where j <= i (selected, never
      // masked by multiplication: exp overflows above the diagonal)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr + kGrid * i;
        const int qi = i0 + r;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int col = tc + kGrid * j;
          const int qj = j0 + col;
          float m = 0.f;
          if (qj <= qi && qi < Q) m = s[i][j] * expf(cs[qi] - cs[qj]) * dts[qj];
          Ms[r * kMS + col] = m;
        }
      }
      __syncthreads();

      // y_diag += M x
#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float mv[kRows], xv[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i) mv[i] = Ms[(tr + kGrid * i) * kMS + kk];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int pp = tc + kGrid * j;
          xv[j] = pp < P ? Xs[kk * P + pp] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
    }

    T* yg = static_cast<T*>(p.y);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = i0 + tr + kGrid * i;
      if (qi >= Q) continue;
      const long long row = ((static_cast<long long>(b) * p.nc + c) * Q + qi) * p.H + h;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int pp = tc + kGrid * j;
        if (pp < P) store(yg + row * P + pp, acc[i][j]);
      }
    }
  } else {
    // ---- 64 rows n0.. of the chunk's end state (N,P), and gamma
    const int n0 = (by - n_row_tiles) * kTile;
    float* ws = work;            // exp(cs_last - cs_j) * dt_j
    float* Bn = ws + kMaxQ;      // (rows j, state columns n0..n0+63)
    float* Xw = Bn + kTile * kTile;
    const float cs_last = cs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) ws[q] = expf(cs_last - cs[q]) * dts[q];

    float acc[kRows][PJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

    for (int j0 = 0; j0 < Q; j0 += kTile) {
      __syncthreads();  // ws is written; the previous tile's Bn, Xw are read
      for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
        const int r = idx / kTile, nn = idx % kTile;
        const int q = j0 + r, n = n0 + nn;
        Bn[r * kTile + nn] = q < Q && n < N ? to_f32(bg[at(p.b_s, b, c, q, h) + n]) : 0.f;
      }
      for (int idx = tid; idx < kTile * P; idx += kThreads) {
        const int r = idx / P, pp = idx % P;
        const int q = j0 + r;
        Xw[r * P + pp] = q < Q ? to_f32(xg[at(p.x_s, b, c, q, h) + pp]) * ws[q] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float bv[kRows], xv[PJ];
#pragma unroll
        for (int i = 0; i < kRows; ++i) bv[i] = Bn[kk * kTile + tr + kGrid * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int pp = tc + kGrid * j;
          xv[j] = pp < P ? Xw[kk * P + pp] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
    }

    const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int n = n0 + tr + kGrid * i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int pp = tc + kGrid * j;
        if (pp < P) p.states[(cell * N + n) * P + pp] = acc[i][j];
      }
    }
    if (n0 == 0 && tid == 0) p.gamma[cell] = expf(cs_last);
  }
}

size_t smem_bytes(int N, int P) {
  return sizeof(float) *
         (2 * kMaxQ + 2 * kTile * (N + 1) + kTile * P + kTile * kMS);
}

template <typename T, int PJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.N, p.P);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_fwd_kernel<T, PJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_row_tiles = (p.Q + kTile - 1) / kTile;
  const int n_state_tiles = (p.N + kTile - 1) / kTile;
  const dim3 grid(p.nc * p.H, n_row_tiles + n_state_tiles, p.B);
  ssd_chunk_fwd_kernel<T, PJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const Params& p, cudaStream_t stream) {
  if (p.P <= 16) return launch<T, 1>(p, stream);
  if (p.P <= 32) return launch<T, 2>(p, stream);
  if (p.P <= 64) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, Bm, Cm and y alike; A, states
// and gamma are f32.  x (B,nc,Q,H,P), dt (B,nc,Q,H), Bm and Cm (B,nc,Q,H,N) are
// read through `strides`: 16 element strides, the (batch, chunk, row, head)
// strides of x, dt, Bm and Cm in that order; the last dimension of x, Bm and
// Cm is contiguous.  y (B,nc,Q,H,P), states (B,nc,H,N,P) and gamma (B,nc,H)
// are written contiguous.  Q <= 256, P <= 128, N <= 256.
extern "C" int repro_ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* Cm, void* y, void* states, void* gamma, int dtype,
                                   int B, int nc, int Q, int H, int P, int N,
                                   const long long* strides, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = static_cast<const float*>(A);
  p.Bm = Bm;
  p.Cm = Cm;
  p.y = y;
  p.states = static_cast<float*>(states);
  p.gamma = static_cast<float*>(gamma);
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
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_p<float>(p, s) : launch_p<__nv_bfloat16>(p, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
