// Forward flash attention for Hopper (sm_90a): online softmax, causal or not,
// grouped-query attention by index.
//
// Replaces the Pallas TPU kernel `_flash_kernel` reached through
// `flash_attention_bhsd` in src/repro/kernels/flash_attention.py.  It computes
// the same function: scores q.k / sqrt(D), the running max m, sum l and
// accumulator acc in f32, keys masked by kpos < Sk and, when causal, by
// qpos >= kpos in absolute positions aligned top-left (query row i sees keys
// 0..i whatever Sk is), masked scores set to the finite -1e30, the output
// divided by max(l, 1e-30) and stored in q's dtype.
//
// What bounds it on this card.  At chatglm3-6b prefill shapes (32 query heads
// over 2 KV heads, D = 128, S = 2048, causal) the work is about 34 GFLOP for
// 36 MB of input and output: 950 operations a byte, far above the H100's
// ridge, so the kernel is bound by arithmetic.  The least time is set by the
// bf16 tensor-core rate (989 TFLOP/s).
//
// What the design does about it.  Two kernels share one structure:
//   * one block of 4 warps per (q tile, head, batch); the TPU's sequential KV
//     grid axis becomes a loop inside the block, with each K/V tile staged
//     once in shared memory and shared by the block's query rows;
//   * under the causal mask, K tiles wholly above the diagonal are skipped
//     (their contribution is exactly 0 under the -1e30 mask), and the q tiles
//     with the most work are scheduled first;
//   * the ragged edge is masked in the kernel (no padded copy in device
//     memory), query head h reads KV head h / G by index, and q, k, v, o are
//     read and written through strides (no layout copies);
//   * shared-memory rows are padded so that inner-loop reads are
//     conflict-free or broadcasts.
// bf16 inputs run on the tensor cores (`flash_fwd_bf16_kernel`): mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, a warp owning 16 query
// rows; the probabilities are rounded to bf16 for the p.v product, as the
// reference's blocked path rounds them to the value dtype.  f32 inputs run as
// f32 FMAs on the CUDA cores (`flash_fwd_f32_kernel`), never TF32, so they
// keep the reference's 2e-5 tolerance.  wgmma, TMA and warp specialisation
// are for a later version.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernels launch on the caller's stream, allocate nothing, and
// the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KVH, Sq, Sk;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, sequence
  long long k_sb, k_sh, k_ss;  // (the last dimension is contiguous)
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

// Number of K tiles a block needs: all of them, or under the causal mask
// those that start at or before the tile's last real query row.
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int BQ, int BK) {
  const int nk = (p.Sk + BK - 1) / BK;
  if (!p.causal) return nk;
  const int qmax = min(q0 + BQ, p.Sq) - 1;
  return min(nk, qmax / BK + 1);
}

// ------------------------------------------------------------------ f32 path
// The 128 threads form an 8 x 16 grid; a thread owns BQ/8 query rows of both
// the score tile and the accumulator, so the softmax row reductions stay
// inside one half-warp (shuffles, no shared memory).
constexpr int kRowThreads = 8;   // thread rows: tr = tid / kColThreads
constexpr int kColThreads = 16;  // threads that share a query row: one half-warp

template <int D> struct F32Tile;
template <> struct F32Tile<32>  { static constexpr int BQ = 64, BK = 64; };
template <> struct F32Tile<64>  { static constexpr int BQ = 64, BK = 64; };
template <> struct F32Tile<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct F32Tile<256> { static constexpr int BQ = 32, BK = 32; };

// Row strides (in floats) of the shared-memory tiles.  D + 1 spreads the rows
// of Q and K over all banks; BK + 16 puts the two query rows a warp touches
// into opposite halves of the banks.
template <int D> struct F32Layout {
  static constexpr int BQ = F32Tile<D>::BQ, BK = F32Tile<D>::BK;
  static constexpr int QS = D + 1, KS = D + 1, VS = D, PS = BK + 16;
  static constexpr size_t kBytes = sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  using L = F32Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int RI = BQ / kRowThreads;  // query rows per thread
  constexpr int CJ = BK / kColThreads;  // key columns per thread
  constexpr int DJ = D / kColThreads;   // output columns per thread
  static_assert(BQ % kRowThreads == 0 && BK % 32 == 0 && D % 32 == 0, "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::QS;
  float* Vs = Ks + BK * L::KS;
  float* Ps = Vs + BK * L::VS;

  const int tid = threadIdx.x;
  const int tr = tid / kColThreads;
  const int tc = tid % kColThreads;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // q scaled by 1/sqrt(D) in f32, as the reference does before its dots
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qpos = q0 + r;
    Qs[r * L::QS + d] = qpos < p.Sq ? qg[qpos * p.q_ss + d] * p.scale : 0.f;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(p, q0, BQ, BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kpos = k0 + r;
      const bool in = kpos < p.Sk;
      Ks[r * L::KS + d] = in ? kg[kpos * p.k_ss + d] : 0.f;
      Vs[r * L::VS + d] = in ? vg[kpos * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // s = (q * scale) k^T for this thread's RI x CJ scores.
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(tr + kRowThreads * i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tc + kColThreads * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then the online-softmax update of m, l and acc.
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + kRowThreads * i;
      const int qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tc + kColThreads * j;
        const bool valid = kpos < p.Sk && (!p.causal || qpos >= kpos);
        s[i][j] = valid ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kColThreads / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = kColThreads / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CJ; ++j) Ps[r * L::PS + tc + kColThreads * j] = s[i][j];
    }
    // A thread reads only P rows written by its own half-warp.
    __syncwarp();

    // acc += p v for this thread's RI rows and DJ output columns.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(tr + kRowThreads * i) * L::PS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * L::VS + tc + kColThreads * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + tr + kRowThreads * i;
    if (qpos < p.Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) og[qpos * p.o_ss + tc + kColThreads * j] = acc[i][j] / denom;
    }
  }
}

// ----------------------------------------------------------------- bf16 path
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..)   a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B (16 x 8, k x n)       b0: (2t..2t+1, g)   b1: (2t+8..2t+9, g)
//   C (16 x 8, f32)         c0, c1: (g, 2t..2t+1)   c2, c3: (g+8, 2t..2t+1)
// Two adjacent C tiles of scores are exactly the A fragment of p for the
// p.v product, so probabilities never leave registers.
constexpr int kTcBQ = 64;  // 4 warps x 16 query rows
constexpr int kTcBK = 64;

// Row strides in bf16 elements: D + 8 keeps 16-byte alignment and maps the
// 8 rows x 4 column pairs of a fragment load onto 32 distinct banks.
template <int D> struct Bf16Layout {
  static constexpr int S = D + 8;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * (kTcBQ + 2 * kTcBK) * S;
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b0,
                                         const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: each lane gives the
// address of one row (lanes 8i..8i+7 the rows of matrix i).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// rows x D bf16 from global (rows past `limit` as zeros) into shared memory,
// 16 bytes a thread.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int rows, int limit) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Bf16Layout<D>::S + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(const Params p) {
  constexpr int S = Bf16Layout<D>::S;
  constexpr int NT = kTcBK / 8;  // score tiles (8 keys each) per K tile
  constexpr int DT = D / 8;      // output tiles (8 columns each)
  static_assert(D % 16 == 0 && DT % 2 == 0, "head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTcBQ * S;
  __nv_bfloat16* Vs = Ks + kTcBK * S;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (p.Sq + kTcBQ - 1) / kTcBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTcBQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<D>(Qs, qg, p.q_ss, q0, kTcBQ, p.Sq);

  // This thread's two query rows: r0 = warp*16 + g and r0 + 8.
  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const __nv_bfloat16* qa = Qs + (warp * 16 + g) * S + 2 * t;
  const int nk = key_tiles(p, q0, kTcBQ, kTcBK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTcBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D>(Ks, kg, p.k_ss, k0, kTcBK, p.Sk);
    load_tile<D>(Vs, vg, p.v_ss, k0, kTcBK, p.Sk);
    __syncthreads();

    // s = q k^T for the warp's 16 rows x 64 keys, f32 accumulation.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a[4] = {ld_pair(qa + kk * 16), ld_pair(qa + 8 * S + kk * 16),
                             ld_pair(qa + kk * 16 + 8), ld_pair(qa + 8 * S + kk * 16 + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * S + kk * 16 + 2 * t;
        mma_bf16(s[n], a, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // Scale, mask, then the online-softmax update (rows qpos0, qpos1).
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const bool valid = kpos < p.Sk && (!p.causal || qpos >= kpos);
        s[n][e] = valid ? s[n][e] * p.scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share rows
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // o += p v: p from the score registers (bf16), v by transposed ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + n * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = n * 8 + 2 * t;
    if (qpos0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qpos0 * p.o_ss + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (qpos1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + qpos1 * p.o_ss + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int BQ, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0)
    return launch(flash_fwd_f32_kernel<D>, F32Layout<D>::kBytes, F32Tile<D>::BQ, p, stream);
  return launch(flash_fwd_bf16_kernel<D>, Bf16Layout<D>::kBytes, kTcBQ, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, sequence) strides of q, k, v and o in that order.  bf16
// tensors must be 16-byte aligned with strides in multiples of 8 elements.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int D, int B, int H, int KVH, int Sq,
                                         int Sk, const long long* strides, float scale,
                                         int causal, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = B;
  p.H = H;
  p.KVH = KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(dtype, p, s);
    case 64: return launch_d<64>(dtype, p, s);
    case 128: return launch_d<128>(dtype, p, s);
    case 256: return launch_d<256>(dtype, p, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
