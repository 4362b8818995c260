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
// bf16 tensor-core rate (989 TFLOP/s), which only `wgmma` reaches; the
// softmax between the two products runs on the CUDA cores and the K/V tiles
// come from L2/HBM, so both have to hide behind the tensor cores.
//
// What the design does about it (bf16, `flash_fwd_bf16_kernel`):
//   * warp roles: one CTA per (128 query rows, head, batch), 384 threads.
//     Warpgroups 0 and 1 are consumers, 64 query rows each; in warpgroup 2
//     one warp is the producer.  `setmaxnreg` gives the producer 24
//     registers a thread and the consumers 240, enough for both f32
//     accumulators (scores and output) without spills;
//   * TMA: the producer loads the Q tile once and the K and V tiles of each
//     key block into a ring of 2-3 stages in shared memory, with a full
//     mbarrier per stage for K and one for V (transaction bytes) and an
//     empty mbarrier per stage that the 8 consumer warps release.  The
//     tensor maps (encoded on the host per call with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPointByVersion, so nothing links
//     libcuda) describe q, k, v as laid out, 4-D (D, S, heads, batch) over
//     their strides, so a (B, S, H, D) tensor transposed to (B, H, S, D)
//     goes in without a copy.  Tiles land 128-byte swizzled (64-byte for
//     D = 32), 64 columns a chunk, the layout the wgmma descriptors read;
//     rows past the sequence come in as zeros (TMA's out-of-bounds fill);
//   * S = Q.K^T by `wgmma.mma_async` m64nBKk16 with both operands in shared
//     memory and f32 accumulation; the online softmax runs on the
//     accumulator registers with exp2 and the scale folded with log2(e);
//     the row sums stay per thread until the epilogue;
//   * O += P.V by `wgmma` with A = P from registers (the f32 scores rounded
//     to bf16 in the A-fragment layout, as the reference rounds p to the
//     value dtype) and B = V from shared memory through the transpose bit,
//     so V is never transposed in memory;
//   * softmax and P.V overlap inside a warpgroup: S(j) and P.V(j-1) are
//     issued as two commit groups, the warpgroup waits for the first only,
//     computes the softmax of block j while P.V(j-1) runs, then rescales O
//     and packs P(j).  One score buffer suffices, since P(j-1) is kept in
//     bf16 registers of its own; the two warpgroups run unordered (forcing
//     them to take turns on the tensor cores measured slower);
//   * masks only where needed: a first loop runs the key blocks that lie
//     wholly below the diagonal and inside Sk without any mask; a second
//     loop runs the diagonal and ragged blocks with the causal and
//     kpos < Sk masks (TMA's zero rows score 0, not -1e30, so they must be
//     masked there); blocks wholly above the diagonal are skipped.  Every
//     mbarrier wait comes before the wgmma fence and no wgmma sits on a
//     branch of its own, or ptxas serializes all of them (C7520);
//   * the q tiles with the most causal work are scheduled first, query head
//     h reads KV head h / G by index, and the output is stored through o's
//     strides (laid out (B, Sq, H, D) by the wrapper).
// Key-block width and stages per head dim: D = 32, 64: 128 keys, 3 stages;
// D = 128: 128 keys, 3 stages (224 KB; with 2 the load of block j+1 waits
// on the release of block j-1, 9 % slower on the card,
// tools/kernel_variants.py); D = 256: 64 keys, 2 stages (192 KB).
// Not done yet: a persistent grid (each SM now runs ~4 CTAs one after the
// other at chatglm3-6b's shape, each paying its own prologue and epilogue),
// TMA multicast of K and V to the CTAs of one KV head, and exp2 partly on
// the FMA units for D = 64, where the softmax's exponentials, not the tensor
// cores, bound the kernel.
//
// f32 inputs run as f32 FMAs on the CUDA cores (`flash_fwd_f32_kernel`),
// never TF32, so they keep the reference's 2e-5 tolerance: one block of 4
// warps per (q tile, head, batch), K/V tiles staged in padded shared memory,
// the causal blocks above the diagonal skipped.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernels launch on the caller's stream, allocate nothing, and
// the entry point returns cudaGetLastError() (or cudaErrorInvalidValue when
// a tensor map cannot be encoded).

#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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
constexpr int kHopperThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kConsumerWarps = 8;
constexpr int kBQ = 128;             // query rows a CTA: 64 per consumer warpgroup

template <int D> struct HopperTile;
template <> struct HopperTile<32>  { static constexpr int BK = 128, ST = 3; };
template <> struct HopperTile<64>  { static constexpr int BK = 128, ST = 3; };
template <> struct HopperTile<128> { static constexpr int BK = 128, ST = 3; };
template <> struct HopperTile<256> { static constexpr int BK = 64, ST = 2; };

// Shared memory: Q, then the K stages, the V stages, the mbarriers.  Each
// tile is D / SW column chunks; a chunk is `rows` rows of SW bf16 (64 or 128
// bytes), swizzled as TMA writes it, 1024-byte aligned.
template <int D> struct HopperLayout {
  static constexpr int BK = HopperTile<D>::BK, ST = HopperTile<D>::ST;
  static constexpr int SW = D < 64 ? D : 64;   // columns a swizzled row
  static constexpr int SWB = 2 * SW;           // its bytes
  static constexpr int NC = D / SW;            // chunks a tile
  static constexpr uint32_t Q_BYTES = kBQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr uint32_t K_OFF = Q_BYTES, V_OFF = K_OFF + ST * KV_BYTES,
                            BAR_OFF = V_OFF + ST * KV_BYTES;
  static constexpr size_t kBytes = BAR_OFF + 8 * (1 + 3 * ST) + 1024;  // + alignment
  static constexpr uint64_t DESC_LAYOUT = SWB == 128 ? 1 : 2;  // wgmma: 128B or 64B swizzle
  static_assert(kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The consumer warpgroup's state: 2 query rows a thread (row0, row0 + 8).
template <int D> struct RowState {
  float o[D / 2];
  float m[2], l[2];  // running max (raw score units) and this thread's partial sum
};

// Issues S = Q K^T of key block kt into sc (asynchronous; the caller has
// waited for the block's K, fenced, and commits and waits).
template <int D>
__device__ __forceinline__ void issue_scores(float* sc, uint32_t base, uint32_t q_rows, int kt) {
  using L = HopperLayout<D>;
  const uint32_t k_tile = base + L::K_OFF + (kt % L::ST) * L::KV_BYTES;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t chunk = kk * 16 / L::SW, col = (kk * 16 % L::SW) * 2;
    Wgmma<L::BK>::template ss<0>(
        sc, smem_desc(q_rows + chunk * kBQ * L::SWB + col, 16, 8 * L::SWB, L::DESC_LAYOUT),
        smem_desc(k_tile + chunk * L::BK * L::SWB + col, 16, 8 * L::SWB, L::DESC_LAYOUT), kk > 0);
  }
}

// Waits until K (which = 0) or V (which = 1) of key block kt has landed.
template <int D>
__device__ __forceinline__ void wait_block(uint32_t base, int kt, int which) {
  using L = HopperLayout<D>;
  mbar_wait(base + L::BAR_OFF + 8 * (1 + which * L::ST + kt % L::ST), (kt / L::ST) & 1);
}

// The online softmax of key block kt on its scores in sc (MASK: the block
// crosses the diagonal or Sk, so scores are masked one by one): sc becomes
// p = exp(s - m_new) in place, m and l are updated, and alpha = exp(m_old -
// m_new) of the thread's two rows is returned for the output's rescale.
template <int D, bool MASK>
__device__ __forceinline__ void softmax_block(RowState<D>& st, float* sc, int kt, int qpos0,
                                              const Params& p, float c, float (&alpha)[2]) {
  constexpr int BK = HopperLayout<D>::BK;
  const int t4 = threadIdx.x % 4;
  const int k0 = kt * BK;
  float mx0 = st.m[0], mx1 = st.m[1];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    if (MASK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        if (kpos >= p.Sk || (p.causal && qpos < kpos)) sc[4 * j + e] = kNegInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  alpha[0] = ex2((st.m[0] - mx0) * c);
  alpha[1] = ex2((st.m[1] - mx1) * c);
  st.m[0] = mx0;
  st.m[1] = mx1;
  const float mc0 = mx0 * c, mc1 = mx1 * c;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], c, -mc0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], c, -mc0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], c, -mc1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], c, -mc1));
    rs0 += sc[4 * j] + sc[4 * j + 1];
    rs1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l[0] = st.l[0] * alpha[0] + rs0;
  st.l[1] = st.l[1] * alpha[1] + rs1;
}

// O *= alpha row by row, then P (the probabilities in sc) in bf16 as the A
// fragment of each 16-key step: two adjacent 8-key accumulator blocks are
// exactly one m64k16 A fragment.
template <int D>
__device__ __forceinline__ void rescale_and_pack(RowState<D>& st, const float* sc,
                                                 const float (&alpha)[2],
                                                 uint32_t (&pa)[HopperLayout<D>::BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[4 * j] *= alpha[0];
    st.o[4 * j + 1] *= alpha[0];
    st.o[4 * j + 2] *= alpha[1];
    st.o[4 * j + 3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < HopperLayout<D>::BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Issues O += P V of key block kt (asynchronous; the caller has waited for
// the block's V and fenced).
template <int D>
__device__ __forceinline__ void issue_pv(RowState<D>& st,
                                         const uint32_t (&pa)[HopperLayout<D>::BK / 16][4],
                                         uint32_t base, int kt) {
  using L = HopperLayout<D>;
  const uint32_t v_tile = base + L::V_OFF + (kt % L::ST) * L::KV_BYTES;
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk)  // V: 16 keys (rows) a step, MN-major
    Wgmma<D>::template rs<1>(st.o, pa[kk],
                             smem_desc(v_tile + kk * 16 * L::SWB, L::BK * L::SWB,
                                       8 * L::SWB, L::DESC_LAYOUT));
}

// Gives stage kt back to the producer: one arrival from each consumer warp.
template <int D>
__device__ __forceinline__ void release_block(uint32_t base, int kt) {
  using L = HopperLayout<D>;
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(base + L::BAR_OFF + 8 * (1 + 2 * L::ST + kt % L::ST));
}

// Key block kt >= 1 for one consumer warpgroup, with P of block kt - 1 in
// pa: S(kt) = Q K^T and O += P V(kt - 1) are issued together; the softmax
// of block kt runs on the CUDA cores while P V(kt - 1) is still on the
// tensor cores; then O is rescaled and P(kt) packed.  Every mbarrier wait
// comes before the wgmma fence, so no wgmma sits on a branch of its own
// (ptxas would serialize them all).
template <int D, bool MASK>
__device__ __forceinline__ void consume_block(RowState<D>& st, float* sc,
                                              uint32_t (&pa)[HopperLayout<D>::BK / 16][4],
                                              uint32_t base, uint32_t q_rows, int kt, int qpos0,
                                              const Params& p, float c) {
  constexpr int BK = HopperLayout<D>::BK;
  wait_block<D>(base, kt, 0);
  wait_block<D>(base, kt - 1, 1);
  wgmma_fence();
  issue_scores<D>(sc, base, q_rows, kt);
  wgmma_commit();
  issue_pv<D>(st, pa, base, kt - 1);
  wgmma_commit();
  wgmma_wait<1>();  // S(kt) is done, P V(kt - 1) may still run
  reg_fence<BK / 2>(sc);
  float alpha[2];
  softmax_block<D, MASK>(st, sc, kt, qpos0, p, c, alpha);
  wgmma_wait<0>();
  reg_fence<D / 2>(st.o);
  release_block<D>(base, kt - 1);
  rescale_and_pack<D>(st, sc, alpha, pa);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = HopperLayout<D>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  // mbarriers: full_q, full_k[ST], full_v[ST], empty[ST]
  const uint32_t bars = base + L::BAR_OFF;

  const int nq = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int nk = key_tiles(p, q0, kBQ, BK);
  // blocks before n_plain lie wholly inside Sk and, when causal, wholly at
  // or below the diagonal of every row of the tile: no mask
  int n_plain = min(nk, p.Sk / BK);
  if (p.causal) n_plain = min(n_plain, q0 / BK);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + L::ST + s), 1);
      mbar_init(bars + 8 * (1 + 2 * L::ST + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread of warp 8 issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_q)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_k)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_v)) : "memory");
      mbar_expect_tx(bars, L::Q_BYTES);
      for (int c = 0; c < L::NC; ++c)
        tma_load(base + c * kBQ * L::SWB, &tm_q, bars, c * L::SW, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % L::ST;
        mbar_wait(bars + 8 * (1 + 2 * L::ST + s), ((kt / L::ST) & 1) ^ 1);  // stage free
        const uint32_t full_k = bars + 8 * (1 + s), full_v = bars + 8 * (1 + L::ST + s);
        mbar_expect_tx(full_k, L::KV_BYTES);
        for (int c = 0; c < L::NC; ++c)
          tma_load(base + L::K_OFF + s * L::KV_BYTES + c * BK * L::SWB, &tm_k, full_k,
                   c * L::SW, kt * BK, kvh, b);
        mbar_expect_tx(full_v, L::KV_BYTES);
        for (int c = 0; c < L::NC; ++c)
          tma_load(base + L::V_OFF + s * L::KV_BYTES + c * BK * L::SWB, &tm_v, full_v,
                   c * L::SW, kt * BK, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int qpos0 = q0 + 64 * wg + 16 * warp + lane / 4;
    const float c = p.scale * 1.4426950408889634f;  // scores to log2 units
    RowState<D> st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = kNegInf;
    st.l[0] = st.l[1] = 0.f;
    const uint32_t q_rows = base + 64 * wg * L::SWB;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];
    mbar_wait(bars, 0);  // Q has landed
    wait_block<D>(base, 0, 0);
    wgmma_fence();
    issue_scores<D>(sc, base, q_rows, 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<BK / 2>(sc);
    if (n_plain > 0)
      softmax_block<D, false>(st, sc, 0, qpos0, p, c, alpha);
    else
      softmax_block<D, true>(st, sc, 0, qpos0, p, c, alpha);
    rescale_and_pack<D>(st, sc, alpha, pa);
    // blocks before n_plain unmasked, the rest masked
    int kt = 1;
    for (; kt < n_plain; ++kt) consume_block<D, false>(st, sc, pa, base, q_rows, kt, qpos0, p, c);
    for (; kt < nk; ++kt) consume_block<D, true>(st, sc, pa, base, q_rows, kt, qpos0, p, c);
    wait_block<D>(base, nk - 1, 1);  // the last block's P V
    wgmma_fence();
    issue_pv<D>(st, pa, base, nk - 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<D / 2>(st.o);
    release_block<D>(base, nk - 1);

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qpos = qpos0 + 8 * r;
      if (qpos < p.Sq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(og + qpos * p.o_ss + 8 * j + 2 * (lane % 4)) =
              pack_bf16(st.o[4 * j + 2 * r] * inv, st.o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (batch, heads, S, D) bf16 tensor with element strides (sb, sh, ss, 1)
// as a 4-D tensor map, boxes of `rows` x sw elements, swizzled.
bool encode_bhsd(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int heads, int S,
                 int D, long long sb, long long sh, long long ss, int sw, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  // bytes, dims 1..3; a dimension of extent 1 gets its packed stride (any
  // stride addresses it, but TMA wants a non-zero multiple of 16)
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint64_t packed = 2ull * D;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using L = HopperLayout<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bhsd(encode, &tq, p.q, p.B, p.H, p.Sq, D, p.q_sb, p.q_sh, p.q_ss, L::SW, kBQ) ||
      !encode_bhsd(encode, &tk, p.k, p.B, p.KVH, p.Sk, D, p.k_sb, p.k_sh, p.k_ss, L::SW,
                   L::BK) ||
      !encode_bhsd(encode, &tv, p.v, p.B, p.KVH, p.Sk, D, p.v_sb, p.v_sh, p.v_ss, L::SW, L::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_bf16_kernel<D><<<grid, kHopperThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D>(p, stream);
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(F32Layout<D>::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + F32Tile<D>::BQ - 1) / F32Tile<D>::BQ, p.H, p.B);
  flash_fwd_f32_kernel<D><<<grid, kThreads, F32Layout<D>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, sequence) strides of q, k, v and o in that order.  bf16
// tensors must be 16-byte aligned with strides in multiples of 8 elements
// (TMA's rules).
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

// Dynamic shared memory of one CTA (bytes) for head dim D and dtype, or -1.
extern "C" int repro_flash_attention_smem_bytes(int dtype, int D) {
  switch (D) {
    case 32: return static_cast<int>(dtype ? HopperLayout<32>::kBytes : F32Layout<32>::kBytes);
    case 64: return static_cast<int>(dtype ? HopperLayout<64>::kBytes : F32Layout<64>::kBytes);
    case 128:
      return static_cast<int>(dtype ? HopperLayout<128>::kBytes : F32Layout<128>::kBytes);
    case 256:
      return static_cast<int>(dtype ? HopperLayout<256>::kBytes : F32Layout<256>::kBytes);
    default: return -1;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
