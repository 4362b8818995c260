// Intra-chunk SSD (Mamba2 state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel`, reached through
// `_chunks_fwd_impl` (entries `ssd_chunk_pallas`, `ssd_chunks_flat`) in
// src/repro/kernels/ssd_scan.py.  It computes the same function.  For each
// (batch b, chunk c, head h), from the chunk's Q rows of x (Q,P), dt (Q), B and
// C (Q,N) and the scalar A[h], all in f32:
//   cs     = cumsum(dt * A)                                            (Q,)
//   y_diag = M x,  M[i,j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0
//   state  = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j = Bᵀ (w∘x)     (N,P)
//   gamma  = exp(cs_last)
// y_diag is stored in x's dtype, state and gamma in f32.
//
// What bounds it on this card.  At mamba2-1.3b's 2048-token prefill (B 1,
// nc 8, Q 256, H 64, P 64, N 128, bf16, B and C shared by the heads) the
// products are 0.067 GFLOP of C Bᵀ (once per chunk) and 4.3 GFLOP with an
// f32 operand (M, w∘x), which the tensor cores run twice (below): 0.009 ms
// at 989 TFLOP/s bf16.  The 51.6 MB that must move (x and y in bf16, the f32
// states) take 0.015 ms at 3.35 TB/s: it is bound by bytes, as long as no
// product runs on the CUDA cores (67 TFLOP/s would take 0.13 ms).  What
// holds it now is instructions: forming and splitting a per-head 64 x 64
// f32 operand a tile pair is ~700 instructions a warp, with 8 warps an SM
// (their registers allow no more).
//
// What the design does about it:
//   * Every product runs on `wgmma` (hopper.cuh), bf16 operands, f32
//     accumulators.  s = C Bᵀ takes the bf16 inputs as they are (exact
//     products).  The f32 operands, M of y = M x and w∘x of the state
//     Bᵀ (w∘x), are split into hi = bf16(v) and lo = bf16(v - hi), and each
//     product runs twice, hi and lo, against the same bf16 operand: ~16
//     mantissa bits, never a single rounding of M or w∘x.  The f32 instance
//     (f32 inputs) splits its inputs too and sums hi·hi + hi·lo + lo·hi.
//   * Two kinds of CTA in one launch, each two warpgroups (256 threads)
//     over a block of up to kHeads heads of one (batch, chunk) and 64
//     columns of P (P <= 128 goes in parts):
//       - row CTAs, one per 64-row tile i: form s_ij = C_i B_jᵀ for the
//         column tiles j <= i ONCE for the block's heads when B and C are
//         shared by them (stride 0 over heads, as `expand` gives; the
//         models' one group), f32 in shared memory (so at H 64 it is formed
//         8 times per (batch, chunk), once per head block and 64 columns of
//         P: 16 heads a CTA is slower at B 1); then each warpgroup
//         takes every other head and, per tile pair, forms M from s as a
//         register A fragment (hi, lo) and runs y_i += M x_j;
//       - state CTAs, one per 64 state rows n: keep B's 64 columns for all
//         Q rows in shared memory, then per head and 64-row tile form w∘x
//         (hi, lo) in place of the x tile and run state += Bᵀ (w∘x), Bᵀ read
//         MN-major (the transpose bit) from the same tiles.
//     Per-head B or C (stride != 0) is read per head: the CTA forms s (or
//     loads B) for one head at a time, and one warpgroup runs it.
//     The heaviest CTAs launch first: state CTAs (Q / 64 tiles a head),
//     then row tiles from the last.  Nothing is summed across CTAs: no
//     atomics, and two runs give the same bits.
//   * Overlap: in one iteration a warpgroup issues a step's products, forms
//     the next step's M (w∘x) while they run, then waits (K3's pattern; no
//     wgmma stays in flight across the loop's back edge, and each head's
//     first product overwrites its accumulator, or ptxas serializes the
//     wgmmas, C7511/C7514).  x tiles go by `cp.async` into a ring of 4
//     stages a warpgroup, 128-byte swizzled, three steps ahead; f32 tiles
//     are split to hi/lo bf16 on the way in.  The head block's dt and the
//     first B (and C) tiles load before the head scalars form.  A stride-0
//     head broadcast of B or C is read through its strides at no copy;
//     tiles past Q, N or P load as zeros.
//   * Stores: a finished tile goes through its step's stage; a contiguous
//     block (the models' states) leaves by one bulk copy, which drains while
//     the warpgroup goes on, y as whole 16-byte row pieces.
//   * G = exp(cs_i - cs_j) is masked by selection, never multiplied by a
//     0/1 mask (above the diagonal it overflows, and inf * 0 is NaN).  Only
//     the diagonal (and a ragged) tile pair is masked; below it G = a_i b_j,
//     a_i = exp(cs_i - c) and b_j = exp(c - cs_j) with c = cs at the last
//     row of tile j, so a tile pair takes 2 exponentials a thread, not 32.
//     Precondition of that factorization: cs does not increase (A <= 0 and
//     dt >= 0, as every model gives), so both factors are <= 1.  The kernel
//     checks dt * A <= 0 on every row of a head; where that fails, every
//     tile pair of the head takes exp(cs_i - cs_j) per entry, as the
//     diagonal does.  Such a head's outputs are finite, and its states,
//     gamma and bf16 y keep their tolerance; the f32 instance's y may not:
//     where cs rises nothing decays, and the ~16 bits that hi + lo keep of
//     C, B, M and x add up to about 1e-3 of y (with A = 0.002 and 0.005 at
//     Q 256, up to 1.7 times y's 1e-3 tolerance, where the plain f32
//     version stays within a tenth of it).
//   * Every wgmma is issued between a fence and a commit, none on a branch
//     of its own, so ptxas does not serialize them (C7520); descriptors are
//     built where they are used (hopper.cuh).
//   * Any Q <= 256 (rows past Q load as zeros and are not stored), P <= 128
//     and N <= 256 (64-column pieces).
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernel launches on the caller's stream, allocates nothing, and
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

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;               // rows and columns of a tile
constexpr int kMaxQ = 256;
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kP = 64;                  // columns of x a CTA (P <= 128 in parts of 64)
constexpr int kHeads = 8;               // heads a CTA, at most
constexpr int kYRow = 2 * kP + 16;      // bytes a row of a bf16 y tile staged in shared memory
// Params::vec bits: the tensor takes 16-byte loads
constexpr int kVecX = 1, kVecB = 2, kVecC = 4;

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
  int vec;
  int shared;        // B and C are one tensor for every head (stride 0)
  int head_blocks;   // ceil(H / kHeads)
  int parts;         // ceil(P / kP)
  int cells;         // B * nc * head_blocks * parts: the CTAs of one kind and tile
};

__host__ __device__ constexpr int n_tiles(int Q) { return (Q + kTile - 1) / kTile; }
__host__ __device__ constexpr int n_pieces(int N) { return (N + 63) / 64; }

// Shared memory (bytes from a 1024-aligned base).  A 64-row bf16 tile of F
// features takes 128 F bytes; f32 inputs keep two (hi, lo).
//   P_OFF: row CTAs' s, up to 4 tiles of 64 x 64 f32 (16 KB each, in the
//          accumulator fragment's order, so each thread reads its own 32
//          values as 8 conflict-free 16-byte loads); state CTAs' B columns,
//          one 64 x 64 tile (hi, lo) per row tile;
//   U_OFF: a ring of XST x stages per warpgroup, each x (hi, lo) or w∘x
//          (hi, lo); before it, a row CTA's C_i and B_j tiles to form s;
//   F_OFF: per head: cs, dt, and bdt_q = exp(c - cs_q) dt_q (row CTAs) or
//          w_q = exp(cs_last - cs_q) dt_q (state CTAs); whether cs falls.
template <typename T> struct Layout {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr uint32_t S = kSplit ? 2 : 1;             // copies of an input tile
  static constexpr uint32_t CHUNK = kTile * 128;            // 64 x 64 bf16
  static constexpr uint32_t UNIT = S * CHUNK;               // a 64 x 64 input tile
  static constexpr uint32_t XT = kTile * kP * 2;            // a 64 x 64 bf16 tile
  static constexpr uint32_t XSTAGE = 2 * XT;
  static constexpr int XST = 4;                            // stages a warpgroup
  static constexpr uint32_t RING = XST * XSTAGE;
  static constexpr uint32_t P_OFF = 0, P_BYTES = 4 * kTile * kTile * 4;
  static constexpr uint32_t U_OFF = P_BYTES, U_BYTES = kWarpgroups * RING;
  static constexpr uint32_t F_OFF = U_OFF + U_BYTES;
  static constexpr size_t kBytes = F_OFF + 4 * (3 * kHeads * kMaxQ + kHeads) + 1024;
  static_assert(kBytes <= 232448, "shared memory");
  static_assert(n_tiles(kMaxQ) * UNIT <= P_BYTES, "a state CTA's B columns");
  static_assert(kTile * kYRow <= XSTAGE && kTile * 4 * kP <= XSTAGE, "a tile staged in a stage");
  static_assert((n_tiles(kMaxQ) + 1) * UNIT <= U_BYTES, "one piece of C_i and every B_j");
};

__device__ __forceinline__ void wg_sync(int wg) {  // the warpgroup's 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Steps of a warpgroup's loop: step u is tile jt of local head hl.
struct Walk {
  int u, jt, hl;
  __device__ __forceinline__ void next(int ns, int stride) {
    ++u;
    if (++jt == ns) {
      jt = 0;
      hl += stride;
    }
  }
};

// A warpgroup's 64 x 64 f32 accumulator to rows 0 .. rows - 1 and columns
// 0 .. cols - 1 of a row-major tensor of T at dst (row stride `stride`),
// through the ring stage at st (every warp's product has read it by the
// first barrier), in rows of kRow bytes.  Where the rows are one contiguous
// block (the models' states) one thread hands it to the bulk-copy engine,
// whose writes drain while the warpgroup goes on; the caller's warp 0 waits
// with bulk_wait_read before the stage is loaded again.  Otherwise each
// thread stores whole 16-byte pieces of rows (elements where a row is not
// whole pieces).
template <typename T>
__device__ void store_tile(const float (&acc)[kP / 2], T* dst, long long stride, int rows,
                           int cols, uint32_t st, unsigned char* sg, int wg) {
  constexpr int kRow = sizeof(T) == 2 ? kYRow : 4 * kP, kPieces = kP * sizeof(T) / 16;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  wg_sync(wg);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int jj = 0; jj < kP / 8; ++jj) {
      unsigned char* at_rc = sg + (r0 + 8 * u) * kRow + sizeof(T) * (8 * jj + cq);
      const float v0 = acc[4 * jj + 2 * u], v1 = acc[4 * jj + 2 * u + 1];
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(at_rc) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(at_rc) = make_float2(v0, v1);
    }
  const bool aligned =
      (reinterpret_cast<uintptr_t>(dst) | stride * sizeof(T) | cols * sizeof(T)) % 16 == 0;
  if (aligned && stride == cols && cols * sizeof(T) == kRow) {
    fence_async_smem();
    wg_sync(wg);
    if (t == 0) {
      bulk_store(dst, st, rows * kRow);
      bulk_commit();
    }
    return;
  }
  wg_sync(wg);
#pragma unroll
  for (int i = 0; i < kTile * kPieces / 128; ++i) {
    const int idx = t + 128 * i, r = idx / kPieces, k = idx % kPieces, c0 = k * 16 / sizeof(T);
    if (r >= rows || c0 >= cols) continue;
    const unsigned char* src = sg + r * kRow + 16 * k;
    T* out = dst + r * stride + c0;
    if (aligned) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 16 / static_cast<int>(sizeof(T)) && c0 + e < cols; ++e)
        out[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

// Rows q0 .. q0 + 63 of a (batch, chunk, row, head, feature) tensor read
// through its strides, features f0 .. f0 + 8 pieces - 1, into the swizzled
// bf16 tile at `hi` (64 rows); an f32 tensor also writes the low halves of
// its split at `lo`.  Rows at or past Q and features past F are zero.  Thread
// `tid` of `nthr` takes pieces tid, tid + nthr, ...; with `vec` (16-byte
// aligned base and strides, F % 8 == 0) bf16 pieces go by cp.async (the
// caller commits and waits), the rest through registers, four loads in
// flight before the first store.
template <typename T>
__device__ __forceinline__ void load_rows(int tid, int nthr, uint32_t hi, uint32_t lo, const T* g,
                                          const long long s[4], int b, int c, int h, int q0, int Q,
                                          int f0, int pieces, int F, bool vec) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const int total = kTile * pieces;
  if constexpr (!kSplit) {
    if (vec) {
#pragma unroll 4
      for (int i = tid; i < total; i += nthr) {
        const int r = i / pieces, k = i % pieces, q = q0 + r, f = f0 + 8 * k;
        const bool in = q < Q && f < F;
        cp_async16(hi + swz(kTile, r, k), in ? g + at(s, b, c, q, h) + f : g, in ? 16 : 0);
      }
      return;
    }
  }
#pragma unroll 1
  for (int i0 = tid; i0 < total; i0 += 4 * nthr) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nthr;
      const int r = i / pieces, k = i % pieces, q = q0 + r, f = f0 + 8 * k;
      const bool in = i < total && q < Q && f < F;
      const T* src = in ? g + at(s, b, c, q, h) + f : g;
      if (vec && in) {
        load8(v[u], src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = in && f + e < F ? to_f32(src[e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nthr;
      if (i < total) {
        const int r = i / pieces, k = i % pieces;
        uint32_t h4[4], l4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(v[u][2 * e], v[u][2 * e + 1], h4[e], l4[e]);
        st_shared_v4(hi + swz(kTile, r, k), h4);
        if constexpr (kSplit) st_shared_v4(lo + swz(kTile, r, k), l4);
      }
    }
  }
}

// A warpgroup's x tiles (64 rows from j0, columns p0 .. p0 + 63, of head h)
// into a ring stage, in load_rows' order: thread t takes piece t % 8 of rows
// t / 8 + 16 i, so its offsets are fixed and a tile adds one base.  bf16
// with 16-byte access goes by cp.async; the rest through load_rows.
template <typename T>
struct XTiles {
  const T* g;
  const long long* s;
  long long bc;        // b s[0] + c s[1] + p0 + 8 (t % 8)
  int b, c, p0, t, P;
  bool vec, fast, col_in;
  __device__ XTiles(const Params& p, int b_, int c_, int p0_, int t_)
      : g(static_cast<const T*>(p.x)), s(p.x_s), b(b_), c(c_), p0(p0_), t(t_), P(p.P) {
    bc = b * s[0] + c * s[1] + p0 + 8 * (t % 8);
    vec = p.vec & kVecX;
    fast = vec && !std::is_same<T, float>::value;
    col_in = p0 + 8 * (t % 8) < P;
  }
  // rows at or past q_end load as zeros
  __device__ __forceinline__ void load(uint32_t hi, uint32_t lo, int h, int j0, int q_end) const {
    if (fast) {
      const T* tile = g + bc + h * s[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = t / 8 + 16 * i;
        const bool in = col_in && j0 + r < q_end;
        cp_async16(hi + swz(kTile, r, t % 8), in ? tile + (j0 + r) * s[2] : g, in ? 16 : 0);
      }
    } else {
      load_rows<T>(t, 128, hi, lo, g, s, b, c, h, j0, q_end, p0, kP / 8, P, vec);
    }
  }
};

// The head block's dt, a thread's share (neighbouring threads, neighbouring
// heads), loaded into registers: the kernel issues these first.
constexpr int kLoads = kHeads * kMaxQ / kThreads;
template <typename T>
__device__ __forceinline__ void load_dt(const Params& p, int b, int c, int h0, int nh,
                                        float (&dv)[kLoads]) {
  const T* dtg = static_cast<const T*>(p.dt);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads, hh = i % nh, q = i / nh;
    dv[k] = i < nh * p.Q ? to_f32(dtg[at(p.dt_s, b, c, q, h0 + hh)]) : 0.f;
  }
}

// Per head of the block, from its dt (load_dt): cs = cumsum(dt * A) (warp w
// scans heads w, w + 8, ...: each lane sums 8 consecutive rows, then the
// lanes' totals are scanned with shuffles, as K5 does), whether cs falls,
// and v: w_q (state CTAs; 0 past Q) or bdt_q with c = cs at the last row of
// q's tile (row CTAs).
__device__ void head_scalars(const Params& p, int h0, int nh, bool state, const float (&dv)[kLoads],
                             float* cs, float* dts, float* v, int* falls) {
  const int tid = threadIdx.x, Q = p.Q, rows = n_tiles(Q) * kTile;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = tid + k * kThreads;
    if (i < nh * Q) dts[(i % nh) * kMaxQ + i / nh] = dv[k];
  }
  __syncthreads();
  for (int hh = warp; hh < nh; hh += kThreads / 32) {
    const float A = p.A[h0 + hh];
    const float* dh = dts + hh * kMaxQ;
    float* ch = cs + hh * kMaxQ;
    constexpr int kRun = kMaxQ / 32;
    float run = 0.f, vv[kRun];
    bool down = true;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = lane * kRun + k;
      const float d = q < Q ? dh[q] * A : 0.f;
      down = down && d <= 0.f;
      run += d;
      vv[k] = run;
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
    for (int k = 0; k < kRun; ++k) {
      const int q = lane * kRun + k;
      if (q < Q) ch[q] = excl + vv[k];
    }
    down = __all_sync(0xffffffffu, down);
    if (lane == 0) falls[hh] = down;
  }
  __syncthreads();
  for (int i = tid; i < nh * kMaxQ; i += kThreads) {
    const int hh = i / kMaxQ, q = i % kMaxQ;
    if (q >= rows) continue;
    const float* ch = cs + hh * kMaxQ;
    float val = 0.f;
    if (q < Q) {
      const float d = dts[hh * kMaxQ + q];
      val = state ? expf(ch[Q - 1] - ch[q]) * d
                  : __expf(ch[min((q / kTile + 1) * kTile, Q) - 1] - ch[q]) * d;
    }
    v[hh * kMaxQ + q] = val;
  }
  __syncthreads();
}

// ---- row CTA, phase 1: s_ij = C_i B_jᵀ for j <= it, for the heads that read
// head h's B and C, into P_OFF.  Batches of nb 64-column pieces of N: the
// batch's C_i and B_j pieces are loaded by the whole CTA; warpgroup wg forms
// tiles wg, wg + 2, ...  Where one batch holds all of N (the models' bf16
// shapes) it is loaded once for both, nothing in the loop syncs the CTA, and
// a warpgroup stops at tile it.  Where it takes several, the batches'
// barriers need both warpgroups to run two tiles: a tile past it computes
// tile 0 and is not stored (no wgmma sits on a branch of its own).  The
// kernel issues the first batch's loads before the head scalars (issued =
// true), so their latency hides behind them.
template <typename T>
__device__ __forceinline__ int s_batch(const Params& p, int it) {
  using L = Layout<T>;
  return min(n_pieces(p.N), static_cast<int>(L::U_BYTES / (L::UNIT * (it + 2))));
}

template <typename T>
__device__ void issue_s_batch(const Params& p, uint32_t base, int b, int c, int h, int it, int k0) {
  using L = Layout<T>;
  const int nb = s_batch<T>(p, it), nbk = min(nb, n_pieces(p.N) - k0);
  const uint32_t area = base + L::U_OFF, tile = nb * L::UNIT, lo = nb * L::CHUNK;
  load_rows<T>(threadIdx.x, kThreads, area, area + lo, static_cast<const T*>(p.Cm), p.c_s, b, c,
               h, it * kTile, p.Q, 64 * k0, 8 * nbk, p.N, p.vec & kVecC);
  for (int j = 0; j <= it; ++j) {
    const uint32_t bt = area + (1 + j) * tile;
    load_rows<T>(threadIdx.x, kThreads, bt, bt + lo, static_cast<const T*>(p.Bm), p.b_s, b, c, h,
                 j * kTile, p.Q, 64 * k0, 8 * nbk, p.N, p.vec & kVecB);
  }
  cp_async_commit();
}

__device__ __forceinline__ void land() {  // the CTA's loads are in shared memory, for wgmma too
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
}

template <typename T>
__device__ void form_s(const Params& p, uint32_t base, unsigned char* gen, int b, int c, int h,
                       int it, bool issued) {
  using L = Layout<T>;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int npc = n_pieces(p.N), nb = s_batch<T>(p, it);
  const uint32_t area = base + L::U_OFF, tile = nb * L::UNIT, lo = nb * L::CHUNK;
  const auto load_batch = [&](int k0) {
    if (!issued) {    // (the first batch's loads are in flight already)
      __syncthreads();  // the previous batch (or phase) is read
      issue_s_batch<T>(p, base, b, c, h, it, k0);
    }
    issued = false;
    land();
  };
  const bool one_batch = nb >= npc;
  if (one_batch) load_batch(0);
  const int jn = one_batch ? it + 1 : 4;   // (above)
  float4* s4 = reinterpret_cast<float4*>(gen + L::P_OFF) + t;
  for (int j = wg; j < jn; j += 2) {
    const uint32_t ct = area, bt = area + (1 + (j <= it ? j : 0)) * tile;
    float s[32];
    for (int k0 = 0; k0 < npc; k0 += nb) {
      if (!one_batch) load_batch(k0);
      for (int kc = 0; kc < min(nb, npc - k0); ++kc) {
        const int acc = k0 > 0 || kc > 0;
        wgmma_fence();
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int kk = 4 * kc + k4;
          const uint64_t a = desc_k(ct, kTile, kk), bb = desc_k(bt, kTile, kk);
          Wgmma<64>::template ss<0>(s, a, bb, acc || k4 > 0);
          if constexpr (L::kSplit) {
            Wgmma<64>::template ss<0>(s, a, desc_k(bt + lo, kTile, kk), 1);
            Wgmma<64>::template ss<0>(s, desc_k(ct + lo, kTile, kk), bb, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<32>(s);
      }
    }
    if (j <= it) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        s4[j * 1024 + k * 128] = make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
    }
  }
  __syncthreads();  // s is written; the C_i, B_j area is free for the rings
}

// ---- row CTA, phase 2, one warpgroup: y of row tile it for `count` heads
// (local indices first, first + stride, ...), steps u = (head, column tile
// j <= it) in order.  Step u runs M_u x_u while it forms M_{u+1} in f32
// registers (K3's pattern: issued, other work, waited, in one iteration);
// after the wait M_{u+1} is split into the A fragments.
template <typename T>
__device__ void y_rows(const Params& p, uint32_t base, unsigned char* gen, int b, int c, int h0,
                       int p0, int it, int first, int stride, int count, const float* cs,
                       const float* dts, const float* v, const int* falls) {
  using L = Layout<T>;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4;    // the thread's tile rows r0, r0 + 8
  const int cq = 2 * (lane % 4);          // its first column of each 8-column block
  const int Q = p.Q, P = p.P, i0 = it * kTile, ns = it + 1;
  const int steps = count * ns;
  const uint32_t ring = base + L::U_OFF + wg * L::RING;
  const float4* s4 = reinterpret_cast<const float4*>(gen + L::P_OFF) + t;
  const XTiles<T> xs(p, b, c, p0, t);
  const auto load = [&](const Walk& w) {  // x_j of step w.u
    if (w.u < steps) {
      const uint32_t st = ring + (w.u % L::XST) * L::XSTAGE;
      xs.load(st, st + L::XT, h0 + w.hl, w.jt * kTile, Q);
    }
  };
  float acc[kP / 2];   // y of the step's head: its first product overwrites it
  const auto store_y = [&](int hl, uint32_t st) {
    T* dst = static_cast<T*>(p.y) +
             (((static_cast<long long>(b) * p.nc + c) * Q + i0) * p.H + h0 + hl) * P + p0;
    store_tile<T>(acc, dst, static_cast<long long>(p.H) * P, min(kTile, Q - i0),
                  min(kP, P - p0), st, gen + (st - base), wg);
  };
  // M of step w = s∘G∘dt_j where j <= i < Q (selected), f32.  Below the
  // diagonal tile G = a_i b_j with c = cs at the tile's last row j (where
  // cs falls).
  float m[32];
  const auto form_m = [&](const Walk& w) {
    const int hl = w.hl, jt = w.jt, j0 = jt * kTile;
    const float* ch = cs + hl * kMaxQ;
    const float4* sv = s4 + jt * 1024;
    if (jt < it && i0 + kTile <= Q && falls[hl]) {
      const float* bh = v + hl * kMaxQ;
      const float c_end = ch[j0 + kTile - 1];
      const float a[2] = {__expf(ch[i0 + r0] - c_end), __expf(ch[i0 + r0 + 8] - c_end)};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 sj = sv[jj * 128];
        const float2 bd = *reinterpret_cast<const float2*>(bh + j0 + 8 * jj + cq);
        m[4 * jj] = sj.x * a[0] * bd.x;
        m[4 * jj + 1] = sj.y * a[0] * bd.y;
        m[4 * jj + 2] = sj.z * a[1] * bd.x;
        m[4 * jj + 3] = sj.w * a[1] * bd.y;
      }
    } else {
      const float* dh = dts + hl * kMaxQ;
      const float cs_i[2] = {ch[i0 + r0], ch[i0 + r0 + 8]};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int qj = j0 + 8 * jj + cq;   // and qj + 1
        const float4 sj = sv[jj * 128];
        const float2 cj = *reinterpret_cast<const float2*>(ch + qj);
        const float2 dj = *reinterpret_cast<const float2*>(dh + qj);
        const float s_e[4] = {sj.x, sj.y, sj.z, sj.w}, c_e[2] = {cj.x, cj.y}, d_e[2] = {dj.x, dj.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + r0 + 8 * (e >> 1), q = qj + (e & 1);
          m[4 * jj + e] = q <= qi && qi < Q
                              ? s_e[e] * __expf(cs_i[e >> 1] - c_e[e & 1]) * d_e[e & 1]
                              : 0.f;
        }
      }
    }
  };
  uint32_t mh[4][4], ml[4][4];
  Walk cur{0, 0, first}, nxt{0, 0, first}, ld{0, 0, first};  // steps u, u + 1, u + XST - 1
  for (int u = 0; u < L::XST - 1; ++u) {
    load(ld);
    cp_async_commit();
    ld.next(ns, stride);
  }
  if (steps > 0) form_m(nxt);
  nxt.next(ns, stride);
  for (int u = 0; u < steps; ++u) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float m4[4] = {m[4 * jj], m[4 * jj + 1], m[4 * jj + 2], m[4 * jj + 3]};
      pack_frag(mh, ml, jj, m4);
    }
    cp_async_wait<L::XST - 2>();  // x of step u has landed
    fence_async_smem();
    if (warp == 0) bulk_wait_read<0>();  // a staged y is read
    wg_sync(wg);                  // ... for every thread; the stage of step u - 1 is read
    load(ld);
    cp_async_commit();
    ld.next(ns, stride);
    const uint32_t xt = ring + (u % L::XST) * L::XSTAGE;
    const int head_first = cur.jt == 0;   // the head's first product overwrites y
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc_mn(xt, kTile, kk);
      Wgmma<kP>::template rs<1>(acc, mh[kk], d, kk > 0 || !head_first);
      Wgmma<kP>::template rs<1>(acc, ml[kk], d);
      if constexpr (L::kSplit) Wgmma<kP>::template rs<1>(acc, mh[kk], desc_mn(xt + L::XT, kTile, kk));
    }
    wgmma_commit();
    if (nxt.u < steps) form_m(nxt);  // while the products run
    wgmma_wait<0>();
    reg_fence<kP / 2>(acc);
    if (nxt.u == steps || nxt.jt == 0) store_y(cur.hl, xt);  // the head's y is complete
    cur.next(ns, stride);
    nxt.next(ns, stride);
  }
  cp_async_wait<0>();
  if (warp == 0) bulk_wait();
}

// ---- state CTA, phase 1: B's columns 64 ck .. 64 ck + 63 for every row
// tile, read from head h, into P_OFF (one tile (hi, lo) per row tile); the
// caller lands them.
template <typename T>
__device__ void issue_b_columns(const Params& p, uint32_t base, int b, int c, int h, int ck) {
  using L = Layout<T>;
  for (int kt = 0; kt < n_tiles(p.Q); ++kt) {
    const uint32_t bt = base + L::P_OFF + kt * L::UNIT;
    load_rows<T>(threadIdx.x, kThreads, bt, bt + L::CHUNK, static_cast<const T*>(p.Bm), p.b_s, b,
                 c, h, kt * kTile, p.Q, 64 * ck, 8, p.N, p.vec & kVecB);
  }
  cp_async_commit();
}

// ---- state CTA, phase 2, one warpgroup: rows 64 ck .. 64 ck + 63 of the
// state for `count` heads, steps u = (head, row tile).  Each thread turns
// the x pieces it loaded itself into w∘x (hi, lo) in place (so no barrier
// comes between its load and its conversion), the next step's while this
// step's Bᵀ (w∘x) runs from another stage.
template <typename T>
__device__ void state_rows(const Params& p, uint32_t base, unsigned char* gen, int b, int c,
                           int h0, int p0, int ck, int first, int stride, int count,
                           const float* v) {
  using L = Layout<T>;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32;
  const int Q = p.Q, N = p.N, P = p.P, nt = n_tiles(Q);
  const int steps = count * nt;
  const uint32_t ring = base + L::U_OFF + wg * L::RING;
  const XTiles<T> xs(p, b, c, p0, t);
  const auto load = [&](const Walk& w) {
    if (w.u < steps) {
      const uint32_t st = ring + (w.u % L::XST) * L::XSTAGE;
      xs.load(st, st + L::XT, h0 + w.hl, w.jt * kTile, Q);
    }
  };
  float acc[kP / 2];   // the step's head's state: its first product overwrites it
  const auto store_state = [&](int hl, uint32_t st) {
    const long long cell = (static_cast<long long>(b) * p.nc + c) * p.H + h0 + hl;
    store_tile<float>(acc, p.states + (cell * N + 64 * ck) * P + p0, P, min(64, N - 64 * ck),
                      min(kP, P - p0), st, gen + (st - base), wg);
  };
  // w∘x (hi, lo) of step w in place of its x in its stage: the thread's own
  // pieces (load_rows' order), which have landed
  const auto convert = [&](const Walk& w) {
    const uint32_t st = ring + (w.u % L::XST) * L::XSTAGE;
    const unsigned char* sg = gen + (st - base);
    const float* wr_ = v + w.hl * kMaxQ + w.jt * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = t / 8 + 16 * i;
      const uint32_t off = swz(kTile, r, t % 8);
      float xv[8];
      const uint4 hraw = *reinterpret_cast<const uint4*>(sg + off);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hraw);
      if constexpr (L::kSplit) {
        const uint4 lraw = *reinterpret_cast<const uint4*>(sg + L::XT + off);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lraw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 hf = __bfloat1622float2(h2[e]), lf = __bfloat1622float2(l2[e]);
          xv[2 * e] = hf.x + lf.x;
          xv[2 * e + 1] = hf.y + lf.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 hf = __bfloat1622float2(h2[e]);
          xv[2 * e] = hf.x;
          xv[2 * e + 1] = hf.y;
        }
      }
      const float wr = wr_[r];
      uint32_t h4[4], l4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split2(xv[2 * e] * wr, xv[2 * e + 1] * wr, h4[e], l4[e]);
      st_shared_v4(st + off, h4);
      st_shared_v4(st + L::XT + off, l4);
    }
  };

  Walk cur{0, 0, first}, ld{0, 0, first};   // steps u and u + XST - 1
  for (int u = 0; u < L::XST - 1; ++u) {
    load(ld);
    cp_async_commit();
    ld.next(nt, stride);
  }
  if (steps > 0) {
    cp_async_wait<L::XST - 2>();  // x of step 0
    convert(cur);
  }
  // step u: state += Bᵀ (w∘x)_u; while it runs, w∘x of step u + 1
  for (int u = 0; u < steps; ++u) {
    const uint32_t st = ring + (u % L::XST) * L::XSTAGE;
    const uint32_t bt = base + L::P_OFF + cur.jt * L::UNIT;
    const int head_first = cur.jt == 0;   // the head's first product overwrites the state
    fence_async_smem();
    if (warp == 0) bulk_wait_read<0>();  // a staged state is read
    wg_sync(wg);  // w∘x of step u is written by every thread; stage u - 1 is read
    load(ld);
    cp_async_commit();
    ld.next(nt, stride);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_mn(bt, kTile, kk), wx = desc_mn(st, kTile, kk);
      Wgmma<kP>::template ss<1, 1>(acc, a, wx, kk > 0 || !head_first);
      Wgmma<kP>::template ss<1, 1>(acc, a, desc_mn(st + L::XT, kTile, kk), 1);
      if constexpr (L::kSplit)
        Wgmma<kP>::template ss<1, 1>(acc, desc_mn(bt + L::CHUNK, kTile, kk), wx, 1);
    }
    wgmma_commit();
    Walk nxt = cur;
    nxt.next(nt, stride);
    if (nxt.u < steps) {
      cp_async_wait<L::XST - 2>();  // x of step u + 1
      convert(nxt);
    }
    wgmma_wait<0>();
    reg_fence<kP / 2>(acc);
    if (nxt.u == steps || nxt.jt == 0) store_state(cur.hl, st);  // the head's state is complete
    cur = nxt;
  }
  cp_async_wait<0>();
  if (warp == 0) bulk_wait();
}

// One CTA: blockIdx.x < cells * n_pieces(N) is a state CTA for (head block,
// part of P, 64 state rows), the rest row CTAs, the last row tile first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_fwd_kernel(const Params p) {
  using L = Layout<T>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  unsigned char* gen = smem_raw + (base - raw);   // generic pointer to base
  float* cs = reinterpret_cast<float*>(gen + L::F_OFF);
  float* dts = cs + kHeads * kMaxQ;
  float* v = dts + kHeads * kMaxQ;
  int* falls = reinterpret_cast<int*>(v + kHeads * kMaxQ);

  const int nt = n_tiles(p.Q), npc = n_pieces(p.N);
  const int n_state = p.cells * npc;
  int idx = blockIdx.x, it = 0, ck = 0;
  const bool state = idx < n_state;
  if (state) {
    ck = idx % npc;
    idx /= npc;
  } else {
    idx -= n_state;
    it = nt - 1 - idx / p.cells;
    idx %= p.cells;
  }
  const int p0 = idx % p.parts * kP;
  idx /= p.parts;
  const int hb = idx % p.head_blocks, bc = idx / p.head_blocks;
  const int c = bc % p.nc, b = bc / p.nc;
  const int h0 = hb * kHeads, nh = min(kHeads, p.H - h0);
  const int wg = threadIdx.x / 128;

  // dt, then the first group's B (and C) tiles, load while the head
  // scalars form
  float dv[kLoads];
  load_dt<T>(p, b, c, h0, nh, dv);
  if (state)
    issue_b_columns<T>(p, base, b, c, h0, ck);
  else
    issue_s_batch<T>(p, base, b, c, h0, it, 0);
  head_scalars(p, h0, nh, state, dv, cs, dts, v, falls);
  if (state && ck == 0 && threadIdx.x < nh)
    p.gamma[(static_cast<long long>(b) * p.nc + c) * p.H + h0 + threadIdx.x] =
        expf(cs[threadIdx.x * kMaxQ + p.Q - 1]);

  // B and C shared by the heads: one group of nh heads, the warpgroups take
  // every other head; per-head B or C: nh groups of one head, warpgroup 0's
  for (int g = 0; g < (p.shared ? 1 : nh); ++g) {
    const int first = p.shared ? wg : g, stride = p.shared ? 2 : 1;
    const int count = p.shared ? (nh - wg + 1) / 2 : (wg == 0 ? 1 : 0);
    const int h = h0 + (p.shared ? 0 : g);   // the head whose B and C the group reads
    if (state) {
      if (g > 0) issue_b_columns<T>(p, base, b, c, h, ck);
      land();
      state_rows<T>(p, base, gen, b, c, h0, p0, ck, first, stride, count, v);
    } else {
      form_s<T>(p, base, gen, b, c, h, it, g == 0);
      y_rows<T>(p, base, gen, b, c, h0, p0, it, first, stride, count, cs, dts, v, falls);
    }
    __syncthreads();  // the group's s or B columns, and the rings, are free
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T>;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(p.cells) * (n_pieces(p.N) + n_tiles(p.Q));
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_chunk_fwd_kernel<T><<<static_cast<unsigned>(grid), kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, Bm, Cm and y alike; A, states
// and gamma are f32.  x (B,nc,Q,H,P), dt (B,nc,Q,H), Bm and Cm (B,nc,Q,H,N) are
// read through `strides`: 16 element strides, the (batch, chunk, row, head)
// strides of x, dt, Bm and Cm in that order; the last dimension of x, Bm and
// Cm is contiguous.  y (B,nc,Q,H,P), states (B,nc,H,N,P) and gamma (B,nc,H)
// are written contiguous.  Q <= 256, P <= 128, N <= 256.  The kernel's
// factorization of exp(cs_i - cs_j) assumes dt * A <= 0 (cs falls); a head
// where that fails on some row is computed entry by entry instead, and its
// y from f32 inputs may miss 1e-3 of the exact value (above).
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
  const int elem = dtype == 0 ? 4 : 2;
  p.vec = (takes_vec(x, p.x_s, P, elem) ? kVecX : 0) | (takes_vec(Bm, p.b_s, N, elem) ? kVecB : 0) |
          (takes_vec(Cm, p.c_s, N, elem) ? kVecC : 0);
  p.shared = H == 1 || (p.b_s[3] == 0 && p.c_s[3] == 0);
  p.head_blocks = (H + kHeads - 1) / kHeads;
  p.parts = (P + kP - 1) / kP;
  const long long cells = static_cast<long long>(B) * nc * p.head_blocks * p.parts;
  if (cells > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.cells = static_cast<int>(cells);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
}

// Dynamic shared memory (bytes) of a CTA of the instance that takes dtype, or
// -1.
extern "C" int repro_ssd_chunk_fwd_smem_bytes(int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return static_cast<int>(dtype == 0 ? Layout<float>::kBytes : Layout<__nv_bfloat16>::kBytes);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
