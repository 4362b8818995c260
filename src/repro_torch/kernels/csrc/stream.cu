// The paper's Table-1 kernels (K1) and STREAM Triad (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_ew_kernel` (reached through `elementwise`)
// and `_triad_kernel` (through `stream_triad`) in src/repro/kernels/stream.py.
//
// K1 computes y = fn(x1, x2, y0) for one of the 28 expressions of `EXPRS`
// (stream.py:34-63), with the reference's semantics, not a C library's of the
// same name: mod is a - trunc(a/b)*b (not fmod), exp10 is exp2(x * LOG2_10),
// pwr is exp(b * log(a)) (not pow), nint is rint then int32, sign is
// copysign(|a|, b), d2i truncates.  Where the plain version rounds twice
// (fma's y + C0*a, mod, pwr's b*log(a), exp10's x*LOG2_10) the kernel rounds
// twice too, with __dmul_rn/__dadd_rn/__dsub_rn, so that nvcc's FMA
// contraction does not change the result.  Transcendentals are CUDA's f64
// math functions.  Two entries that are not in Table 1 serve the fit of the
// H100 spec (core/calibrate.py fit_h100): POLY16, a 16-deep Horner chain of
// FMAs (32 flops an element; the ALU rate), and FILL, a pure store (the
// write path), each in f64 and f32.
//
// K2 computes y = a + s*b in f32 or f64, rounded as the plain version rounds
// it (a product, then a sum).
//
// What bounds them on this card.  Every Table-1 expression moves 12-24 bytes
// an element and does 1-~50 f64 operations on it; at the H100's 34 TFLOP/s
// f64 and 3.35 TB/s the ridge is ~10 operations a byte, so all of them are
// bound by memory (HBM, or the 50 MB L2 where the working set fits).  Triad
// is the memory benchmark by design.
//
// What the design does about it.  One kernel template per expression (a
// template over the expression id, resolved with `if constexpr`), so no
// timed launch pays for a runtime switch, and each launch reads only the
// arrays its expression uses: x2 only for the two-input expressions, y0
// only for fma, nothing for fill (the TPU kernel DMAs all three).  K1 is
// built for memory-level parallelism: a bound on bytes is reached only with
// enough loads in flight, so each thread takes 4 independent elements an
// iteration and issues the vector loads of all of them before any
// arithmetic, then computes them and stores 16-byte vectors; a long
// expression (exp's ~30 dependent f64 operations) thus no longer holds back
// the next element's loads.  The elements are grouped by the output's
// 16-byte vector (two f64, four f32 or i32), and neighbouring threads take
// neighbouring vectors, so every warp-wide access is one contiguous stretch
// (a thread that wrote 32 contiguous bytes in two stores left each store
// instruction half of every sector, and ran slower on the card than one
// element a thread).
// Inputs come in 16-byte vectors (`double2`, `float4`, `int4`), or 8-byte
// ones where a 4-byte input feeds two f64 outputs (f2d, i2d).  The vector
// path runs when every array the expression touches is 16-byte aligned; the
// last n mod 1024 elements, and every element of a misaligned call, take a
// scalar grid-stride loop.  The vector path launches one block a tile and
// lets the block scheduler fill the card: a grid capped at what fits at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) striding over the tiles
// was 7 % slower on the card (tools/kernel_variants.py); the scalar path
// takes the capped grid.  No
// cache-policy hints: the Fig. 3 rows at n x 1024 measure how much of a
// ~48 MiB set the L2 keeps.
// K2 has K1's access layout: tiles of 1024 threads x 4 elements, each thread
// issuing the 16-byte loads of its elements of a and b (two `double2` or one
// `float4` each) before any arithmetic, neighbouring threads on neighbouring
// vectors; the last n mod tile elements, and every element of a misaligned
// call, go one a thread.  Without a cap it launches one tile a block where
// the tiles fill two waves of the CTAs that fit at once or more (2x the L2
// and beyond), and else those CTAs, striding over the tiles: at 3/4 of the
// L2 (368 tiles on 264 CTAs) one tile a block leaves a short second wave
// and was 6-10 % slower, while the striding grid was 1 % slower at 2x the
// L2 and slower still at 2^26 elements (tools/kernel_variants.py); with a
// cap k it launches exactly k CTAs of 1024 threads striding over the tiles
// with the same layout: the card's counterpart of the reference bench's
// host-thread count (Figs. 4/5).  No cache-policy hints either: the sweep at
// 3/4 of the L2 measures what the L2 keeps.
//
// Plain C interface (built with nvcc into a shared library, loaded with
// ctypes).  The kernels launch on the caller's stream, allocate nothing, and
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr double kC0 = 1.6180339887;          // stream.py C0
constexpr double kLog2_10 = 3.321928094887362;  // stream.py LOG2_10

// Expression ids: the order of `EXPRS` in stream.py, then the two fit entries.
enum Expr {
  ADD, SUB, MUL, FMA, DIV, REV, SQRT, F2D, I2D, D2F, D2I, AINT, NINT, ANINT,
  ABS, MAX, MIN, MOD, SIGN, ATAN, ATAN2, COS, SIN, EXP, EXP10, LOG, LOG10,
  PWR, POLY16, FILL, N_EXPR
};

// Arrays an expression reads: x2 for the two-input ones, y0 for fma only.
__host__ __device__ constexpr bool reads_x1(int e) { return e != FILL; }
__host__ __device__ constexpr bool reads_x2(int e) {
  return e == ADD || e == SUB || e == MUL || e == DIV || e == MAX || e == MIN ||
         e == MOD || e == SIGN || e == ATAN2 || e == PWR;
}
__host__ __device__ constexpr bool reads_y0(int e) { return e == FMA; }

// NaN-propagating maximum/minimum, as jnp.maximum/jnp.minimum (fmax drops a
// NaN operand).
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || b != b) ? a + b : fmax(a, b);
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || b != b) ? a + b : fmin(a, b);
}

template <int E, typename Tin, typename Tout>
__device__ __forceinline__ Tout apply(Tin a, Tin b, Tout y) {
  if constexpr (E == ADD) return __dadd_rn(a, b);
  else if constexpr (E == SUB) return __dsub_rn(a, b);
  else if constexpr (E == MUL) return __dmul_rn(a, b);
  else if constexpr (E == FMA) return __dadd_rn(y, __dmul_rn(kC0, a));
  else if constexpr (E == DIV) return __ddiv_rn(a, b);
  else if constexpr (E == REV) return __ddiv_rn(1.0, a);
  else if constexpr (E == SQRT) return __dsqrt_rn(a);
  else if constexpr (E == F2D || E == I2D) return static_cast<double>(a);
  else if constexpr (E == D2F) return __double2float_rn(a);
  else if constexpr (E == D2I) return __double2int_rz(a);
  else if constexpr (E == AINT) return trunc(a);
  else if constexpr (E == NINT) return __double2int_rn(rint(a));
  else if constexpr (E == ANINT) return rint(a);
  else if constexpr (E == ABS) return fabs(a);
  else if constexpr (E == MAX) return nan_max(a, b);
  else if constexpr (E == MIN) return nan_min(a, b);
  else if constexpr (E == MOD) return __dsub_rn(a, __dmul_rn(trunc(__ddiv_rn(a, b)), b));
  else if constexpr (E == SIGN) return copysign(fabs(a), b);
  else if constexpr (E == ATAN) return atan(a);
  else if constexpr (E == ATAN2) return atan2(a, b);
  else if constexpr (E == COS) return cos(a);
  else if constexpr (E == SIN) return sin(a);
  else if constexpr (E == EXP) return exp(a);
  else if constexpr (E == EXP10) return exp2(__dmul_rn(a, kLog2_10));
  else if constexpr (E == LOG) return log(a);
  else if constexpr (E == LOG10) return log10(a);
  else if constexpr (E == PWR) return exp(__dmul_rn(b, log(a)));
  else if constexpr (E == POLY16) {
    Tout r = a;
#pragma unroll
    for (int k = 0; k < 16; ++k) r = fma(r, a, static_cast<Tout>(1.25));
    return r;
  } else {
    static_assert(E == FILL, "unknown expression");
    return static_cast<Tout>(0);
  }
}

constexpr int kEwThreads = 256;  // K1's block
constexpr int kEwUnroll = 4;     // elements a thread an iteration on the vector path

// P contiguous elements as one vector access: 16 bytes, or 8 bytes where a
// 4-byte type feeds a piece of two 8-byte outputs.
template <int P, typename T> struct VecOf;
template <> struct VecOf<2, double> { using type = double2; };
template <> struct VecOf<4, float> { using type = float4; };
template <> struct VecOf<4, int32_t> { using type = int4; };
template <> struct VecOf<2, float> { using type = float2; };
template <> struct VecOf<2, int32_t> { using type = int2; };

template <typename V, typename T>
__device__ __forceinline__ void unpack(T* dst, const V& v) {
  static_assert(sizeof(V) == 8 || sizeof(V) == 16, "vector");
  dst[0] = v.x;
  dst[1] = v.y;
  if constexpr (sizeof(V) / sizeof(T) == 4) {
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// P elements of T at src (aligned to the access), in as few accesses as the
// vector types allow.
template <int P, typename T>
__device__ __forceinline__ void load_piece(T* dst, const T* src) {
  constexpr int kMax = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kStep = P < kMax ? P : kMax;
  using V = typename VecOf<kStep, T>::type;
#pragma unroll
  for (int k = 0; k < P; k += kStep) unpack(dst + k, *reinterpret_cast<const V*>(src + k));
}

__device__ __forceinline__ void store_piece(double* dst, const double* v) {
  *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store_piece(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_piece(int32_t* dst, const int32_t* v) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

template <int E, typename Tin, typename Tout>
__device__ __forceinline__ void ew_one(const Tin* __restrict__ x1, const Tin* __restrict__ x2,
                                       const Tout* __restrict__ y0, Tout* __restrict__ y,
                                       long long i) {
  const Tin a = reads_x1(E) ? x1[i] : Tin(0);
  const Tin b = reads_x2(E) ? x2[i] : Tin(0);
  const Tout c = reads_y0(E) ? y0[i] : Tout(0);
  y[i] = apply<E, Tin, Tout>(a, b, c);
}

// Scalar path: a grid-stride loop, one element a thread an iteration.
template <int E, typename Tin, typename Tout>
__global__ void __launch_bounds__(kEwThreads) ew_kernel(const Tin* __restrict__ x1,
                                                        const Tin* __restrict__ x2,
                                                        const Tout* __restrict__ y0,
                                                        Tout* __restrict__ y, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    ew_one<E>(x1, x2, y0, y, i);
}

// Vector path (every array 16-byte aligned): tiles of kEwThreads x
// kEwUnroll elements, one a block (the loop covers any grid).  A tile is cut into pieces of one
// 16-byte output vector (P elements); thread t takes pieces t, t +
// kEwThreads, ..., so every load and store instruction of a warp covers
// one contiguous stretch.  All loads of a thread's pieces are issued
// before their arithmetic.  The last n mod tile elements go one a thread.
template <int E, typename Tin, typename Tout>
__global__ void __launch_bounds__(kEwThreads) ew_vec_kernel(const Tin* __restrict__ x1,
                                                            const Tin* __restrict__ x2,
                                                            const Tout* __restrict__ y0,
                                                            Tout* __restrict__ y, long long n) {
  constexpr int U = kEwUnroll;
  constexpr int P = 16 / sizeof(Tout);  // elements a piece
  constexpr int NP = U / P;             // pieces a thread a tile
  constexpr long long kTile = static_cast<long long>(kEwThreads) * U;
  static_assert(U % P == 0, "whole pieces");
  const long long tiles = n / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    Tin a[U] = {}, b[U] = {};
    Tout c[U] = {}, r[U];
    const long long e0 = tile * kTile + static_cast<long long>(threadIdx.x) * P;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const long long e = e0 + static_cast<long long>(k) * kEwThreads * P;
      if (reads_x1(E)) load_piece<P>(a + k * P, x1 + e);
      if (reads_x2(E)) load_piece<P>(b + k * P, x2 + e);
      if (reads_y0(E)) load_piece<P>(c + k * P, y0 + e);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) r[k] = apply<E, Tin, Tout>(a[k], b[k], c[k]);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      store_piece(y + e0 + static_cast<long long>(k) * kEwThreads * P, r + k * P);
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tiles * kTile + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    ew_one<E>(x1, x2, y0, y, i);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Blocks of kEwThreads for `threads` threads of work, at most as many as
// the card holds at once at the scalar kernel's occupancy (queried once).
template <typename Kernel>
int fill_grid(Kernel kernel, int& per_sm, long long threads) {
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kEwThreads, 0) != cudaSuccess)
    per_sm = 1;
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (threads + kEwThreads - 1) / kEwThreads;
  return static_cast<int>(std::max(1LL, std::min(want, static_cast<long long>(sms) * per_sm)));
}

template <int E, typename Tin, typename Tout>
cudaError_t launch(const void* x1, const void* x2, const void* y0, void* y, long long n,
                   cudaStream_t s) {
  const Tin* a = static_cast<const Tin*>(x1);
  const Tin* b = static_cast<const Tin*>(x2);
  const Tout* c = static_cast<const Tout*>(y0);
  Tout* out = static_cast<Tout*>(y);
  const bool vec = aligned16(y) && (!reads_x1(E) || aligned16(x1)) &&
                   (!reads_x2(E) || aligned16(x2)) && (!reads_y0(E) || aligned16(y0));
  if (vec) {
    // one tile a block: the block scheduler keeps the card full
    const long long tiles = n / (static_cast<long long>(kEwThreads) * kEwUnroll);
    const int grid = static_cast<int>(std::max(tiles, 1LL));
    ew_vec_kernel<E, Tin, Tout><<<grid, kEwThreads, 0, s>>>(a, b, c, out, n);
  } else {
    static int per_sm = 0;
    const int grid = fill_grid(ew_kernel<E, Tin, Tout>, per_sm, n);
    ew_kernel<E, Tin, Tout><<<grid, kEwThreads, 0, s>>>(a, b, c, out, n);
  }
  return cudaGetLastError();
}

// One element of expression E and nothing else: never launched, compiled so
// that the f64 operations of apply<E> can be counted in its SASS
// (chip_smoke.py, the bound of each K1 instance).
template <int E, typename Tin, typename Tout>
__global__ void ops_probe(const Tin* x1, const Tin* x2, const Tout* y0, Tout* y) {
  y[0] = apply<E, Tin, Tout>(x1[0], x2[0], y0[0]);
}

#define PROBE(E, Tin, Tout) \
  template __global__ void ops_probe<E, Tin, Tout>(const Tin*, const Tin*, const Tout*, Tout*);
PROBE(ADD, double, double) PROBE(SUB, double, double) PROBE(MUL, double, double)
PROBE(FMA, double, double) PROBE(DIV, double, double) PROBE(REV, double, double)
PROBE(SQRT, double, double) PROBE(F2D, float, double) PROBE(I2D, int32_t, double)
PROBE(D2F, double, float) PROBE(D2I, double, int32_t) PROBE(AINT, double, double)
PROBE(NINT, double, int32_t) PROBE(ANINT, double, double) PROBE(ABS, double, double)
PROBE(MAX, double, double) PROBE(MIN, double, double) PROBE(MOD, double, double)
PROBE(SIGN, double, double) PROBE(ATAN, double, double) PROBE(ATAN2, double, double)
PROBE(COS, double, double) PROBE(SIN, double, double) PROBE(EXP, double, double)
PROBE(EXP10, double, double) PROBE(LOG, double, double) PROBE(LOG10, double, double)
PROBE(PWR, double, double)
#undef PROBE

constexpr int kTriadThreads = 1024;  // K2's CTA
constexpr int kTriadUnroll = 4;      // elements a thread a tile

template <typename T>
__device__ __forceinline__ T triad_one(T a, T b, T s) {
  if constexpr (sizeof(T) == 8)
    return __dadd_rn(a, __dmul_rn(s, b));
  else
    return __fadd_rn(a, __fmul_rn(s, b));
}

// Tiles of kTriadThreads x kTriadUnroll elements on the vector path (`vec`:
// a, b and y 16-byte aligned), thread t on pieces t, t + kTriadThreads, ...
// of one 16-byte vector each; then the rest one element a thread.
template <typename T>
__global__ void __launch_bounds__(kTriadThreads) triad_kernel(const T* __restrict__ a,
                                                              const T* __restrict__ b, T s,
                                                              T* __restrict__ y, long long n,
                                                              bool vec) {
  constexpr int U = kTriadUnroll;
  constexpr int P = 16 / sizeof(T);  // elements a piece
  constexpr int NP = U / P;          // pieces a thread a tile
  constexpr long long kTile = static_cast<long long>(kTriadThreads) * U;
  const long long tiles = vec ? n / kTile : 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    T av[U], bv[U], r[U];
    const long long e0 = tile * kTile + static_cast<long long>(threadIdx.x) * P;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const long long e = e0 + static_cast<long long>(k) * kTriadThreads * P;
      load_piece<P>(av + k * P, a + e);
      load_piece<P>(bv + k * P, b + e);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) r[k] = triad_one(av[k], bv[k], s);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      store_piece(y + e0 + static_cast<long long>(k) * kTriadThreads * P, r + k * P);
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tiles * kTile + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    y[i] = triad_one(a[i], b[i], s);
}

// max_ctas > 0: exactly that many CTAs.  Otherwise, on the vector path, one
// tile a block where the tiles fill at least two waves of the CTAs that fit
// at once (two a SM), and else as many CTAs as fit, striding; on the scalar
// path as many as fit, at most one a 1024 elements.
template <typename T>
cudaError_t launch_triad(const T* a, const T* b, T s, T* y, long long n, int max_ctas,
                         cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(y);
  long long grid = max_ctas;
  if (max_ctas <= 0) {
    static int sms = 0;
    if (sms == 0) {
      int device = 0;
      cudaGetDevice(&device);
      if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        sms = 1;
    }
    const long long resident = 2LL * sms;
    const long long tile = static_cast<long long>(kTriadThreads) * kTriadUnroll;
    const long long tiles = std::max(n / tile, 1LL);
    if (vec)
      grid = tiles >= 2 * resident ? tiles : std::min(tiles, resident);
    else
      grid = std::min((n + kTriadThreads - 1) / kTriadThreads, resident);
  }
  const unsigned blocks = static_cast<unsigned>(grid);
  triad_kernel<T><<<blocks, kTriadThreads, 0, stream>>>(a, b, s, y, n, vec);
  return cudaGetLastError();
}

}  // namespace

// K1.  expr: an `Expr` id; dtype selects the f32 (1) or f64 (0) instance of
// POLY16 and FILL and must be 0 for the Table-1 expressions, whose types are
// fixed.  Arrays an expression does not read may be null.  The kernel picks
// the vector or the scalar path from the pointers and its grid from its
// occupancy.
extern "C" int repro_stream_elementwise(int expr, int dtype, const void* x1, const void* x2,
                                        const void* y0, void* y, long long n, void* stream) {
  if (n <= 0 || expr < 0 || expr >= N_EXPR || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && expr != POLY16 && expr != FILL))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (expr) {
#define F8(E) \
  case E: return launch<E, double, double>(x1, x2, y0, y, n, s);
    F8(ADD) F8(SUB) F8(MUL) F8(FMA) F8(DIV) F8(REV) F8(SQRT) F8(AINT) F8(ANINT)
    F8(ABS) F8(MAX) F8(MIN) F8(MOD) F8(SIGN) F8(ATAN) F8(ATAN2) F8(COS) F8(SIN)
    F8(EXP) F8(EXP10) F8(LOG) F8(LOG10) F8(PWR)
#undef F8
    case F2D: return launch<F2D, float, double>(x1, x2, y0, y, n, s);
    case I2D: return launch<I2D, int32_t, double>(x1, x2, y0, y, n, s);
    case D2F: return launch<D2F, double, float>(x1, x2, y0, y, n, s);
    case D2I: return launch<D2I, double, int32_t>(x1, x2, y0, y, n, s);
    case NINT: return launch<NINT, double, int32_t>(x1, x2, y0, y, n, s);
    case POLY16:
      return dtype ? launch<POLY16, float, float>(x1, x2, y0, y, n, s)
                   : launch<POLY16, double, double>(x1, x2, y0, y, n, s);
    case FILL:
      return dtype ? launch<FILL, float, float>(x1, x2, y0, y, n, s)
                   : launch<FILL, double, double>(x1, x2, y0, y, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// K2.  dtype: 0 f64, 1 f32 (the scalar is rounded to f32 first, as the plain
// version's Python scalar is).  max_ctas: a cap on the CTAs of 1024 threads
// (exactly that many launch), or 0 for none.
extern "C" int repro_stream_triad(int dtype, const void* a, const void* b, double scalar,
                                  void* y, long long n, int max_ctas, void* stream) {
  if (n <= 0 || max_ctas < 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_triad(static_cast<const double*>(a), static_cast<const double*>(b), scalar,
                        static_cast<double*>(y), n, max_ctas, s);
  return launch_triad(static_cast<const float*>(a), static_cast<const float*>(b),
                      static_cast<float>(scalar), static_cast<float*>(y), n, max_ctas, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
