// The simulator's own in-order scan for Hopper (sm_90a): one pass of the
// batched O3 list scheduler over a compiled program, M batch elements at once.
//
// Replaces the reference's two jitted vmap(lax.scan) passes, which are not
// Pallas kernels but ran the simulator on the accelerator it models:
// `schedule_batch_jax` (src/repro/core/compiled.py:412) and
// `_node_pass_batch_jax` (src/repro/core/node.py:940).  One kernel serves
// both: core/node.py hands it S streams (one per core) and a ring-latency
// addend per def-use edge; core/compiled.py one stream in program order.
//
// What it computes, per batch element m (a knob combo x a duration column),
// for each op i in program order:
//   ready   = max over i's producers j of finishes[j] (+ the edge's addend);
//   a free op (port < 0) passes `ready` on and takes a ROB slot;
//   a costed op on pipe (stream s, port p) starts at the max of ready, its
//   pipe's earliest free lane (the first of equal minima), the retire time
//   `window` ops back on its stream and the start `depth` costed ops back on
//   its pipe; it finishes `dur` later.
// The result is the last finish over the costed ops (0.0 where none).  Only
// float64 `+` and `max` are used, in the NumPy pass's order, so each element
// equals core/node.py `_node_pass_batch` bit for bit; the build adds
// -fmad=false (sched_scan's entry in kernels/_build.py) so that no future
// product can be contracted either.
//
// Where bit-identity would break: numpy's argmin takes the first minimal
// lane, so lanes compare with a strict `<`, and lanes beyond an element's
// width hold +inf; the NumPy pass reads a ring slot that is not yet written as
// 0.0, a no-op under max, which here is an explicit `pos >= window` test, so
// that a ring of min(window, ops on the stream) slots serves (ring slots are
// then non-negative: C's % of a negative number would be negative).
//
// What bounds it on this card.  The ops form a chain: an op's start waits on
// a producer's finish, which the same thread stored an op or more earlier,
// and each op's pipe, ring and finish loads sit behind it.  The bytes are
// small (finishes [n, M] and the rings, ~40 MB at 26 k ops x 180 elements,
// ~12 us at 3.35 TB/s), so the floor is n dependent loads; at one thread a
// batch element only M threads run, on ceil(M / 64) SMs.
//
// What the design does about it (first version: simple and right).  One
// thread a batch element; the op loop runs in each thread.  Every state
// array has the element index fastest (finishes [n, M], the ROB rings
// [S, rob_slots, M], the pipes [S * P, lanes, M], the reservation rings
// [S * P, q_slots, M]), so a warp's loads of one op coalesce into 256-byte
// rows.  An op's CSR row, port, stream and positions are the same for every
// thread, so a CTA stages them in shared memory, kChunk ops and up to kEdges
// edges at a time (an op with more inputs than that reads them from global
// memory).  Each op issues all its loads (its stream's retire tail, the
// window and queue entries, its duration, four pipe lanes, its producers'
// finishes) before it uses any of them: loaded one after another where each
// was used, they cost ~1.4-1.9 us an op on the H100.  Hot state in shared
// memory and a cache of recent finishes are left for a redesign.
//
// `repro_sched_chase` times one dependent load (shared memory, or L2 read
// past the L1), the latency that bounds the chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPorts = 4;       // core.compiled.PORTS
constexpr int kThreads = 64;    // batch elements a CTA
constexpr int kChunk = kThreads;
constexpr int kEdges = 1024;    // CSR entries staged a chunk
constexpr int kLaneRegs = 4;    // pipe lanes loaded into registers at once

struct ScanArgs {
  const int* __restrict__ indptr;      // [n + 1]
  const int* __restrict__ indices;     // [E]
  const double* __restrict__ extra;    // [E] or null
  const int* __restrict__ port;        // [n], -1 = free
  const int* __restrict__ stream;      // [n]
  const int* __restrict__ pos_core;    // [n]
  const int* __restrict__ pos_cp;      // [n]
  const int* __restrict__ cpid;        // [n] stream * kPorts + port
  const double* __restrict__ durs;     // durs[i * durs_si + m * durs_sm]
  long long durs_si, durs_sm;
  const int* __restrict__ window;      // [M]
  const int* __restrict__ width;       // [M, kPorts]
  const int* __restrict__ depth;       // [M, kPorts]
  double* __restrict__ finishes;       // [n, M]
  double* __restrict__ rob;            // [S, rob_slots, M]
  double* __restrict__ tail;           // [S, M]
  double* __restrict__ pipes;          // [S * kPorts, lanes, M]
  double* __restrict__ qring;          // [S * kPorts, q_slots, M]
  double* __restrict__ t_out;          // [M]
  int n, M, S, lanes, rob_slots, q_slots;
};

// np.maximum on values that are never NaN
__device__ __forceinline__ double vmax(double a, double b) { return b > a ? b : a; }

__global__ void __launch_bounds__(kThreads) node_scan_kernel(const ScanArgs a) {
  __shared__ int s_port[kChunk], s_stream[kChunk], s_pos[kChunk], s_poscp[kChunk];
  __shared__ int s_cpid[kChunk], s_ptr[kChunk + 1];
  __shared__ int s_idx[kEdges];
  __shared__ double s_extra[kEdges];

  const int t = threadIdx.x;
  const int m = blockIdx.x * kThreads + t;
  const bool live = m < a.M;
  const size_t M = a.M;
  int win = 1, dep[kPorts];
  if (live) {
    win = a.window[m];
    for (int p = 0; p < kPorts; ++p) dep[p] = a.depth[m * kPorts + p];
    for (int s = 0; s < a.S; ++s) {
      a.tail[s * M + m] = 0.0;
      for (int p = 0; p < kPorts; ++p) {
        const int w = a.width[m * kPorts + p];
        double* pl = a.pipes + (size_t)(s * kPorts + p) * a.lanes * M + m;
        for (int l = 0; l < a.lanes; ++l) pl[l * M] = l < w ? 0.0 : INFINITY;
      }
    }
  }
  double t_best = 0.0;
  for (int base = 0; base < a.n;) {
    __syncthreads();                     // the last chunk is consumed
    const int e0 = a.indptr[base];
    const int fits = base + t < a.n && a.indptr[base + t + 1] - e0 <= kEdges;
    int cnt = __syncthreads_count(fits);  // ops whose edges fit, a prefix
    const bool direct = cnt == 0;          // one op with more than kEdges
    if (direct) cnt = 1;
    if (t < cnt) {
      const int i = base + t;
      s_port[t] = a.port[i];
      s_stream[t] = a.stream[i];
      s_pos[t] = a.pos_core[i];
      s_poscp[t] = a.pos_cp[i];
      s_cpid[t] = a.cpid[i];
      s_ptr[t + 1] = a.indptr[i + 1] - e0;
    }
    if (t == 0) s_ptr[0] = 0;
    const int ne = direct ? 0 : a.indptr[base + cnt] - e0;
    for (int k = t; k < ne; k += kThreads) {
      s_idx[k] = a.indices[e0 + k];
      if (a.extra) s_extra[k] = a.extra[e0 + k];
    }
    __syncthreads();
    if (live) {
      for (int q = 0; q < cnt; ++q) {
        const size_t i = base + q;
        const int s = s_stream[q], p = s_port[q], pos = s_pos[q];
        const int pid = s_cpid[q], qp = s_poscp[q];
        double* tl = a.tail + s * M + m;
        double* rb = a.rob + (size_t)s * a.rob_slots * M + m;
        double* pl = a.pipes + (size_t)pid * a.lanes * M + m;
        double* qr = a.qring + (size_t)pid * a.q_slots * M + m;
        // The op's loads go out together, before its stores (which the
        // compiler may not move a load above) and before any of their
        // values is used, so that the op waits about one L2 round trip, not
        // one for each load in turn.
        const double tail0 = *tl;
        double wt = 0.0, qt = 0.0, dur = 0.0, lv[kLaneRegs];
        if (p >= 0) {
          if (pos >= win) wt = rb[(size_t)((pos - win) % a.rob_slots) * M];
          const int d = dep[p];
          if (qp >= d) qt = qr[(size_t)((qp - d) % a.q_slots) * M];
          dur = a.durs[(long long)i * a.durs_si + (long long)m * a.durs_sm];
#pragma unroll
          for (int l = 0; l < kLaneRegs; ++l) lv[l] = l < a.lanes ? pl[l * M] : INFINITY;
        }
        double ready = 0.0;
        if (direct) {
          for (int k = a.indptr[i]; k < a.indptr[i + 1]; ++k) {
            double f = a.finishes[(size_t)a.indices[k] * M + m];
            if (a.extra) f += a.extra[k];
            ready = vmax(ready, f);
          }
        } else {
#pragma unroll 4
          for (int k = s_ptr[q]; k < s_ptr[q + 1]; ++k) {
            double f = a.finishes[(size_t)s_idx[k] * M + m];
            if (a.extra) f += s_extra[k];
            ready = vmax(ready, f);
          }
        }
        if (p < 0) {                       // free: pass readiness on
          a.finishes[i * M + m] = ready;
          const double tv = vmax(tail0, ready);
          *tl = tv;
          rb[(size_t)(pos % a.rob_slots) * M] = tv;
          continue;
        }
        double best = lv[0];               // the first of equal minima
        int lane = 0;
#pragma unroll
        for (int l = 1; l < kLaneRegs; ++l)
          if (lv[l] < best) { best = lv[l]; lane = l; }
        for (int l = kLaneRegs; l < a.lanes; ++l) {
          const double v = pl[l * M];
          if (v < best) { best = v; lane = l; }
        }
        // a window or queue entry not reached reads 0.0 (wt, qt), a no-op
        // under max against a start that is never negative
        const double start = vmax(vmax(vmax(ready, best), wt), qt);
        const double fin = start + dur;
        pl[lane * M] = fin;
        qr[(size_t)(qp % a.q_slots) * M] = start;
        a.finishes[i * M + m] = fin;
        const double tv = vmax(tail0, fin);
        *tl = tv;
        rb[(size_t)(pos % a.rob_slots) * M] = tv;
        t_best = vmax(t_best, fin);
      }
    }
    base += cnt;
  }
  if (live) a.t_out[m] = t_best;
}

__global__ void chase_shared(const int* __restrict__ next, int entries, long long hops,
                             int* sink) {
  extern __shared__ int s_next[];
  for (int k = threadIdx.x; k < entries; k += blockDim.x) s_next[k] = next[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    int j = 0;
    for (long long h = 0; h < hops; ++h) j = s_next[j];
    *sink = j;
  }
}

__global__ void chase_l2(const int* __restrict__ next, long long hops, int* sink) {
  int j = 0;
  for (long long h = 0; h < hops; ++h) j = __ldcg(next + j);
  *sink = j;
}

}  // namespace

extern "C" int repro_node_scan(const void* indptr, const void* indices, const void* extra,
                               const void* port, const void* stream_of, const void* pos_core,
                               const void* pos_cp, const void* cpid, const void* durs,
                               long long durs_si, long long durs_sm, const void* window,
                               const void* width, const void* depth, void* finishes, void* rob,
                               void* tail, void* pipes, void* qring, void* t_out, int n, int M,
                               int S, int lanes, int rob_slots, int q_slots, void* stream) {
  if (n <= 0 || M <= 0 || S <= 0 || lanes <= 0 || rob_slots <= 0 || q_slots <= 0)
    return cudaErrorInvalidValue;
  ScanArgs a;
  a.indptr = static_cast<const int*>(indptr);
  a.indices = static_cast<const int*>(indices);
  a.extra = static_cast<const double*>(extra);
  a.port = static_cast<const int*>(port);
  a.stream = static_cast<const int*>(stream_of);
  a.pos_core = static_cast<const int*>(pos_core);
  a.pos_cp = static_cast<const int*>(pos_cp);
  a.cpid = static_cast<const int*>(cpid);
  a.durs = static_cast<const double*>(durs);
  a.durs_si = durs_si;
  a.durs_sm = durs_sm;
  a.window = static_cast<const int*>(window);
  a.width = static_cast<const int*>(width);
  a.depth = static_cast<const int*>(depth);
  a.finishes = static_cast<double*>(finishes);
  a.rob = static_cast<double*>(rob);
  a.tail = static_cast<double*>(tail);
  a.pipes = static_cast<double*>(pipes);
  a.qring = static_cast<double*>(qring);
  a.t_out = static_cast<double*>(t_out);
  a.n = n;
  a.M = M;
  a.S = S;
  a.lanes = lanes;
  a.rob_slots = rob_slots;
  a.q_slots = q_slots;
  const int grid = (M + kThreads - 1) / kThreads;
  node_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int repro_sched_chase(int level, const void* next, int entries, long long hops,
                                 void* sink, void* stream) {
  if (entries <= 0 || hops <= 0 || (level != 0 && level != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nx = static_cast<const int*>(next);
  int* sk = static_cast<int*>(sink);
  if (level == 0) {
    const size_t smem = (size_t)entries * sizeof(int);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    chase_shared<<<1, 256, smem, s>>>(nx, entries, hops, sk);
  } else {
    chase_l2<<<1, 1, 0, s>>>(nx, hops, sk);
  }
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
