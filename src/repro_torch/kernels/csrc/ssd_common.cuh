// Global-memory side of the SSD chunk kernels, forward (K4, ssd_scan.cu) and
// backward (K5, ssd_scan_bwd.cu): their (batch, chunk, row, head, feature)
// tensors are read through (batch, chunk, row, head) element strides with
// the feature dimension contiguous, in f32 or bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* ptr, float v) { *ptr = v; }
__device__ __forceinline__ void store(__nv_bfloat16* ptr, float v) { *ptr = __float2bfloat16_rn(v); }

__device__ __forceinline__ long long at(const long long s[4], int b, int c, int q, int h) {
  return b * s[0] + c * s[1] + q * s[2] + h * s[3];
}

// 8 consecutive elements from a 16-byte aligned address, as f32.
__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// A tensor takes 16-byte loads if its base and its four strides are
// multiples of 16 bytes and its features come in whole 8-element pieces.
inline bool takes_vec(const void* ptr, const long long* s, int features, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || features % 8 != 0) return false;
  for (int k = 0; k < 4; ++k)
    if ((s[k] * elem) % 16 != 0) return false;
  return true;
}

}  // namespace ssd
