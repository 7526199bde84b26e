// 16-byte vector loads converted to fp32, and fp32 stores in the output
// type: shared by the attention and indexer tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16-byte vectors: N elements of T, loaded raw and converted to fp32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void convert(const uint4& v, float* o) {
    const float* f = reinterpret_cast<const float*>(&v);
    o[0] = f[0]; o[1] = f[1]; o[2] = f[2]; o[3] = f[3];
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void convert(const uint4& v, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ inline uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ inline void store_out(float* p, float x) { *p = x; }
__device__ inline void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace
