// Device helpers shared by the decode-attention kernels (decode_attention.cu,
// decode_attention_chunk.cu, decode_attention_streamed.cu, and their shared
// core in decode_tiles.cuh): float32 reads of the cache's element types, 8-
// and 16-byte vector loads of a head's D-slice (from device or shared
// memory), and block-wide reductions over the kernels' 128 threads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Elements per vector load: 16 bytes for 2- and 4-byte types, 8 for int8
// (an int8 chunk of 16 would need 16 accumulators per query row).
template <typename T, bool VEC>
struct Chunk {
  static constexpr int bytes = std::is_same<T, int8_t>::value ? 8 : 16;
  static constexpr int width = VEC ? bytes / static_cast<int>(sizeof(T)) : 1;
};

template <typename T, int CW>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float (&out)[CW]) {
  if constexpr (CW == 1) {
    out[0] = to_f32(p[0]);
  } else {
    constexpr int bytes = CW * static_cast<int>(sizeof(T));
    using V = typename std::conditional<bytes == 16, uint4, uint2>::type;
    const V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < CW; ++i) out[i] = to_f32(e[i]);
  }
}

// Block-wide max (IS_MAX) or sum of the first n of NM per-thread values;
// every thread receives the results. `red` holds kWarps * NM floats.
template <int NM, bool IS_MAX>
__device__ __forceinline__ void block_reduce(float (&v)[NM], int n, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n) {
      float x = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, x, off);
        x = IS_MAX ? fmaxf(x, y) : x + y;
      }
      if (lane == 0) red[warp * NM + i] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i < n) {
      float x = red[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float y = red[w * NM + i];
        x = IS_MAX ? fmaxf(x, y) : x + y;
      }
      v[i] = x;
    }
  }
  __syncthreads();  // `red` is reused by the next reduction
}

}  // namespace
