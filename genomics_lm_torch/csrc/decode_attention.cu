// Fused single-token decode attention over the packed-lane KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genomics_lm_tpu/ops/decode_attention.py
// ::decode_attention (ops/decode_attention.py:106-215) with the same
// contract: one new query token per slot attends layer `layer` of the
// packed (L, B, S, P = Hkv*D) cache under an additive (B, S) float32 mask,
// with a single-pass softmax; an int8 cache carries per-vector float32
// scales (L, B, Hkv, S) that multiply the scores (k) and the probabilities
// (v), so the int8 cache is read raw and never dequantized into memory.
// Output: (B, Hq, D) float32.
//
// What bounds it: the bytes of the cache. Per launch it must read every
// K and V row of one layer (2*B*S*P elements) and does only ~4 flops per
// element read, far below the card's operations-per-byte balance point, so
// its least time is cache bytes over device-memory bandwidth.
//
// What this simple design does about that: every cache byte is read from
// device memory exactly once, in 16-byte vector loads (8-byte for int8)
// wherever D and P allow it, with no lane padding (D = 48 at the main shape
// is no power of two, which is why this is CUDA and not Triton), and the
// G = Hq/Hkv query heads of a kv head share one read of its K/V slice.
// Scores and probabilities stay in shared memory. What it does not do yet:
// it reads the whole S axis every step (the mask decides, as on the TPU),
// including the dead tail past the longest live slot; it has one block per
// (slot, kv head) with no split over S, so a small batch cannot fill the
// card; and it issues plain loads rather than a TMA/cp.async pipeline.
//
// Layout: grid (Hkv, B), 128 threads. Phase 1: one thread per cached
// position computes that position's G scores (f32). Phase 2: block-wide max
// and sum per query head. Phase 3: threads split (position group, D chunk)
// and accumulate P*V in f32, combined across position groups with shared
// memory atomics. The TPU kernel's batch blocks of 8, its block-diagonal
// query routing matrix and its (Hq, P) output band are TPU layout choices
// and are not carried over.

#include "decode_common.cuh"

namespace {

// GM: compile-time bound on G = Hq / Hkv (1, 2, 4 or 8); G <= GM at run time.
template <typename TQ, typename TC, int GM, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k_cache,
                        const TC* __restrict__ v_cache, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const float* __restrict__ mask,
                        float* __restrict__ out, int B, int S, int Hkv, int G, int D,
                        int layer, float inv_sqrt_d) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int CW = Chunk<TC, VEC>::width;

  extern __shared__ float smem[];
  float* q_s = smem;           // [G][D] query rows of this kv head's group
  float* o_s = q_s + G * D;    // [G][D] P*V accumulator
  float* p_s = o_s + G * D;    // [G][S] scores, then probabilities
  float* red = p_s + G * S;    // [kWarps][GM] reduction scratch

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Hq = Hkv * G;
  const size_t P = static_cast<size_t>(Hkv) * D;
  const size_t slab = (static_cast<size_t>(layer) * B + b) * S;  // row (layer, b, 0)
  const TC* kb = k_cache + slab * P + static_cast<size_t>(g) * D;
  const TC* vb = v_cache + slab * P + static_cast<size_t>(g) * D;
  const size_t scale_row = ((static_cast<size_t>(layer) * B + b) * Hkv + g) * S;
  const float* mrow = mask + static_cast<size_t>(b) * S;
  const size_t head0 = (static_cast<size_t>(b) * Hq + static_cast<size_t>(g) * G) * D;

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    o_s[i] = 0.f;
  }
  __syncthreads();

  // Phase 1: scores, one thread per cached position.
  float mx[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) mx[gi] = -INFINITY;
  for (int s = tid; s < S; s += kThreads) {
    float acc[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) acc[gi] = 0.f;
    const TC* kr = kb + static_cast<size_t>(s) * P;
    for (int d0 = 0; d0 < D; d0 += CW) {
      float kv[CW];
      load_chunk<TC, CW>(kr + d0, kv);
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi < G) {
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[gi] += q_s[gi * D + d0 + c] * kv[c];
        }
      }
    }
    const float m_add = mrow[s];
    const float sk = kQuant ? k_scale[scale_row + s] : 1.f;
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < G) {
        float sc = acc[gi] * inv_sqrt_d;
        if (kQuant) sc *= sk;
        sc += m_add;
        p_s[gi * S + s] = sc;
        mx[gi] = fmaxf(mx[gi], sc);
      }
    }
  }
  block_reduce<GM, true>(mx, GM, red);

  // Phase 2: exponentials and their sum, then normalized probabilities
  // (times the v scale for an int8 cache).
  float sm[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) sm[gi] = 0.f;
  for (int s = tid; s < S; s += kThreads) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < G) {
        const float e = expf(p_s[gi * S + s] - mx[gi]);
        p_s[gi * S + s] = e;
        sm[gi] += e;
      }
    }
  }
  block_reduce<GM, false>(sm, GM, red);
  for (int s = tid; s < S; s += kThreads) {
    const float sv = kQuant ? v_scale[scale_row + s] : 1.f;
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < G) {
        float p = p_s[gi * S + s] / sm[gi];
        if (kQuant) p *= sv;
        p_s[gi * S + s] = p;
      }
    }
  }
  __syncthreads();

  // Phase 3: P*V. Thread t takes D-chunk t % nc of every nsg-th position.
  const int nc = D / CW;
  const int nsg = kThreads / nc;
  const int c = tid % nc;
  const int sg = tid / nc;
  if (sg < nsg) {
    float acc[GM][CW];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[gi][j] = 0.f;
    for (int s = sg; s < S; s += nsg) {
      float vv[CW];
      load_chunk<TC, CW>(vb + static_cast<size_t>(s) * P + c * CW, vv);
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi < G) {
          const float p = p_s[gi * S + s];
#pragma unroll
          for (int j = 0; j < CW; ++j) acc[gi][j] += p * vv[j];
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < G) {
#pragma unroll
        for (int j = 0; j < CW; ++j) atomicAdd(&o_s[gi * D + c * CW + j], acc[gi][j]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) out[head0 + i] = o_s[i];
}

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;
  const float* v_scale;
  const float* mask;
  float* out;
  int B, S, Hkv, G, D, layer;
  float inv_sqrt_d;
};

template <typename TQ, typename TC, int GM, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_attention_kernel<TQ, TC, GM, VEC>;
  const size_t smem = (static_cast<size_t>(2 * a.G * a.D + a.G * a.S) + kWarps * GM) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.Hkv, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k_cache),
      static_cast<const TC*>(a.v_cache), a.k_scale, a.v_scale, a.mask, a.out, a.B, a.S,
      a.Hkv, a.G, a.D, a.layer, a.inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_g(const Args& a, bool vec, cudaStream_t stream) {
#define GLM_DA_VEC(GM)                                                             \
  return vec ? launch<TQ, TC, GM, true>(a, stream) : launch<TQ, TC, GM, false>(a, stream)
  if (a.G <= 1) GLM_DA_VEC(1);
  if (a.G <= 2) GLM_DA_VEC(2);
  if (a.G <= 4) GLM_DA_VEC(4);
  if (a.G <= 8) GLM_DA_VEC(8);
#undef GLM_DA_VEC
  return -1;
}

template <typename TQ>
int dispatch_cache(const Args& a, int cache_dtype, bool vec, cudaStream_t stream) {
  return cache_dtype == 3 ? dispatch_g<TQ, int8_t>(a, vec, stream)
                          : dispatch_g<TQ, TQ>(a, vec, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8. A float cache has
// the query's dtype; an int8 cache takes a query of any of the float types.
// Returns the launch's cudaError_t, or -1 for arguments it does not take.
extern "C" int glm_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                    const void* k_scale, const void* v_scale,
                                    const void* mask, void* out, int B, int S, int Hkv,
                                    int G, int D, int layer, float inv_sqrt_d, int q_dtype,
                                    int cache_dtype, int vec, void* stream) {
  if (cache_dtype != 3 && cache_dtype != q_dtype) return -1;
  const Args a{q,
               k_cache,
               v_cache,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const float*>(mask),
               static_cast<float*>(out),
               B, S, Hkv, G, D, layer, inv_sqrt_d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return dispatch_cache<float>(a, cache_dtype, vec != 0, st);
    case 1: return dispatch_cache<__nv_bfloat16>(a, cache_dtype, vec != 0, st);
    case 2: return dispatch_cache<__half>(a, cache_dtype, vec != 0, st);
    default: return -1;
  }
}
