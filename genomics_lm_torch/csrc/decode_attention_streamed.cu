// Split-S single-token decode attention (flash-decoding) over the
// packed-lane KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genomics_lm_tpu/ops/decode_attention.py
// ::decode_attention_streamed (ops/decode_attention.py:263-410, launched at
// :397). Its contract is decode_attention's: one query token per slot,
// q (B, Hq, D), attends layer `layer` of the packed (L, B, S, P = Hkv*D)
// cache under an additive (B, S) float32 mask; an int8 cache carries
// per-vector float32 scales (L, B, Hkv, S) on the scores (k) and the
// probabilities (v). Output: (B, Hq, D) float32. Its edge cases are the
// streamed kernel's: a key blocked by the mask (mask <= -0.5e30)
// contributes exactly zero, so a split whose every key is masked adds
// nothing, and the final sum is clamped at 1e-30.
//
// What bounds it: the bytes of the cache, as for decode_attention.cu
// (~4 flops per cache element read). The TPU kernel streamed the cache
// through a VMEM ring so that FEW programs could each cover a large batch
// block; on Hopper blocks run in parallel on 132 SMs, and the problem is
// the opposite one: at small batch the (slot, kv head) blocks of the
// single-pass kernel are too few to keep enough loads in flight.
//
// What this design does about that: the S axis is split over blocks, grid
// (Hkv, B, splits). Each split block reads its positions of the head's
// D-slice once, computes the split's max m over its scores, p = exp(s - m)
// for the live keys, their sum l and the unnormalized P*V (times the v
// scale) in f32, and writes (m, l, acc) for its G query heads to a scratch
// buffer. A second launch combines the splits per (slot, head):
// M = max m, w = exp(m - M), out = sum w*acc / max(sum w*l, 1e-30). The
// split count is the wrapper's choice from B, S and the SM count
// (block_s overrides it); a split of the whole S axis is the single-pass
// kernel plus the combine. Plain loads, no TMA/cp.async pipeline yet.

#include "decode_common.cuh"

namespace {

constexpr int kMaxGroup = 8;
constexpr float kLiveAbove = -0.5e30f;  // 0.5 * NEG_INF: keys above it are attended

// One split of one (slot, kv head): positions [z*block_s, min(S, (z+1)*block_s)).
// GM: compile-time bound on G = Hq / Hkv (1, 2, 4 or 8); G <= GM at run time.
template <typename TQ, typename TC, int GM, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ k_cache,
                    const TC* __restrict__ v_cache, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const float* __restrict__ mask,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int B, int S, int Hkv, int G, int D,
                    int layer, int block_s, float inv_sqrt_d) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int CW = Chunk<TC, VEC>::width;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G][D] query rows of this kv head's group
  float* o_s = q_s + G * D;        // [G][D] P*V accumulator
  float* p_s = o_s + G * D;        // [G][block_s] scores, then weights
  float* red = p_s + G * block_s;  // [kWarps][GM] reduction scratch

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int s_begin = z * block_s;
  const int n = min(block_s, S - s_begin);
  const int Hq = Hkv * G;
  const size_t P = static_cast<size_t>(Hkv) * D;
  const size_t slab = (static_cast<size_t>(layer) * B + b) * S + s_begin;
  const TC* kb = k_cache + slab * P + static_cast<size_t>(g) * D;
  const TC* vb = v_cache + slab * P + static_cast<size_t>(g) * D;
  const size_t scale_row = ((static_cast<size_t>(layer) * B + b) * Hkv + g) * S + s_begin;
  const float* mrow = mask + static_cast<size_t>(b) * S + s_begin;
  const size_t head0 = (static_cast<size_t>(b) * Hq + static_cast<size_t>(g) * G) * D;

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    o_s[i] = 0.f;
  }
  __syncthreads();

  // Phase 1: scores of the split's positions, one thread per position.
  float mx[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) mx[gi] = -INFINITY;
  for (int s = tid; s < n; s += kThreads) {
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
        p_s[gi * block_s + s] = sc;
        mx[gi] = fmaxf(mx[gi], sc);
      }
    }
  }
  block_reduce<GM, true>(mx, G, red);

  // Phase 2: weights exp(s - m) of the live keys (0 for a masked key) and
  // their sum; the weights then take the v scale, not the normalization.
  float sm[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) sm[gi] = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const bool live = mrow[s] > kLiveAbove;
    const float sv = kQuant ? v_scale[scale_row + s] : 1.f;
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < G) {
        const float e = live ? expf(p_s[gi * block_s + s] - mx[gi]) : 0.f;
        sm[gi] += e;
        p_s[gi * block_s + s] = kQuant ? e * sv : e;
      }
    }
  }
  block_reduce<GM, false>(sm, G, red);  // its barrier also publishes p_s

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
    for (int s = sg; s < n; s += nsg) {
      float vv[CW];
      load_chunk<TC, CW>(vb + static_cast<size_t>(s) * P + c * CW, vv);
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi < G) {
          const float p = p_s[gi * block_s + s];
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

  // (m, l, acc) of this split for the G heads: part row ((b*Hkv + g)*splits + z)*G + gi
  const size_t part0 = ((static_cast<size_t>(b) * Hkv + g) * splits + z) * G;
  if (tid < G) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi == tid) {
        m_part[part0 + gi] = mx[gi];
        l_part[part0 + gi] = sm[gi];
      }
    }
  }
  for (int i = tid; i < G * D; i += kThreads) acc_part[part0 * D + i] = o_s[i];
}

// Combine the splits of one (slot, head): grid (Hq, B), threads over D.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, float* __restrict__ out, int Hkv,
                      int G, int D, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  // part rows of (b, kv head h / G, split z, group member h % G)
  const size_t row0 = (static_cast<size_t>(b) * Hkv + h / G) * splits * G + h % G;
  float M = -INFINITY;
  for (int z = 0; z < splits; ++z) M = fmaxf(M, m_part[row0 + static_cast<size_t>(z) * G]);
  float l = 0.f;
  for (int z = 0; z < splits; ++z) {
    const size_t row = row0 + static_cast<size_t>(z) * G;
    l += expf(m_part[row] - M) * l_part[row];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) {
      const size_t row = row0 + static_cast<size_t>(z) * G;
      a += expf(m_part[row] - M) * acc_part[row * D + d];
    }
    out[(static_cast<size_t>(b) * Hq + h) * D + d] = a * inv;
  }
}

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;
  const float* v_scale;
  const float* mask;
  float* m_part;
  float* l_part;
  float* acc_part;
  float* out;
  int B, S, Hkv, G, D, layer, block_s;
  float inv_sqrt_d;
};

template <typename TQ, typename TC, int GM, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_split_kernel<TQ, TC, GM, VEC>;
  const size_t smem =
      (static_cast<size_t>(2 * a.G * a.D) + static_cast<size_t>(a.G) * a.block_s +
       kWarps * GM) * sizeof(float);
  if (smem > 48 * 1024) {  // opt in above the 48 KB default
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int splits = (a.S + a.block_s - 1) / a.block_s;
  const dim3 grid(a.Hkv, a.B, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k_cache),
      static_cast<const TC*>(a.v_cache), a.k_scale, a.v_scale, a.mask, a.m_part, a.l_part,
      a.acc_part, a.B, a.S, a.Hkv, a.G, a.D, a.layer, a.block_s, a.inv_sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<<<dim3(a.Hkv * a.G, a.B), kThreads, 0, stream>>>(
      a.m_part, a.l_part, a.acc_part, a.out, a.Hkv, a.G, a.D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_g(const Args& a, bool vec, cudaStream_t stream) {
#define GLM_DAS_VEC(GM)                                                            \
  return vec ? launch<TQ, TC, GM, true>(a, stream) : launch<TQ, TC, GM, false>(a, stream)
  if (a.G <= 1) GLM_DAS_VEC(1);
  if (a.G <= 2) GLM_DAS_VEC(2);
  if (a.G <= 4) GLM_DAS_VEC(4);
  if (a.G <= kMaxGroup) GLM_DAS_VEC(8);
#undef GLM_DAS_VEC
  return -1;
}

template <typename TQ>
int dispatch_cache(const Args& a, int cache_dtype, bool vec, cudaStream_t stream) {
  return cache_dtype == 3 ? dispatch_g<TQ, int8_t>(a, vec, stream)
                          : dispatch_g<TQ, TQ>(a, vec, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 3 int8. A float cache has the
// query's dtype; an int8 cache takes a float32 or bfloat16 query. The
// scratch buffers are (B, Hkv, splits, G) for m and l and
// (B, Hkv, splits, G, D) for acc, splits = ceil(S / block_s). Launches the
// split kernel and the combine kernel on `stream`; returns the first
// launch error, or -1 for arguments it does not take.
extern "C" int glm_decode_attention_streamed(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* mask, void* m_part, void* l_part, void* acc_part,
    void* out, int B, int S, int Hkv, int G, int D, int layer, int block_s,
    float inv_sqrt_d, int q_dtype, int cache_dtype, int vec, void* stream) {
  if (cache_dtype != 3 && cache_dtype != q_dtype) return -1;
  if (D > 128 || block_s < 1 || block_s > S) return -1;
  const Args a{q,
               k_cache,
               v_cache,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const float*>(mask),
               static_cast<float*>(m_part),
               static_cast<float*>(l_part),
               static_cast<float*>(acc_part),
               static_cast<float*>(out),
               B, S, Hkv, G, D, layer, block_s, inv_sqrt_d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return dispatch_cache<float>(a, cache_dtype, vec != 0, st);
    case 1: return dispatch_cache<__nv_bfloat16>(a, cache_dtype, vec != 0, st);
    default: return -1;
  }
}
