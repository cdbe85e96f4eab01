// Multi-query decode attention over the packed-lane KV cache (the
// speculative verify chunk), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genomics_lm_tpu/ops/decode_attention.py
// ::decode_attention_chunk (ops/decode_attention.py:474-577, launched at
// :565) with the same contract: T query tokens per slot, q (B, Hq, T, D),
// attend layer `layer` of the packed (L, B, S, P = Hkv*D) cache, each query
// under its own additive float32 mask row mask[b, t, :] (cached positions
// plus the chunk's causal prefix, built by the caller); an int8 cache
// carries per-vector float32 scales (L, B, Hkv, S) that multiply the scores
// (k) and the probabilities (v), so the cache is read raw and never
// dequantized. Output: (B, Hq, T, D) float32.
//
// What bounds it: the bytes of the cache. Per launch it must read every K
// and V row of one layer (2*B*S*P elements) and does ~4*T*G flops per
// element read; at the verify shapes (T <= 8, G <= 4) that is still far
// below the card's operations-per-byte balance point, so its least time is
// the cache bytes (plus the (B, T, S) mask) over device-memory bandwidth.
//
// What this simple design does about that: it generalizes the single-token
// kernel (decode_attention.cu) from G to R = T*G query rows per block, one
// block per (slot, kv head). Every cached position of the head's D-slice is
// read from device memory once per block for all R rows, so verifying a
// T-token chunk reads the cache once, not T times: that shared read is why
// the kernel exists. Scores and probabilities for the R rows stay in shared
// memory (R*S*4 bytes: 7.5 KiB at T 5, G 1, S 384). Phase 3 stages V in
// tiles of 32 positions in shared memory (coalesced 16-byte loads along the
// D-slice, 8-byte for int8), and each thread keeps its own (row, dim)
// outputs in registers, so no atomics are needed. What it does not do yet:
// it reads the whole S axis (the mask decides, as on the TPU), phase 1 reads
// K one position per thread (strided across the warp), and it issues plain
// loads rather than a TMA/cp.async pipeline. The TPU kernel's block-diagonal
// routing (pack_query_chunk) and its t-major repeat/tile of masks and scales
// are MXU lane tricks and are not carried over.
//
// Layout: grid (Hkv, B), 128 threads. Block rows r = g*T + t (the query
// head g of the kv head's group, then the chunk position t), so the
// block's q and output rows are one contiguous (G, T, D) slab of q/out.

#include "decode_common.cuh"

namespace {

constexpr int kTileS = 32;   // V positions staged in shared memory per phase-3 step
constexpr int kMaxRows = 32;  // R = T*G bound (the wrapper's KERNEL_MAX_CHUNK_ROWS)

// RM: compile-time bound on R = T*G (1, 4, 8, 16 or 32); R <= RM at run time.
template <typename TQ, typename TC, int RM, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_attention_chunk_kernel(const TQ* __restrict__ q, const TC* __restrict__ k_cache,
                              const TC* __restrict__ v_cache,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const float* __restrict__ mask, float* __restrict__ out,
                              int B, int S, int Hkv, int G, int T, int D, int layer,
                              float inv_sqrt_d) {
  constexpr bool kQuant = std::is_same<TC, int8_t>::value;
  constexpr int CW = Chunk<TC, VEC>::width;
  const int R = G * T;

  extern __shared__ float smem[];
  float* q_s = smem;              // [R][D] query rows of this kv head's group
  float* p_s = q_s + R * D;       // [R][S] scores, then probabilities
  float* v_t = p_s + R * S;       // [kTileS][D] one tile of V
  float* red = v_t + kTileS * D;  // [kWarps][kMaxRows] reduction scratch

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t P = static_cast<size_t>(Hkv) * D;
  const size_t slab = (static_cast<size_t>(layer) * B + b) * S;  // row (layer, b, 0)
  const TC* kb = k_cache + slab * P + static_cast<size_t>(g) * D;
  const TC* vb = v_cache + slab * P + static_cast<size_t>(g) * D;
  const size_t scale_row = ((static_cast<size_t>(layer) * B + b) * Hkv + g) * S;
  const float* mrows = mask + static_cast<size_t>(b) * T * S;  // [T][S]
  // q and out rows (b, g*G .. g*G + G - 1, 0 .. T - 1, :): one (G, T, D) slab
  const size_t base = (static_cast<size_t>(b) * Hkv + g) * static_cast<size_t>(G) * T * D;

  for (int i = tid; i < R * D; i += kThreads) q_s[i] = to_f32(q[base + i]);
  __syncthreads();

  // Phase 1: scores, one thread per cached position, all R rows at once.
  float mx[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) mx[r] = -INFINITY;
  for (int s = tid; s < S; s += kThreads) {
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    const TC* kr = kb + static_cast<size_t>(s) * P;
    for (int d0 = 0; d0 < D; d0 += CW) {
      float kv[CW];
      load_chunk<TC, CW>(kr + d0, kv);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < R) {
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[r] += q_s[r * D + d0 + c] * kv[c];
        }
      }
    }
    const float sk = kQuant ? k_scale[scale_row + s] : 1.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        float sc = acc[r] * inv_sqrt_d;
        if (kQuant) sc *= sk;
        sc += mrows[static_cast<size_t>(r % T) * S + s];
        p_s[r * S + s] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    }
  }
  block_reduce<RM, true>(mx, R, red);

  // Phase 2: exponentials and their sum, then normalized probabilities
  // (times the v scale for an int8 cache).
  float sm[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) sm[r] = 0.f;
  for (int s = tid; s < S; s += kThreads) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        const float e = expf(p_s[r * S + s] - mx[r]);
        p_s[r * S + s] = e;
        sm[r] += e;
      }
    }
  }
  block_reduce<RM, false>(sm, R, red);
  for (int s = tid; s < S; s += kThreads) {
    const float sv = kQuant ? v_scale[scale_row + s] : 1.f;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        float p = p_s[r * S + s] / sm[r];
        if (kQuant) p *= sv;
        p_s[r * S + s] = p;
      }
    }
  }
  __syncthreads();

  // Phase 3: P*V over tiles of V staged in shared memory. Thread tid owns
  // the outputs i = tid + k*kThreads (row i / D, dim i % D); R*D <= RM*128
  // since D <= 128, so RM registers hold them.
  const int nout = R * D;
  const int nc = D / CW;
  float o[RM];
#pragma unroll
  for (int k = 0; k < RM; ++k) o[k] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kTileS) {
    const int ns = min(kTileS, S - s0);
    for (int i = tid; i < ns * nc; i += kThreads) {
      const int sr = i / nc;
      const int c = i - sr * nc;
      float vv[CW];
      load_chunk<TC, CW>(vb + static_cast<size_t>(s0 + sr) * P + c * CW, vv);
#pragma unroll
      for (int j = 0; j < CW; ++j) v_t[sr * D + c * CW + j] = vv[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RM; ++k) {
      const int i = tid + k * kThreads;
      if (i < nout) {
        const int r = i / D;
        const int d = i - r * D;
        const float* pr = p_s + r * S + s0;
        float a = o[k];
        for (int s = 0; s < ns; ++s) a += pr[s] * v_t[s * D + d];
        o[k] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < RM; ++k) {
    const int i = tid + k * kThreads;
    if (i < nout) out[base + i] = o[k];
  }
}

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const float* k_scale;
  const float* v_scale;
  const float* mask;
  float* out;
  int B, S, Hkv, G, T, D, layer;
  float inv_sqrt_d;
};

template <typename TQ, typename TC, int RM, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_attention_chunk_kernel<TQ, TC, RM, VEC>;
  const int R = a.G * a.T;
  const size_t smem =
      (static_cast<size_t>(R) * a.D + static_cast<size_t>(R) * a.S +
       static_cast<size_t>(kTileS) * a.D + kWarps * kMaxRows) * sizeof(float);
  if (smem > 48 * 1024) {  // opt in above the 48 KB default
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.Hkv, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k_cache),
      static_cast<const TC*>(a.v_cache), a.k_scale, a.v_scale, a.mask, a.out, a.B, a.S,
      a.Hkv, a.G, a.T, a.D, a.layer, a.inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_rows(const Args& a, bool vec, cudaStream_t stream) {
#define GLM_DAC_VEC(RM)                                                            \
  return vec ? launch<TQ, TC, RM, true>(a, stream) : launch<TQ, TC, RM, false>(a, stream)
  const int R = a.G * a.T;
  if (R <= 1) GLM_DAC_VEC(1);
  if (R <= 4) GLM_DAC_VEC(4);
  if (R <= 8) GLM_DAC_VEC(8);
  if (R <= 16) GLM_DAC_VEC(16);
  if (R <= kMaxRows) GLM_DAC_VEC(32);
#undef GLM_DAC_VEC
  return -1;
}

template <typename TQ>
int dispatch_cache(const Args& a, int cache_dtype, bool vec, cudaStream_t stream) {
  return cache_dtype == 3 ? dispatch_rows<TQ, int8_t>(a, vec, stream)
                          : dispatch_rows<TQ, TQ>(a, vec, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 3 int8. A float cache has the
// query's dtype; an int8 cache takes a float32 or bfloat16 query. Returns
// the launch's cudaError_t, or -1 for arguments it does not take.
extern "C" int glm_decode_attention_chunk(const void* q, const void* k_cache,
                                          const void* v_cache, const void* k_scale,
                                          const void* v_scale, const void* mask, void* out,
                                          int B, int S, int Hkv, int G, int T, int D,
                                          int layer, float inv_sqrt_d, int q_dtype,
                                          int cache_dtype, int vec, void* stream) {
  if (cache_dtype != 3 && cache_dtype != q_dtype) return -1;
  if (D > 128 || G * T < 1 || G * T > kMaxRows) return -1;
  const Args a{q,
               k_cache,
               v_cache,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const float*>(mask),
               static_cast<float*>(out),
               B, S, Hkv, G, T, D, layer, inv_sqrt_d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return dispatch_cache<float>(a, cache_dtype, vec != 0, st);
    case 1: return dispatch_cache<__nv_bfloat16>(a, cache_dtype, vec != 0, st);
    default: return -1;
  }
}
