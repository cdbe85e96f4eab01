// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of genomics_lm_tpu/ops/flash_attention.py
// with their contract: _fwd_kernel (:124-172, launched at :206), _bwd_dq_kernel
// (:235-276, launched at :365) and _bwd_dkv_kernel (:279-340, launched at :390).
// Causal attention with queries bottom-right aligned (q_offset = S - T), an
// optional one-sided window (q_pos - k_pos < window) and an optional
// same-segment mask from one (B, S) int32 id row; attention-probability
// dropout from Philox-4x32-10; online softmax over the key tiles of the band;
// O and dQ/dK/dV in q's dtype, the row LSE in float32. The backward recomputes
// P from the LSE, with delta = rowsum(dO * O) computed by the caller.
//
// What bounds them on this card: at the training shape (B 8, H 8, T = S = 512,
// D 48, <SEP> every 97th token) the operands are ~13-19 MB per call and the
// attended pairs ~24k per head-batch, so the least time is set by
// device-memory bytes (a few microseconds), not by the tensor cores. What a
// kernel loses beyond that comes from instruction issue (SIMT multiply-adds,
// per-element loads), from copies that do not overlap the math, from tiles
// it computes for nothing, and, once those are gone, from the latency of
// each block's chain of loads and per-score work.
//
// Two designs live here: one for bfloat16, one for float32.
//
// bfloat16, all three kernels (flash_fwd_mma_kernel, flash_bwd_dq_mma_kernel,
// flash_bwd_dkv_mma_kernel):
// - Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32, operands
//   fetched by ldmatrix (transposed where the product needs it) from bf16
//   tiles in shared memory with rows padded by 16 bytes (no bank conflicts).
//   D is padded to DP, a multiple of 16, with zeros; the kernels are
//   templated on DP. 128 threads: each of 4 warps owns 16 query rows
//   (forward, dQ) or 16 keys (dK/dV).
// - Accumulators stay in registers (FlashAttention-2): the forward keeps Q's
//   fragments, S, the online softmax and O in registers, and feeds P to
//   P.V as an A operand straight from the S accumulator. dQ holds Q's and
//   dO's fragments, computes S = Q K^T and dP = dO V^T per key tile, and
//   feeds dS to dQ += dS K the same way, with K's B operand by ldmatrix
//   .trans; at DP > 64 it takes each key tile in two passes of 32 keys to
//   bound registers. dK/dV computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T are A operands of dV += Pd^T dO and
//   dK += dS^T Q without leaving registers; K and V fragments are held for
//   the whole loop (DP <= 64) and the queries run in passes of 32 (DP <= 64)
//   or 16 rows. P and dS enter the second product rounded to bf16, as in
//   FlashAttention-2 (the JAX kernels keep them float32).
// - Few instructions per score: the masks become one [lo, hi] range per row
//   and tile plus a segment compare, with no branches; scores are kept in
//   log2 units so each probability is one exp2; dropout multiplies by the
//   reciprocal of 1 - rate. At this shape the kernels are bound by the
//   latency of that per-score work and of each block's loads, more than by
//   any unit's rate (training/benchmark_flash.py varies batch, layout and
//   dropout to show it).
// - Copies are asynchronous: 16-byte cp.async (when D % 8 == 0 and rows are
//   16-byte aligned; plain loads otherwise) into two stages, so the next
//   tile (K/V forward and dQ, Q/dO/LSE/delta dK/dV) loads while this one
//   computes.
//   Rows past T or S are zero-filled by the copy itself.
// - Tiles are skipped unless they lie in the causal/window band AND the
//   segment-id ranges of their query and key rows overlap. At its start a
//   block reduces each band tile's range from the ids (one warp per tile,
//   __reduce_min/max_sync) into one live flag per tile in shared memory: no
//   extra launch, and the loop then steps over dead tiles. A skipped tile
//   has every pair masked, which would add p = 0 with alpha = 1: outputs do
//   not change. ops/flash_attention.py::flash_live_tiles states the rule.
// - Dropout keep bits of a 64 x 64 tile are computed once, cooperatively
//   (eight Philox calls per thread), into a 512-byte bit mask in shared
//   memory that the fragment owners read.
//
// float32, all three kernels, keep the first, SIMT design: the tensor cores
// have no exact float32 path (TF32 would break the 1e-4 float32 checks and
// the float32 card-vs-CPU training step). They visit every tile of the band.
// Tiles of 64 query rows x 64 keys, 256 threads as 16 x 16; a
// thread owns the score elements of rows ty + 16a (a < 4) and keys 4tx + b
// (b < 4) and the output elements of rows ty + 16a and head dims tx + 16c
// (c < NC = ceil(D / 16)); operands are converted to float32 in shared
// memory; row reductions are shuffles across a half-warp.
//
// Common to both: the S x S score matrix never reaches device memory; the
// tile loops visit only the causal/window band (the JAX _band_bounds and the
// dK/dV bounds at :327-336); the ragged tails of T and S are masked in the
// kernel, so the JAX off-grid fallback has no counterpart. The kv head is
// h / G: K and V are never repeated per query head, and the dK/dV kernels
// loop over the G query heads of their kv head, so dK and dV come out reduced
// over the group with no atomics. The Philox counter (i, j / 4) yields the
// keep bits of four consecutive keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLDT = kBK + 4;  // row length of a transposed (D x 64) tile
constexpr int kLDP = kBK + 1;  // row length of a (64 x 64) score tile
constexpr float kNegInf = -1e30f;

// Philox-4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;   // (B, S) or null
  const int* seed;  // one element, read only with dropout
  const void* dout;
  const float* lse;
  const float* delta;
  void* out;  // O (forward) or dQ
  float* lse_out;
  void* dk;
  void* dv;
  int B, Hq, Hkv, T, S, D, causal, window;  // window <= 0: none
  int key_hq, key_h0;  // dropout keys: heads [key_h0, key_h0 + Hq) of key_hq
  float scale;
  uint32_t threshold;
  float keep_div;  // 1 - rate
  int dropout;
  int vec;  // bf16 kernels: 16-byte copies (D % 8 == 0, 16-byte aligned rows)
};

__host__ __device__ __forceinline__ int num_tiles(int n, int t) { return (n + t - 1) / t; }

// Key tiles [lo, hi) that meet the band of the query tile starting at row i0.
__device__ __forceinline__ void key_band(const Params& p, int i0, int& lo, int& hi) {
  const int q_offset = p.S - p.T;
  const int nkb = num_tiles(p.S, kBK);
  hi = p.causal ? min((q_offset + i0 + kBQ - 1) / kBK + 1, nkb) : nkb;
  lo = p.window > 0 ? max(q_offset + i0 - p.window + 1, 0) / kBK : 0;
}

// Query tiles [lo, hi) that meet the band of the key tile starting at key j0.
__device__ __forceinline__ void query_band(const Params& p, int j0, int& lo, int& hi) {
  const int q_offset = p.S - p.T;
  const int nqb = num_tiles(p.T, kBQ);
  lo = p.causal ? max(j0 - q_offset, 0) / kBQ : 0;
  hi = nqb;
  if (p.window > 0) {
    const int last = j0 + kBK - 2 + p.window - q_offset;  // last query row reached
    hi = last < 0 ? 0 : min(last / kBQ + 1, nqb);
  }
}

__device__ __forceinline__ bool attends(const Params& p, int i, int j, int qseg, int kseg) {
  if (i >= p.T || j >= p.S) return false;
  const int d = (p.S - p.T) + i - j;
  if (p.causal && d < 0) return false;
  if (p.window > 0 && d >= p.window) return false;
  return p.seg == nullptr || qseg == kseg;
}

// rows x D tile of (B, H, len, D) float32 tensor `src` (head row `head`) from
// row r0 into shared memory, row-major with row length ld, times `mul`; rows
// past `len` are zero.
__device__ __forceinline__ void load_rows(float* dst, int ld, const void* src, size_t head,
                                          int r0, int rows, int len, int D, float mul) {
  const float* base = static_cast<const float*>(src) + head * static_cast<size_t>(len) * D;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = r0 + r < len ? base[static_cast<size_t>(r0 + r) * D + d] * mul : 0.f;
  }
}

// The same, transposed: dst[d * kLDT + r].
__device__ __forceinline__ void load_rows_t(float* dst, const void* src, size_t head, int r0,
                                            int rows, int len, int D) {
  const float* base = static_cast<const float*>(src) + head * static_cast<size_t>(len) * D;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[d * kLDT + r] = r0 + r < len ? base[static_cast<size_t>(r0 + r) * D + d] : 0.f;
  }
}

// acc[a][b] = sum_d A[ty + 16a][d] * Bt[d][4tx + b] over one 64 x 64 tile.
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, int lda,
                                         const float* Bt, int D, int tx, int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4 kv = *reinterpret_cast<const float4*>(Bt + d * kLDT + 4 * tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float x = A[(ty + 16 * a) * lda + d];
      acc[a][0] += x * kv.x;
      acc[a][1] += x * kv.y;
      acc[a][2] += x * kv.z;
      acc[a][3] += x * kv.w;
    }
  }
}

// The Philox key of query head h of batch row b: its index among the key_hq
// heads of the whole model (a tensor-parallel rank holds heads key_h0 ..
// key_h0 + Hq - 1), so a rank drops what the unsplit model drops there.
__device__ __forceinline__ int key_head(const Params& p, int b, int h) {
  return b * p.key_hq + p.key_h0 + h;
}

// Keep bits of keys j4*4 .. j4*4+3 of query row i of head bh.
__device__ __forceinline__ uint4 keep_bits(uint32_t seed, int bh, int i, int j4) {
  return philox(make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(j4), 0u, 0u),
                make_uint2(seed, static_cast<uint32_t>(bh)));
}

__device__ __forceinline__ bool kept(const uint4& w, int b, uint32_t threshold) {
  const uint32_t x = b == 0 ? w.x : b == 1 ? w.y : b == 2 ? w.z : w.w;
  return x >= threshold;
}

// --- forward ------------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ldq = D + 1;
  float* qs = smem;                 // [64][D+1], q * scale
  float* kt = qs + kBQ * ldq;       // [D][68], K transposed
  float* vs = kt + D * kLDT;        // [64][D]
  float* ps = vs + kBK * D;         // [64][65], dropped probabilities
  int* qseg = reinterpret_cast<int*>(ps + kBQ * kLDP);
  int* kseg = qseg + kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const size_t qhead = static_cast<size_t>(b) * p.Hq + h;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + h / G;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;

  load_rows(qs, ldq, p.q, qhead, i0, kBQ, p.T, D, p.scale);
  for (int r = tid; r < kBQ; r += kThreads)
    qseg[r] = (p.seg != nullptr && i0 + r < p.T) ? p.seg[static_cast<size_t>(b) * p.S + (p.S - p.T) + i0 + r] : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  int lo, hi;
  key_band(p, i0, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int j0 = kb * kBK;
    __syncthreads();  // the previous tile is no longer read
    load_rows_t(kt, p.k, khead, j0, kBK, p.S, D);
    load_rows(vs, D, p.v, khead, j0, kBK, p.S, D, 1.f);
    for (int r = tid; r < kBK; r += kThreads)
      kseg[r] = (p.seg != nullptr && j0 + r < p.S) ? p.seg[static_cast<size_t>(b) * p.S + j0 + r] : 0;
    __syncthreads();

    float s[4][4];
    tile_dot(s, qs, ldq, kt, D, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = attends(p, i, j0 + 4 * tx + c, qseg[r], kseg[4 * tx + c]);
        s[a][c] = ok[c] ? s[a][c] : kNegInf;
        mt = fmaxf(mt, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[a], mt);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        sum += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[a] - m_new);
      l[a] = alpha * l[a] + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= alpha;
      if (p.dropout) {
        const uint4 w = keep_bits(seed, key_head(p, b, h), i, j0 / 4 + tx);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = kept(w, c, p.threshold) ? s[a][c] / p.keep_div : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[r * kLDP + 4 * tx + c] = s[a][c];
    }
    __syncthreads();

    const int jn = min(kBK, p.S - j0);
    for (int j = 0; j < jn; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pa = ps[(ty + 16 * a) * kLDP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] += pa * vv[c];
      }
    }
  }

  float* out = static_cast<float*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.T) continue;
    const float l_safe = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[static_cast<size_t>(i) * D + d] = acc[a][c] / l_safe;
    }
    if (tx == 0) p.lse_out[qhead * p.T + i] = m[a] + logf(l_safe);
  }
}

// --- backward: dQ ---------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ldq = D + 1;
  float* qs = smem;             // [64][D+1]
  float* dos = qs + kBQ * ldq;  // [64][D+1]
  float* kt = dos + kBQ * ldq;  // [D][68]
  float* vt = kt + D * kLDT;    // [D][68]
  float* dss = vt + D * kLDT;   // [64][65]
  int* qseg = reinterpret_cast<int*>(dss + kBQ * kLDP);
  int* kseg = qseg + kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const size_t qhead = static_cast<size_t>(b) * p.Hq + h;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + h / G;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;

  load_rows(qs, ldq, p.q, qhead, i0, kBQ, p.T, D, 1.f);
  load_rows(dos, ldq, p.dout, qhead, i0, kBQ, p.T, D, 1.f);
  for (int r = tid; r < kBQ; r += kThreads)
    qseg[r] = (p.seg != nullptr && i0 + r < p.T) ? p.seg[static_cast<size_t>(b) * p.S + (p.S - p.T) + i0 + r] : 0;
  float lse[4], delta[4], dq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    lse[a] = i < p.T ? p.lse[qhead * p.T + i] : 0.f;
    delta[a] = i < p.T ? p.delta[qhead * p.T + i] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[a][c] = 0.f;
  }

  int lo, hi;
  key_band(p, i0, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int j0 = kb * kBK;
    __syncthreads();
    load_rows_t(kt, p.k, khead, j0, kBK, p.S, D);
    load_rows_t(vt, p.v, khead, j0, kBK, p.S, D);
    for (int r = tid; r < kBK; r += kThreads)
      kseg[r] = (p.seg != nullptr && j0 + r < p.S) ? p.seg[static_cast<size_t>(b) * p.S + j0 + r] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot(s, qs, ldq, kt, D, tx, ty);
    tile_dot(dp, dos, ldq, vt, D, tx, ty);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (p.dropout) w = keep_bits(seed, key_head(p, b, h), i, j0 / 4 + tx);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = attends(p, i, j0 + 4 * tx + c, qseg[r], kseg[4 * tx + c]);
        const float pr = ok ? expf(p.scale * s[a][c] - lse[a]) : 0.f;
        float pd = pr;
        if (p.dropout) pd = kept(w, c, p.threshold) ? pr / p.keep_div : 0.f;
        dss[r * kLDP + 4 * tx + c] = pd * dp[a][c] - pr * delta[a];
      }
    }
    __syncthreads();

    const int jn = min(kBK, p.S - j0);
    for (int j = 0; j < jn; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < D ? kt[d * kLDT + j] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dss[(ty + 16 * a) * kLDP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[a][c] += ds * kv[c];
      }
    }
  }

  float* out = static_cast<float*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.T) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[static_cast<size_t>(i) * D + d] = p.scale * dq[a][c];
    }
  }
}

// --- backward: dK and dV ----------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, ldq = D + 1;
  float* kt = smem;              // [D][68]
  float* vt = kt + D * kLDT;     // [D][68]
  float* qs = vt + D * kLDT;     // [64][D+1]
  float* dos = qs + kBQ * ldq;   // [64][D+1]
  float* pds = dos + kBQ * ldq;  // [64][65], dropped probabilities
  float* dss = pds + kBQ * kLDP; // [64][65]
  float* lse_s = dss + kBQ * kLDP;
  float* delta_s = lse_s + kBQ;
  int* qseg = reinterpret_cast<int*>(delta_s + kBQ);
  int* kseg = qseg + kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + hk;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;

  load_rows_t(kt, p.k, khead, j0, kBK, p.S, D);
  load_rows_t(vt, p.v, khead, j0, kBK, p.S, D);
  for (int r = tid; r < kBK; r += kThreads)
    kseg[r] = (p.seg != nullptr && j0 + r < p.S) ? p.seg[static_cast<size_t>(b) * p.S + j0 + r] : 0;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[a][c] = dv[a][c] = 0.f;

  int lo, hi;
  query_band(p, j0, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qhead = static_cast<size_t>(b) * p.Hq + h;
    for (int qb = lo; qb < hi; ++qb) {
      const int i0 = qb * kBQ;
      __syncthreads();
      load_rows(qs, ldq, p.q, qhead, i0, kBQ, p.T, D, 1.f);
      load_rows(dos, ldq, p.dout, qhead, i0, kBQ, p.T, D, 1.f);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = i0 + r < p.T;
        lse_s[r] = in ? p.lse[qhead * p.T + i0 + r] : 0.f;
        delta_s[r] = in ? p.delta[qhead * p.T + i0 + r] : 0.f;
        qseg[r] = (p.seg != nullptr && in) ? p.seg[static_cast<size_t>(b) * p.S + (p.S - p.T) + i0 + r] : 0;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot(s, qs, ldq, kt, D, tx, ty);
      tile_dot(dp, dos, ldq, vt, D, tx, ty);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a, i = i0 + r;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (p.dropout) w = keep_bits(seed, key_head(p, b, h), i, j0 / 4 + tx);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = attends(p, i, j0 + 4 * tx + c, qseg[r], kseg[4 * tx + c]);
          const float pr = ok ? expf(p.scale * s[a][c] - lse_s[r]) : 0.f;
          float pd = pr;
          if (p.dropout) pd = kept(w, c, p.threshold) ? pr / p.keep_div : 0.f;
          pds[r * kLDP + 4 * tx + c] = pd;
          dss[r * kLDP + 4 * tx + c] = pd * dp[a][c] - pr * delta_s[r];
        }
      }
      __syncthreads();

      const int in_rows = min(kBQ, p.T - i0);
      for (int i = 0; i < in_rows; ++i) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          qv[c] = d < D ? qs[i * ldq + d] : 0.f;
          dov[c] = d < D ? dos[i * ldq + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int jr = ty + 16 * a;
          const float pdv = pds[i * kLDP + jr], dsv = dss[i * kLDP + jr];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[a][c] += pdv * dov[c];
            dk[a][c] += dsv * qv[c];
          }
        }
      }
    }
  }

  const size_t base = khead * static_cast<size_t>(p.S) * D;
  float* dk_out = static_cast<float*>(p.dk) + base;
  float* dv_out = static_cast<float*>(p.dv) + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= p.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk_out[static_cast<size_t>(j) * D + d] = p.scale * dk[a][c];
        dv_out[static_cast<size_t>(j) * D + d] = dv[a][c];
      }
    }
  }
}

// --- bfloat16 tensor-core kernels: forward and dK/dV -------------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows (forward) or keys (dK/dV)
// fill_keep gives each thread one word of a 64-row mask, and copy_vals two
// rows of 64 values to the two halves of the block.
static_assert(kMmaThreads == 2 * kBQ && kBQ == kBK, "the bf16 kernels assume 64 x 64 tiles");

// 64 rows from r0 of head `head` of a (B, H, len, D) bf16 tensor into the
// shared tile dst (row length ld); rows past len are zero. vec: 16-byte
// asynchronous copies; else plain loads. Columns D .. ld are left alone.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld, const void* src,
                                          size_t head, int r0, int len, int D, bool vec) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src) + head * len * D;
  if (vec) {
    const int cpr = D / 8;  // 16-byte chunks per row
    for (int e = threadIdx.x; e < kBQ * cpr; e += kMmaThreads) {
      const int r = e / cpr, c = e - r * cpr;
      const bool in = r0 + r < len;
      cp_async16(dst + r * ld + 8 * c, base + (in ? static_cast<size_t>(r0 + r) * D + 8 * c : 0),
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < kBQ * D; e += kMmaThreads) {
      const int r = e / D, d = e - r * D;
      dst[r * ld + d] = r0 + r < len ? base[static_cast<size_t>(r0 + r) * D + d]
                                     : __float2bfloat16_rn(0.f);
    }
  }
}

// 64 four-byte values src[r0 + r] into dst[r], zero past len, copied by the
// threads first .. first + 63.
template <typename V>
__device__ __forceinline__ void copy_vals(V* dst, const V* src, int r0, int len, int first) {
  const int r = static_cast<int>(threadIdx.x) - first;
  if (r >= 0 && r < kBQ) cp_async4(dst + r, src + (r0 + r < len ? r0 + r : 0), r0 + r < len);
}

// [min, max] of the segment ids seg[r0 .. r0 + 64) below len; (INT_MAX,
// INT_MIN) when empty, reduced by the calling warp alone.
__device__ __forceinline__ int2 seg_range(const int* seg, int r0, int len) {
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = threadIdx.x & 31; r < kBQ; r += 32) {
    if (r0 + r < len) {
      const int s = seg[r0 + r];
      mn = min(mn, s);
      mx = max(mx, s);
    }
  }
  return make_int2(__reduce_min_sync(0xffffffffu, mn), __reduce_max_sync(0xffffffffu, mx));
}

__device__ __forceinline__ bool overlap(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// Keep bits of the 64 x 64 tile at (query i0, key j0) of head bh: word w of
// row r holds keys j0 + 32w .. j0 + 32w + 31 (bit k for key j0 + 32w + k).
// Thread t fills word t % 2 of row t / 2 with eight Philox calls.
__device__ __forceinline__ void fill_keep(uint32_t* keep, uint32_t seed, int bh, int i0, int j0,
                                          uint32_t threshold) {
  const int r = threadIdx.x >> 1, w = threadIdx.x & 1;
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 x = keep_bits(seed, bh, i0 + r, j0 / 4 + 8 * w + q);
    const uint32_t nib = (x.x >= threshold ? 1u : 0u) | (x.y >= threshold ? 2u : 0u) |
                         (x.z >= threshold ? 4u : 0u) | (x.w >= threshold ? 8u : 0u);
    word |= nib << (4 * q);
  }
  keep[2 * r + w] = word;
}

// Flags of the tiles [lo, hi) (one byte each, from `live`) whose segment-id
// range meets `own` (the range of this block's fixed tile); the other tiles'
// rows are seg[t * 64 ..] below len. The warps share the tiles; the caller
// synchronises before reading.
__device__ __forceinline__ void mark_live(uint8_t* live, int lo, int hi, int2 own,
                                          const int* seg, int len) {
  for (int t = lo + static_cast<int>(threadIdx.x >> 5); t < hi; t += kMmaThreads / 32) {
    const bool ok = overlap(own, seg_range(seg, t * kBQ, len));
    if ((threadIdx.x & 31) == 0) live[t - lo] = ok;
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Shared layout of the bf16 kernels: bf16 tiles of 64 rows x (DP + 8), then
// 32-bit rows of 64 (segment ids, LSE, delta), the keep masks, and one byte
// per tile of the band (the live flags).
template <int DP>
struct MmaTiles {
  static constexpr int ld = DP + 8;
  static constexpr int tile = kBQ * ld;  // elements of one tile
  // forward: Q, K x 2, V x 2; dQ: Q, dO, K x 2, V x 2; dK/dV: K, V, Q x 2, dO x 2
  __host__ __device__ static constexpr int tiles(Kind kind) { return kind == kFwd ? 5 : 6; }
  // forward: qseg, kseg x 2; dQ: lse, delta, qseg, kseg x 2;
  // dK/dV: lse x 2, delta x 2, qseg x 2, kseg
  __host__ __device__ static constexpr int rows(Kind kind) {
    return kind == kFwd ? 3 : kind == kDq ? 5 : 7;
  }
  static constexpr int keep_words = 2 * 2 * kBQ;
  static constexpr size_t bytes(Kind kind, int flags) {
    return tiles(kind) * tile * sizeof(__nv_bfloat16) +
           (rows(kind) * kBQ + keep_words) * sizeof(int) + (flags + 15) / 16 * 16;
  }
};

// Blocks per SM the register budget is cut for. The forward at padded
// D <= 64 is held to 168 registers (3 blocks of 128 threads per SM) with no
// spills; 4 blocks (128 registers) spill. The dQ and dK/dV kernels keep the
// compiler's own choice (up to 255); dK/dV needs ~245 registers at D <= 64,
// and a tighter bound spills and measured no faster.
template <int DP>
constexpr int mma_min_blocks(Kind kind) {
  return DP <= 64 && kind == kFwd ? 3 : 1;
}

// The key tiles one query tile streams, shared by the forward and dQ
// kernels: the band [lo, hi) of key_band, walked over the tiles that
// mark_live flagged, with K, V and the key segment ids of a tile copied into
// one of two stages by cp.async.
template <int DP>
struct KeyStream {
  __nv_bfloat16 *ks, *vs;  // [2][64][ld] each
  int* kseg;               // [2][64]
  const uint8_t* live;     // [hi - lo]
  const void *k, *v;
  const int* seg;  // this batch row's ids, or nullptr (every band tile live)
  size_t khead;
  int S, D, lo, hi;
  bool vec;

  __device__ __forceinline__ int next_live(int kb) const {  // the first from kb that may attend
    if (seg)
      while (kb < hi && !live[kb - lo]) ++kb;
    return kb;
  }
  __device__ __forceinline__ void load(int kb, int stage) const {  // always commits a group
    constexpr int LD = MmaTiles<DP>::ld, TILE = MmaTiles<DP>::tile;
    if (kb < hi) {
      copy_rows(ks + stage * TILE, LD, k, khead, kb * kBK, S, D, vec);
      copy_rows(vs + stage * TILE, LD, v, khead, kb * kBK, S, D, vec);
      if (seg) copy_vals(kseg + stage * kBQ, seg, kb * kBK, S, 0);
    }
    cp_async_commit();
  }
};

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>(kFwd))
    flash_fwd_mma_kernel(Params p) {
  using L = MmaTiles<DP>;
  constexpr int LD = L::ld, TILE = L::tile, KS = DP / 16, NT = DP / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [64][LD]
  __nv_bfloat16* ks = qs + TILE;                                    // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // [2][64][LD]
  int* qseg = reinterpret_cast<int*>(vs + 2 * TILE);                // [64]
  int* kseg = qseg + kBQ;                                           // [2][64]
  uint32_t* keep = reinterpret_cast<uint32_t*>(kseg + 2 * kBQ);     // [2][64][2]
  uint8_t* live = reinterpret_cast<uint8_t*>(keep + L::keep_words); // [hi - lo]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gr = lane >> 2, c = lane & 3;
  const int qb = num_tiles(p.T, kBQ) - 1 - blockIdx.x;  // the longest rows first
  const int i0 = qb * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv, D = p.D, q_offset = p.S - p.T;
  const size_t qhead = static_cast<size_t>(b) * p.Hq + h;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + h / G;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<size_t>(b) * p.S;
  const bool vec = p.vec != 0;
  const float sl2 = p.scale * kLog2e;  // scores are kept in log2 units
  const float inv_keep = 1.f / p.keep_div;

  if (D < DP) {  // the padding columns must read as zeros
    for (int e = threadIdx.x; e < L::tiles(kFwd) * TILE / 8; e += kMmaThreads)
      reinterpret_cast<uint4*>(qs)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  copy_rows(qs, LD, p.q, qhead, i0, p.T, D, vec);
  if (seg) copy_vals(qseg, seg + q_offset, i0, p.T, 0);
  cp_async_commit();

  int lo, hi;
  key_band(p, i0, lo, hi);
  if (seg) mark_live(live, lo, hi, seg_range(seg + q_offset, i0, p.T), seg, p.S);
  __syncthreads();
  const KeyStream<DP> kv{ks, vs, kseg, live, p.k, p.v, seg, khead, p.S, D, lo, hi, vec};
  int kb = kv.next_live(lo);
  kv.load(kb, 0);
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], frag_a<LD>(qs, 16 * warp, 16 * kk));
  int qpos[2], qsv[2];  // rows gr and gr + 8 of the warp's 16: key position, segment
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = 16 * warp + gr + 8 * e2;
    qpos[e2] = i0 + r < p.T ? q_offset + i0 + r : -1;  // -1: past T, attends nothing
    qsv[e2] = seg ? qseg[r] : 0;
  }

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int dt = 0; dt < NT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int n = 0; kb < hi; ++n) {
    const int stage = n & 1, j0 = kb * kBK;
    const int nxt = kv.next_live(kb + 1);
    kv.load(nxt, stage ^ 1);
    uint32_t* kp = keep + stage * 2 * kBQ;
    if (p.dropout) fill_keep(kp, seed, key_head(p, b, h), i0, j0, p.threshold);
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();

    const __nv_bfloat16* kt = ks + stage * TILE;
    const __nv_bfloat16* vt = vs + stage * TILE;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, frag_b<LD>(kt, 16 * np, 16 * kk));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    int2 ksv[8];  // segment ids of this thread's keys 8nt + 2c, 8nt + 2c + 1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      ksv[nt] = seg ? *reinterpret_cast<const int2*>(kseg + stage * kBQ + 8 * nt + 2 * c)
                    : make_int2(0, 0);

#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 16 * warp + gr + 8 * e2;
      // the keys jl this row attends lie in [jlo, jhi]
      int jhi = min(p.S - j0, kBK) - 1;
      if (p.causal) jhi = min(jhi, qpos[e2] - j0);
      if (qpos[e2] < 0) jhi = -1;
      const int jlo = p.window > 0 ? qpos[e2] - j0 - p.window + 1 : INT_MIN;
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * nt + 2 * c + e;
          const bool ok = jl >= jlo && jl <= jhi && (e ? ksv[nt].y : ksv[nt].x) == qsv[e2];
          float& x = s[nt][2 * e2 + e];
          x = ok ? x * sl2 : kNegInf;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[e2], mt);
      const float alpha = exp2f(m[e2] - m_new);
      const uint2 kw = p.dropout ? *reinterpret_cast<const uint2*>(kp + 2 * r) : make_uint2(0, 0);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * e2 + e];
          const float pr = x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;  // masked: exactly 0
          sum += pr;
          const uint32_t bit = ((nt < 4 ? kw.x : kw.y) >> (8 * (nt & 3) + 2 * c + e)) & 1u;
          x = p.dropout ? (bit ? pr * inv_keep : 0.f) : pr;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[e2] = alpha * l[e2] + sum;
      m[e2] = m_new;
#pragma unroll
      for (int dt = 0; dt < NT; ++dt) {
        o[dt][2 * e2] *= alpha;
        o[dt][2 * e2 + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16kk .. 16kk + 15: P's A operand
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, frag_a<LD>(vt, 16 * kk, 16 * dp));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
    kb = nxt;
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = i0 + 16 * warp + gr + 8 * e2;
    if (i >= p.T) continue;
    const float l_safe = fmaxf(l[e2], 1e-30f), inv_l = 1.f / l_safe;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const int d = 8 * dt + 2 * c;
      const float x0 = o[dt][2 * e2] * inv_l, x1 = o[dt][2 * e2 + 1] * inv_l;
      __nv_bfloat16* dst = out + static_cast<size_t>(i) * D + d;
      if (vec) {
        if (d < D) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < D) dst[1] = __float2bfloat16_rn(x1);
      }
    }
    // a row that attends nothing keeps the plain version's -1e30 exactly
    const float mrow = m[e2] > 0.5f * kNegInf ? m[e2] * kLn2 : kNegInf;
    if (c == 0) p.lse_out[qhead * p.T + i] = mrow + logf(l_safe);
  }
}

// dQ of one 64-row query tile: the forward's loop shape (Q's and dO's
// fragments held in registers, live key tiles streamed through two stages)
// with three products per tile: S = Q K^T and dP = dO V^T, then dS, packed to
// bf16 from the accumulators, as the A operand of dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>(kDq))
    flash_bwd_dq_mma_kernel(Params p) {
  using L = MmaTiles<DP>;
  constexpr int LD = L::ld, TILE = L::tile, KS = DP / 16, NT = DP / 8;
  constexpr int KC = DP <= 64 ? 64 : 32;  // keys per register pass
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [64][LD]
  __nv_bfloat16* dos = qs + TILE;                                   // [64][LD]
  __nv_bfloat16* ks = dos + TILE;                                   // [2][64][LD]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * TILE);           // [64]
  float* delta_s = lse_s + kBQ;                                     // [64]
  int* qseg = reinterpret_cast<int*>(delta_s + kBQ);                // [64]
  int* kseg = qseg + kBQ;                                           // [2][64]
  uint32_t* keep = reinterpret_cast<uint32_t*>(kseg + 2 * kBQ);     // [2][64][2]
  uint8_t* live = reinterpret_cast<uint8_t*>(keep + L::keep_words); // [hi - lo]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gr = lane >> 2, c = lane & 3;
  const int qb = num_tiles(p.T, kBQ) - 1 - blockIdx.x;  // the longest rows first
  const int i0 = qb * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv, D = p.D, q_offset = p.S - p.T;
  const size_t qhead = static_cast<size_t>(b) * p.Hq + h;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + h / G;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<size_t>(b) * p.S;
  const bool vec = p.vec != 0;
  const float sl2 = p.scale * kLog2e;
  const float inv_keep = 1.f / p.keep_div;

  if (D < DP) {
    for (int e = threadIdx.x; e < L::tiles(kDq) * TILE / 8; e += kMmaThreads)
      reinterpret_cast<uint4*>(qs)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  copy_rows(qs, LD, p.q, qhead, i0, p.T, D, vec);
  copy_rows(dos, LD, p.dout, qhead, i0, p.T, D, vec);
  copy_vals(lse_s, p.lse + qhead * p.T, i0, p.T, 0);
  copy_vals(delta_s, p.delta + qhead * p.T, i0, p.T, kBQ);
  if (seg) copy_vals(qseg, seg + q_offset, i0, p.T, 0);
  cp_async_commit();

  int lo, hi;
  key_band(p, i0, lo, hi);
  if (seg) mark_live(live, lo, hi, seg_range(seg + q_offset, i0, p.T), seg, p.S);
  __syncthreads();
  const KeyStream<DP> kv{ks, vs, kseg, live, p.k, p.v, seg, khead, p.S, D, lo, hi, vec};
  int kb = kv.next_live(lo);
  kv.load(kb, 0);
  cp_async_wait<1>();  // Q, dO, LSE, delta have landed
  __syncthreads();

  uint32_t qf[KS][4], df[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], frag_a<LD>(qs, 16 * warp, 16 * kk));
    ldmatrix_x4(df[kk], frag_a<LD>(dos, 16 * warp, 16 * kk));
  }
  // rows gr and gr + 8 of the warp's 16: key position, segment, LSE (log2
  // units), delta
  int qpos[2], qsv[2];
  float lse_l2[2], dlt[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = 16 * warp + gr + 8 * e2;
    qpos[e2] = i0 + r < p.T ? q_offset + i0 + r : -1;  // -1: past T, attends nothing
    qsv[e2] = seg ? qseg[r] : 0;
    lse_l2[e2] = lse_s[r] * kLog2e;
    dlt[e2] = delta_s[r];
  }

  float dq[NT][4];
#pragma unroll
  for (int dt = 0; dt < NT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  for (int n = 0; kb < hi; ++n) {
    const int stage = n & 1, j0 = kb * kBK;
    const int nxt = kv.next_live(kb + 1);
    kv.load(nxt, stage ^ 1);
    uint32_t* kp = keep + stage * 2 * kBQ;
    if (p.dropout) fill_keep(kp, seed, key_head(p, b, h), i0, j0, p.threshold);
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();

    const __nv_bfloat16* kt = ks + stage * TILE;
    const __nv_bfloat16* vt = vs + stage * TILE;
    const int* ksg = kseg + stage * kBQ;
    int jlo[2], jhi[2];  // the keys jl row e2 attends lie in [jlo, jhi]
    uint2 kw[2];         // its keep bits of this tile
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      jhi[e2] = min(p.S - j0, kBK) - 1;
      if (p.causal) jhi[e2] = min(jhi[e2], qpos[e2] - j0);
      if (qpos[e2] < 0) jhi[e2] = -1;
      jlo[e2] = p.window > 0 ? qpos[e2] - j0 - p.window + 1 : INT_MIN;
      kw[e2] = p.dropout ? *reinterpret_cast<const uint2*>(kp + 2 * (16 * warp + gr + 8 * e2))
                         : make_uint2(0, 0);
    }
#pragma unroll
    for (int kc = 0; kc < kBK; kc += KC) {
      float s[KC / 8][4], dp[KC / 8][4];  // S and dP: 16 rows x KC keys
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t bm[4];
          ldmatrix_x4(bm, frag_b<LD>(kt, kc + 16 * np, 16 * kk));
          mma_bf16(s[2 * np], qf[kk], bm[0], bm[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bm[2], bm[3]);
          ldmatrix_x4(bm, frag_b<LD>(vt, kc + 16 * np, 16 * kk));
          mma_bf16(dp[2 * np], df[kk], bm[0], bm[1]);
          mma_bf16(dp[2 * np + 1], df[kk], bm[2], bm[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt) {
        const int jb = kc + 8 * nt;  // this thread's keys jb + 2c, jb + 2c + 1
        const int2 ksv = seg ? *reinterpret_cast<const int2*>(ksg + jb + 2 * c) : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int e2 = e >> 1, jl = jb + 2 * c + (e & 1);
          const bool ok = jl >= jlo[e2] && jl <= jhi[e2] && ((e & 1) ? ksv.y : ksv.x) == qsv[e2];
          const float pr = ok ? exp2f(fmaf(s[nt][e], sl2, -lse_l2[e2])) : 0.f;
          const uint32_t bit = ((jb < 32 ? kw[e2].x : kw[e2].y) >> (jl & 31)) & 1u;
          const float pd = p.dropout ? (bit ? pr * inv_keep : 0.f) : pr;
          s[nt][e] = pd * dp[nt][e] - pr * dlt[e2];  // dS
        }
      }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {  // keys kc + 16kk ..: dS's A operand
        const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < DP / 16; ++dp2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, frag_a<LD>(kt, kc + 16 * kk, 16 * dp2));
          mma_bf16(dq[2 * dp2], da, bk[0], bk[1]);
          mma_bf16(dq[2 * dp2 + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
    kb = nxt;
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int i = i0 + 16 * warp + gr + 8 * e2;
    if (i >= p.T) continue;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const int d = 8 * dt + 2 * c;
      const float x0 = p.scale * dq[dt][2 * e2], x1 = p.scale * dq[dt][2 * e2 + 1];
      __nv_bfloat16* dst = out + static_cast<size_t>(i) * D + d;
      if (vec) {
        if (d < D) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < D) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, mma_min_blocks<DP>(kDkv))
    flash_bwd_dkv_mma_kernel(Params p) {
  using L = MmaTiles<DP>;
  constexpr int LD = L::ld, TILE = L::tile, KS = DP / 16, NT = DP / 8;
  constexpr bool kHoldKV = DP <= 64;      // K and V fragments in registers
  constexpr int QC = DP <= 64 ? 32 : 16;  // queries per register pass
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [64][LD]
  __nv_bfloat16* vs = ks + TILE;                                    // [64][LD]
  __nv_bfloat16* qs = vs + TILE;                                    // [2][64][LD]
  __nv_bfloat16* dos = qs + 2 * TILE;                               // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);          // [2][64]
  float* delta_s = lse_s + 2 * kBQ;                                 // [2][64]
  int* qseg = reinterpret_cast<int*>(delta_s + 2 * kBQ);            // [2][64]
  int* kseg = qseg + 2 * kBQ;                                       // [64]
  uint32_t* keep = reinterpret_cast<uint32_t*>(kseg + kBQ);         // [2][64][2]
  uint8_t* live = reinterpret_cast<uint8_t*>(keep + L::keep_words); // [hi - lo]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gr = lane >> 2, c = lane & 3;
  const int j0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv, D = p.D, q_offset = p.S - p.T;
  const size_t khead = static_cast<size_t>(b) * p.Hkv + hk;
  const uint32_t seed = p.dropout ? static_cast<uint32_t>(p.seed[0]) : 0u;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<size_t>(b) * p.S;
  const bool vec = p.vec != 0;
  const float sl2 = p.scale * kLog2e;
  const float inv_keep = 1.f / p.keep_div;

  if (D < DP) {
    for (int e = threadIdx.x; e < L::tiles(kDkv) * TILE / 8; e += kMmaThreads)
      reinterpret_cast<uint4*>(ks)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  copy_rows(ks, LD, p.k, khead, j0, p.S, D, vec);
  copy_rows(vs, LD, p.v, khead, j0, p.S, D, vec);
  if (seg) copy_vals(kseg, seg, j0, p.S, 0);
  cp_async_commit();

  int lo, hi;
  query_band(p, j0, lo, hi);
  if (seg) mark_live(live, lo, hi, seg_range(seg, j0, p.S), seg + q_offset, p.T);
  __syncthreads();
  auto next_live = [&](int qb) {  // the first query tile from qb that may attend
    if (seg)
      while (qb < hi && !live[qb - lo]) ++qb;
    return qb;
  };
  auto load_q = [&](int hg, int qb, int stage) {  // always commits a group, maybe empty
    if (hg < G) {
      const size_t qhead = static_cast<size_t>(b) * p.Hq + hk * G + hg;
      const int i0 = qb * kBQ;
      copy_rows(qs + stage * TILE, LD, p.q, qhead, i0, p.T, D, vec);
      copy_rows(dos + stage * TILE, LD, p.dout, qhead, i0, p.T, D, vec);
      copy_vals(lse_s + stage * kBQ, p.lse + qhead * p.T, i0, p.T, 0);
      copy_vals(delta_s + stage * kBQ, p.delta + qhead * p.T, i0, p.T, kBQ);
      if (seg) copy_vals(qseg + stage * kBQ, seg + q_offset, i0, p.T, 0);
    }
    cp_async_commit();
  };
  const int first = next_live(lo);
  int g = first < hi ? 0 : G, qb = first;  // the (head, query tile) items, head-major
  load_q(g, qb, 0);
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();

  uint32_t kf[kHoldKV ? KS : 1][4], vf[kHoldKV ? KS : 1][4];
  if constexpr (kHoldKV) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(kf[kk], frag_a<LD>(ks, 16 * warp, 16 * kk));
      ldmatrix_x4(vf[kk], frag_a<LD>(vs, 16 * warp, 16 * kk));
    }
  }
  int kpos[2], ksv[2];  // key rows gr and gr + 8 of the warp's 16: position, segment
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int jl = 16 * warp + gr + 8 * e2;
    kpos[e2] = j0 + jl;
    ksv[e2] = seg ? kseg[jl] : 0;
  }
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int n = 0; g < G; ++n) {
    const int stage = n & 1, i0 = qb * kBQ;
    int g2 = g, qb2 = next_live(qb + 1);
    if (qb2 >= hi) {
      ++g2;
      qb2 = first;
    }
    load_q(g2, qb2, stage ^ 1);
    uint32_t* kp = keep + stage * 2 * kBQ;
    if (p.dropout) fill_keep(kp, seed, key_head(p, b, hk * G + g), i0, j0, p.threshold);
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* qt = qs + stage * TILE;
    const __nv_bfloat16* dot = dos + stage * TILE;
    const float* ls = lse_s + stage * kBQ;
    const float* dl = delta_s + stage * kBQ;
    const int* qsg = qseg + stage * kBQ;
    // the queries il each key row attends lie in [ilo, ihi)
    int ilo[2], ihi[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int rel = kpos[e2] - q_offset - i0;  // il of the query at this key's position
      ilo[e2] = p.causal ? rel : INT_MIN;
      ihi[e2] = min(p.T - i0, kBQ);
      if (p.window > 0) ihi[e2] = min(ihi[e2], rel + p.window);
      if (kpos[e2] >= p.S) ihi[e2] = INT_MIN;
    }
#pragma unroll
    for (int qc = 0; qc < kBQ; qc += QC) {
      float st[QC / 8][4], dpt[QC / 8][4];  // S^T and dP^T: 16 keys x QC queries
#pragma unroll
      for (int nt = 0; nt < QC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kHoldKV) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[kk][e];
            va[e] = vf[kk][e];
          }
        } else {
          ldmatrix_x4(ka, frag_a<LD>(ks, 16 * warp, 16 * kk));
          ldmatrix_x4(va, frag_a<LD>(vs, 16 * warp, 16 * kk));
        }
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, frag_b<LD>(qt, qc + 16 * np, 16 * kk));
          mma_bf16(st[2 * np], ka, bq[0], bq[1]);
          mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bq, frag_b<LD>(dot, qc + 16 * np, 16 * kk));
          mma_bf16(dpt[2 * np], va, bq[0], bq[1]);
          mma_bf16(dpt[2 * np + 1], va, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < QC / 8; ++nt) {
        const int il0 = qc + 8 * nt + 2 * c;  // this thread's queries il0, il0 + 1
        const float2 lse2 = *reinterpret_cast<const float2*>(ls + il0);
        const float2 del2 = *reinterpret_cast<const float2*>(dl + il0);
        const int2 qs2 = seg ? *reinterpret_cast<const int2*>(qsg + il0) : make_int2(0, 0);
        const uint32_t w0 = p.dropout ? kp[2 * il0 + (warp >> 1)] : 0u;
        const uint32_t w1 = p.dropout ? kp[2 * il0 + 2 + (warp >> 1)] : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int e2 = e >> 1, il = il0 + (e & 1);
          const bool ok = il >= ilo[e2] && il < ihi[e2] && ((e & 1) ? qs2.y : qs2.x) == ksv[e2];
          const float lse_l2 = ((e & 1) ? lse2.y : lse2.x) * kLog2e;
          const float pr = ok ? exp2f(fmaf(st[nt][e], sl2, -lse_l2)) : 0.f;
          const uint32_t bit =
              (((e & 1) ? w1 : w0) >> (16 * (warp & 1) + gr + 8 * e2)) & 1u;
          const float pd = p.dropout ? (bit ? pr * inv_keep : 0.f) : pr;
          st[nt][e] = pd;
          dpt[nt][e] = pd * dpt[nt][e] - pr * ((e & 1) ? del2.y : del2.x);
        }
      }
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {  // queries qc + 16kk ..: Pd^T and dS^T as A
        const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bm[4];
          ldmatrix_x4_trans(bm, frag_a<LD>(dot, qc + 16 * kk, 16 * dp));
          mma_bf16(dv[2 * dp], pa, bm[0], bm[1]);
          mma_bf16(dv[2 * dp + 1], pa, bm[2], bm[3]);
          ldmatrix_x4_trans(bm, frag_a<LD>(qt, qc + 16 * kk, 16 * dp));
          mma_bf16(dk[2 * dp], da, bm[0], bm[1]);
          mma_bf16(dk[2 * dp + 1], da, bm[2], bm[3]);
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
    g = g2;
    qb = qb2;
  }

  const size_t base = khead * static_cast<size_t>(p.S) * D;
  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(p.dk) + base;
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(p.dv) + base;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int j = j0 + 16 * warp + gr + 8 * e2;
    if (j >= p.S) continue;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const int d = 8 * dt + 2 * c;
      const float k0 = p.scale * dk[dt][2 * e2], k1 = p.scale * dk[dt][2 * e2 + 1];
      const float v0 = dv[dt][2 * e2], v1 = dv[dt][2 * e2 + 1];
      const size_t at = static_cast<size_t>(j) * D + d;
      if (vec) {
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(k0, k1);
          *reinterpret_cast<__nv_bfloat162*>(dv_out + at) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
        if (d < D) {
          dk_out[at] = __float2bfloat16_rn(k0);
          dv_out[at] = __float2bfloat16_rn(v0);
        }
        if (d + 1 < D) {
          dk_out[at + 1] = __float2bfloat16_rn(k1);
          dv_out[at + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// --- launch -------------------------------------------------------------------------

size_t smem_bytes(Kind kind, int D) {
  const size_t rows = static_cast<size_t>(kBQ) * (D + 1);  // one [64][D+1] tile
  const size_t tr = static_cast<size_t>(D) * kLDT;         // one [D][68] tile
  const size_t sc = static_cast<size_t>(kBQ) * kLDP;       // one [64][65] tile
  size_t floats = 0;
  switch (kind) {
    case kFwd: floats = rows + tr + static_cast<size_t>(kBK) * D + sc; break;
    case kDq: floats = 2 * rows + 2 * tr + sc; break;
    case kDkv: floats = 2 * tr + 2 * rows + 2 * sc + 2 * kBQ; break;
  }
  return (floats + 2 * kBQ) * sizeof(float);  // + the two segment-id rows
}

// The SIMT kernels, float32 only (bf16 runs the tensor-core kernels).
template <int NC>
int launch_nc(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kern)(Params) = kind == kFwd ? flash_fwd_kernel<NC>
                         : kind == kDq ? flash_bwd_dq_kernel<NC>
                                       : flash_bwd_dkv_kernel<NC>;
  const size_t smem = smem_bytes(kind, p.D);
  // Opt in to more than 48 KB once per kernel instantiation: every D that
  // maps to this NC needs at most the shared memory of D = 16 * NC.
  static bool opted_in[3] = {false, false, false};
  if (!opted_in[kind]) {
    const size_t most = smem_bytes(kind, 16 * NC);
    if (most > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    opted_in[kind] = true;
  }
  const dim3 grid = kind == kDkv ? dim3(num_tiles(p.S, kBK), p.Hkv, p.B)
                                 : dim3(num_tiles(p.T, kBQ), p.Hq, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(Kind kind, const Params& p, cudaStream_t stream) {
  const int nc = (p.D + 15) / 16;
  if (nc <= 1) return launch_nc<1>(kind, p, stream);
  if (nc <= 2) return launch_nc<2>(kind, p, stream);
  if (nc <= 3) return launch_nc<3>(kind, p, stream);
  if (nc <= 4) return launch_nc<4>(kind, p, stream);
  if (nc <= 6) return launch_nc<6>(kind, p, stream);
  if (nc <= 8) return launch_nc<8>(kind, p, stream);
  return -1;
}

// The bf16 tensor-core kernel of `kind` at padded head width DP.
template <int DP>
int launch_mma_dp(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kern)(Params) = kind == kFwd ? flash_fwd_mma_kernel<DP>
                         : kind == kDq ? flash_bwd_dq_mma_kernel<DP>
                                       : flash_bwd_dkv_mma_kernel<DP>;
  const int nqb = num_tiles(p.T, kBQ), nkb = num_tiles(p.S, kBK);
  // one live flag per tile of the other axis
  const size_t smem = MmaTiles<DP>::bytes(kind, kind == kDkv ? nqb : nkb);
  static size_t opted_in[3] = {48 * 1024, 48 * 1024, 48 * 1024};  // per kernel instantiation
  if (smem > opted_in[kind]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[kind] = smem;
  }
  const dim3 grid = kind == kDkv ? dim3(nkb, p.Hkv, p.B) : dim3(nqb, p.Hq, p.B);
  kern<<<grid, kMmaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(Kind kind, Params p, cudaStream_t stream) {
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  p.vec = p.D % 8 == 0 && aligned(p.q) && aligned(p.k) && aligned(p.v) && aligned(p.dout) &&
          aligned(p.out) && aligned(p.dk) && aligned(p.dv);
  switch ((p.D + 15) / 16) {
    case 1: return launch_mma_dp<16>(kind, p, stream);
    case 2: return launch_mma_dp<32>(kind, p, stream);
    case 3: return launch_mma_dp<48>(kind, p, stream);
    case 4: return launch_mma_dp<64>(kind, p, stream);
    case 5: return launch_mma_dp<80>(kind, p, stream);
    case 6: return launch_mma_dp<96>(kind, p, stream);
    case 7: return launch_mma_dp<112>(kind, p, stream);
    case 8: return launch_mma_dp<128>(kind, p, stream);
    default: return -1;
  }
}

int launch(Kind kind, const Params& p, int dtype, cudaStream_t stream) {
  if (p.D < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.S < p.T || p.T < 1) return -1;
  if (p.dropout && (p.seed == nullptr || p.key_h0 < 0 || p.key_h0 + p.Hq > p.key_hq)) return -1;
  switch (dtype) {
    case 0: return launch_f32(kind, p, stream);
    case 1: return launch_mma(kind, p, stream);
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* seg,
                   const void* seed, int B, int Hq, int Hkv, int T, int S, int D, int causal,
                   int window, float scale, unsigned int threshold, float keep_div,
                   int dropout, int key_hq, int key_h0) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.seed = static_cast<const int*>(seed);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.T = T;
  p.S = S;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.threshold = threshold;
  p.keep_div = keep_div;
  p.dropout = dropout;
  p.key_hq = key_hq;
  p.key_h0 = key_h0;
  return p;
}

}  // namespace

// q (B, Hq, T, D), k and v (B, Hkv, S, D) contiguous in one dtype (0 float32,
// 1 bfloat16); seg (B, S) int32 or null; seed one int32, read only
// with dropout, whose keep bits of head h of row b are keyed on
// b * key_hq + key_h0 + h (key_hq = Hq, key_h0 = 0 for a whole model).
// window <= 0 means none. Each returns the launch's cudaError_t, or -1 for
// arguments it does not take.
extern "C" int glm_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                             const void* seed, void* out, void* lse, int B, int Hq, int Hkv,
                             int T, int S, int D, int causal, int window, float scale,
                             unsigned int threshold, float keep_div, int dropout, int key_hq,
                             int key_h0, int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout, key_hq, key_h0);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int glm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                                const void* seed, const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Hq, int Hkv, int T,
                                int S, int D, int causal, int window, float scale,
                                unsigned int threshold, float keep_div, int dropout,
                                int key_hq, int key_h0, int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout, key_hq, key_h0);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = dq;
  return launch(kDq, p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int glm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* seg, const void* seed, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int B, int Hq, int Hkv, int T, int S, int D, int causal,
                                 int window, float scale, unsigned int threshold,
                                 float keep_div, int dropout, int key_hq, int key_h0,
                                 int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout, key_hq, key_h0);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return launch(kDkv, p, dtype, static_cast<cudaStream_t>(stream));
}
