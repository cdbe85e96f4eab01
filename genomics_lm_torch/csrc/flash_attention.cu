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
// D 48) the causal band holds ~8.4M score elements per head-batch sweep, each
// needing 2*D multiply-adds in the forward and 4*D to 6*D in the backward,
// against ~13-19 MB of operands: 120-170 operations per byte, so a tensor-core
// kernel would be bound by device-memory bytes (a few microseconds). These
// first kernels do the multiply-adds in float32 on the CUDA cores instead,
// so they are bound by the CUDA cores and the shared-memory loads that feed
// them, far above that bound: a simple design that is right comes first;
// mma/wgmma tiles, TMA and warp specialisation are later work.
//
// What the design does: every operand element is read from device memory
// once per tile visit and kept in shared memory as float32 (so bf16 inputs
// are converted once); the S x S score matrix never reaches device memory;
// the key-tile loop visits only the tiles of the causal/window band (the
// JAX _band_bounds and the dK/dV bounds at :327-336); the ragged tails of T
// and S are masked in the kernel, so every length runs here and the JAX
// off-grid fallback has no counterpart. The kv head is h / G: K and V are
// never repeated per query head, and the dK/dV kernel loops over the G
// query heads of its kv head, so dK and dV come out reduced over the group.
//
// Tiles: 64 query rows x 64 keys, 256 threads as 16 x 16. A thread owns the
// score elements of rows ty + 16a (a < 4) and keys 4tx + b (b < 4), and the
// output elements of rows ty + 16a and head dims tx + 16c (c < NC, NC =
// ceil(D / 16)). Row reductions are shuffles across the 16 lanes of a
// half-warp. The Philox counter (i, j / 4) yields the keep bits of four
// consecutive keys, which one thread owns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLDT = kBK + 4;  // row length of a transposed (D x 64) tile
constexpr int kLDP = kBK + 1;  // row length of a (64 x 64) score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
  float scale;
  uint32_t threshold;
  float keep_div;  // 1 - rate
  int dropout;
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

// rows x D tile of (B, H, len, D) tensor `src` (head row `head`) from row r0
// into shared memory, row-major with row length ld, times `mul`; rows past
// `len` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, size_t head,
                                          int r0, int rows, int len, int D, float mul) {
  const T* base = src + head * static_cast<size_t>(len) * D;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = r0 + r < len ? to_f32(base[static_cast<size_t>(r0 + r) * D + d]) * mul : 0.f;
  }
}

// The same, transposed: dst[d * kLDT + r].
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, size_t head, int r0,
                                            int rows, int len, int D) {
  const T* base = src + head * static_cast<size_t>(len) * D;
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[d * kLDT + r] = r0 + r < len ? to_f32(base[static_cast<size_t>(r0 + r) * D + d]) : 0.f;
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

template <typename T, int NC>
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

  load_rows(qs, ldq, static_cast<const T*>(p.q), qhead, i0, kBQ, p.T, D, p.scale);
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
    load_rows_t(kt, static_cast<const T*>(p.k), khead, j0, kBK, p.S, D);
    load_rows(vs, D, static_cast<const T*>(p.v), khead, j0, kBK, p.S, D, 1.f);
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
        const uint4 w = keep_bits(seed, static_cast<int>(qhead), i, j0 / 4 + tx);
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

  T* out = static_cast<T*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.T) continue;
    const float l_safe = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[static_cast<size_t>(i) * D + d] = from_f32<T>(acc[a][c] / l_safe);
    }
    if (tx == 0) p.lse_out[qhead * p.T + i] = m[a] + logf(l_safe);
  }
}

// --- backward: dQ ---------------------------------------------------------------

template <typename T, int NC>
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

  load_rows(qs, ldq, static_cast<const T*>(p.q), qhead, i0, kBQ, p.T, D, 1.f);
  load_rows(dos, ldq, static_cast<const T*>(p.dout), qhead, i0, kBQ, p.T, D, 1.f);
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
    load_rows_t(kt, static_cast<const T*>(p.k), khead, j0, kBK, p.S, D);
    load_rows_t(vt, static_cast<const T*>(p.v), khead, j0, kBK, p.S, D);
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
      if (p.dropout) w = keep_bits(seed, static_cast<int>(qhead), i, j0 / 4 + tx);
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

  T* out = static_cast<T*>(p.out) + qhead * static_cast<size_t>(p.T) * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= p.T) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) out[static_cast<size_t>(i) * D + d] = from_f32<T>(p.scale * dq[a][c]);
    }
  }
}

// --- backward: dK and dV ----------------------------------------------------------

template <typename T, int NC>
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

  load_rows_t(kt, static_cast<const T*>(p.k), khead, j0, kBK, p.S, D);
  load_rows_t(vt, static_cast<const T*>(p.v), khead, j0, kBK, p.S, D);
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
      load_rows(qs, ldq, static_cast<const T*>(p.q), qhead, i0, kBQ, p.T, D, 1.f);
      load_rows(dos, ldq, static_cast<const T*>(p.dout), qhead, i0, kBQ, p.T, D, 1.f);
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
        if (p.dropout) w = keep_bits(seed, static_cast<int>(qhead), i, j0 / 4 + tx);
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
  T* dk_out = static_cast<T*>(p.dk) + base;
  T* dv_out = static_cast<T*>(p.dv) + base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= p.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk_out[static_cast<size_t>(j) * D + d] = from_f32<T>(p.scale * dk[a][c]);
        dv_out[static_cast<size_t>(j) * D + d] = from_f32<T>(dv[a][c]);
      }
    }
  }
}

// --- launch -------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

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

template <typename T, int NC>
int launch_nc(Kind kind, const Params& p, cudaStream_t stream) {
  void (*kern)(Params) = kind == kFwd  ? flash_fwd_kernel<T, NC>
                         : kind == kDq ? flash_bwd_dq_kernel<T, NC>
                                       : flash_bwd_dkv_kernel<T, NC>;
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

template <typename T>
int launch_t(Kind kind, const Params& p, cudaStream_t stream) {
  const int nc = (p.D + 15) / 16;
  if (nc <= 1) return launch_nc<T, 1>(kind, p, stream);
  if (nc <= 2) return launch_nc<T, 2>(kind, p, stream);
  if (nc <= 3) return launch_nc<T, 3>(kind, p, stream);
  if (nc <= 4) return launch_nc<T, 4>(kind, p, stream);
  if (nc <= 6) return launch_nc<T, 6>(kind, p, stream);
  if (nc <= 8) return launch_nc<T, 8>(kind, p, stream);
  return -1;
}

int launch(Kind kind, const Params& p, int dtype, cudaStream_t stream) {
  if (p.D < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.S < p.T || p.T < 1) return -1;
  if (p.dropout && p.seed == nullptr) return -1;
  switch (dtype) {
    case 0: return launch_t<float>(kind, p, stream);
    case 1: return launch_t<__nv_bfloat16>(kind, p, stream);
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* seg,
                   const void* seed, int B, int Hq, int Hkv, int T, int S, int D, int causal,
                   int window, float scale, unsigned int threshold, float keep_div,
                   int dropout) {
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
  return p;
}

}  // namespace

// q (B, Hq, T, D), k and v (B, Hkv, S, D) contiguous in one dtype (0 float32,
// 1 bfloat16); seg (B, S) int32 or null; seed one int32, read only
// with dropout. window <= 0 means none. Each returns the launch's
// cudaError_t, or -1 for arguments it does not take.
extern "C" int glm_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                             const void* seed, void* out, void* lse, int B, int Hq, int Hkv,
                             int T, int S, int D, int causal, int window, float scale,
                             unsigned int threshold, float keep_div, int dropout, int dtype,
                             void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int glm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* seg,
                                const void* seed, const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Hq, int Hkv, int T,
                                int S, int D, int causal, int window, float scale,
                                unsigned int threshold, float keep_div, int dropout,
                                int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout);
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
                                 float keep_div, int dropout, int dtype, void* stream) {
  Params p = make_params(q, k, v, seg, seed, B, Hq, Hkv, T, S, D, causal, window, scale,
                         threshold, keep_div, dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return launch(kDkv, p, dtype, static_cast<cudaStream_t>(stream));
}
