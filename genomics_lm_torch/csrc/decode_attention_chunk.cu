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
// dequantized in device memory. Output: (B, Hq, T, D) float32.
//
// What bounds it: the bytes of the cache. A launch reads the K and V rows of
// one layer (2*B*S*P elements at most) and does ~4*T*G operations per
// element read; at the verify shapes (T <= 8, G <= 4) that is far below the
// card's operations-per-byte balance point, so its least time is the cache
// bytes (plus the (B, T, S) mask) over device-memory bandwidth. Every block
// is one (kv head, slot): the cache is read once for all R = T*G query rows
// of the head's group, not T times. Block rows r = g*T + t (the query head g
// of the group, then the chunk position t), so the block's q and output rows
// are one contiguous (G, T, D) slab of q/out.
//
// Two designs live here.
//
// bfloat16 query, bfloat16 or int8 cache (decode_attention_chunk_mma_kernel):
// - Only live tiles are read. A cache position is dead when every one of
//   the slot's T mask rows is <= NEG_INF/2 there: the plain version gives it
//   weight exactly 0. The block reads its T x S mask rows once, marks the
//   tiles of 64 positions that hold a live position (one byte each in
//   shared memory), and never reads K, V or scales of a dead tile: the dead
//   tail past the slot's length and any wholly masked segment gap cost
//   nothing. The host passes no lengths (ops/decode_attention.py
//   ::chunk_live_tiles states the rule).
// - One pass with an online softmax: the live tiles stream through three
//   stages of shared memory with cp.async (16-, 8- or 4-byte copies of
//   whole head slices of consecutive positions, so every sector a warp
//   touches is used; rows past S are zero-filled), the scales and the
//   tile's mask values with them, so two tiles are in flight while one is
//   computed. Nothing in shared memory grows with S but one byte per tile.
// - Products on the tensor cores: the R query rows, padded to 16 or 32, are
//   the A operand of S = Q K^T (mma.sync m16n8k16, K fragments by ldmatrix)
//   and P, packed to bf16 straight from the accumulators, the A operand of
//   O += P V (V fragments by ldmatrix .trans). Each of the 4 warps owns 16
//   positions of every tile with its own running max, sum and O; the four
//   are combined once at the end through shared memory. An int8 tile is
//   converted to bf16 in shared memory (exact), its scores are multiplied
//   by k_scale and its probabilities by v_scale before P is packed.
// - P enters P V rounded to bf16 (the plain version keeps it float32): each
//   term of an output moves by at most bf16's unit roundoff times |v|.
// What it does not do: split S over blocks (one block per (kv head, slot)
// already gives 512 blocks at the speculative shape), TMA, wgmma.
//
// float32 query (decode_attention_chunk_kernel, the first, SIMT design): one
// thread per cached position computes the R scores into an R x S buffer in
// shared memory, a second pass takes the softmax, a third stages V in tiles
// of 32 positions and each thread keeps its (row, dim) outputs in
// registers. It reads the whole S axis with plain loads. It stays for the
// float32 path because the tensor cores have no exact float32 product.
//
// The TPU kernel's block-diagonal routing (pack_query_chunk) and its t-major
// repeat/tile of masks and scales are MXU lane tricks and are not carried
// over.

#include "decode_common.cuh"
#include "decode_tiles.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kTileS = 32;   // V positions staged in shared memory per phase-3 step
constexpr int kMaxRows = 32;  // R = T*G bound (the wrapper's KERNEL_MAX_CHUNK_ROWS)

// RM: compile-time bound on R = T*G (1, 4, 8, 16 or 32); R <= RM at run time.
template <typename TC, int RM, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_attention_chunk_kernel(const float* __restrict__ q, const TC* __restrict__ k_cache,
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

  for (int i = tid; i < R * D; i += kThreads) q_s[i] = q[base + i];
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
  // tensor-core kernel: bytes per cp.async of a head slice (16, 8, 4; 0:
  // plain loads), and whether mask rows take 16-byte reads (S % 4 == 0)
  int cb, mvec;
};

// --- bfloat16 query: the tensor-core kernel --------------------------------------

// kTile (64 cache positions), kNegInf, kLog2e, ceil_div and copy_tile come
// from decode_tiles.cuh.
constexpr int kErrSmem = -2;  // returned when chunk_layout(...) exceeds kSmemOptInLimit
constexpr size_t kSmemOptInLimit = 227 * 1024;  // sm_90's largest opt-in per block
constexpr int kStages = 3;   // tiles in shared memory: two in flight while one is computed

// Byte offsets of the tensor-core kernel's shared memory. bf16 tiles have
// rows of DP + 8 elements (16 bytes of padding: no bank conflicts). An int8
// cache lands raw in `raw` and is converted into one K and one V tile; a
// bf16 cache lands in kStages K and V tiles directly. The per-warp O
// partials of the final combine reuse the stage area.
struct Layout {
  size_t q, k, v, raw, ksc, vsc, msk, comb, ml, live, total;
};

__host__ __device__ inline Layout chunk_layout(int DP, int QM, int T, bool quant, int ntiles) {
  const size_t ld = DP + 8;
  const size_t tile = static_cast<size_t>(kTile) * ld * 2;  // one bf16 tile
  const size_t kv_tiles = quant ? 1 : kStages;
  Layout L{};
  L.q = 0;
  L.k = L.q + static_cast<size_t>(QM) * ld * 2;
  L.v = L.k + kv_tiles * tile;
  L.raw = L.v + kv_tiles * tile;
  L.ksc = L.raw + (quant ? static_cast<size_t>(kStages) * 2 * kTile * DP : 0);
  L.vsc = L.ksc + (quant ? kStages * kTile * 4 : 0);
  L.msk = L.vsc + (quant ? kStages * kTile * 4 : 0);
  const size_t stage_end = L.msk + static_cast<size_t>(kStages) * T * kTile * 4;
  L.comb = L.k;  // [kWarps][QM][DP] float, after the loop
  const size_t comb_end = L.comb + static_cast<size_t>(kWarps) * QM * DP * 4;
  L.ml = stage_end > comb_end ? stage_end : comb_end;  // [kWarps][QM][2] float
  L.live = L.ml + static_cast<size_t>(kWarps) * QM * 2 * 4;
  L.total = L.live + static_cast<size_t>(ceil_div(ntiles, 16)) * 16;
  return L;
}

// DP: D padded to a multiple of 16; MT: m16 tiles of query rows (R <= 16 MT).
template <int DP, int MT, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_attention_chunk_mma_kernel(Args a) {
  using TC = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  constexpr int LD = DP + 8, KS = DP / 16, NT = DP / 8, QM = 16 * MT;
  const int T = a.T, S = a.S, D = a.D, R = a.G * a.T;
  const int ntiles = ceil_div(S, kTile);
  const Layout lay = chunk_layout(DP, QM, T, kQuant, ntiles);
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(chunk_smem + lay.q);   // [QM][LD]
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(chunk_smem + lay.k);   // [kv][64][LD]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(chunk_smem + lay.v);   // [kv][64][LD]
  unsigned char* raw = chunk_smem + lay.raw;                          // [kStages][2][64][DP]
  float* ksc = reinterpret_cast<float*>(chunk_smem + lay.ksc);        // [kStages][64]
  float* vsc = reinterpret_cast<float*>(chunk_smem + lay.vsc);        // [kStages][64]
  float* msk = reinterpret_cast<float*>(chunk_smem + lay.msk);        // [kStages][T][64]
  float* comb = reinterpret_cast<float*>(chunk_smem + lay.comb);      // [kWarps][QM][DP]
  float* ml = reinterpret_cast<float*>(chunk_smem + lay.ml);          // [kWarps][QM][2]
  uint8_t* live = chunk_smem + lay.live;                              // [ntiles]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gr = lane >> 2, c = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t P = static_cast<size_t>(a.Hkv) * D;
  const size_t slab = (static_cast<size_t>(a.layer) * a.B + b) * S;  // row (layer, b, 0)
  const TC* kb = static_cast<const TC*>(a.k_cache) + slab * P + static_cast<size_t>(hk) * D;
  const TC* vb = static_cast<const TC*>(a.v_cache) + slab * P + static_cast<size_t>(hk) * D;
  const size_t scale_row = ((static_cast<size_t>(a.layer) * a.B + b) * a.Hkv + hk) * S;
  const float* mrows = a.mask + static_cast<size_t>(b) * T * S;  // [T][S]
  const size_t base = (static_cast<size_t>(b) * a.Hkv + hk) * static_cast<size_t>(R) * D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);

  // zero the K/V tiles and raw int8 rows (their padding columns must read
  // as zeros) and the live flags; Q with its padding rows and columns
  if (D < DP) {
    for (int e = threadIdx.x; e < static_cast<int>((lay.ksc - lay.k) / 16); e += kThreads)
      reinterpret_cast<uint4*>(ks)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int t = threadIdx.x; t < ntiles; t += kThreads) live[t] = 0;
  for (int e = threadIdx.x; e < QM * LD; e += kThreads) {
    const int r = e / LD, d = e - r * LD;
    qs[e] = r < R && d < D ? q[base + static_cast<size_t>(r) * D + d] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  // live tiles: any of the T mask rows above NEG_INF / 2 somewhere in the tile
  // (several writers store the same 1); 16-byte loads when rows allow
  if (a.mvec) {
    const float4* m4 = reinterpret_cast<const float4*>(mrows);
    const int S4 = S / 4;
#pragma unroll 4
    for (int t = 0; t < T; ++t)
      for (int j = threadIdx.x; j < S4; j += kThreads) {
        const float4 x = __ldg(m4 + t * S4 + j);
        if (fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)) > 0.5f * kNegInf) live[j / (kTile / 4)] = 1;
      }
  } else {
#pragma unroll 4
    for (int t = 0; t < T; ++t)
      for (int j = threadIdx.x; j < S; j += kThreads)
        if (__ldg(mrows + static_cast<size_t>(t) * S + j) > 0.5f * kNegInf) live[j / kTile] = 1;
  }
  __syncthreads();

  auto next_live = [&](int t) {
    while (t < ntiles && !live[t]) ++t;
    return t;
  };
  auto load = [&](int t, int st) {  // always commits a group, maybe empty
    if (t < ntiles) {
      const int j0 = t * kTile;
      if constexpr (kQuant) {
        unsigned char* rk = raw + static_cast<size_t>(st) * 2 * kTile * DP;
        copy_tile(rk, DP, kb, P, j0, S, D, a.cb);
        copy_tile(rk + kTile * DP, DP, vb, P, j0, S, D, a.cb);
        const int r = threadIdx.x & (kTile - 1);
        const bool in = j0 + r < S;
        const float* src = (threadIdx.x < kTile ? a.k_scale : a.v_scale) + scale_row;
        cp_async4((threadIdx.x < kTile ? ksc : vsc) + st * kTile + r, src + (in ? j0 + r : 0), in);
      } else {
        copy_tile(reinterpret_cast<unsigned char*>(ks + st * kTile * LD), LD * 2, kb, P, j0, S, D,
                  a.cb);
        copy_tile(reinterpret_cast<unsigned char*>(vs + st * kTile * LD), LD * 2, vb, P, j0, S, D,
                  a.cb);
      }
      const int step = a.mvec ? 4 : 1;  // mask values per copy
      for (int e = threadIdx.x; e < T * kTile / step; e += kThreads) {
        const int t2 = e * step / kTile, j = e * step - t2 * kTile;
        const bool in = j0 + j < S;  // all `step` values or none (S % step == 0)
        float* dst = msk + st * T * kTile + t2 * kTile + j;
        const float* src = mrows + static_cast<size_t>(t2) * S + (in ? j0 + j : 0);
        if (a.mvec) cp_async16(dst, src, in);
        else cp_async4(dst, src, in);
      }
    }
    cp_async_commit();
  };

  int fetch = next_live(0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    load(fetch, st);
    fetch = next_live(fetch + 1);
  }

  // this thread's rows 16mt + gr + 8e2: their mask row t (-1: past R)
  int rt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 16 * mt + gr + 8 * e2;
      rt[mt][e2] = r < R ? r % T : -1;
    }
  float m[MT][2], l[MT][2], o[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) o[mt][dt][0] = o[mt][dt][1] = o[mt][dt][2] = o[mt][dt][3] = 0.f;
  }
  const int jw = 16 * warp;  // this warp's 16 positions of every tile
  const float sl2 = a.inv_sqrt_d * kLog2e;

  int kt_idx = next_live(0);
  for (int n = 0; kt_idx < ntiles; ++n) {
    const int st = n % kStages, j0 = kt_idx * kTile;
    load(fetch, (n + kStages - 1) % kStages);
    fetch = next_live(fetch + 1);
    cp_async_wait<kStages - 1>();  // this stage has landed
    __syncthreads();

    const __nv_bfloat16* kt = ks;
    const __nv_bfloat16* vt = vs;
    if constexpr (kQuant) {  // int8 -> bf16 (exact), 16 bytes of a raw row at a time
      constexpr int CPR = DP / 16;  // pieces per raw row; 128 rows x CPR = kThreads x CPR
      const uint4* rk = reinterpret_cast<const uint4*>(raw + static_cast<size_t>(st) * 2 * kTile * DP);
#pragma unroll
      for (int i = 0; i < CPR; ++i) {
        const int e = threadIdx.x + kThreads * i;
        const int rr = e / CPR, piece = e - rr * CPR;  // rows 0..63 K, 64..127 V
        const uint4 w = rk[e];
        const int8_t* x = reinterpret_cast<const int8_t*>(&w);
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          h[j] = pack_bf16(static_cast<float>(x[2 * j]), static_cast<float>(x[2 * j + 1]));
        uint4* dst = reinterpret_cast<uint4*>(
            (rr < kTile ? ks + rr * LD : vs + (rr - kTile) * LD) + 16 * piece);
        dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
        dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
    } else {
      kt = ks + st * kTile * LD;
      vt = vs + st * kTile * LD;
    }

    float s[MT][2][4];  // scores of rows 16mt.., keys jw + 8nt ..
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      ldmatrix_x4(bk, frag_b<LD>(kt, jw, 16 * kk));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldmatrix_x4(qa, frag_a<LD>(qs, 16 * mt, 16 * kk));
        mma_bf16(s[mt][0], qa, bk[0], bk[1]);
        mma_bf16(s[mt][1], qa, bk[2], bk[3]);
      }
    }

    const float* mk = msk + st * T * kTile;
    float kscl[2][2], vscl[2][2];  // scales of keys jw + 8nt + 2c + e
    bool kin[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = jw + 8 * nt + 2 * c + e;
        kin[nt][e] = j0 + jl < S;
        kscl[nt][e] = kQuant ? ksc[st * kTile + jl] : 1.f;
        vscl[nt][e] = kQuant ? vsc[st * kTile + jl] : 1.f;
      }
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = rt[mt][e2];
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = jw + 8 * nt + 2 * c + e;
            const float mv = t >= 0 ? mk[t * kTile + jl] : kNegInf;
            const bool ok = kin[nt][e] && mv > 0.5f * kNegInf;
            float& x = s[mt][nt][2 * e2 + e];
            x = ok ? fmaf(x * kscl[nt][e], sl2, mv * kLog2e) : kNegInf;  // log2 units
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][e2], mx);
        const float alpha = exp2f(m[mt][e2] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * e2 + e];
            const float pr = x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;  // masked: exactly 0
            sum += pr;
            x = pr * vscl[nt][e];
          }
        l[mt][e2] = alpha * l[mt][e2] + sum;  // this thread's share of the row sum
        m[mt][e2] = m_new;
#pragma unroll
        for (int dt = 0; dt < NT; ++dt) {
          o[mt][dt][2 * e2] *= alpha;
          o[mt][dt][2 * e2 + 1] *= alpha;
        }
      }
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, frag_a<LD>(vt, jw, 16 * dp));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
        mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is read; a later iteration refills it
    kt_idx = next_live(kt_idx + 1);
  }
  cp_async_wait<0>();

  // Combine the four warps: M = max m_w, out = sum_w 2^(m_w - M) O_w / sum_w 2^(m_w - M) l_w.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      float x = l[mt][e2];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[mt][e2] = x;
      if (c == 0) {
        float* at = ml + (warp * QM + 16 * mt + gr + 8 * e2) * 2;
        at[0] = m[mt][e2];
        at[1] = x;
      }
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 16 * mt + gr + 8 * e2;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml[(w * QM + r) * 2]);
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        total += exp2f(ml[(w * QM + r) * 2] - M) * ml[(w * QM + r) * 2 + 1];
      const float f = exp2f(m[mt][e2] - M) / fmaxf(total, 1e-30f);
      float* dst = comb + (warp * QM + r) * DP;
#pragma unroll
      for (int dt = 0; dt < NT; ++dt)
        *reinterpret_cast<float2*>(dst + 8 * dt + 2 * c) =
            make_float2(o[mt][dt][2 * e2] * f, o[mt][dt][2 * e2 + 1] * f);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += comb[(w * QM + r) * DP + d];
    a.out[base + e] = x;
  }
}

// --- launch ------------------------------------------------------------------------

template <typename TC, int RM, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = decode_attention_chunk_kernel<TC, RM, VEC>;
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
      static_cast<const float*>(a.q), static_cast<const TC*>(a.k_cache),
      static_cast<const TC*>(a.v_cache), a.k_scale, a.v_scale, a.mask, a.out, a.B, a.S,
      a.Hkv, a.G, a.T, a.D, a.layer, a.inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int dispatch_rows(const Args& a, bool vec, cudaStream_t stream) {
#define GLM_DAC_VEC(RM)                                                            \
  return vec ? launch<TC, RM, true>(a, stream) : launch<TC, RM, false>(a, stream)
  const int R = a.G * a.T;
  if (R <= 1) GLM_DAC_VEC(1);
  if (R <= 4) GLM_DAC_VEC(4);
  if (R <= 8) GLM_DAC_VEC(8);
  if (R <= 16) GLM_DAC_VEC(16);
  if (R <= kMaxRows) GLM_DAC_VEC(32);
#undef GLM_DAC_VEC
  return -1;
}

template <int DP, int MT, bool kQuant>
int launch_mma(const Args& a, cudaStream_t stream) {
  auto kern = decode_attention_chunk_mma_kernel<DP, MT, kQuant>;
  const size_t smem = chunk_layout(DP, 16 * MT, a.T, kQuant, ceil_div(a.S, kTile)).total;
  if (smem > kSmemOptInLimit) return kErrSmem;
  static size_t opted_in = 48 * 1024;  // per kernel instantiation
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  kern<<<dim3(a.Hkv, a.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_mma_rows(const Args& a, bool quant, cudaStream_t stream) {
  if (a.G * a.T <= 16)
    return quant ? launch_mma<DP, 1, true>(a, stream) : launch_mma<DP, 1, false>(a, stream);
  return quant ? launch_mma<DP, 2, true>(a, stream) : launch_mma<DP, 2, false>(a, stream);
}

int dispatch_mma(Args a, bool quant, cudaStream_t stream) {
  a.cb = copy_bytes(a.k_cache, a.v_cache, a.D, a.Hkv, quant ? 1 : 2);
  a.mvec = a.S % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 16 == 0;
  switch ((a.D + 15) / 16) {
    case 1: return dispatch_mma_rows<16>(a, quant, stream);
    case 2: return dispatch_mma_rows<32>(a, quant, stream);
    case 3: return dispatch_mma_rows<48>(a, quant, stream);
    case 4: return dispatch_mma_rows<64>(a, quant, stream);
    case 5: return dispatch_mma_rows<80>(a, quant, stream);
    case 6: return dispatch_mma_rows<96>(a, quant, stream);
    case 7: return dispatch_mma_rows<112>(a, quant, stream);
    case 8: return dispatch_mma_rows<128>(a, quant, stream);
    default: return -1;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 3 int8. A float cache has the
// query's dtype; an int8 cache takes a float32 or bfloat16 query. A
// bfloat16 query runs the tensor-core kernel, a float32 query the SIMT one
// (`vec`: its 16-byte, 8 for int8, loads). Returns the launch's
// cudaError_t, -1 for arguments it does not take, or kErrSmem (-2) when the
// tensor-core kernel's layout needs more shared memory than a block may have.
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
               B, S, Hkv, G, T, D, layer, inv_sqrt_d, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = cache_dtype == 3;
  switch (q_dtype) {
    case 0:
      return quant ? dispatch_rows<int8_t>(a, vec != 0, st) : dispatch_rows<float>(a, vec != 0, st);
    case 1: return dispatch_mma(a, quant, st);
    default: return -1;
  }
}
