// The cache-tile machinery of the decode-attention kernels, for Hopper
// (sm_90a): the 64-position tile, its asynchronous copy (also used by
// decode_attention_chunk.cu), and the single-token core that
// decode_attention.cu and decode_attention_streamed.cu both launch.
//
// The single-token core (decode_tile_kernel): one block of 128 threads per
// (kv head, slot, split of the S axis) walks the split's positions in tiles
// of 64 and reads only the tiles that hold a live mask position.
// - Live tiles. A position whose mask value is <= NEG_INF/2 has weight
//   exactly 0 (exp(-1e30 + x - m) is 0 in float32), so a tile with no live
//   position is never read: its K, V and scales may hold anything. Every
//   warp reads the slot's mask row itself (16-byte reads, four in flight a
//   lane) and keeps the flags of 64 tiles as one 64-bit word in registers,
//   so the first copies are issued right after one round trip of mask
//   reads, with no barrier and nothing in shared memory that grows with S.
// - Pipeline. The live tiles stream through four stages of shared memory
//   (three for a float32 cache) with cp.async (16-, 8- or 4-byte copies of
//   the head's D-slice of consecutive positions; rows past the split are
//   zero-filled), each with its 64 mask values and, for an int8 cache, its
//   k and v scales: a slot of up to 256 positions has all its tiles in
//   flight at once, and the block waits on memory once. One barrier a tile.
// - One pass. Each of the 4 warps owns 16 positions of every tile and keeps
//   its own running max m, sum l and P.V accumulator for the G query rows
//   (float32 on the SIMT units: the serving model is MHA, G = 1, where the
//   tensor cores buy little). Scores: two lanes per position, each half of
//   D, summed by one shuffle. P.V: lanes own (query row, 16 bytes of D, 8
//   for int8) items over a share of the warp's positions. The warps combine once at
//   the end through shared memory (no atomics). Scores are kept in log2
//   units (exp2); int8 turns into float32 with a byte permute and a
//   subtraction, not the quarter-rate integer conversion.
// - Output. One split writes the normalized (B, Hq, D) rows. Several write
//   (m, l, unnormalized acc) per split (a split without a live tile writes
//   m = NEG_INF, l = 0, acc = 0, so it adds exactly nothing), and the last
//   block of a (slot, kv head) to finish, found with a counter that it
//   resets, combines them: no second launch.

#pragma once

#include "decode_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kTile = 64;           // cache positions per tile
constexpr float kNegInf = -1e30f;   // the mask's NEG_INF; <= kNegInf / 2 blocks a key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxGroup = 8;        // G = Hq / Hkv bound of the single-token core

__host__ __device__ constexpr int ceil_div(int n, int d) { return (n + d - 1) / d; }

// kTile cache rows from position j0 of one head slice (row stride P elements)
// into dst (row stride ld_bytes); rows at or past `end` are zero. cb: bytes per
// cp.async (a warp's consecutive threads copy consecutive pieces of whole
// rows), or 0 for plain loads.
template <typename TC>
__device__ __forceinline__ void copy_tile(unsigned char* dst, int ld_bytes, const TC* src,
                                          size_t P, int j0, int end, int D, int cb) {
  if (cb) {
    const int cpr = D * static_cast<int>(sizeof(TC)) / cb;  // copies per row
    const int row_bytes = static_cast<int>(P * sizeof(TC));  // < 2^31 / kTile
    const unsigned char* base = reinterpret_cast<const unsigned char*>(src + static_cast<size_t>(j0) * P);
    // copy e is (row r, piece c); both step by kThreads without a division
    int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
    const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
    for (int e = threadIdx.x; e < kTile * cpr; e += kThreads) {
      const bool in = j0 + r < end;
      const unsigned char* s = in ? base + r * row_bytes + c * cb : base;
      unsigned char* d = dst + r * ld_bytes + c * cb;
      if (cb == 16) cp_async16(d, s, in);
      else if (cb == 8) cp_async8(d, s, in);
      else cp_async4(d, s, in);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      reinterpret_cast<TC*>(dst + r * ld_bytes)[c] =
          j0 + r < end ? src[static_cast<size_t>(j0 + r) * P + c] : TC{};
    }
  }
}

// The widest cp.async (16, 8 or 4 bytes; 0: none) that every head slice's
// start and length allow.
inline int copy_bytes(const void* k_cache, const void* v_cache, int D, int Hkv, int esize) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k_cache) | reinterpret_cast<uintptr_t>(v_cache);
  for (int w = 16; w >= 4; w /= 2)
    if ((D * esize) % w == 0 && (Hkv * D * esize) % w == 0 && addr % w == 0) return w;
  return 0;
}

// --- the single-token core ----------------------------------------------------------

// Tiles of the single-token core in shared memory: four (a slot of 256
// positions at once), three for a float32 cache, whose four would not fit.
__host__ __device__ constexpr int tile_stages(int esize) { return esize == 4 ? 3 : 4; }

// Elements a lane reads from a K or V row in shared memory at once: 16
// bytes, 8 for int8 (so that 48 bytes split evenly over the two lanes of a
// position), or one element when D's bytes are no multiple of that.
template <typename TC>
__host__ __device__ constexpr int row_chunk_bytes() {
  return std::is_same<TC, int8_t>::value ? 8 : 16;
}

// CW float32 values of consecutive elements of a K or V row in shared
// memory. An int8 row goes 8 bytes at a time: byte x + 128 placed in the
// mantissa of 2^23 is 2^23 + 128 + x exactly, and one subtraction leaves x.
template <typename TC, int CW>
__device__ __forceinline__ void load_row(const TC* p, float (&out)[CW]) {
  if constexpr (std::is_same<TC, int8_t>::value && CW == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | j)) - 8388736.f;
  } else {
    load_chunk<TC, CW>(p, out);
  }
}

// dtype codes of the C entry points: 0 float32, 1 bfloat16, 2 float16, 3 int8
template <int CODE> struct DType;
template <> struct DType<0> { using T = float; };
template <> struct DType<1> { using T = __nv_bfloat16; };
template <> struct DType<2> { using T = __half; };
template <> struct DType<3> { using T = int8_t; };

struct DecodeArgs {
  const void* q;  // (B, Hq, D)
  const void* k_cache;
  const void* v_cache;  // (L, B, S, Hkv * D)
  const float* k_scale;
  const float* v_scale;  // (L, B, Hkv, S), int8 cache only
  const float* mask;     // (B, S)
  float* out;            // (B, Hq, D)
  float* m_part;         // (B, Hkv, splits, G), several splits only
  float* l_part;         // (B, Hkv, splits, G)
  float* acc_part;       // (B, Hkv, splits, G, D)
  int* done;             // (B, Hkv) split blocks finished, zero between launches
  int B, S, Hkv, G, D, layer, block_s;
  float inv_sqrt_d;
  int cb;    // bytes per cp.async of a head-slice row (copy_bytes)
  int mvec;  // mask rows take 16-byte reads: S % 4 == 0, block_s % 4 == 0, aligned
};

// How the lanes of a warp share P.V: item (query row g, D chunk c) = g * nc
// + c, chunks of cw elements (row_chunk_bytes, or one element); a lane holds
// items lane % span + 32k over the warp's positions pg, pg + npg, ... of
// each tile.
struct PvSplit {
  int cw, nc, nitems, span, npg;
};

__host__ __device__ inline PvSplit pv_split(int D, int esize, int G) {
  const int chunk = esize == 1 ? 8 : 16;  // row_chunk_bytes
  PvSplit v{};
  v.cw = (D * esize) % chunk == 0 ? chunk / esize : 1;
  v.nc = D / v.cw;
  v.nitems = G * v.nc;
  v.span = v.nitems < 32 ? v.nitems : 32;
  v.npg = 32 / v.span;
  return v;
}

// Byte offsets of the core's shared memory: tile_stages stages of K and V
// rows (ld bytes each, D's bytes rounded up to 16), the tile's mask values
// and scales; then the query rows, per-warp probabilities, rescale factors
// and (m, l) pairs, and the block's flags. After the loop the stage area
// holds each lane group's share of the output (comb: [kWarps][npg][G][D]
// floats).
struct TileLayout {
  int ld, k, v, msk, ksc, vsc, stage, comb, q, p, alpha, ml, flags, total;
};

__host__ __device__ inline TileLayout tile_layout(int D, int esize, int G, bool quant) {
  TileLayout L{};
  L.ld = ceil_div(D * esize, 16) * 16;
  L.k = 0;
  L.v = L.k + kTile * L.ld;
  L.msk = L.v + kTile * L.ld;
  L.ksc = L.msk + kTile * 4;
  L.vsc = L.ksc + (quant ? kTile * 4 : 0);
  L.stage = L.vsc + (quant ? kTile * 4 : 0);
  L.comb = 0;
  const int comb_end = kWarps * pv_split(D, esize, G).npg * G * D * 4;
  const int stages_end = tile_stages(esize) * L.stage;
  L.q = ceil_div(stages_end > comb_end ? stages_end : comb_end, 16) * 16;
  L.p = L.q + ceil_div(G * D, 4) * 16;
  L.alpha = L.p + kWarps * G * 16 * 4;
  L.ml = L.alpha + kWarps * G * 4;
  L.flags = L.ml + kWarps * G * 2 * 4;  // j0 of each stage; the last-block flag
  L.total = L.flags + (tile_stages(esize) + 1) * 4;
  return L;
}

// Live flags of tiles w0 .. w0 + 63 of the range [s0, s1) (tile t holds
// positions s0 + 64t .. min(s1, s0 + 64t + 64) - 1): bit t - w0 is set when
// a mask value there is above NEG_INF / 2. Every lane returns the same word.
__device__ __forceinline__ uint64_t live_window(const float* __restrict__ mrow, int s0, int s1,
                                                int w0, bool mvec) {
  const int lane = threadIdx.x & 31;
  const int p0 = s0 + w0 * kTile;
  const int p1 = min(s1, p0 + 64 * kTile);
  uint64_t bits = 0;
  if (mvec) {  // a read of the warp covers 128 positions, two tiles
    for (int base = p0; base < p1; base += 4 * 128) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = base + 128 * u + 4 * lane;
        x[u] = p < p1 ? __ldg(reinterpret_cast<const float4*>(mrow + p))
                      : make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float mx = fmaxf(fmaxf(x[u].x, x[u].y), fmaxf(x[u].z, x[u].w));
        const unsigned bal = __ballot_sync(0xffffffffu, mx > 0.5f * kNegInf);
        const int t = (base + 128 * u - p0) / kTile;  // the tile of lanes 0..15
        if (bal & 0xffffu) bits |= 1ull << t;
        if (bal >> 16) bits |= 1ull << (t + 1);
      }
    }
  } else {  // a read of the warp covers 32 positions, half a tile
    for (int base = p0; base < p1; base += 4 * 32) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = base + 32 * u + lane;
        x[u] = p < p1 ? __ldg(mrow + p) : kNegInf;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (__ballot_sync(0xffffffffu, x[u] > 0.5f * kNegInf))
          bits |= 1ull << ((base + 32 * u - p0) / kTile);
    }
  }
  return bits;
}

// Walks the live tiles of [s0, s1) in order, 64 tiles of flags at a time.
struct LiveWalk {
  const float* mrow;
  int s0, s1, ntiles;
  bool mvec;
  int w0;
  uint64_t bits;

  __device__ LiveWalk(const float* mrow_, int s0_, int s1_, bool mvec_)
      : mrow(mrow_), s0(s0_), s1(s1_), ntiles(ceil_div(s1_ - s0_, kTile)), mvec(mvec_), w0(0),
        bits(live_window(mrow_, s0_, s1_, 0, mvec_)) {}

  // the next live tile (its index from s0), or ntiles when none is left
  __device__ int next() {
    while (bits == 0) {
      if (w0 + 64 >= ntiles) return ntiles;
      w0 += 64;
      bits = live_window(mrow, s0, s1, w0, mvec);
    }
    const int t = w0 + __ffsll(static_cast<long long>(bits)) - 1;
    bits &= bits - 1;
    return t;
  }
};

// One (kv head, slot, split) per block: grid (Hkv, B, splits), kThreads
// threads. QT/CT: the query's and the cache's dtype codes; GM: compile-time
// bound on G (1, 2, 4 or 8); VEC: K/V rows are read from shared memory
// row_chunk_bytes at a time (D's bytes a multiple of it), else one element
// at a time.
template <int QT, int CT, int GM, bool VEC>
__global__ void __launch_bounds__(kThreads, 4) decode_tile_kernel(const DecodeArgs a) {
  using TQ = typename DType<QT>::T;
  using TC = typename DType<CT>::T;
  constexpr bool kQuant = CT == 3;
  constexpr int ST = tile_stages(sizeof(TC));
  constexpr int CW = VEC ? row_chunk_bytes<TC>() / static_cast<int>(sizeof(TC)) : 1;
  constexpr int IPL = (4 * GM + CW - 1) / CW;  // P.V items a lane may own: G*D/CW/32, D <= 128
  const int G = a.G, D = a.D, S = a.S;
  const TileLayout lay = tile_layout(D, sizeof(TC), G, kQuant);
  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* q_s = reinterpret_cast<float*>(tile_smem + lay.q);          // [G][D]
  float* p_s = reinterpret_cast<float*>(tile_smem + lay.p);          // [kWarps][G][16]
  float* alpha_s = reinterpret_cast<float*>(tile_smem + lay.alpha);  // [kWarps][G]
  float* ml_s = reinterpret_cast<float*>(tile_smem + lay.ml);        // [kWarps][G][2]
  int* j0_s = reinterpret_cast<int*>(tile_smem + lay.flags);         // [ST]
  int* last_s = j0_s + ST;                                           // this block combines

  const int hk = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int s0 = z * a.block_s, s1 = min(S, s0 + a.block_s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t P = static_cast<size_t>(a.Hkv) * D;
  const size_t slab = (static_cast<size_t>(a.layer) * a.B + b) * S;  // row (layer, b, 0)
  const TC* kb = static_cast<const TC*>(a.k_cache) + slab * P + static_cast<size_t>(hk) * D;
  const TC* vb = static_cast<const TC*>(a.v_cache) + slab * P + static_cast<size_t>(hk) * D;
  const size_t scale_row = ((static_cast<size_t>(a.layer) * a.B + b) * a.Hkv + hk) * S;
  const float* mrow = a.mask + static_cast<size_t>(b) * S;
  const size_t head0 = (static_cast<size_t>(b) * a.Hkv + hk) * static_cast<size_t>(G) * D;

  // the query's loads go out first; nothing waits on them before the loop
  TQ qr[GM];
#pragma unroll
  for (int k = 0; k < GM; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < G * D) qr[k] = static_cast<const TQ*>(a.q)[head0 + i];
  }

  LiveWalk walk(mrow, s0, s1, a.mvec != 0);
  const int ntiles = walk.ntiles;
  auto issue = [&](int t, int st) {
    const int j0 = s0 + t * kTile;
    unsigned char* stg = tile_smem + st * lay.stage;
    copy_tile(stg + lay.k, lay.ld, kb, P, j0, s1, D, a.cb);
    copy_tile(stg + lay.v, lay.ld, vb, P, j0, s1, D, a.cb);
    float* msk = reinterpret_cast<float*>(stg + lay.msk);
    const int r = threadIdx.x;
    if (a.mvec) {
      if (r < kTile / 4) {
        const bool in = j0 + 4 * r < s1;  // all four values or none (s1 % 4 == 0)
        cp_async16(msk + 4 * r, mrow + (in ? j0 + 4 * r : 0), in);
      }
    } else if (r < kTile) {
      const bool in = j0 + r < s1;
      cp_async4(msk + r, mrow + (in ? j0 + r : 0), in);
    }
    if constexpr (kQuant) {  // threads 0..63 the k scales, 64..127 the v scales
      const int rr = r & (kTile - 1);
      const bool in = j0 + rr < s1;
      float* dst = reinterpret_cast<float*>(stg + (r < kTile ? lay.ksc : lay.vsc)) + rr;
      cp_async4(dst, (r < kTile ? a.k_scale : a.v_scale) + scale_row + (in ? j0 + rr : 0), in);
    }
    if (threadIdx.x == 0) j0_s[st] = j0;
  };

  int fetched = 0, t_next = walk.next();
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (t_next < ntiles) {
      issue(t_next, st);
      ++fetched;
      t_next = walk.next();
    }
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < GM; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < G * D) q_s[i] = to_f32(qr[k]);
  }

  // scores: lanes i and i + 16 share position 16 * warp + i, half of D each
  const int i16 = lane & 15, half = lane >> 4;
  const int jw = 16 * warp + i16;
  const PvSplit pv = pv_split(D, sizeof(TC), G);
  const int nc = pv.nc, nitems = pv.nitems, span = pv.span, npg = pv.npg;
  const int pg = lane / span;

  float m[GM], l[GM], o[IPL][CW];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < IPL; ++k)
#pragma unroll
    for (int e = 0; e < CW; ++e) o[k][e] = 0.f;

  for (int n = 0; n < fetched; ++n) {
    cp_async_wait<ST - 2>();  // tile n has landed ...
    __syncthreads();  // ... for every thread, and every thread is done with tile n - 1
    if (t_next < ntiles) {  // into tile n - 1's stage
      issue(t_next, (n + ST - 1) % ST);
      ++fetched;
      t_next = walk.next();
    }
    cp_async_commit();

    const unsigned char* stg = tile_smem + (n % ST) * lay.stage;
    const int j0 = j0_s[n % ST];
    const TC* kr = reinterpret_cast<const TC*>(stg + lay.k + jw * lay.ld);
    float acc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) acc[g] = 0.f;
    for (int c = half; c < nc; c += 2) {
      float kv[CW];
      load_row<TC, CW>(kr + c * CW, kv);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) {
          const float* qg = q_s + g * D + c * CW;
          if constexpr (VEC) {  // 16-byte aligned: CW and D are multiples of 4 (8 for int8)
#pragma unroll
            for (int e = 0; e < CW; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qg + e);
              acc[g] = fmaf(qq.x, kv[e], acc[g]);
              acc[g] = fmaf(qq.y, kv[e + 1], acc[g]);
              acc[g] = fmaf(qq.z, kv[e + 2], acc[g]);
              acc[g] = fmaf(qq.w, kv[e + 3], acc[g]);
            }
          } else {
            acc[g] = fmaf(qg[0], kv[0], acc[g]);
          }
        }
    }
    const float mv = reinterpret_cast<const float*>(stg + lay.msk)[jw];
    const bool live = j0 + jw < s1 && mv > 0.5f * kNegInf;
    const float sk = kQuant ? reinterpret_cast<const float*>(stg + lay.ksc)[jw] : 1.f;
    const float sv = kQuant ? reinterpret_cast<const float*>(stg + lay.vsc)[jw] : 1.f;
    const float sl2 = a.inv_sqrt_d * kLog2e * sk;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float x = acc[g] + __shfl_xor_sync(0xffffffffu, acc[g], 16);
        x = live ? fmaf(x, sl2, mv * kLog2e) : kNegInf;  // log2 units
        float mx = x;
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        const float p = live ? exp2f(x - m_new) : 0.f;  // a masked key: exactly 0
        l[g] = alpha * l[g] + (half ? 0.f : p);  // this lane's share of the row sum
        m[g] = m_new;
        if (!half) p_s[(warp * G + g) * 16 + i16] = p * sv;
        if (lane == 0) alpha_s[warp * G + g] = alpha;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < IPL; ++k) {
      const int item = lane % span + 32 * k;
      if (pg < npg && item < nitems) {
        const int g = item / nc, d0 = (item - g * nc) * CW;
        const float al = alpha_s[warp * G + g];
#pragma unroll
        for (int e = 0; e < CW; ++e) o[k][e] *= al;
        const float* pr = p_s + (warp * G + g) * 16;
        for (int jj = pg; jj < 16; jj += npg) {
          float vv[CW];
          load_row<TC, CW>(
              reinterpret_cast<const TC*>(stg + lay.v + (16 * warp + jj) * lay.ld) + d0, vv);
          const float p = pr[jj];
#pragma unroll
          for (int e = 0; e < CW; ++e) o[k][e] = fmaf(p, vv[e], o[k][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // combine the warps: M = max m_w, L = sum_w 2^(m_w - M) l_w
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      float x = l[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) {
        ml_s[(warp * G + g) * 2] = m[g];
        ml_s[(warp * G + g) * 2 + 1] = x;
      }
    }
  }
  __syncthreads();  // also: every warp is done with the stages, which comb reuses
  auto row_max_sum = [&](int g, float& M, float& L) {
    M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ml_s[(w * G + g) * 2]);
    L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) L += exp2f(ml_s[(w * G + g) * 2] - M) * ml_s[(w * G + g) * 2 + 1];
  };
  const int splits = gridDim.z;
  // each lane's items, rescaled to the block's max (and normalized for one
  // split), into its lane group's share of the output
  float* comb = reinterpret_cast<float*>(tile_smem + lay.comb) + (warp * npg + pg) * G * D;
#pragma unroll
  for (int k = 0; k < IPL; ++k) {
    const int item = lane % span + 32 * k;
    if (pg < npg && item < nitems) {
      const int g = item / nc, d0 = (item - g * nc) * CW;
      float M, L;
      row_max_sum(g, M, L);
      float f = exp2f(ml_s[(warp * G + g) * 2] - M);
      if (splits == 1) f /= fmaxf(L, 1e-30f);
#pragma unroll
      for (int e = 0; e < CW; ++e) comb[g * D + d0 + e] = o[k][e] * f;
    }
  }
  __syncthreads();
  const float* comb0 = reinterpret_cast<const float*>(tile_smem + lay.comb);
  auto sum_comb = [&](int i) {
    float x = 0.f;
    for (int r = 0; r < kWarps * npg; ++r) x += comb0[r * G * D + i];
    return x;
  };
  if (splits == 1) {
    for (int i = threadIdx.x; i < G * D; i += kThreads) a.out[head0 + i] = sum_comb(i);
    return;
  }

  // (m, l, acc) of this split: part row ((b * Hkv + hk) * splits + z) * G + g
  const size_t part_bh = (static_cast<size_t>(b) * a.Hkv + hk) * splits;
  const size_t part0 = (part_bh + z) * G;
  for (int i = threadIdx.x; i < G * D; i += kThreads) a.acc_part[part0 * D + i] = sum_comb(i);
  if (threadIdx.x < G) {
    float M, L;
    row_max_sum(threadIdx.x, M, L);
    a.m_part[part0 + threadIdx.x] = M;
    a.l_part[part0 + threadIdx.x] = L;
  }
  // the last split block of this (slot, kv head) to finish combines them all:
  // M = max m, w = 2^(m - M), out = sum w * acc / max(sum w * l, 1e-30)
  __threadfence();  // this split's partials are visible before it is counted
  __syncthreads();
  int* done = a.done + static_cast<size_t>(b) * a.Hkv + hk;
  if (threadIdx.x == 0) *last_s = atomicAdd(done, 1) == splits - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  float* w_s = ml_s;  // [G][2]: M and 1 / max(L, 1e-30) of each row
  if (threadIdx.x < G) {
    const size_t row0 = part_bh * G + threadIdx.x;
    float M = kNegInf, L = 0.f;
    for (int zz = 0; zz < splits; ++zz) M = fmaxf(M, __ldcg(a.m_part + row0 + zz * G));
    for (int zz = 0; zz < splits; ++zz)
      L += exp2f(__ldcg(a.m_part + row0 + zz * G) - M) * __ldcg(a.l_part + row0 + zz * G);
    w_s[threadIdx.x * 2] = M;
    w_s[threadIdx.x * 2 + 1] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const size_t row0 = part_bh * G + g;
    float x = 0.f;
    for (int zz = 0; zz < splits; ++zz)
      x += exp2f(__ldcg(a.m_part + row0 + zz * G) - w_s[g * 2]) *
           __ldcg(a.acc_part + (row0 + zz * G) * D + (i - g * D));
    a.out[head0 + i] = x * w_s[g * 2 + 1];
  }
  if (threadIdx.x == 0) *done = 0;  // ready for the next launch
}

template <int QT, int CT, int GM, bool VEC>
int launch_tiles(const DecodeArgs& a, int splits, cudaStream_t stream) {
  auto kern = decode_tile_kernel<QT, CT, GM, VEC>;
  const int smem = tile_layout(a.D, sizeof(typename DType<CT>::T), a.G, CT == 3).total;
  static int opted_in = 48 * 1024;  // per kernel instantiation
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  kern<<<dim3(a.Hkv, a.B, splits), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, int CT>
int launch_tiles_g(const DecodeArgs& a, int splits, cudaStream_t stream) {
  using TC = typename DType<CT>::T;
  const bool vec = (a.D * static_cast<int>(sizeof(TC))) % row_chunk_bytes<TC>() == 0;
#define GLM_TILES_VEC(GM)                                                        \
  return vec ? launch_tiles<QT, CT, GM, true>(a, splits, stream)                 \
             : launch_tiles<QT, CT, GM, false>(a, splits, stream)
  if (a.G <= 1) GLM_TILES_VEC(1);
  if (a.G <= 2) GLM_TILES_VEC(2);
  if (a.G <= 4) GLM_TILES_VEC(4);
  if (a.G <= kMaxGroup) GLM_TILES_VEC(8);
#undef GLM_TILES_VEC
  return -1;
}

// Launches the core over grid (Hkv, B, splits), splits = ceil(S / block_s).
// A float cache has the query's dtype; an int8 cache takes any query the
// instantiations cover (kHalf: float16 queries too). Returns the launch's
// cudaError_t, or -1 for arguments it does not take.
template <bool kHalf>
int launch_decode_tiles(DecodeArgs a, int q_dtype, int cache_dtype, cudaStream_t stream) {
  if (cache_dtype != 3 && cache_dtype != q_dtype) return -1;
  if (a.D < 1 || a.D > 128 || a.G < 1 || a.G > kMaxGroup || a.block_s < 1) return -1;
  const int esize = cache_dtype == 3 ? 1 : cache_dtype == 0 ? 4 : 2;
  a.cb = copy_bytes(a.k_cache, a.v_cache, a.D, a.Hkv, esize);
  a.mvec = a.S % 4 == 0 && a.block_s % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 16 == 0;
  const int splits = ceil_div(a.S, a.block_s);
  switch (q_dtype * 4 + cache_dtype) {
    case 0: return launch_tiles_g<0, 0>(a, splits, stream);
    case 3: return launch_tiles_g<0, 3>(a, splits, stream);
    case 5: return launch_tiles_g<1, 1>(a, splits, stream);
    case 7: return launch_tiles_g<1, 3>(a, splits, stream);
    case 10:
      if constexpr (kHalf) return launch_tiles_g<2, 2>(a, splits, stream);
      return -1;
    case 11:
      if constexpr (kHalf) return launch_tiles_g<2, 3>(a, splits, stream);
      return -1;
    default: return -1;
  }
}

}  // namespace
