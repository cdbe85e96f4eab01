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
// What bounds it: the bytes of the cache the mask needs, as for
// decode_attention.cu (~4 operations per cache element read). The TPU
// kernel streamed the cache through a VMEM ring so that FEW programs could
// each cover a large batch block; on Hopper blocks run in parallel on 132
// SMs, and at small batch the (slot, kv head) blocks are few.
//
// What this design does about that: the S axis is split over blocks, grid
// (Hkv, B, splits), splits of block_s positions (the wrapper's
// stream_block_s splits only a batch too small to fill the card's resident
// blocks, in whole 64-position tiles, so a split's tiles are the cache's
// tiles). Each split block runs decode_tiles.cuh's core over its positions:
// it reads only its live tiles through cp.async stages, with an online
// softmax, and writes (m, l, acc) for its G query heads (m = NEG_INF, l =
// 0, acc = 0 for a split without a live tile). The last split block of a
// (slot, kv head) to finish, found with a per-(slot, kv head) counter that
// it resets to 0, combines the splits: M = max m, w = 2^(m - M), out =
// sum w*acc / max(sum w*l, 1e-30). A combine launch of its own would cost
// more than its work (on an H100 at 700 W, B 64: 5.5 us with its launch,
// 2.55 us of kernel time). One split (a batch that fills the card) is the
// single-pass kernel: it writes the output itself.

#include "decode_tiles.cuh"

// dtype codes: 0 float32, 1 bfloat16, 3 int8. A float cache has the
// query's dtype; an int8 cache takes a float32 or bfloat16 query. With
// splits = ceil(S / block_s) > 1 the scratch buffers are (B, Hkv, splits, G)
// for m and l, (B, Hkv, splits, G, D) for acc, and `done` is (B, Hkv) int32,
// all zero before the first launch (the kernel leaves it zero); with one
// split they are not read. Launches one kernel on `stream`; returns the
// launch's cudaError_t, or -1 for arguments it does not take.
extern "C" int glm_decode_attention_streamed(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* mask, void* m_part, void* l_part, void* acc_part,
    void* done, void* out, int B, int S, int Hkv, int G, int D, int layer, int block_s,
    float inv_sqrt_d, int q_dtype, int cache_dtype, void* stream) {
  if (block_s < 1 || block_s > S) return -1;
  DecodeArgs a{};
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.m_part = static_cast<float*>(m_part);
  a.l_part = static_cast<float*>(l_part);
  a.acc_part = static_cast<float*>(acc_part);
  a.done = static_cast<int*>(done);
  a.B = B;
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.D = D;
  a.layer = layer;
  a.block_s = block_s;
  a.inv_sqrt_d = inv_sqrt_d;
  return launch_decode_tiles<false>(a, q_dtype, cache_dtype, static_cast<cudaStream_t>(stream));
}
