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
// What bounds it: the bytes of the cache. Per launch it reads the K and V
// rows of one layer that the mask needs (at most 2*B*S*P elements) and does
// ~4 operations per element read, far below the card's operations-per-byte
// balance point, so its least time is those bytes over device-memory
// bandwidth. At the serving shape (B 64, S 256, 8 kv heads of 48) that is
// little work per block, so a block's latency (mask read, copies, one pass,
// combine) weighs as much as the bytes.
//
// What the design does about that (decode_tiles.cuh, decode_tile_kernel,
// one split): one block per (kv head, slot), grid (Hkv, B), 128 threads.
// - It reads only the 64-position tiles that hold a live mask position
//   (ops/decode_attention.py::decode_live_tiles states the rule): a serving
//   slot holds at most 192 of 256 positions, and usually far fewer.
// - The live tiles stream through four cp.async stages (three for a
//   float32 cache) of K and V head slices, mask values and int8 scales, so
//   a slot of up to 256 positions has all its tiles in flight at once;
//   every warp flags the tiles from the mask row itself, so the first
//   copies wait on one round trip of mask reads only.
// - One pass with an online softmax in float32 on the SIMT units; each
//   warp owns 16 positions of every tile and the warps combine once,
//   through shared memory without atomics. Every query and cache type the
//   wrapper takes: q float32, bfloat16 or float16, a cache of q's type or
//   int8 with scales (converted 8 bytes at a time by byte permutes).
// - The G = Hq/Hkv query heads of a kv head share one read of its slice.
// What it does not do: use the tensor cores (G = 1 at the serving shape),
// TMA, or split S over blocks (decode_attention_streamed.cu does).
// The TPU kernel's batch blocks of 8, its block-diagonal query routing
// matrix and its (Hq, P) output band are TPU layout choices and are not
// carried over.

#include "decode_tiles.cuh"

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 int8. A float cache has
// the query's dtype; an int8 cache takes a query of any of the float types.
// Returns the launch's cudaError_t, or -1 for arguments it does not take.
extern "C" int glm_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                    const void* k_scale, const void* v_scale,
                                    const void* mask, void* out, int B, int S, int Hkv,
                                    int G, int D, int layer, float inv_sqrt_d, int q_dtype,
                                    int cache_dtype, void* stream) {
  DecodeArgs a{};
  a.q = q;
  a.k_cache = k_cache;
  a.v_cache = v_cache;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.D = D;
  a.layer = layer;
  a.block_s = S;  // one split: the block writes the normalized output
  a.inv_sqrt_d = inv_sqrt_d;
  return launch_decode_tiles<true>(a, q_dtype, cache_dtype, static_cast<cudaStream_t>(stream));
}
