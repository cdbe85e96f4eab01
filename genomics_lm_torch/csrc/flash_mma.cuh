// Warp-level tensor-core and asynchronous-copy helpers of the bfloat16
// kernels (flash_attention.cu, decode_attention_chunk.cu): mma.sync m16n8k16
// bf16 -> f32, ldmatrix (plain and transposed) fragments from shared memory,
// and cp.async copies that zero-fill what lies past a tensor's end.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4): the f32
// accumulator holds (row g, cols 2c, 2c+1) in c[0], c[1] and (row g+8, the
// same cols) in c[2], c[3]. The A operand (16 x 16, row-major) holds rows g
// and g+8 at k 2c, 2c+1 (a[0], a[1]) and at k 2c+8, 2c+9 (a[2], a[3]); the
// B operand (16 x 8) holds col g at k 2c, 2c+1 (b[0]) and 2c+8, 2c+9 (b[1]).
// Two adjacent n8 accumulator tiles are therefore, packed to bf16, the A
// operand of one k16 step: a product's result feeds the next product from
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives one 32-bit word of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Fragment addresses inside a bf16 tile of row length LD, for lane l of a
// warp. A operand (16 rows from r0, k16 from k0), or with .trans the B
// operand of a (k16 rows from r0) x (two n8 column tiles from k0) product:
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* frag_a(const __nv_bfloat16* t, int r0, int k0) {
  const int l = threadIdx.x & 31;
  return t + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * LD + k0 + ((l >> 4) & 1) * 8;
}
// B operand of two n8 tiles (rows r0 .. r0 + 15 of the tile) at k16 from k0:
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* frag_b(const __nv_bfloat16* t, int r0, int k0) {
  const int l = threadIdx.x & 31;
  return t + (r0 + (l & 7) + ((l >> 4) & 1) * 8) * LD + k0 + ((l >> 3) & 1) * 8;
}

// c += a . b on one 16 x 8 tile, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte asynchronous copy; src_bytes 0 writes 16 zero bytes (src is then
// not read but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8-byte asynchronous copy, zero-filled when not valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4-byte asynchronous copy, zero-filled when not valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
