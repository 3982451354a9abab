// Tensor-core and cp.async primitives shared by the port's Hopper (sm_90a)
// kernels: mhsa.cu, and through tc_gemm.cuh vector_attention.cu and vit_block.cu. Device functions only, each
// translation unit's own copy (an unnamed namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// cp.async tile copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Tensor-core products, one warp each. Fragment layouts (PTX ISA, mma.m16n8k8
// .tf32 and mma.m16n8k16 .bf16), with g = lane / 4 and t = lane % 4:
//   C (16 x 8, f32)  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   tf32 A (16 x 8)  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   tf32 B (8 x 8)   b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   bf16 A (16 x 16) pairs (g, 2t..)  (g+8, 2t..)  (g, 2t+8..)  (g+8, 2t+8..)
//   bf16 B (16 x 8)  pairs (k=2t.., n=g)  (k=2t+8.., n=g)
// ---------------------------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// result for every finite x, as an integer add and mask on the bits (the cvt
// compiles to four instructions with its checks for NaN and infinity; the
// operands here are finite)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = tf32(x), and small = x - big (exact in f32), which the
// tensor core reads as TF32 by ignoring its low 13 bits. Rounding small with a
// second cvt would change the product by under 2^-21 of it and cost an
// instruction per operand value.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as 3-pass TF32, a split already, b0 and b1 split here: the small
// terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0, float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// two values (rounded to bf16) in one register, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ldmatrix .x4 .trans: four 8 x 8 bf16 matrices whose rows (lanes 8i .. 8i+7
// give matrix i's row addresses) are k, delivered as B fragments.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// ldmatrix .x4 without .trans: four 8 x 8 matrices of 16-bit values, lanes 8i
// .. 8i+7 giving matrix i's row addresses (16 bytes each); register i holds
// matrix i's row lane / 4, values 2 (lane % 4) and 2 (lane % 4) + 1: A or B
// fragments of a tile stored with the contraction contiguous (for f32 data,
// its 32-bit value lane % 4, the tf32 layout)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

}  // namespace
