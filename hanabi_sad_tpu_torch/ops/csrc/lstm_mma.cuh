// Tensor-core pieces of the bfloat16 LSTM kernels (lstm_bf16.cu), for Hopper
// (sm_90a): the warp-level product mma.sync m16n8k16 with bfloat16 operands
// and float32 accumulators, ldmatrix, 16-byte cp.async, and the split of a
// float32 value into bfloat16 terms.
//
// Fragments of mma.sync.m16n8k16.row.col (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane = 4 g + t (g = lane / 4, t = lane % 4); a 32-bit
// register holds two bfloat16 values, the lower half the one of smaller index:
//   A (16 x 16): a0 = (row g, k 2t, 2t+1), a1 = (row g+8, k 2t, 2t+1),
//                a2 = (row g, k 2t+8, 2t+9), a3 = (row g+8, k 2t+8, 2t+9);
//   B (16 x 8):  b0 = (k 2t, 2t+1; column g), b1 = (k 2t+8, 2t+9; column g);
//   C (16 x 8):  c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g+8, ...).
// A product over k is the same whichever order its 16 k take, as long as A
// and B take the same one. The persistent kernels read operands straight from
// memory with k permuted so that lane (g, t) holds k 16s + 4t .. 4t+3 of its
// rows in one 8- or 16-byte load: logical k 2t, 2t+1 (a0, a1, b0) is physical
// 4t, 4t+1, and logical 2t+8, 2t+9 (a2, a3, b1) is physical 4t+2, 4t+3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

// d += a . b over one k-step of 16: bfloat16 products, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a . b over one k-step: the 16 products summed from zero on the
// tensor core, then added to acc in float32 (round to nearest). The tensor
// core aligns the products and its accumulator input to the largest of them
// and drops the bits below, so a running sum kept in the accumulator input
// loses low bits of every product added to it; chained over many k-steps
// that puts a sum further from float64 than a float32 product (PERF.md).
__device__ __forceinline__ void mma_bf16_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(d, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// d = a . b over one k-step, from zero, rounded to nearest (ties away from
// zero) where mma_bf16 truncates: the tensor core cuts the bits of the exact
// sum below its 24 (toward zero), a bias that a recurrence integrates over its
// steps. The first pass gives the sum's sign and binade; the second adds half
// an ulp of it, toward its sign, to the accumulator input, so that the cut
// rounds. A sum that gains a binade, or that cancels far below its largest
// product, keeps the first pass's truncation.
__device__ __forceinline__ void mma_bf16_rn(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(z, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __uint_as_float(__float_as_uint(z[e]) & 0xFF800000u) * 0x1p-24f;
  mma_bf16(d, a, b0, b1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bfloat16 matrices from shared memory; lanes 8i .. 8i+7 give the
// row addresses of matrix i, whose fragment lands in r[i] (as A's a0..a3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each matrix transposed: from rows k of a [k][n] tile, lane (g, t)
// receives (k 2t, 2t+1; column g), a B fragment's register.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes from global to shared memory through L2 only (.cg), so that data
// other blocks wrote before a grid barrier is never read from a stale L1 line.
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x0, x1 = hi + mid + lo, three bfloat16 pairs (lower half x0's): hi rounds
// x, mid rounds x - hi, lo rounds x - hi - mid, each remainder exact in
// float32. A float32 value has 24 significant bits and each term takes 8, so
// for normal values the three add up to x exactly (ops/lstm_seq.py:split_bf16
// is the same split in PyTorch).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  r0 -= __low2float(m);
  r1 -= __high2float(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(r0, r1));
}

}  // namespace lstm
