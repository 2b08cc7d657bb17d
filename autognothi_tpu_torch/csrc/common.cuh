// Shared device helpers for the port's kernels: the two activation dtypes
// (fp32, bf16), conversions that round where the JAX package casts, exact
// erf GELU, warp reductions, cp.async copies and the mma.sync tensor-core
// products (bf16, and fp32 as 3xTF32).  Every kernel accumulates in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace ag {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through T and widened back: the cast points of the JAX math
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// element i of an attention mask row held as fp32 or, with bf16
// activations, as bf16 (BERT's additive bias comes in the activation
// dtype): read as it is, no copy
template <bool BF16>
__device__ __forceinline__ float mask_at(const void* mask, size_t i) {
  if constexpr (BF16)
    return __bfloat162float(
        __ldg(static_cast<const __nv_bfloat16*>(mask) + i));
  else
    return __ldg(static_cast<const float*>(mask) + i);
}

// exact GELU, 0.5 x (1 + erf(x / sqrt(2))), with CUDA's erff
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// reductions over the 4 lanes of a quad (the lanes holding one row of an
// mma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes global -> shared, asynchronous; valid = false zero-fills the
// 16 bytes and reads nothing (gmem must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------- tensor-core products
// Fragment layouts are those of the PTX ISA for mma.sync with row-major A
// and column-major B: with g = lane / 4 and t = lane % 4, the accumulator
// c[0], c[1] hold C[g][2t], C[g][2t + 1] and c[2], c[3] rows g + 8.

// D += A B, bf16 m16n8k16: a[0..3] = A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..] (pairs packed low element first); b[0..1] = B[2t..][g],
// B[2t+8..][g].
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A B, bf16 m16n8k8: a[0..1] = A[g][2t..], A[g+8][2t..]; b[0] =
// B[2t..][g].
__device__ __forceinline__ void mma_bf16_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// D += A B, tf32 m16n8k8: a[0..3] = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b[0..1] = B[t][g], B[t+4][g].
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3xTF32 split of an fp32 x: hi = rna_tf32(x), lo = rna_tf32(x - hi).
// hi + lo carries 22 of x's 24 significand bits; hi*hi + hi*lo + lo*hi is
// x*y to about 2^-21 relative, fp32-grade (the dropped lo*lo is ~2^-22).
// rna_tf32 is cvt.rna.tf32.f32 written as integer ops on the bits (round
// the magnitude half away from zero to 10 significand bits): the same
// result at the full ALU rate, where the conversion instruction is not.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float r = x - __uint_as_float(hi);
  lo = (__float_as_uint(r) + 0x1000u) & 0xFFFFE000u;
}

// D += A B in fp32 grade from fp32 operands: three tf32 products, the small
// ones first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32_1688(c, al, bh);
  mma_tf32_1688(c, ah, bl);
  mma_tf32_1688(c, ah, bh);
}

// ldmatrix: 8x8 b16 matrices from shared memory; lane l gives the row
// address of matrix l / 8 (x4: lanes 0-31, x2: lanes 0-15).  Without .trans
// lane (g, t) receives row g, columns 2t and 2t + 1 of each matrix; with
// .trans rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The card's SM count, for the GEMMs' tile choice (one card per process:
// the first query is cached).
static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace ag
