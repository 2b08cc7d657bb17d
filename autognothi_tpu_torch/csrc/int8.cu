// The W8A8 building blocks of the int8 serving path: a row quantizer and an
// int8 x int8 -> int32 tensor-core GEMM with a float epilogue.  The four
// int8 kernels of the JAX package run here:
//   autognothi_tpu/ops/attention_block.py:_pallas_attention_block_q (K1),
//   autognothi_tpu/ops/ladder_block.py:_pallas_mlp_ladder_q (K2, its trunk MLP),
//   autognothi_tpu/ops/head_block.py:_pallas_head_q (K3, d1 and d2),
//   autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block_q (K4).
//
// Quantization (autognothi_tpu/ops/mlp_block.py:quant_cols, _quant_rows):
//   activations, per row: amax = max|x| + 1e-12, inv = 127 / amax,
//     code = rint(x * inv) (a multiply), scale = amax * (1 / 127);
//   weights, per output channel (a row of the torch (out, in) layout):
//     scale = max|w| / 127 + 1e-12, code = rint(w / scale) (a divide).
// Rounding is half to even (__float2int_rn), as jnp.round.  The activation
// quantizer can take the LayerNorm prologue: the normalised row is rounded
// to the activation dtype first, as the JAX kernels cast the LN output.
// Products and sums that decide a code use the _rn intrinsics, so no FMA
// contraction moves a value across a rounding boundary.
//
// GEMM: C[m, n] = epi(acc[m, n] * a_scale[m] * w_scale[n] + bias[n]) with
// acc = sum_k A[m, k] W[n, k] in int32 (A <M, K> and W <N, K> int8, rows
// contiguous).  |acc| <= 127^2 K, which fp32 cannot hold exactly from
// K = 1040 on; int32 does.  Epilogues: cast to the activation dtype; + the
// residual after that cast; GELU kept in fp32 (the intermediate the next
// quantizer reads); GELU then cast (K3's d2, the input of the float d3).
//
// What bounds it on the H100: this first design issues mma.sync m16n8k32
// (the Ampere-style tensor-core path, well below wgmma's int8 rate) from a
// two-stage cp.async pipeline over 64-deep k slices, with 32-bit shared-
// memory fragment loads; each block computes a 128x128 (or 64x64 for small
// problems) output tile with 8 warps.  Measured at the LTT ViT-B/16 trunk
// shapes (B=64): ~230-260 TOP/s, an eighth of the card's int8 peak.  The
// <M, K> int8 activations and the fp32 MLP intermediate go to device
// memory, where the TPU kernels kept them on chip.  wgmma + TMA tiles,
// ldmatrix fragments and a fused quantize-in-epilogue are later work.

#include <stdint.h>

#include "common.cuh"

namespace ag {

// ------------------------------------------------------------ quantizer

// One warp per row.  LN: mean and rsqrt(var + eps) with fp32 math, then
// round_to<T>((x - mean) * rstd * w + b).  WEIGHT: the divide recipe.
template <typename T, bool LN, bool WEIGHT>
__global__ void quant_rows_kernel(const T* __restrict__ x, int ldx, int M,
                                  int N, float eps,
                                  const float* __restrict__ lnw,
                                  const float* __restrict__ lnb,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + (size_t)row * ldx;
  float mu = 0.f, rs = 1.f;
  if (LN) {
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += to_f(xr[c]);
    mu = warp_sum(s) / N;
    float v = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float d = to_f(xr[c]) - mu;
      v += d * d;
    }
    rs = rsqrtf(warp_sum(v) / N + eps);  // as ag_rowstats and torch.rsqrt
  }
  auto value = [&](int c) -> float {
    const float a = to_f(xr[c]);
    if (!LN) return a;
    return round_to<T>(
        __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a, mu), rs), lnw[c]), lnb[c]));
  };
  float amax = 0.f;
  for (int c = lane; c < N; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  amax = warp_max(amax);
  int8_t* qr = q + (size_t)row * N;
  if (WEIGHT) {
    const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-12f);
    for (int c = lane; c < N; c += 32)
      qr[c] = (int8_t)__float2int_rn(__fdiv_rn(value(c), s));
    if (lane == 0) scale[row] = s;
  } else {
    amax = __fadd_rn(amax, 1e-12f);
    const float inv = __fdiv_rn(127.0f, amax);
    for (int c = lane; c < N; c += 32)
      qr[c] = (int8_t)__float2int_rn(__fmul_rn(value(c), inv));
    if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
  }
}

// ----------------------------------------------------------------- GEMM

enum EpiI8 {
  kI8Bias = 0,       // C = cast(v)
  kI8BiasResid = 1,  // C = R + cast(v)
  kI8GeluF32 = 2,    // C (fp32) = gelu(v)
  kI8Gelu = 3        // C = cast(gelu(v))
};

struct GemmI8Args {
  const int8_t* A;  // <M, K>, row stride lda
  int lda;
  const float* a_scale;  // <M>
  const int8_t* W;       // <N, K>, row stride K
  const float* w_scale;  // <N>
  const float* bias;     // <N>
  const void* R;         // residual (kI8BiasResid), row stride ldr
  int ldr;
  void* C;  // row stride ldc; fp32 for kI8GeluF32, else the activation type
  int ldc;
  int M, N, K;
};

constexpr int kI8BK = 64;              // k bytes per pipeline stage
constexpr int kI8Row = kI8BK + 16;     // smem row pitch: conflict-free frags
constexpr int kI8Threads = 256;        // 8 warps: 2 (m) x 4 (n)

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int EPI, int BM, int BN>
__global__ void __launch_bounds__(kI8Threads)
    gemm_i8_kernel(GemmI8Args p) {
  constexpr int WTM = BM / 2, WTN = BN / 4;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;  // mma tiles per warp
  __shared__ __align__(16) int8_t As[2][BM][kI8Row];
  __shared__ __align__(16) int8_t Ws[2][BN][kI8Row];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // 16-byte chunks: BM (BN) rows x 4 chunks of the 64-byte k slice
  auto load = [&](int k0, int buf) {
    for (int c = tid; c < BM * 4; c += kI8Threads) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const bool ok = row0 + r < p.M && k0 + kc < p.K;
      cp_async16(&As[buf][r][kc],
                 ok ? p.A + (size_t)(row0 + r) * p.lda + k0 + kc : p.A, ok);
    }
    for (int c = tid; c < BN * 4; c += kI8Threads) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const bool ok = col0 + r < p.N && k0 + kc < p.K;
      cp_async16(&Ws[buf][r][kc],
                 ok ? p.W + (size_t)(col0 + r) * p.K + k0 + kc : p.W, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (p.K + kI8BK - 1) / kI8BK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load((kt + 1) * kI8BK, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kI8BK; ks += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WTM + i * 16 + g;
        const int8_t* base = &As[buf][r][ks + t * 4];
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kI8Row);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kI8Row + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* base = &Ws[buf][wn * WTN + j * 8 + g][ks + t * 4];
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = row0 + wm * WTM + i * 16 + g + e2 * 8;
      if (r >= p.M) continue;
      const float sa = p.a_scale[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int c = col0 + wn * WTN + j * 8 + t * 2 + e1;
          if (c >= p.N) continue;
          float v = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[i][j][e2 * 2 + e1], sa),
                        p.w_scale[c]),
              p.bias[c]);
          if (EPI == kI8GeluF32 || EPI == kI8Gelu) v = gelu_erf(v);
          if (EPI == kI8GeluF32) {
            static_cast<float*>(p.C)[(size_t)r * p.ldc + c] = v;
            continue;
          }
          if (EPI == kI8BiasResid)
            v = to_f(static_cast<const T*>(p.R)[(size_t)r * p.ldr + c]) +
                round_to<T>(v);
          static_cast<T*>(p.C)[(size_t)r * p.ldc + c] = from_f<T>(v);
        }
      }
    }
  }
}

// 128x128 tiles when they fill one wave of the card's SMs, else 64x64.
template <typename T, int EPI>
static int launch_gemm_i8(const GemmI8Args& p, cudaStream_t s) {
  const long long big = (long long)((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (big >= sm_count()) {
    dim3 grid((p.N + 127) / 128, (p.M + 127) / 128);
    gemm_i8_kernel<T, EPI, 128, 128><<<grid, kI8Threads, 0, s>>>(p);
  } else {
    dim3 grid((p.N + 63) / 64, (p.M + 63) / 64);
    gemm_i8_kernel<T, EPI, 64, 64><<<grid, kI8Threads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_gemm_i8(int epi, const GemmI8Args& p, cudaStream_t s) {
  switch (epi) {
    case kI8Bias: return launch_gemm_i8<T, kI8Bias>(p, s);
    case kI8BiasResid: return launch_gemm_i8<T, kI8BiasResid>(p, s);
    case kI8GeluF32: return launch_gemm_i8<T, kI8GeluF32>(p, s);
    case kI8Gelu: return launch_gemm_i8<T, kI8Gelu>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_quant_rows(const void* x, int ldx, int M, int N, float eps,
                             const float* lnw, const float* lnb, int weight,
                             int8_t* q, float* scale, cudaStream_t s) {
  constexpr int threads = 256;  // 8 rows per block
  const int blocks = (M * 32 + threads - 1) / threads;
  const T* xt = static_cast<const T*>(x);
  if (weight && lnw) return (int)cudaErrorInvalidValue;
  if (weight)
    quant_rows_kernel<T, false, true><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale);
  else if (lnw)
    quant_rows_kernel<T, true, false><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale);
  else
    quant_rows_kernel<T, false, false><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale);
  return (int)cudaGetLastError();
}

}  // namespace ag

using namespace ag;

// Row quantizer.  weight = 1: the per-output-channel weight recipe;
// weight = 0: the per-token activation recipe, with the LN prologue when
// lnw / lnb are given.  q <M, N> is contiguous.
extern "C" int ag_quant_rows(int dtype, const void* x, int ldx, int M, int N,
                             float eps, const void* lnw, const void* lnb,
                             int weight, void* q, void* scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(lnw);
  const float* b = static_cast<const float*>(lnb);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  if (dtype == kF32)
    return launch_quant_rows<float>(x, ldx, M, N, eps, w, b, weight, qq, sc, s);
  if (dtype == kBF16)
    return launch_quant_rows<__nv_bfloat16>(x, ldx, M, N, eps, w, b, weight,
                                            qq, sc, s);
  return (int)cudaErrorInvalidValue;
}

// int8 GEMM; dtype is the activation type of R and C (C is fp32 for the
// kI8GeluF32 epilogue).  K, lda and both base pointers must be multiples
// of 16 bytes.
extern "C" int ag_gemm_i8(int dtype, int epi, const void* A, int lda,
                          const void* a_scale, const void* W,
                          const void* w_scale, const void* bias, const void* R,
                          int ldr, void* C, int ldc, int M, int N, int K,
                          void* stream) {
  if (K % 16 != 0 || lda % 16 != 0) return (int)cudaErrorInvalidValue;
  GemmI8Args p{static_cast<const int8_t*>(A),
               lda,
               static_cast<const float*>(a_scale),
               static_cast<const int8_t*>(W),
               static_cast<const float*>(w_scale),
               static_cast<const float*>(bias),
               R,
               ldr,
               C,
               ldc,
               M,
               N,
               K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_gemm_i8<float>(epi, p, s);
  if (dtype == kBF16) return dispatch_gemm_i8<__nv_bfloat16>(epi, p, s);
  return (int)cudaErrorInvalidValue;
}
