// Tiled GEMM with a fused LayerNorm prologue and fused epilogues, plus the
// LayerNorm row statistics it reads.  The dense products of the three fused
// blocks of the serving path run here:
//   attention block (autognothi_tpu/ops/attention_block.py:_pallas_attention_block):
//     LN -> Q/K/V projections, and out-proj + bias + residual;
//   MLP block (autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block and the
//     split _pallas_mlp_sepx chain): LN -> W1 + bias + GELU, W2 + bias + residual;
//   ladder block (autognothi_tpu/ops/ladder_block.py:_pallas_ladder): the map
//     dense side + GELU(h Wmap + b), then the 96-wide side layer as above.
//
// C[m, n] = epilogue(sum_k A'[m, k] * W[n, k]) with W in torch (out, in)
// layout and A' = A, or A' = cast(LN(A)) when the prologue is on.  The LN
// statistics come from ag_rowstats (one pass over A), so the normalised
// tensor never goes to device memory.
//
// Numerics: fp32 FMA accumulation (no TF32, no tensor cores), the bias is
// added to the fp32 accumulator, and values are rounded to the activation
// dtype exactly where the JAX math casts: after LN, after bias (+GELU), and
// the projection before the residual add.
//
// What bounds it on the H100: this first design is a plain SIMT kernel
// (64x64 output tile, 16-deep k slices staged through shared memory, a 4x4
// register tile per thread), so it is bound by fp32 FMA issue and shared
// memory bandwidth, well below the tensor-core rate.  wgmma + TMA tiles are
// the work of later changes.
//
// Device-memory intermediates of this design (kept on chip by the TPU
// kernels): the Q/K/V projections, the attention context, the MLP
// intermediate <M, 4H> and the ladder's mapped side.

#include "common.cuh"

namespace ag {

enum Epi {
  kEpiBias = 0,          // C = cast(acc + b)
  kEpiBiasGelu = 1,      // C = cast(gelu(acc + b))
  kEpiBiasResid = 2,     // C = R + cast(acc + b)
  kEpiBiasGeluResid = 3  // C = R + cast(gelu(acc + b))
};

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256

struct GemmArgs {
  const void* A;
  int lda;
  const float* ln_mean;  // null: no LN prologue
  const float* ln_rstd;
  const float* ln_w;
  const float* ln_b;
  const void* W;  // [N, K], row stride K
  const float* bias;
  const void* R;  // residual (epilogues 2, 3)
  int ldr;
  void* C;
  int ldc;
  int M, N, K;
};

template <typename T, int EPI, bool LN>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs p) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Ws[kBK][kBN + 4];
  const T* __restrict__ A = static_cast<const T*>(p.A);
  const T* __restrict__ W = static_cast<const T*>(p.W);
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    // 64 rows x 16 k of A and of W: four elements of each per thread,
    // consecutive threads on consecutive k (coalesced along the row)
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kGemmThreads; ++r) {
      const int idx = tid + r * kGemmThreads;
      const int lr = idx / kBK, lk = idx % kBK;
      const int gk = k0 + lk;
      const int gr = row0 + lr;
      float a = 0.f;
      if (gr < p.M && gk < p.K) {
        a = to_f(A[(size_t)gr * p.lda + gk]);
        if (LN)
          a = round_to<T>((a - p.ln_mean[gr]) * p.ln_rstd[gr] * p.ln_w[gk] +
                          p.ln_b[gk]);
      }
      As[lk][lr] = a;
      const int gn = col0 + lr;
      Ws[lk][lr] =
          (gn < p.N && gk < p.K) ? to_f(W[(size_t)gn * p.K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Ws[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* __restrict__ C = static_cast<T*>(p.C);
  const T* R = static_cast<const T*>(p.R);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc >= p.N) continue;
      float v = acc[i][j] + p.bias[gc];
      if (EPI == kEpiBiasGelu || EPI == kEpiBiasGeluResid) v = gelu_erf(v);
      if (EPI == kEpiBiasResid || EPI == kEpiBiasGeluResid)
        v = to_f(R[(size_t)gr * p.ldr + gc]) + round_to<T>(v);
      C[(size_t)gr * p.ldc + gc] = from_f<T>(v);
    }
  }
}

// The large-tile variant: 128x128 output tile, 8-deep k slices double-
// buffered in shared memory with the next slice prefetched into registers,
// and an 8x8 register tile per thread split into four 4x4 quadrants (rows
// ty*4 and 64+ty*4, columns tx*4 and 64+tx*4) so the float4 shared-memory
// reads are conflict-free.  Same arithmetic per output element as
// gemm_kernel: one fp32 FMA chain over k in order.
constexpr int kLBM = 128, kLBN = 128, kLBK = 8, kLPad = 4;

template <typename T, int EPI, bool LN>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm128_kernel(GemmArgs p) {
  __shared__ __align__(16) float As[2][kLBK][kLBM + kLPad];
  __shared__ __align__(16) float Ws[2][kLBK][kLBN + kLPad];
  const T* __restrict__ A = static_cast<const T*>(p.A);
  const T* __restrict__ W = static_cast<const T*>(p.W);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kLBM, col0 = blockIdx.x * kLBN;

  // loader: thread -> (tile row lr, four consecutive k from kb)
  const int lr = tid >> 1, kb = (tid & 1) * 4;
  const int gr = row0 + lr, gn = col0 + lr;
  const bool row_ok = gr < p.M, col_ok = gn < p.N;
  float mu = 0.f, rs = 0.f;
  if (LN && row_ok) {
    mu = p.ln_mean[gr];
    rs = p.ln_rstd[gr];
  }
  float ra[4], rw[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + kb + i;
      float a = 0.f;
      if (row_ok && gk < p.K) {
        a = to_f(A[(size_t)gr * p.lda + gk]);
        if (LN) a = round_to<T>((a - mu) * rs * p.ln_w[gk] + p.ln_b[gk]);
      }
      ra[i] = a;
      rw[i] = (col_ok && gk < p.K) ? to_f(W[(size_t)gn * p.K + gk]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][kb + i][lr] = ra[i];
      Ws[buf][kb + i][lr] = rw[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < p.K; k0 += kLBK) {
    const bool has_next = k0 + kLBK < p.K;
    if (has_next) load(k0 + kLBK);
#pragma unroll
    for (int kk = 0; kk < kLBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ws[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (has_next) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  T* __restrict__ C = static_cast<T*>(p.C);
  const T* R = static_cast<const T*>(p.R);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= p.N) continue;
      float v = acc[i][j] + p.bias[c];
      if (EPI == kEpiBiasGelu || EPI == kEpiBiasGeluResid) v = gelu_erf(v);
      if (EPI == kEpiBiasResid || EPI == kEpiBiasGeluResid)
        v = to_f(R[(size_t)r * p.ldr + c]) + round_to<T>(v);
      C[(size_t)r * p.ldc + c] = from_f<T>(v);
    }
  }
}

// Tile choice from the problem size: the 128x128 kernel when its tiles fill
// at least one wave of the card's SMs, else the 64x64 kernel (narrow N = 96
// ladders, small serving batches), which puts more blocks in flight.
template <typename T, int EPI>
static void launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const bool ln = p.ln_mean != nullptr;
  const long long big_tiles = (long long)((p.M + kLBM - 1) / kLBM) *
                              ((p.N + kLBN - 1) / kLBN);
  if (big_tiles >= sm_count()) {
    dim3 grid((p.N + kLBN - 1) / kLBN, (p.M + kLBM - 1) / kLBM);
    if (ln)
      gemm128_kernel<T, EPI, true><<<grid, kGemmThreads, 0, stream>>>(p);
    else
      gemm128_kernel<T, EPI, false><<<grid, kGemmThreads, 0, stream>>>(p);
    return;
  }
  dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  if (ln)
    gemm_kernel<T, EPI, true><<<grid, kGemmThreads, 0, stream>>>(p);
  else
    gemm_kernel<T, EPI, false><<<grid, kGemmThreads, 0, stream>>>(p);
}

template <typename T>
static int dispatch_gemm(int epi, const GemmArgs& p, cudaStream_t stream) {
  switch (epi) {
    case kEpiBias: launch_gemm<T, kEpiBias>(p, stream); break;
    case kEpiBiasGelu: launch_gemm<T, kEpiBiasGelu>(p, stream); break;
    case kEpiBiasResid: launch_gemm<T, kEpiBiasResid>(p, stream); break;
    case kEpiBiasGeluResid: launch_gemm<T, kEpiBiasGeluResid>(p, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// LayerNorm statistics with fp32 math, one warp per row: mean and
// 1/sqrt(var + eps), var = mean((x - mean)^2) as in the JAX layer_norm.
template <typename T>
__global__ void rowstats_kernel(const T* __restrict__ x, int M, int N,
                                float eps, float* __restrict__ mean,
                                float* __restrict__ rstd) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + (size_t)row * N;
  float s = 0.f;
  for (int c = lane; c < N; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / N;
  float v = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float var = warp_sum(v) / N;
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(var + eps);
  }
}

// LayerNorm applied to whole rows (the post-norm epilogue); out may be x.
template <typename T>
__global__ void layernorm_kernel(const T* x, int M, int N, float eps,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b, T* out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * N;
  float s = 0.f;
  for (int c = lane; c < N; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / N;
  float v = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / N + eps);
  T* orow = out + (size_t)row * N;
  for (int c = lane; c < N; c += 32)
    orow[c] = from_f<T>((to_f(xr[c]) - mu) * rs * w[c] + b[c]);
}

constexpr int kRowThreads = 256;  // 8 rows per block

}  // namespace ag

using namespace ag;

extern "C" int ag_gemm(int dtype, int epi, const void* A, int lda,
                       const void* ln_mean, const void* ln_rstd,
                       const void* ln_w, const void* ln_b, const void* W,
                       const void* bias, const void* R, int ldr, void* C,
                       int ldc, int M, int N, int K, void* stream) {
  GemmArgs p{A,
             lda,
             static_cast<const float*>(ln_mean),
             static_cast<const float*>(ln_rstd),
             static_cast<const float*>(ln_w),
             static_cast<const float*>(ln_b),
             W,
             static_cast<const float*>(bias),
             R,
             ldr,
             C,
             ldc,
             M,
             N,
             K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_gemm<float>(epi, p, s);
  if (dtype == kBF16) return dispatch_gemm<__nv_bfloat16>(epi, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ag_rowstats(int dtype, const void* x, int M, int N, float eps,
                           void* mean, void* rstd, void* stream) {
  const int blocks = (M * 32 + kRowThreads - 1) / kRowThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (dtype == kF32)
    rowstats_kernel<float><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), M, N, eps, mu, rs);
  else if (dtype == kBF16)
    rowstats_kernel<__nv_bfloat16><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, N, eps, mu, rs);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ag_layernorm(int dtype, const void* x, int M, int N, float eps,
                            const void* w, const void* b, void* out,
                            void* stream) {
  const int blocks = (M * 32 + kRowThreads - 1) / kRowThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == kF32)
    layernorm_kernel<float><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), M, N, eps, wf, bf,
        static_cast<float*>(out));
  else if (dtype == kBF16)
    layernorm_kernel<__nv_bfloat16><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, N, eps, wf, bf,
        static_cast<__nv_bfloat16*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
