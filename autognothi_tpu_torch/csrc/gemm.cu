// Tensor-core GEMM with a fused LayerNorm prologue and fused epilogues,
// plus the LayerNorm row statistics it reads.  K7, the float MLP block
// (autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block, and the bf16 split
// chain _pallas_mlp_sepx, K8, one tile per call), runs on it alone; it is
// also K3's float product (the head's d3).  K6's products and K5's side-in
// product run on `gemm_wgmma.cu`, K5's side layer in `ladder.cu`.
//
// C[m, n] = epilogue(sum_k A'[m, k] * W[n, k]) with W in torch (out, in)
// layout and any row stride (a column slice of a wider weight is read in
// place), and A' = A, or A' = cast(LN(A)) when the prologue is on.  The LN
// statistics come from ag_rowstats (one pass over A); the normalised tile
// is made in shared memory after its load, so the normalised tensor never
// goes to device memory.
//
// Numerics: fp32 accumulation.  bf16 operands: bf16 mma.sync m16n8k16
// (exact products, fp32 sums: the JAX preferred_element_type=f32).  fp32
// operands: 3xTF32 on the tensor cores, each operand split into hi =
// rna_tf32(x) and lo = rna_tf32(x - hi) and hi*hi + hi*lo + lo*hi
// accumulated in fp32: about 2^-21 relative per product, fp32-grade, not
// TF32-grade.  The tensor cores' own fp32 sums are not rounded to nearest,
// so each 64-deep k slice sums into a fresh accumulator that a rounded fp32
// add joins to the running sum (with one accumulator over K = 3072 the
// error reached 2.2e-5 relative; per slice it is ~5e-7, below cuBLAS fp32).
// The bias is added to the fp32 accumulator, and values are rounded to the
// activation dtype exactly where the JAX math casts: after LN, after bias
// (+GELU), and the projection before the residual add.
//
// Design: one block of 8 warps (2 x 4) per output tile of 128 x 128 (or
// 64 x 64 where the large tiles do not fill the card's SMs: the N = 96
// ladder GEMMs, small serving batches); k slices of 64 elements (256 bytes
// of a row in fp32, 128 in bf16) in a 3-stage cp.async ring in shared
// memory.  bf16 fragments come from ldmatrix.x4 (rows padded to 144 bytes,
// conflict-free); fp32 fragments from 64-bit reads (rows padded to 288
// bytes), each group of 8 k read as the fragment's k = t, t + 4 from the
// adjacent columns 2t, 2t + 1 in A and W alike, and split in registers as
// they are read.  The fp32 128 x 128 tile holds 232-234 registers (two
// accumulators) and a 221 KB ring: one block per SM; the others two.
//
// What bounds it on the H100 is not settled (it has not been profiled with
// hardware counters): mma.sync issued from registers, the ring's barrier
// per 64-deep slice and, in fp32, the register splits are the candidates.
// At K7's shapes the work is operations-bound (counted against 495/3 = 165
// TFLOP/s of fp32-grade work, bf16 against 989).  Measured on an H100 80GB
// HBM3 (700 W) at the ViT B=64 products <12608, 768> x <3072, 768>^T and
// <12608, 3072> x <768, 3072>^T (`kernel_ab.py`): fp32 1.11-1.13 ms (~53
// TFLOP/s of fp32-grade work, a third of the bound's rate; cuBLAS fp32
// without TF32 takes 1.16-1.47 ms), bf16 0.26-0.33 ms (180-225 TFLOP/s;
// cuBLAS 0.08-0.09 ms).  Tried and not kept: fp32 on wgmma (A split in
// registers, B's hi and lo split into swizzled shared memory, the split of
// the next slice overlapped with the products) ran no faster than this
// kernel, so the fp32 limit is not the mma.sync path alone; bf16 on
// wgmma from swizzled cp.async tiles was faster at K = 3072 but slower at
// K = 768 with the LN prologue.  A warp-specialised TMA pipeline is the
// next step.
//
// Device-memory intermediates of this design (kept on chip by the TPU
// kernels): the MLP intermediate <M, 4H>.

#include "common.cuh"

namespace ag {

enum Epi {
  kEpiBias = 0,          // C = cast(acc + b)
  kEpiBiasGelu = 1,      // C = cast(gelu(acc + b))
  kEpiBiasResid = 2      // C = R + cast(acc + b)
};

constexpr int kGemmThreads = 256;  // 8 warps: 2 (m) x 4 (n)
constexpr int kStages = 3;

// k bytes of a row per stage: fp32 256 (64 k), bf16 128 (64 k), so the
// bf16 ring leaves room for two blocks per SM
template <typename T>
__host__ __device__ constexpr int gemm_row_bytes() {
  return sizeof(T) == 4 ? 256 : 128;
}

// Padded shared-memory row: fp32 288 bytes (72 words: the 64-bit fragment
// reads of 4 rows x 4 lanes hit 32 distinct banks), bf16 144 bytes (36
// words: the 8 rows of an ldmatrix phase hit distinct banks).
template <typename T>
__host__ __device__ constexpr int gemm_pitch_bytes() {
  return gemm_row_bytes<T>() + (sizeof(T) == 4 ? 32 : 16);
}

struct GemmArgs {
  const void* A;
  int lda;
  const float* ln_mean;  // null: no LN prologue
  const float* ln_rstd;
  const float* ln_w;
  const float* ln_b;
  const void* W;  // [N, K], row stride ldw
  int ldw;
  const float* bias;
  const void* R;  // residual (epilogue 2)
  int ldr;
  void* C;
  int ldc;
  int M, N, K;
};

template <typename T, int BM, int BN>
constexpr int gemm_smem_bytes() {
  return kStages * (BM + BN) * gemm_pitch_bytes<T>();
}

// A, W: 16-byte aligned rows (checked by the wrapper); K a multiple of 16
// bytes of elements.  Rows past M or N and k past K are zero-filled.  The
// fp32 128 x 128 tile takes one block per SM (its ring is 221 KB and it
// holds two accumulators), the others two.
template <typename T, int EPI, bool LN, int BM, int BN>
__global__ void __launch_bounds__(kGemmThreads,
                                  sizeof(T) == 4 && BM == 128 ? 1 : 2)
    gemm_tc_kernel(GemmArgs p) {
  constexpr int ES = sizeof(T);
  constexpr int BKE = gemm_row_bytes<T>() / ES;  // k elements per stage
  constexpr int PITCH = gemm_pitch_bytes<T>() / ES;  // row pitch, elements
  constexpr int CH = gemm_row_bytes<T>() / 16;  // 16-byte chunks of a row
  constexpr int CE = 16 / ES;            // elements per chunk
  constexpr int WTM = BM / 2, WTN = BN / 4;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;  // mma tiles per warp
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(NT % 2 == 0, "B fragments are read two n tiles at a time");

  extern __shared__ __align__(16) unsigned char gemm_smem[];
  T* As = reinterpret_cast<T*>(gemm_smem);       // [kStages][BM][PITCH]
  T* Ws = As + kStages * BM * PITCH;             // [kStages][BN][PITCH]

  const T* __restrict__ A = static_cast<const T*>(p.A);
  const T* __restrict__ W = static_cast<const T*>(p.W);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (p.K + BKE - 1) / BKE;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BKE;
    T* as = As + stage * BM * PITCH;
    T* ws = Ws + stage * BN * PITCH;
#pragma unroll
    for (int c = tid; c < BM * CH; c += kGemmThreads) {
      const int r = c / CH, kc = (c % CH) * CE;
      const bool ok = row0 + r < p.M && k0 + kc < p.K;
      cp_async16(as + r * PITCH + kc,
                 ok ? A + (size_t)(row0 + r) * p.lda + k0 + kc : A, ok);
    }
#pragma unroll
    for (int c = tid; c < BN * CH; c += kGemmThreads) {
      const int r = c / CH, kc = (c % CH) * CE;
      const bool ok = col0 + r < p.N && k0 + kc < p.K;
      cp_async16(ws + r * PITCH + kc,
                 ok ? W + (size_t)(col0 + r) * p.ldw + k0 + kc : W, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1's readers are done
    if (kt + kStages - 1 < nk)
      load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const int stage = kt % kStages;
    T* as = As + stage * BM * PITCH;
    const T* ws = Ws + stage * BN * PITCH;
    if (LN) {
      // A' = cast(LN(A)) on the landed tile, in place: each warp walks
      // rows, its lanes consecutive k (zero-filled rows and k past the
      // ends stay zero)
      constexpr int KJ = BKE / 32;
      const int k0 = kt * BKE;
      float lw[KJ], lb[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int gk = k0 + lane + 32 * j;
        lw[j] = gk < p.K ? p.ln_w[gk] : 0.f;
        lb[j] = gk < p.K ? p.ln_b[gk] : 0.f;
      }
      for (int r = warp; r < BM; r += kGemmThreads / 32) {
        const int gr = row0 + r;
        if (gr >= p.M) break;  // warp-uniform; later rows are past M too
        const float mu = p.ln_mean[gr], rs = p.ln_rstd[gr];
        T* x = as + r * PITCH + lane;
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          if (k0 + lane + 32 * j < p.K)
            x[32 * j] = from_f<T>((to_f(x[32 * j]) - mu) * rs * lw[j] + lb[j]);
      }
      __syncthreads();
    }
    if constexpr (F32) {
      // Fragments by 64-bit reads: within each group of 8 k the fragment's
      // k = t, t + 4 are taken from the adjacent columns 2t, 2t + 1, in A
      // and W alike (a sum over k in another order).  The tensor cores'
      // fp32 sums are not rounded to nearest (their error grows with the
      // number of mma adds into one accumulator), so each slice sums into
      // a fresh accumulator, added to the running sum with a rounded fp32
      // add: 24 mma adds per accumulator instead of up to 3 K / 8.
      const float* af = reinterpret_cast<const float*>(as);
      const float* wf = reinterpret_cast<const float*>(ws);
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKE; kk += 8) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              wf + (wn * WTN + j * 8 + g) * PITCH + kk + 2 * t);
          split_tf32(b.x, bh[j][0], bl[j][0]);
          split_tf32(b.y, bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* ap = af + (wm * WTM + i * 16 + g) * PITCH + kk + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(ap);
          const float2 x1 = *reinterpret_cast<const float2*>(ap + 8 * PITCH);
          uint32_t ah[4], al[4];
          split_tf32(x0.x, ah[0], al[0]);
          split_tf32(x1.x, ah[1], al[1]);
          split_tf32(x0.y, ah[2], al[2]);
          split_tf32(x1.y, ah[3], al[3]);
          // the three products by term, so the mma into one accumulator
          // are NT apart, not back to back
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32_1688(part[i][j], al, bh[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32_1688(part[i][j], ah, bl[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32_1688(part[i][j], ah, bh[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    } else {
      // bf16 fragments by ldmatrix: x4 gives one A tile (16 rows x 16 k)
      // or the B fragments of two n tiles
#pragma unroll
      for (int kk = 0; kk < BKE; kk += 16) {
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r4[4];
          ldmatrix_x4(r4, ws + (wn * WTN + j * 8 + (lane & 7) +
                                8 * (lane >> 4)) * PITCH +
                              kk + 8 * ((lane >> 3) & 1));
          b[j][0] = r4[0];
          b[j][1] = r4[1];
          b[j + 1][0] = r4[2];
          b[j + 1][1] = r4[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, as + (wm * WTM + i * 16 + (lane & 15)) * PITCH +
                             kk + 8 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], a, b[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* __restrict__ C = static_cast<T*>(p.C);
  const T* R = static_cast<const T*>(p.R);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * WTM + i * 16 + g + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + wn * WTN + j * 8 + 2 * t + e;
          if (c >= p.N) continue;
          float v = acc[i][j][2 * h + e] + p.bias[c];
          if (EPI == kEpiBiasGelu) v = gelu_erf(v);
          if (EPI == kEpiBiasResid)
            v = to_f(R[(size_t)r * p.ldr + c]) + round_to<T>(v);
          C[(size_t)r * p.ldc + c] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T, int EPI, bool LN, int BM, int BN>
static int launch_tile(const GemmArgs& p, cudaStream_t stream) {
  auto kernel = gemm_tc_kernel<T, EPI, LN, BM, BN>;
  constexpr int smem = gemm_smem_bytes<T, BM, BN>();
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, kGemmThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Tile choice from the problem size: 128 x 128 when those tiles fill at
// least one wave of the card's SMs, else 64 x 64 (narrow N = 96 ladders,
// small serving batches), which puts more blocks in flight.
template <typename T, int EPI>
static int launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  const bool ln = p.ln_mean != nullptr;
  const long long big_tiles =
      (long long)((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (big_tiles >= sm_count())
    return ln ? launch_tile<T, EPI, true, 128, 128>(p, stream)
              : launch_tile<T, EPI, false, 128, 128>(p, stream);
  return ln ? launch_tile<T, EPI, true, 64, 64>(p, stream)
            : launch_tile<T, EPI, false, 64, 64>(p, stream);
}

template <typename T>
static int dispatch_gemm(int epi, const GemmArgs& p, cudaStream_t stream) {
  switch (epi) {
    case kEpiBias: return launch_gemm<T, kEpiBias>(p, stream);
    case kEpiBiasGelu: return launch_gemm<T, kEpiBiasGelu>(p, stream);
    case kEpiBiasResid: return launch_gemm<T, kEpiBiasResid>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
                       int ldw, const void* bias, const void* R, int ldr,
                       void* C, int ldc, int M, int N, int K, void* stream) {
  GemmArgs p{A,
             lda,
             static_cast<const float*>(ln_mean),
             static_cast<const float*>(ln_rstd),
             static_cast<const float*>(ln_w),
             static_cast<const float*>(ln_b),
             W,
             ldw,
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
