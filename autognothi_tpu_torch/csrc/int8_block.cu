// Fused int8 kernels of the W8A8 serving path, for the shapes where a whole
// row of the intermediate stays on the SM.  A block owns 64 rows (one m64
// wgmma) and splits the columns over four warpgroups; a row's max and sums
// are each slice's, met in shared memory.
//
// * The narrow W8A8 MLP block in one launch (`mlp_narrow_kernel`), replacing
//   autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block_q (body `_kernel_q`,
//   K4) at the side widths (H/I = 96/384 of ViT-B and BERT-base, 128/512 of
//   ViT-L): [LN] -> x's codes -> int8 W1 + b1 -> GELU (fp32) -> its codes
//   per row -> int8 W2 + b2 -> cast -> + resid -> [LN].  The block is
//   persistent over the row blocks and holds both weights' codes in shared
//   memory, loaded once by TMA.  Per row block: the x tile into shared
//   memory; x's codes (LN and all, `quant_row_warp`) into swizzled shared
//   memory; each warpgroup multiplies them by a quarter of W1's rows on
//   wgmma and takes bias, GELU and its slice of each row's max |.| in
//   registers; the row's max (exact: max is exact in any order) gives the
//   intermediate's codes with `quant_rows`' arithmetic, into swizzled
//   shared memory; each warpgroup multiplies them by a quarter of W2's rows
//   and applies the residual epilogue (and BERT's post-norm LN).  The
//   intermediate never leaves the SM, the fusion boundary of the TPU
//   kernel.  What bounds it: its bound is the bytes of x and the output
//   (3.0 us at ViT B=64 on an H100), but each row block's steps run one
//   after the other, GELU's erff the longest (24,576 values a block), at
//   1.5 row blocks per SM (PERF.md).
//
// * The explainer head's d1 straight to codes (`head_d1_kernel`), replacing
//   the first half of autognothi_tpu/ops/head_block.py:_pallas_head_q (body
//   `_kernel_q`, K3): [LN 1e-5] -> x's codes -> int8 d1 + b1 -> GELU -> h's
//   codes per row, written as int8 with their scales: the fp32 <M, 3072> h
//   never reaches device memory.  d1 has K = 96 (about 3% of K3's
//   operations), so a block computes its rows' d1 product twice, 256
//   columns at a time with the W1 chunks streamed by TMA into two buffers,
//   the same values bit for bit each time (int32 sums, the same _rn
//   arithmetic): the first pass takes each row's max |GELU(v)|, the second
//   writes the codes.  The first pass evaluates GELU only where a value can
//   hold the max (`d1_candidate`): for v > 0, gelu(v) / v grows with v, so
//   a v below vmax (1 - 2^-12) has a GELU below gelu(vmax) (1 - 2^-12), far
//   more than the few ulp that erff and the products may err by; a v < 0
//   has |gelu(v)| < 0.17, so where the row's gelu(vmax) > 0.171 it cannot
//   hold the max either; a row where that fails takes a pass over every
//   value.  So the max is the one the fp32 h would give, exact.  d2 with
//   GELU, the cast and d3 folded in is the int8 GEMM's kI8GeluFold epilogue
//   (`int8.cu`); `fold_sum_kernel` adds its per-column-tile partial sums in
//   a fixed order with b3 and casts: three launches per head.  What bounds
//   d1: a block's passes run one after the other, GELU once per value of h
//   (38.7 M at ViT B=64) and for the candidates; at BERT B=8 only 64 row
//   blocks fill 64 of the 132 SMs (PERF.md).

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "int8.cuh"

namespace ag {

constexpr int kBlkRows = 64;  // rows of a block: one m64 wgmma
constexpr int kBlkWG = 4;     // warpgroups of a block, each a column slice
constexpr int kBlkThreads = 128 * kBlkWG;

// ------------------------------------------------------ the narrow K4

// Shared memory of the narrow block: x's codes (one 64 x 128-byte box), W1's
// codes <I, H> (one k box of I rows), the intermediate's codes (I / 128
// boxes of 64 rows), W2's codes <H, I> (I / 128 boxes of H rows), each box
// 1024-byte aligned; the x tile; the vectors; the warpgroups' row maxima
// and row sums.
template <int H, int I>
struct NarrowShape {
  static_assert(H % 32 == 0 && H <= 128,
                "H: k steps of 32, one k box, 8-column slices");
  static_assert(I % 128 == 0 && I / kBlkWG <= 256,
                "I: whole boxes, one wgmma a warpgroup");
  static constexpr int kIBoxes = I / 128;
  static constexpr int kX = kBlkRows * 128;
  static constexpr int kW1 = I * 128;
  static constexpr int kInter = kIBoxes * kBlkRows * 128;
  static constexpr int kW2 = kIBoxes * H * 128;
  static constexpr int kXin = kBlkRows * H * 4;     // the x tile (fp32 room)
  static constexpr int kVec = (2 * I + 4 * H) * 4;  // s1 b1 s2 b2 lnw lnb
  static constexpr int kSmem = kX + kW1 + kInter + kW2 + kXin + kVec +
                               (1 + 2 * kBlkWG) * kBlkRows * 4 + 16 + 1024;
};

struct NarrowArgs {
  const void* x;  // the residual <M, H>, row stride ldx, activation dtype
  int ldx;
  const float* lnw;  // <H>: LN of the prologue or the epilogue
  const float* lnb;
  float eps;
  const float* s1;  // W1's scales and b1 <I>
  const float* b1;
  const float* s2;  // W2's scales and b2 <H>
  const float* b2;
  void* out;   // <M, H> contiguous, activation dtype
  int8_t* hq;  // may be null: the intermediate's codes <M, I> ...
  float* hs;   // ... and scales <M>
  int M;
};

// LNPOS: 0 none, 1 prologue, 2 epilogue
template <typename T, int H, int I, int LNPOS>
__global__ void __launch_bounds__(kBlkThreads, 1)
    mlp_narrow_kernel(const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      NarrowArgs p) {
  using Sh = NarrowShape<H, I>;
  constexpr int kN1 = I / kBlkWG, kN2 = H / kBlkWG;  // a warpgroup's columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sX = smem;
  uint8_t* sW1 = sX + Sh::kX;
  uint8_t* sH = sW1 + Sh::kW1;
  uint8_t* sW2 = sH + Sh::kInter;
  T* sx = reinterpret_cast<T*>(sW2 + Sh::kW2);  // the x tile <64, H>
  float* vs1 = reinterpret_cast<float*>(sW2 + Sh::kW2 + Sh::kXin);
  float* vb1 = vs1 + I;
  float* vs2 = vb1 + I;     // then b2, lnw, lnb, H each
  float* xs = vs2 + 4 * H;  // x's scales [64]
  float* rmax = xs + kBlkRows;             // [wg][64]: each slice's row max
  float* rsum = rmax + kBlkWG * kBlkRows;  // [wg][64]: each slice's row sum
  uint64_t* bar = reinterpret_cast<uint64_t*>(rsum + kBlkWG * kBlkRows);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, Sh::kW1 + Sh::kW2);
    tma_load_2d(sW1, &map_w1, bar, 0, 0);
    tma_load_2d(sW1 + (I / 2) * 128, &map_w1, bar, 0, I / 2);
    for (int b = 0; b < Sh::kIBoxes; ++b)
      tma_load_2d(sW2 + b * H * 128, &map_w2, bar, 128 * b, 0);
  }
  // the vectors, once: the epilogues read them from shared memory
  for (int i = tid; i < I; i += kBlkThreads) {
    vs1[i] = p.s1[i];
    vb1[i] = p.b1[i];
  }
  for (int i = tid; i < H; i += kBlkThreads) {
    vs2[i] = p.s2[i];
    vs2[H + i] = p.b2[i];
    vs2[2 * H + i] = LNPOS ? p.lnw[i] : 1.f;
    vs2[3 * H + i] = LNPOS ? p.lnb[i] : 0.f;
  }
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8 of a block
  const int nblocks = (p.M + kBlkRows - 1) / kBlkRows;
  bool weights_in = false;
  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int m0 = blk * kBlkRows;
    // the x tile into shared memory, 16 bytes a thread (zeros past M), so
    // the row quantizer's passes and the residual read no device memory
    constexpr int kRowVecs = H * sizeof(T) / 16;
    for (int i = tid; i < kBlkRows * kRowVecs; i += kBlkThreads) {
      const int r = i / kRowVecs, row = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < p.M)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * p.ldx) +
                  i % kRowVecs);
      reinterpret_cast<uint4*>(sx)[i] = v;
    }
    __syncthreads();
    // x's codes, one warp per row, with `quant_rows`' arithmetic; a warp's
    // rows unrolled, so their reductions overlap
#pragma unroll
    for (int i = 0; i < kBlkRows / (kBlkThreads / 32); ++i) {
      const int r = (tid >> 5) + (kBlkThreads / 32) * i;
      const float s = quant_row_warp<T, LNPOS == 1, false>(
          sx + r * H, H, p.eps, vs2 + 2 * H, vs2 + 3 * H, lane,
          [&](int c, int8_t q) { sX[sw128_offset(r, c, kBlkRows)] = q; });
      if (lane == 0) xs[r] = m0 + r < p.M ? s : 0.f;
    }
    fence_proxy_async();
    __syncthreads();
    if (!weights_in) {
      mbar_wait(bar, 0);
      weights_in = true;
    }

    // W1: this warpgroup's kN1 columns of the intermediate
    int acc1[kN1 / 2];
#pragma unroll
    for (int i = 0; i < kN1 / 2; ++i) acc1[i] = 0;
    fence_regs<kN1 / 2>(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 32; ++kk)
      wgmma_s8<kN1>(acc1, sw128_desc(sX + kk * 32),
                    sw128_desc(sW1 + wg * kN1 * 128 + kk * 32));
    wgmma_commit();
    fence_regs<kN1 / 2>(acc1);
    wgmma_wait_all();
    fence_regs<kN1 / 2>(acc1);

    // bias and GELU in fp32 (kept in acc1's registers as float bits), each
    // row's max |.| over this slice
    float mx[2] = {0.f, 0.f};
    const float sa[2] = {xs[r0], xs[r0 + 8]};
#pragma unroll
    for (int j = 0; j < kN1 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wg * kN1 + 8 * j + 2 * t + e;
        const float ws = vs1[c], bs = vb1[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float v = gelu_erf(__fadd_rn(
              __fmul_rn(__fmul_rn((float)acc1[i], sa[h]), ws), bs));
          acc1[i] = __float_as_int(v);
          mx[h] = fmaxf(mx[h], fabsf(v));
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = quad_max(mx[h]);
      if (t == 0) rmax[wg * kBlkRows + r0 + 8 * h] = m;
    }
    __syncthreads();

    // the intermediate's codes from the whole row's max, as `quant_rows`
    // makes them, into swizzled shared memory (and, where asked, memory)
    float inv[2], sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float a = rmax[r];
#pragma unroll
      for (int w = 1; w < kBlkWG; ++w) a = fmaxf(a, rmax[w * kBlkRows + r]);
      inv[h] = inv_of_amax(a);
      sc[h] = scale_of_amax(a);
      if (p.hs && wg == 0 && t == 0 && m0 + r < p.M) p.hs[m0 + r] = sc[h];
    }
#pragma unroll
    for (int j = 0; j < kN1 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = wg * kN1 + 8 * j + 2 * t;
        const uint32_t q0 = __float2int_rn(
            __fmul_rn(__int_as_float(acc1[4 * j + 2 * h]), inv[h]));
        const uint32_t q1 = __float2int_rn(
            __fmul_rn(__int_as_float(acc1[4 * j + 2 * h + 1]), inv[h]));
        const uint16_t pair = (uint16_t)((q0 & 0xFFu) | (q1 & 0xFFu) << 8);
        *reinterpret_cast<uint16_t*>(sH + sw128_offset(r, c, kBlkRows)) =
            pair;
        if (p.hq && m0 + r < p.M)
          *reinterpret_cast<uint16_t*>(p.hq + (size_t)(m0 + r) * I + c) =
              pair;
      }
    fence_proxy_async();
    __syncthreads();

    // W2: this warpgroup's kN2 output columns over the intermediate's I
    int acc2[kN2 / 2];
#pragma unroll
    for (int i = 0; i < kN2 / 2; ++i) acc2[i] = 0;
    fence_regs<kN2 / 2>(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < I / 32; ++kk) {
      const int box = kk >> 2, k = (kk & 3) * 32;
      wgmma_s8<kN2>(acc2, sw128_desc(sH + box * kBlkRows * 128 + k),
                    sw128_desc(sW2 + box * H * 128 + wg * kN2 * 128 + k));
    }
    wgmma_commit();
    fence_regs<kN2 / 2>(acc2);
    wgmma_wait_all();
    fence_regs<kN2 / 2>(acc2);

    // bias, cast, + the residual (as the GEMM's kI8BiasResid) [, LN]
    float y[kN2 / 2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kN2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wg * kN2 + 8 * j + 2 * t + e;
        const float ws = vs2[c], bs = vs2[H + c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float v =
              __fadd_rn(__fmul_rn(__fmul_rn((float)acc2[i], sc[h]), ws), bs);
          const float res = to_f(sx[(r0 + 8 * h) * H + c]);
          y[i] = round_to<T>(res + round_to<T>(v));
          sum[h] += y[i];
        }
      }
    float mean[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
    if constexpr (LNPOS == 2) {
      // mean, then the variance about it, over the row's H values: each
      // slice's sum, the slices added in order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = quad_sum(sum[h]);
        if (t == 0) rsum[wg * kBlkRows + r0 + 8 * h] = s;
      }
      __syncthreads();
      float var[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        float tot = rsum[r];
#pragma unroll
        for (int w = 1; w < kBlkWG; ++w) tot += rsum[w * kBlkRows + r];
        mean[h] = tot / H;
#pragma unroll
        for (int j = 0; j < kN2 / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = y[4 * j + 2 * h + e] - mean[h];
            var[h] += d * d;
          }
        const float s = quad_sum(var[h]);
        if (t == 0) rmax[wg * kBlkRows + r] = s;  // the maxima are read
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        float tot = rmax[r];
#pragma unroll
        for (int w = 1; w < kBlkWG; ++w) tot += rmax[w * kBlkRows + r];
        rstd[h] = rsqrtf(tot / H + p.eps);
      }
    }
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int j = 0; j < kN2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h;
        if (row >= p.M) continue;
        const int c = wg * kN2 + 8 * j + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[e] = y[4 * j + 2 * h + e];
          if constexpr (LNPOS == 2)
            o[e] = (o[e] - mean[h]) * rstd[h] * vs2[2 * H + c + e] +
                   vs2[3 * H + c + e];
        }
        T* dst = out + (size_t)row * H + c;
        dst[0] = from_f<T>(o[0]);
        dst[1] = from_f<T>(o[1]);
      }
    __syncthreads();  // the next row block rewrites the codes and sums
  }
}

template <typename T, int H, int I, int LNPOS>
static int launch_narrow(const CUtensorMap& m1, const CUtensorMap& m2,
                         const NarrowArgs& p, cudaStream_t s) {
  using Sh = NarrowShape<H, I>;
  auto kernel = mlp_narrow_kernel<T, H, I, LNPOS>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int blocks = (p.M + kBlkRows - 1) / kBlkRows;
  const int grid = blocks < sm_count() ? blocks : sm_count();
  kernel<<<grid, kBlkThreads, Sh::kSmem, s>>>(m1, m2, p);
  return (int)cudaGetLastError();
}

template <typename T, int H, int I>
static int dispatch_narrow(int ln_pos, const CUtensorMap& m1,
                           const CUtensorMap& m2, const NarrowArgs& p,
                           cudaStream_t s) {
  if (ln_pos == 0) return launch_narrow<T, H, I, 0>(m1, m2, p, s);
  if (ln_pos == 1) return launch_narrow<T, H, I, 1>(m1, m2, p, s);
  if (ln_pos == 2) return launch_narrow<T, H, I, 2>(m1, m2, p, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_narrow_shape(int ln_pos, int H, int I,
                                 const CUtensorMap& m1, const CUtensorMap& m2,
                                 const NarrowArgs& p, cudaStream_t s) {
  if (H == 96 && I == 384)
    return dispatch_narrow<T, 96, 384>(ln_pos, m1, m2, p, s);
  if (H == 128 && I == 512)
    return dispatch_narrow<T, 128, 512>(ln_pos, m1, m2, p, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------ the explainer head (K3)

constexpr int kD1Chunk = 256;  // W1 rows per chunk: 64 per warpgroup
constexpr int kD1MaxN = 4096;  // d1's widest output: its s1, b1 in smem
constexpr int kD1Cluster = 2;  // blocks a row block

struct HeadD1Args {
  const void* x;  // <M, K>, row stride ldx, activation dtype
  int ldx;
  const float* lnw;  // <K> (LN: eps 1e-5 in the models)
  const float* lnb;
  float eps;
  const float* s1;  // W1's scales and b1 <N>
  const float* b1;
  int8_t* hq;  // h's codes <M, N>
  float* hs;   // h's scales <M>
  int M, K, N;
};

// The max pass keeps, per thread and row, the largest v so far (vmax) and
// the largest |gelu(v)| over the values that were candidates when they came:
// every value while vmax <= 0, else those at or above vmax (1 - 2^-12).
// The value with the thread's largest |gelu| is one of them (module note),
// so the row's max is exact where gelu(the row's largest v) > 0.171; a row
// where it is not takes a pass over every value (`every`).
__device__ __forceinline__ void d1_candidate(float v, float& vmax,
                                             float& thr, float& mx) {
  if (v >= thr) {
    mx = fmaxf(mx, fabsf(gelu_erf(v)));
    if (v > vmax) {
      vmax = v;
      thr = v > 0.f ? __fmul_rn(v, 1.0f - 0x1p-12f) : -INFINITY;
    }
  }
}

// A cluster of kD1Cluster blocks shares a row block: block `rank` takes the
// chunks rank, rank + kD1Cluster, ..., and the rows' maxima meet through
// distributed shared memory, so twice the SMs work on each row block.
template <typename T, bool LN>
__global__ void __cluster_dims__(kD1Cluster, 1, 1)
    __launch_bounds__(kBlkThreads, 1)
        head_d1_kernel(const __grid_constant__ CUtensorMap map_w1,
                       HeadD1Args p) {
  namespace cg = cooperative_groups;
  constexpr int kChunkBytes = kD1Chunk * 128;
  constexpr int kN = kD1Chunk / kBlkWG;  // a warpgroup's columns of a chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sX = smem;
  uint8_t* sW = sX + kBlkRows * 128;  // two chunk buffers
  float* xs = reinterpret_cast<float*>(sW + 2 * kChunkBytes);  // [64]
  float* rmax = xs + kBlkRows;  // [2][wg][64]: each slice's row maxima
  float* rrow = rmax + 2 * kBlkWG * kBlkRows;  // [2][64]: this block's
  uint64_t* bar = reinterpret_cast<uint64_t*>(rrow + 2 * kBlkRows);
  float* vs1 = reinterpret_cast<float*>(bar + 2);  // s1 then b1, N each

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nc = (p.N + kD1Chunk - 1) / kD1Chunk;
  const int mine = (nc - rank + kD1Cluster - 1) / kD1Cluster;  // my chunks
  auto chunk_of = [&](int i) { return rank + kD1Cluster * (i % mine); };
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (mine > 0) {
      mbar_expect_tx(&bar[0], kChunkBytes);
      tma_load_2d(sW, &map_w1, &bar[0], 0, chunk_of(0) * kD1Chunk);
    }
  }
  for (int i = tid; i < p.N; i += kBlkThreads) {
    vs1[i] = p.s1[i];
    vs1[p.N + i] = p.b1[i];
  }
  const int m0 = (blockIdx.x / kD1Cluster) * kBlkRows;
  const int kpad = (p.K + 31) & ~31;  // k steps of 32; zero codes past K
  for (int r = tid >> 5; r < kBlkRows; r += kBlkThreads / 32) {
    const int row = m0 + r;
    float s = 0.f;
    if (row < p.M) {
      s = quant_row_warp<T, LN, false>(
          static_cast<const T*>(p.x) + (size_t)row * p.ldx, p.K, p.eps,
          p.lnw, p.lnb, lane,
          [&](int c, int8_t q) { sX[sw128_offset(r, c, kBlkRows)] = q; });
      for (int c = p.K + lane; c < kpad; c += 32)
        sX[sw128_offset(r, c, kBlkRows)] = 0;
    } else {
      for (int c = lane; c < kpad; c += 32)
        sX[sw128_offset(r, c, kBlkRows)] = 0;
    }
    if (lane == 0) xs[r] = s;
  }
  fence_proxy_async();
  __syncthreads();

  const int r0 = 16 * warp + g;
  const float sa[2] = {xs[r0], xs[r0 + 8]};
  float vmax[2] = {-INFINITY, -INFINITY}, thr[2] = {-INFINITY, -INFINITY};
  float mx[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  bool every[2] = {false, false}, fallback = false;
  // slot k of each row: the max over this block's warpgroups, then over
  // the cluster's blocks (max is exact in any order); -> in row r's slot
  auto meet = [&](int slots) {
    if (tid < kBlkRows)
      for (int k = 0; k < slots; ++k) {
        float m = rmax[k * kBlkWG * kBlkRows + tid];
        for (int w = 1; w < kBlkWG; ++w)
          m = fmaxf(m, rmax[(k * kBlkWG + w) * kBlkRows + tid]);
        rrow[k * kBlkRows + tid] = m;
      }
    cluster.sync();  // every block's rows are in
  };
  int it = 0;  // chunk iterations so far: the buffers alternate
  // passes over my chunks: 0 the max, 1 (where a row needs it) the max
  // over every value, 2 the codes
  for (int pass = 0; pass < 3; ++pass) {
    if (pass == 1 && !fallback) continue;
    for (int i = 0; i < mine; ++i, ++it) {
      const int buf = it & 1, chunk = chunk_of(i);
      // the next chunk: every pass walks the same ones, and a codes pass
      // always follows
      if (tid == 0 && !(pass == 2 && i + 1 == mine)) {
        mbar_expect_tx(&bar[buf ^ 1], kChunkBytes);
        tma_load_2d(sW + (buf ^ 1) * kChunkBytes, &map_w1, &bar[buf ^ 1], 0,
                    chunk_of(i + 1) * kD1Chunk);
      }
      mbar_wait(&bar[buf], (it >> 1) & 1);
      int acc[kN / 2];
#pragma unroll
      for (int q = 0; q < kN / 2; ++q) acc[q] = 0;
      const uint8_t* w = sW + buf * kChunkBytes + wg * kN * 128;
      fence_regs<kN / 2>(acc);
      wgmma_fence();
      for (int kk = 0; kk < kpad / 32; ++kk)
        wgmma_s8<kN>(acc, sw128_desc(sX + kk * 32), sw128_desc(w + kk * 32));
      wgmma_commit();
      fence_regs<kN / 2>(acc);
      wgmma_wait_all();
      fence_regs<kN / 2>(acc);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = chunk * kD1Chunk + wg * kN + 8 * j + 2 * t;
        const bool in = c < p.N;  // N is even: the pair is whole
        const int cc = in ? c : 0;
        const float ws[2] = {vs1[cc], vs1[cc + 1]};
        const float bs[2] = {vs1[p.N + cc], vs1[p.N + cc + 1]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = __fadd_rn(
                __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + e], sa[h]),
                          ws[e]),
                bs[e]);
          if (!in) continue;
          if (pass == 0) {
            d1_candidate(v[0], vmax[h], thr[h], mx[h]);
            d1_candidate(v[1], vmax[h], thr[h], mx[h]);
          } else if (pass == 1) {
            if (every[h])
              mx[h] = fmaxf(mx[h], fmaxf(fabsf(gelu_erf(v[0])),
                                         fabsf(gelu_erf(v[1]))));
          } else {
            const int row = m0 + r0 + 8 * h;
            if (row < p.M) {
              const uint32_t q0 =
                  __float2int_rn(__fmul_rn(gelu_erf(v[0]), inv[h]));
              const uint32_t q1 =
                  __float2int_rn(__fmul_rn(gelu_erf(v[1]), inv[h]));
              *reinterpret_cast<uint16_t*>(p.hq + (size_t)row * p.N + c) =
                  (uint16_t)((q0 & 0xFFu) | (q1 & 0xFFu) << 8);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer
    }
    if (pass == 2) break;
    // the pass's row maxima: slot 0 the largest v (pass 0), slot 1 the
    // largest |gelu|, from every warpgroup and block
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = quad_max(mx[h]);
      if (t == 0) rmax[(kBlkWG + wg) * kBlkRows + r0 + 8 * h] = m;
      if (pass == 0) {
        const float v = quad_max(vmax[h]);
        if (t == 0) rmax[wg * kBlkRows + r0 + 8 * h] = v;
      }
    }
    __syncthreads();
    meet(2);
    const float* peer = cluster.map_shared_rank(rrow, rank ^ 1);
    bool any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float a = fmaxf(rrow[kBlkRows + r], peer[kBlkRows + r]);
      if (pass == 0) {
        const float v = fmaxf(rrow[r], peer[r]);
        every[h] = !(gelu_erf(v) > 0.171f) && m0 + r < p.M;
        any = any || every[h];
      }
      if (pass == 0 ? !every[h] : every[h]) {
        inv[h] = inv_of_amax(a);
        if (rank == 0 && wg == 0 && t == 0 && m0 + r < p.M)
          p.hs[m0 + r] = scale_of_amax(a);
      }
      mx[h] = 0.f;
    }
    cluster.sync();  // the peer has read my rows: they may change
    if (pass == 0) fallback = __syncthreads_or(any);
  }
}

// out[m, c] = cast(sum over the column tiles, in order, of part[tile, m,
// c], + b3[c]): the d3 that d2's column tiles folded in
template <typename T>
__global__ void fold_sum_kernel(const float* __restrict__ part, int tiles,
                                int M, int C, const float* __restrict__ b3,
                                T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * C) return;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += part[(size_t)k * M * C + i];
  out[i] = from_f<T>(s + b3[i % C]);
}

constexpr int kD1Smem = kBlkRows * 128 + 2 * kD1Chunk * 128 +
                        (3 + 2 * kBlkWG) * kBlkRows * 4 + 16 +
                        2 * kD1MaxN * 4 + 1024;

template <typename T, bool LN>
static int launch_head_d1(const CUtensorMap& m1, const HeadD1Args& p,
                          cudaStream_t s) {
  auto kernel = head_d1_kernel<T, LN>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kD1Smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int blocks = kD1Cluster * ((p.M + kBlkRows - 1) / kBlkRows);
  kernel<<<blocks, kBlkThreads, kD1Smem, s>>>(m1, p);
  return (int)cudaGetLastError();
}

}  // namespace ag

using namespace ag;

// 1 where the narrow K4 kernel is built for the widths H / I
extern "C" int ag_mlp_narrow_supports(int H, int I) {
  return (H == 96 && I == 384) || (H == 128 && I == 512);
}

// The narrow W8A8 MLP block (K4) in one launch.  x <M, H> (row stride ldx)
// in the activation dtype; ln_pos 0 none, 1 prologue, 2 epilogue (lnw, lnb
// fp32 <H>, eps); W1's codes <I, H> int8 with fp32 scales and b1 <I>, W2's
// codes <H, I> with scales and b2 <H>; out <M, H> contiguous.  hq <M, I>
// int8 and hs <M> fp32 (both or neither): the intermediate's codes and
// scales, written only where given.
extern "C" int ag_mlp_narrow(int dtype, int ln_pos, const void* x, int ldx,
                             const void* lnw, const void* lnb, float eps,
                             const void* q1, const void* s1, const void* b1,
                             const void* q2, const void* s2, const void* b2,
                             void* out, void* hq, void* hs, int M, int H,
                             int I, void* stream) {
  if (!ag_mlp_narrow_supports(H, I) || (ln_pos != 0 && !lnw) ||
      (hq == nullptr) != (hs == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      ldx * (dtype == kF32 ? 4 : 2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap m1, m2;
  if (!tensor_map(&m1, q1, I, H, H, I / 2) ||
      !tensor_map(&m2, q2, H, I, I, H))
    return (int)cudaErrorInvalidValue;
  NarrowArgs p{x,
               ldx,
               static_cast<const float*>(lnw),
               static_cast<const float*>(lnb),
               eps,
               static_cast<const float*>(s1),
               static_cast<const float*>(b1),
               static_cast<const float*>(s2),
               static_cast<const float*>(b2),
               out,
               static_cast<int8_t*>(hq),
               static_cast<float*>(hs),
               M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_narrow_shape<float>(ln_pos, H, I, m1, m2, p, s);
  if (dtype == kBF16)
    return dispatch_narrow_shape<__nv_bfloat16>(ln_pos, H, I, m1, m2, p, s);
  return (int)cudaErrorInvalidValue;
}

// The explainer head's d1 to codes: x <M, K> (row stride ldx), LN where lnw
// is given; W1's codes <N, K> int8 with fp32 scales and b1 <N> -> hq <M, N>
// int8 (contiguous) and hs <M> fp32.  K a multiple of 16 up to 128, N a
// multiple of 16 up to 4096.
extern "C" int ag_head_d1(int dtype, const void* x, int ldx, const void* lnw,
                          const void* lnb, float eps, const void* q1,
                          const void* s1, const void* b1, void* hq, void* hs,
                          int M, int K, int N, void* stream) {
  if (K <= 0 || K > 128 || K % 16 != 0 || N <= 0 || N % 16 != 0 ||
      N > kD1MaxN ||
      reinterpret_cast<uintptr_t>(q1) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap m1;
  if (!tensor_map(&m1, q1, N, K, K, kD1Chunk))
    return (int)cudaErrorInvalidValue;
  HeadD1Args p{x,
               ldx,
               static_cast<const float*>(lnw),
               static_cast<const float*>(lnb),
               eps,
               static_cast<const float*>(s1),
               static_cast<const float*>(b1),
               static_cast<int8_t*>(hq),
               static_cast<float*>(hs),
               M,
               K,
               N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = lnw != nullptr;
  if (dtype == kF32)
    return ln ? launch_head_d1<float, true>(m1, p, s)
              : launch_head_d1<float, false>(m1, p, s);
  if (dtype == kBF16)
    return ln ? launch_head_d1<__nv_bfloat16, true>(m1, p, s)
              : launch_head_d1<__nv_bfloat16, false>(m1, p, s);
  return (int)cudaErrorInvalidValue;
}

// out <M, C> (contiguous, the activation dtype) = cast(the sum over `tiles`
// of part <tiles, M, C> fp32, in order, + b3 <C>)
extern "C" int ag_fold_sum(int dtype, const void* part, int tiles, int M,
                           int C, const void* b3, void* out, void* stream) {
  if (tiles <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = (M * C + threads - 1) / threads;
  const float* pf = static_cast<const float*>(part);
  const float* b = static_cast<const float*>(b3);
  if (dtype == kF32)
    fold_sum_kernel<float><<<blocks, threads, 0, s>>>(
        pf, tiles, M, C, b, static_cast<float*>(out));
  else if (dtype == kBF16)
    fold_sum_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        pf, tiles, M, C, b, static_cast<__nv_bfloat16*>(out));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
