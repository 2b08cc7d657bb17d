// The float LTT ladder step (K5), replacing
// autognothi_tpu/ops/ladder_block.py:_pallas_ladder (body `_kernel`, math
// `_branch_math`): for every branch b, side_b <- SideLayer_b(side_b +
// cast(gelu(h Wmap_b + bmap_b))), SideLayer a whole narrow transformer
// layer (S wide, heads of d = 8, MLP I wide), "mul" mask with pre-norm
// (ViT) or "add" bias with post-norm (BERT).
//
// Shapes: any side width S that is a multiple of 8 up to 128 (S / 8 heads
// of d = 8: ViT-S 48, ViT-B and BERT-base 96, ViT-L and BERT-large 128)
// and any MLP width I that is a multiple of 8.  Each stage is compiled
// for four width classes W = 32, 64, 96, 128 and runs S in (W - 32, W] on
// W's layout: tiles are W wide, the columns past S staged as zeros.
//
// One ladder step is four launches, whatever the number of branches (up
// to four; more take one side-in launch per four):
// 1. side-in (`gemm_wgmma.cu`, TMA + wgmma): h <M, H> times every branch's
//    map weight packed into one <branches * S, H> matrix, so h is read once
//    per step; the epilogue adds the bias, applies exact GELU in fp32,
//    casts, adds the side and writes x_b into x <branches, M, S>.
// 2. side QKV (`ladder_qkv_kernel`): per 64-row tile, branch and one of
//    Q, K, V, LN1 of the S-wide rows (pre-norm), then the <64, S>
//    projection + bias.
// 3. side attention + out-projection (`ladder_attn_kernel`): per (16-query
//    tile, branch, image), one warp per head (S / 8 heads of d = 8); each
//    32-key chunk of K and V rows of every head is staged once (a key row
//    is S contiguous values), and 8-key tiles past T are skipped.  The
//    context goes to shared memory, then the out-projection, bias, cast,
//    residual and, for post-norm, LN1 run on the chip.
// 4. side MLP (`ladder_mlp_kernel`): per 64-row tile and branch, LN2
//    (pre-norm), then for each W-wide chunk of the I intermediate columns:
//    W1's chunk, GELU, and the chunk times W2's matching columns, summed
//    into the output; then bias, residual and, for post-norm, LN2.  Only
//    one <64, W> chunk of the intermediate is on chip at a time (in fp32
//    at S = 96: 27 KB); the W1 and W2 chunks stream through a two-buffer
//    ring of W x W tiles (40 KB each in fp32 at S = 96), read from L2.
// Device memory holds, per step: x <branches, M, S>, the projections
// <branches, M, 3S> (attention needs every key of an image) and x after
// the attention half <branches, M, S>, besides the outputs.  The context
// and the MLP intermediate never leave the chip; the TPU kernel kept all of
// the side layer in VMEM.
//
// Numerics, as `_branch_math` and the port's other kernels: exact-erf
// GELU; fp32 LN statistics; fp32 softmax with the ViT "mul" quirk (a masked
// score becomes 0) or BERT's additive bias (read as fp32 or bf16, as it
// comes), keys past T at -inf; bf16 p rounded after normalisation, where
// JAX rounds it (two passes over the keys, as `attention.cu`), fp32 in one
// online pass; each dot + bias cast to the activation dtype, ctx cast to
// x's dtype, the residual added after the cast.  Products on mma.sync:
// bf16 m16n8k16 / m16n8k8 with fp32 sums; fp32 as 3xTF32 (hi =
// rna_tf32(x), lo = rna_tf32(x - hi), lo*hi + hi*lo + hi*hi), each k slice
// of at most 64 (P.V: a 32-key chunk) into a fresh accumulator added to
// the running sum with a rounded fp32 add.
//
// Why mma.sync here and wgmma in the side-in product: the side layer's
// products have K or N of S, 3S or I (96-384 at ViT-B) over 64-row tiles,
// and the whole step's fp32-grade work is ~9.3 GFLOP at ViT B=64 (56 us at
// the 3xTF32 rate) against ~165 MB (49 us at 3.35 TB/s): no stage is bound
// by the product rate.  mma.sync on 16-row warp slabs keeps every stage in
// one block with its tiles in shared memory.  The side-in product reads h,
// the largest input (<M, 768>), over a K = 768 loop, where the TMA ring
// pays.  Measured on an H100 (PERF.md): the side attention (~25 scalar
// operations per score: scale, mask, max, exp, sum and, in fp32, P's
// split) and the fp32 MLP (3xTF32 splits in registers) are bound by
// instruction issue; they take two thirds of the step.
//
// Layout of a QKV or MLP block: 64 rows (4 warps of 16) x W columns (W / 32
// warps of 32 columns): W / 8 warps; an attention block: S / 8 warps, one
// per head.  Shared-memory pitches keep the fragment reads conflict-free:
// A- and B-type tiles W + 8 (fp32 64-bit reads, bf16 ldmatrix), staged K/V
// rows W + 4 (fp32) or W + 8 (bf16).

#include <stdint.h>

#include "common.cuh"

namespace ag {

constexpr int kLadRows = 64;   // rows per block of the QKV and MLP stages
constexpr int kLadQT = 16;     // queries per block of the attention stage
constexpr int kLadKC = 32;     // keys per staged chunk
constexpr int kLadMaxS = 128;  // the widest width class

template <typename T, int W>
struct Lad {
  static constexpr int kWarps = W / 8;  // 4 row slabs x W / 32 column groups
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kP = W + 8;                              // A/B tiles
  static constexpr int kPKV = sizeof(T) == 4 ? W + 4 : W + 8;  // K/V rows
  static constexpr int kQkvSmem = (kLadRows + W) * kP * (int)sizeof(T);
  static constexpr int kAttnSmem =
      (2 * 2 * kLadKC * kPKV + (kLadQT + W) * kP) * (int)sizeof(T) +
      2 * kLadKC * (int)sizeof(float);
  // x, one intermediate chunk, the two-buffer weight ring
  static constexpr int kMlpSmem = (2 * kLadRows + 2 * W) * kP * (int)sizeof(T);
  // attention blocks per SM the registers are sized for: at W = 96 three
  // in bf16 (at most 56 registers), two in fp32; the same register budget
  // at the other widths
  static constexpr int kAttnBlocks = (sizeof(T) == 2 ? 36 : 24) / (W / 8);
};

// acc[j] += A[16 rows] . B[32 rows]^T over K columns: A the warp's 16-row
// slab of a shared tile (pitch PA), B 32 rows of a [n][k] weight tile
// (pitch PB).  K is the class width W: every tile holds zeros in its
// columns past S, which add nothing (and at S = W there are none), so the
// loop is unrolled whole.  Fragment j holds columns 8j ... 8j + 7 of the
// warp's 32.  fp32: 3xTF32 with 64-bit fragment reads (within each group
// of 8 k the fragment's k = t, t + 4 come from columns 2t, 2t + 1 in A and
// B alike) and a fresh accumulator per 64-deep slice.
template <int K, int PA, int PB>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], const float* A,
                                         const float* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 64) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + 64 && kk < K; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b =
            *reinterpret_cast<const float2*>(B + (8 * j + g) * PB + kk + 2 * t);
        split_tf32(b.x, bh[j][0], bl[j][0]);
        split_tf32(b.y, bh[j][1], bl[j][1]);
      }
      const float2 x0 =
          *reinterpret_cast<const float2*>(A + g * PA + kk + 2 * t);
      const float2 x1 =
          *reinterpret_cast<const float2*>(A + (g + 8) * PA + kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32_1688(part[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32_1688(part[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32_1688(part[j], ah, bh[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// bf16: m16n8k16 with fragments by ldmatrix, one fp32 accumulator.
template <int K, int PA, int PB>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t r4[4];
      ldmatrix_x4(r4, B + (j * 8 + (lane & 7) + 8 * (lane >> 4)) * PB + kk +
                          8 * ((lane >> 3) & 1));
      b[j][0] = r4[0];
      b[j][1] = r4[1];
      b[j + 1][0] = r4[2];
      b[j + 1][1] = r4[3];
    }
    uint32_t a[4];
    ldmatrix_x4(a, A + (lane & 15) * PA + kk + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[j], a, b[j]);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows x W values of src (row stride ld elements) into a shared tile of
// pitch P, 16 bytes per cp.async; a piece at or past row `vr` or column
// `vc` (a multiple of 8) is zero-filled, so a tile's columns past S hold
// zeros for `warp_mma`
template <typename T, int W, int P>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld,
                                           int rows, int vr, int vc) {
  constexpr int CE = 16 / (int)sizeof(T), CPR = W / CE;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c = (idx % CPR) * CE;
    const bool ok = r < vr && c < vc;
    cp_async16(dst + r * P + c, ok ? src + r * ld + c : src, ok);
  }
}

// The first `rows` rows (S of the W columns) of a shared tile of pitch P
// to device memory (row stride ld elements), 16 bytes per store
template <typename T, int W, int P>
__device__ __forceinline__ void store_rows(T* dst, long long ld,
                                           const T* tile, int rows, int S) {
  constexpr int CE = 16 / (int)sizeof(T), CPR = W / CE;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c = (idx % CPR) * CE;
    if (c < S)
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(tile + r * P + c);
  }
}

// LayerNorm of the first `valid` rows (S of the W columns) of a shared
// tile, in place, one warp per row: fp32 statistics (as `_ln32`), the
// result rounded to T
template <typename T, int W, int P>
__device__ __forceinline__ void ln_rows(T* tile, int S, int valid,
                                        const float* __restrict__ w,
                                        const float* __restrict__ b,
                                        float eps) {
  constexpr int V = W / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < valid; r += blockDim.x / 32) {
    T* x = tile + r * P;
    float v[V], s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      s += v[i] = c < S ? to_f(x[c]) : 0.f;
    }
    const float mu = warp_sum(s) / S;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane + 32 * i < S) q += (v[i] - mu) * (v[i] - mu);
    const float rs = rsqrtf(warp_sum(q) / S + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < S) x[c] = from_f<T>((v[i] - mu) * rs * w[c] + b[c]);
    }
  }
}

// ------------------------------------------------------------ 2. side QKV

// grid (row tiles, branches, 3): block z projects one of Q, K, V:
// qkv_b[r, zS ... zS + S) = cast(LN1?(x_b[r]) W_z^T + b_z), so a block
// stages one S x S weight (three blocks per SM at S = 96).  The result goes
// through the shared tile to whole 16-byte row pieces in device memory.
template <typename T, int W, bool LN>
__global__ void __launch_bounds__(Lad<T, W>::kThreads)
    ladder_qkv_kernel(const T* __restrict__ x, int M, int S,
                      const T* __restrict__ wqkv,
                      const float* __restrict__ bqkv,
                      const float* __restrict__ lnw,
                      const float* __restrict__ lnb, float eps,
                      T* __restrict__ qkv) {
  constexpr int P = Lad<T, W>::kP;
  extern __shared__ __align__(16) unsigned char lad_smem[];
  T* As = reinterpret_cast<T*>(lad_smem);  // [64][P]: x, then the output
  T* Ws = As + kLadRows * P;               // [W][P]
  const int br = blockIdx.y, part = blockIdx.z, row0 = blockIdx.x * kLadRows;
  const int valid = min(kLadRows, M - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, cg = warp >> 2;

  stage_tile<T, W, P>(As, x + ((size_t)br * M + row0) * S, S, kLadRows,
                      valid, S);
  stage_tile<T, W, P>(Ws, wqkv + ((size_t)br * 3 + part) * S * S, S, W, S,
                      S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (LN) {
    ln_rows<T, W, P>(As, S, valid, lnw + br * S, lnb + br * S, eps);
    __syncthreads();
  }
  const float* bias = bqkv + (br * 3 + part) * S;
  float acc[4][4];
  zero_acc(acc);
  warp_mma<W, P, P>(acc, As + 16 * rg * P, Ws + 32 * cg * P);
  __syncthreads();  // every warp has read the x tile
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 32 * cg + 8 * j + 2 * t + e;
        if (c < S)
          As[(16 * rg + g + 8 * h) * P + c] =
              from_f<T>(acc[j][2 * h + e] + bias[c]);
      }
  __syncthreads();
  store_rows<T, W, P>(qkv + ((size_t)br * M + row0) * 3 * S + part * S,
                      3 * S, As, valid, S);
}

// ------------------------------------- 3. side attention + out-projection

// grid (16-query tiles, branches, images), S / 8 warps; warp w is head w
// (d = 8) for the tile's 16 queries, so a warp holds one head's running
// max, sum and context: few registers (two blocks per SM in fp32, three in
// bf16, at S = 96).  Keys come in chunks of 32 (the K and V rows of every
// head, staged once for the block); 8-key tiles wholly past T are skipped.
// Then x1_b = x_b + cast(ctx Wo^T + bo) (W / 32 warps of 32 columns), and
// LN1 for post-norm.
template <typename T, int W, bool MUL, bool POST, bool MBF16>
__global__ void __launch_bounds__(Lad<T, W>::kThreads,
                                  Lad<T, W>::kAttnBlocks)
    ladder_attn_kernel(const T* __restrict__ qkv, const void* __restrict__ mask,
                       const T* __restrict__ x,
                       const T* __restrict__ wo, const float* __restrict__ bo,
                       const float* __restrict__ lnw,
                       const float* __restrict__ lnb, float eps,
                       T* __restrict__ out, int M, int S, int Tn) {
  using D = Lad<T, W>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool TWO_PASS = !F32;  // bf16: the JAX rounding point of p
  constexpr int PKV = D::kPKV, P = D::kP, CE = 16 / (int)sizeof(T);
  constexpr int CPR = W / CE;  // 16-byte pieces of a W-wide row
  constexpr int KC = kLadKC, QT = kLadQT;
  extern __shared__ __align__(16) unsigned char lad_smem[];
  T* Ks = reinterpret_cast<T*>(lad_smem);  // [2][KC][PKV]
  T* Vs = Ks + 2 * KC * PKV;               // [2][KC][PKV]
  T* Cs = Vs + 2 * KC * PKV;               // [QT][P]: ctx, then x1
  T* Wos = Cs + QT * P;                    // [W][P]
  float* Ms = reinterpret_cast<float*>(Wos + W * P);  // [2][KC]

  const int qt = blockIdx.x, br = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hd = 8 * warp;  // this warp's head: its first column
  const T* base = qkv + ((size_t)br * M + (size_t)b * Tn) * 3 * S;
  const size_t m0 = (size_t)b * Tn;  // the image's first mask value
  const float scale = 1.0f / sqrtf(8.0f);
  const int r0 = qt * QT;  // the tile's first query
  const int nc = (Tn + KC - 1) / KC;
  const int steps = TWO_PASS ? 2 * nc : nc;

  // step s stages chunk s % nc: the K and V rows of every head, and the
  // chunk's mask values (keys past T: zero-filled, never used)
  auto load = [&](int s, int buf) {
    const int j0 = (s < nc ? s : s - nc) * KC;
    T* ks = Ks + buf * KC * PKV;
    T* vs = Vs + buf * KC * PKV;
    for (int idx = tid; idx < KC * CPR; idx += blockDim.x) {
      const int j = idx / CPR, c = (idx % CPR) * CE;
      if (c >= S) continue;
      const bool ok = j0 + j < Tn;
      const T* row = base + (size_t)(ok ? j0 + j : 0) * 3 * S;
      cp_async16(ks + j * PKV + c, row + S + c, ok);
      cp_async16(vs + j * PKV + c, row + 2 * S + c, ok);
    }
    if (tid < KC)
      Ms[buf * KC + tid] =
          j0 + tid < Tn ? mask_at<MBF16>(mask, m0 + j0 + tid) : 0.f;
  };
  stage_tile<T, W, P>(Wos, wo + (size_t)br * S * S, S, W, S, S);
  load(0, 0);
  cp_async_commit();
  // the context tile's columns past S: zeros for the out-projection
  for (int idx = tid; idx < QT * (W - S); idx += blockDim.x)
    Cs[(idx / (W - S)) * P + S + idx % (W - S)] = from_f<T>(0.f);

  // the head's Q fragment (rows past T are zero); fp32 split once
  uint32_t qa[4], qh[4], ql[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + g + 8 * (e & 1);
    uint32_t v = 0;
    if (row < Tn && (F32 || e < 2)) {
      const T* q = base + (size_t)row * 3 * S + hd;
      if constexpr (F32)
        v = __float_as_uint(q[t + 4 * (e >> 1)]);
      else
        v = *reinterpret_cast<const uint32_t*>(q + 2 * t);
    }
    qa[e] = v;
    if (F32) split_tf32(__uint_as_float(v), qh[e], ql[e]);
  }

  float o[4] = {0.f, 0.f, 0.f, 0.f};
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
    const int j0 = (s < nc ? s : s - nc) * KC;
    const int kv = min(KC, Tn - j0);  // keys of the chunk below T
    const T* ks = Ks + buf * KC * PKV;
    const T* vs = Vs + buf * KC * PKV;
    const float* ms = Ms + buf * KC;
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (F32) {
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (8 * j >= kv) break;
        const float* bp = kf + (8 * j + g) * PKV + hd + t;
        uint32_t bh[2], bl[2];
        split_tf32(bp[0], bh[0], bl[0]);
        split_tf32(bp[4], bh[1], bl[1]);
        mma_3xtf32(sc[j], qh, ql, bh, bl);
      }
    } else {
      // ldmatrix.x4 gives the K fragments of the chunk's four key tiles
      uint32_t r4[4];
      ldmatrix_x4(r4, ks + lane * PKV + hd);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (8 * u < kv) mma_bf16_1688(sc[u], qa, r4 + u);
    }
    // scale and mask; keys past T (only in the last chunk) at -inf
    float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = (e & 1) ? m2.y : m2.x;
        const float v = sc[j][e] * scale;
        sc[j][e] = MUL ? v * m : v + m;
      }
    }
    if (kv < KC) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= kv) sc[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm[e >> 1] = fmaxf(cm[e >> 1], sc[j][e]);
    // every chunk holds a key below T, so the new max is finite
    float m_new[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(mx[h], quad_max(cm[h]));
      alpha[h] = __expf(mx[h] - m_new[h]);  // 0 on the first chunk
    }
    if (!TWO_PASS || s < nc) {
      // row max and sum (fp32: the one pass; bf16: pass 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] *= alpha[h];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(sc[j][e] - m_new[e >> 1]);
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      mx[0] = m_new[0];
      mx[1] = m_new[1];
    }
    if constexpr (F32) {
      // online P.V: this chunk's exp(s - max) . V into a fresh
      // accumulator (32 keys deep: the tensor cores' sums are not rounded
      // to nearest), then o = o * alpha + it with rounded fp32 operations;
      // P's keys 2t, 2t + 1 of each group as the fragment's k = t, t + 4
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (8 * jj >= kv) break;
        uint32_t ah[4], al[4];
        split_tf32(sc[jj][0], ah[0], al[0]);
        split_tf32(sc[jj][2], ah[1], al[1]);
        split_tf32(sc[jj][1], ah[2], al[2]);
        split_tf32(sc[jj][3], ah[3], al[3]);
        const float* bp = vf + (8 * jj + 2 * t) * PKV + hd + g;
        uint32_t bh[2], bl[2];
        split_tf32(bp[0], bh[0], bl[0]);
        split_tf32(bp[PKV], bh[1], bl[1]);
        mma_3xtf32(pv, ah, al, bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = o[e] * alpha[e >> 1] + pv[e];
    } else {
      if (s == nc - 1) {  // end of pass 1: 1 / the rows' whole sums
        l[0] = __frcp_rn(quad_sum(l[0]));
        l[1] = __frcp_rn(quad_sum(l[1]));
      }
      if (s >= nc) {
        // pass 2: p = exp(s - max) / sum rounded to bf16, then P.V
#pragma unroll
        for (int kb2 = 0; kb2 < 2; ++kb2) {
          if (16 * kb2 >= kv) break;
          uint32_t a[4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* c = sc[2 * kb2 + u];
            a[2 * u] = pack_bf16(__expf(c[0] - mx[0]) * l[0],
                                 __expf(c[1] - mx[0]) * l[0]);
            a[2 * u + 1] = pack_bf16(__expf(c[2] - mx[1]) * l[1],
                                     __expf(c[3] - mx[1]) * l[1]);
          }
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, vs + (16 * kb2 + (lane & 15)) * PKV + hd);
          mma_bf16_16816(o, a, bf);
        }
      }
    }
    __syncthreads();  // the buffer is refilled at the next step
  }

  // the context, cast to x's dtype, into the shared tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = F32 ? __frcp_rn(quad_sum(l[h])) : 1.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      Cs[(g + 8 * h) * P + hd + 2 * t + e] = from_f<T>(o[2 * h + e] * inv);
  }
  __syncthreads();
  constexpr int CW = W / 32;  // warps of the out-projection (<= S / 8)
  float acc[4][4];
  zero_acc(acc);
  if (warp < CW) warp_mma<W, P, P>(acc, Cs, Wos + 32 * warp * P);
  __syncthreads();  // every warp has read the context
  const T* xb = x + ((size_t)br * M + (size_t)b * Tn) * S;
  if (warp < CW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = g + 8 * h, q = r0 + rl;
      if (q >= Tn) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * warp + 8 * j + 2 * t + e;
          if (c >= S) continue;
          const float v = acc[j][2 * h + e] + bo[br * S + c];
          Cs[rl * P + c] =
              from_f<T>(to_f(xb[(size_t)q * S + c]) + round_to<T>(v));
        }
    }
  }
  __syncthreads();
  const int valid = min(QT, Tn - r0);
  if (POST) {
    ln_rows<T, W, P>(Cs, S, valid, lnw + br * S, lnb + br * S, eps);
    __syncthreads();
  }
  store_rows<T, W, P>(out + ((size_t)br * M + (size_t)b * Tn + r0) * S, S,
                      Cs, valid, S);
}

// ------------------------------------------------------------ 4. side MLP

// grid (row tiles, branches).  y = LN2(x1) (pre-norm) or x1; for each
// W-wide chunk c of the I intermediate columns, inter_c = cast(gelu(y
// W1_c^T + b1_c)) in shared memory (columns past I: zero) and acc +=
// inter_c W2[:, c]^T; then out = x1 + cast(acc + b2), and LN2 for
// post-norm.  The ring alternates W1_c (W rows of W1, k = S) and W2's
// columns c (S rows, k = W), each a W x W tile.
template <typename T, int W, bool POST>
__global__ void __launch_bounds__(Lad<T, W>::kThreads)
    ladder_mlp_kernel(const T* __restrict__ x1, int M, int S, int I,
                      const float* __restrict__ lnw,
                      const float* __restrict__ lnb, float eps,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      T* __restrict__ out) {
  constexpr int P = Lad<T, W>::kP;
  extern __shared__ __align__(16) unsigned char lad_smem[];
  T* As = reinterpret_cast<T*>(lad_smem);  // [64][P]: y, then the output
  T* Is = As + kLadRows * P;               // [64][P]: one intermediate chunk
  T* Wr = Is + kLadRows * P;               // [2][W][P]
  const int br = blockIdx.y, row0 = blockIdx.x * kLadRows;
  const int valid = min(kLadRows, M - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, cg = warp >> 2;
  const T* xb = x1 + ((size_t)br * M + row0) * S;
  const T* w1b = w1 + (size_t)br * I * S;
  const T* w2b = w2 + (size_t)br * S * I;
  const float* b1b = b1 + (size_t)br * I;
  const int steps = 2 * ((I + W - 1) / W);

  // step i: chunk c0 = (i / 2) W; W1's rows c0 ... (even) or W2's columns
  // c0 ... (odd), zero past I
  auto load_step = [&](int i) {
    T* dst = Wr + (i & 1) * W * P;
    const int c0 = (i >> 1) * W;
    if ((i & 1) == 0)
      stage_tile<T, W, P>(dst, w1b + (size_t)c0 * S, S, W, I - c0, S);
    else
      stage_tile<T, W, P>(dst, w2b + c0, I, W, S, I - c0);
  };
  stage_tile<T, W, P>(As, xb, S, kLadRows, valid, S);
  load_step(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!POST) {
    ln_rows<T, W, P>(As, S, valid, lnw + br * S, lnb + br * S, eps);
    __syncthreads();
  }
  float acc2[4][4];
  zero_acc(acc2);
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      load_step(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* wc = Wr + (i & 1) * W * P + 32 * cg * P;
    if ((i & 1) == 0) {
      const int c0 = (i >> 1) * W;
      float acc[4][4];
      zero_acc(acc);
      warp_mma<W, P, P>(acc, As + 16 * rg * P, wc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * cg + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = c0 + c + e;
            Is[(16 * rg + g + 8 * h) * P + c + e] = from_f<T>(
                n < I ? gelu_erf(acc[j][2 * h + e] + b1b[n]) : 0.f);
          }
      }
    } else {
      warp_mma<W, P, P>(acc2, Is + 16 * rg * P, wc);
    }
    __syncthreads();  // the buffer is refilled at the next step
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rg + g + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 32 * cg + 8 * j + 2 * t + e;
        if (c >= S) continue;
        const float v = acc2[j][2 * h + e] + b2[br * S + c];
        As[r * P + c] = from_f<T>(to_f(xb[(size_t)r * S + c]) + round_to<T>(v));
      }
  }
  __syncthreads();
  if (POST) {
    ln_rows<T, W, P>(As, S, valid, lnw + br * S, lnb + br * S, eps);
    __syncthreads();
  }
  store_rows<T, W, P>(out + ((size_t)br * M + row0) * S, S, As, valid, S);
}

template <typename K>
static int set_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

struct LadderArgs {
  const void *x, *qkv_in, *mask, *w, *b, *w2, *b2, *lnw, *lnb;
  void* out;
  float eps;
  int M, nb, B, Tn, S, I;
  bool mask_bf16;
  cudaStream_t s;
};

template <typename T, int W, bool LN>
static int launch_qkv(const LadderArgs& a) {
  auto k = ladder_qkv_kernel<T, W, LN>;
  static bool done = false;
  if (int e = set_smem(k, Lad<T, W>::kQkvSmem, done)) return e;
  dim3 grid((a.M + kLadRows - 1) / kLadRows, a.nb, 3);
  k<<<grid, Lad<T, W>::kThreads, Lad<T, W>::kQkvSmem, a.s>>>(
      static_cast<const T*>(a.x), a.M, a.S, static_cast<const T*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.lnw),
      static_cast<const float*>(a.lnb), a.eps, static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename T, int W, bool MUL, bool POST, bool MBF16>
static int launch_attn(const LadderArgs& a) {
  auto k = ladder_attn_kernel<T, W, MUL, POST, MBF16>;
  static bool done = false;
  if (int e = set_smem(k, Lad<T, W>::kAttnSmem, done)) return e;
  dim3 grid((a.Tn + kLadQT - 1) / kLadQT, a.nb, a.B);
  k<<<grid, 4 * a.S, Lad<T, W>::kAttnSmem, a.s>>>(  // a warp per head
      static_cast<const T*>(a.qkv_in), a.mask, static_cast<const T*>(a.x),
      static_cast<const T*>(a.w),
      static_cast<const float*>(a.b), static_cast<const float*>(a.lnw),
      static_cast<const float*>(a.lnb), a.eps, static_cast<T*>(a.out), a.M,
      a.S, a.Tn);
  return (int)cudaGetLastError();
}

template <typename T, int W, bool POST>
static int launch_mlp(const LadderArgs& a) {
  auto k = ladder_mlp_kernel<T, W, POST>;
  static bool done = false;
  if (int e = set_smem(k, Lad<T, W>::kMlpSmem, done)) return e;
  dim3 grid((a.M + kLadRows - 1) / kLadRows, a.nb);
  k<<<grid, Lad<T, W>::kThreads, Lad<T, W>::kMlpSmem, a.s>>>(
      static_cast<const T*>(a.x), a.M, a.S, a.I,
      static_cast<const float*>(a.lnw), static_cast<const float*>(a.lnb),
      a.eps, static_cast<const T*>(a.w), static_cast<const float*>(a.b),
      static_cast<const T*>(a.w2), static_cast<const float*>(a.b2),
      static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename T, int W, bool MBF16>
static int launch_attn_flags(bool post, bool mul, const LadderArgs& a) {
  if (mul)
    return post ? launch_attn<T, W, true, true, MBF16>(a)
                : launch_attn<T, W, true, false, MBF16>(a);
  return post ? launch_attn<T, W, false, true, MBF16>(a)
              : launch_attn<T, W, false, false, MBF16>(a);
}

// stage: 0 QKV, 1 attention, 2 MLP; flags: bit 0 LN (QKV) / post-norm
// (attention, MLP), bit 1 "mul" (attention)
template <typename T, int W>
static int launch_stage(int stage, int flags, const LadderArgs& a) {
  const bool f0 = flags & 1, mul = flags & 2;
  if (stage == 0)
    return f0 ? launch_qkv<T, W, true>(a) : launch_qkv<T, W, false>(a);
  if (stage == 1) {
    // the mask's dtype: fp32, or bf16 with bf16 activations
    if constexpr (sizeof(T) == 2)
      if (a.mask_bf16) return launch_attn_flags<T, W, true>(f0, mul, a);
    if (a.mask_bf16) return (int)cudaErrorInvalidValue;
    return launch_attn_flags<T, W, false>(f0, mul, a);
  }
  if (stage == 2)
    return f0 ? launch_mlp<T, W, true>(a) : launch_mlp<T, W, false>(a);
  return (int)cudaErrorInvalidValue;
}

// the width class of S: the layout of the next multiple of 32
template <typename T>
static int pick_w(int stage, int flags, const LadderArgs& a) {
  switch ((a.S + 31) / 32) {
    case 1: return launch_stage<T, 32>(stage, flags, a);
    case 2: return launch_stage<T, 64>(stage, flags, a);
    case 3: return launch_stage<T, 96>(stage, flags, a);
    case 4: return launch_stage<T, 128>(stage, flags, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ag

using namespace ag;

// Side widths the ladder kernels take: multiples of 8 up to 128 (read as
// S / 8 heads of d = 8).
extern "C" int ag_ladder_supports(int S) {
  return S % 8 == 0 && S >= 8 && S <= kLadMaxS;
}

// One launch of a ladder stage.  Tensors are contiguous, branch-major:
// x, out <nb, M, S>; qkv <nb, M, 3S>; the per-branch weights stacked
// <nb, ...> in torch layout (wqkv <3S, S>, wo <S, S>, w1 <I, S>, w2
// <S, I>) and fp32 vectors <nb, n>; mask <B, Tn> with M = B * Tn, fp32 or,
// with bf16 activations, bf16 (flags bit 2).
//   stage 0 (QKV): x, w = wqkv, b = bqkv, lnw/lnb = LN1 (flags bit 0: on),
//     out = qkv;
//   stage 1 (attention): qkv_in, mask, x (the residual), w = wo, b = bo,
//     lnw/lnb = LN1 (flags bit 0: post-norm), bit 1: "mul", out = x1;
//   stage 2 (MLP): x = x1, w/b = w1/b1, w2/b2, lnw/lnb = LN2 (flags bit 0:
//     post-norm, else pre-norm), out; I the MLP width, a multiple of 8.
extern "C" int ag_ladder_stage(int dtype, int stage, int flags, int S, int I,
                               const void* x, const void* qkv_in,
                               const void* mask, const void* w, const void* b,
                               const void* w2, const void* b2, const void* lnw,
                               const void* lnb, float eps, void* out, int M,
                               int nb, int B, int Tn, void* stream) {
  if (!ag_ladder_supports(S) || nb <= 0 || nb > 65535 || M < 0 ||
      (stage == 1 && (B <= 0 || B > 65535 || Tn <= 0 || B * Tn != M)) ||
      (stage == 2 && (I <= 0 || I % 8)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  LadderArgs a{x,   qkv_in, mask, w, b, w2, b2, lnw, lnb,
               out, eps,    M,    nb, B, Tn, S, I, (flags & 4) != 0,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kF32) return pick_w<float>(stage, flags, a);
  if (dtype == kBF16) return pick_w<__nv_bfloat16>(stage, flags, a);
  return (int)cudaErrorInvalidValue;
}
