// The W8A8 building blocks of the int8 serving path: a row quantizer and an
// int8 x int8 -> int32 tensor-core GEMM with a float epilogue.  The int8
// kernels of the JAX package that run here:
//   autognothi_tpu/ops/attention_block.py:_pallas_attention_block_q (K1),
//   autognothi_tpu/ops/ladder_block.py:_pallas_mlp_ladder_q (K2, its trunk
//     MLP: K4's trunk design),
//   autognothi_tpu/ops/head_block.py:_pallas_head_q (K3's d2 with the d3
//     fold; its d1 and the fold's sum are in `int8_block.cu`),
//   autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block_q (K4 at the trunk
//     widths; the narrow widths are one launch of `int8_block.cu`),
//   autognothi_tpu/ops/mlp_block.py:_pallas_mlp_sepx_q (K8q, one tile of
//     the intermediate-dim split).
// The quantizers' arithmetic is `int8.cuh:quant_row_warp`.
//
// GEMM: C[m, n] = epi(acc[m, n] * a_scale[m] * w_scale[n] + bias[n]) with
// acc = sum_k A[m, k] W[n, k] in int32 (A <M, K> and W <N, K> int8, rows
// contiguous).  |acc| <= 127^2 K, which fp32 cannot hold exactly from
// K = 1040 on; int32 does.  Epilogues: cast to the activation dtype; + the
// residual after that cast; GELU kept in fp32 (the intermediate the next
// quantizer reads), with or without each row's max |.|; GELU, the cast,
// and the product of that cast row slice with a few float rows (K3's d2
// with its d3 folded in: see kI8GeluFold).
//
// Design (Hopper): a persistent, warp-specialised TMA + wgmma kernel
// (`gemm_i8_wgmma_kernel`).  Both operands are K-major, as 8-bit wgmma
// requires, and A <M, K> and the torch-layout W <N, K> already are: no
// repacking.  TMA (cp.async.bulk.tensor, tensor maps encoded on the host
// per call) loads 128 x 128-byte A boxes and BN x 128-byte W boxes,
// 128-byte swizzled, into a 5-6 stage ring guarded by mbarrier full/empty
// pairs; one producer warp issues them, two consumer warpgroups run
// wgmma.mma_async m64nBNk32 .s32.s8.s8 from shared memory on the arrived
// stages (setmaxnreg moves registers from the producer to them) and the
// float epilogue straight from the accumulator registers.  Tiles are 128 x
// 192 for the trunk products (N a multiple of 192, at least 768: 3, 9, 12
// full waves of the 132 SMs at the ViT B=64 products) and 128 x 96
// otherwise; TMA zero-fills rows past M and N and k past K, so any M, N and
// any K that is a multiple of 16 runs here.
//
// What bounds it: by the bytes it must move, the epilogue's output (above
// all the <M, 3072> fp32 GELU intermediate of K2's and K4's trunk MLP) and
// residual.  On an H100 80GB HBM3 it runs at 41-66% of that bound at the
// trunk products (PERF.md), held back by the epilogue itself: eight warps
// per SM compute and store the whole tile, GELU's erff included.  Each
// 64-column chunk of the epilogue loads its scales, biases and residuals
// together before its stores.  The producer loads the next tile's stages
// during the epilogue.  Ping-pong consumers (each warpgroup on its own
// tile, one's epilogue under the other's products) were measured and ran no
// faster.
//
// The trunk MLPs (K4, K2's trunk half, K8q's tiles) re-quantize their own
// fp32 GELU intermediate per token.  No pass reduces it: the W1 product's
// kI8GeluF32Amax epilogue raises each row's max |GELU| (fp32 bits,
// atomicMax: exact in any order) into a buffer the x quantizer zeroed in
// its own launch; the W2 product (QA) loads the fp32 intermediate by TMA and
// each consumer thread makes its wgmma A fragments' codes in registers from
// those maxima, with the quantizer's arithmetic.  The fp32 intermediate
// crosses from L2 once per column tile.  Measured on an H100 (PERF.md): at
// K8q's shape an elementwise pass writing the codes from the maxima before
// a GEMM on codes took as long on the device and one launch more, at the
// trunk K4's (N = 768) the row pass + GEMM on codes 40% longer; 64-k
// stages (five, 64-byte-swizzled W boxes) 3% longer; the A boxes shared by
// TMA multicast in clusters of the four column tiles five times longer; 64
// x 384 tiles (the two consumers side by side on the same rows, so A
// crosses half as often) 1-3% longer than 128 x 192.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "int8.cuh"

namespace ag {

// ------------------------------------------------------------ quantizer

// One warp per row (`quant_row_warp`).  zero <nzero> (may be null): fp32
// buffers this launch zeroes on the side (the per-row amax buffers of a
// trunk MLP or a K8q chain, zeroed by the launch that makes x's codes
// instead of a fill of their own).
template <typename T, bool LN, bool WEIGHT>
__global__ void quant_rows_kernel(const T* __restrict__ x, int ldx, int M,
                                  int N, float eps,
                                  const float* __restrict__ lnw,
                                  const float* __restrict__ lnb,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ scale,
                                  float* __restrict__ zero, int nzero) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nzero;
       i += gridDim.x * blockDim.x)
    zero[i] = 0.f;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  int8_t* qr = q + (size_t)row * N;
  const float s = quant_row_warp<T, LN, WEIGHT>(
      x + (size_t)row * ldx, N, eps, lnw, lnb, lane,
      [&](int c, int8_t code) { qr[c] = code; });
  if (lane == 0) scale[row] = s;
}

// ----------------------------------------------------------------- GEMM

enum EpiI8 {
  kI8Bias = 0,         // C = cast(v)
  kI8BiasResid = 1,    // C = R + cast(v)
  kI8GeluF32 = 2,      // C (fp32) = gelu(v)
  kI8GeluF32Amax = 4,  // kI8GeluF32, and amax[m] = max over the row of |C|
  kI8GeluFold = 5      // part[tile n][m][f] = sum over the tile's columns n
                       //   of cast(gelu(v))[m, n] * fold[f][n]; no C
};

// K3's fold takes at most this many float rows (classes)
constexpr int kI8MaxFold = 16;

struct GemmI8Args {
  const float* a_scale;  // <M>
  const float* w_scale;  // <N>
  const float* bias;     // <N>
  const void* R;         // residual (kI8BiasResid), row stride ldr
  int ldr;
  void* C;  // row stride ldc; fp32 for kI8GeluF32*, else the activation type
  int ldc;
  // <M>: kI8GeluF32Amax raises it to each row's max |C| (zeroed before
  // the launch); with A quantized on load, each row's max |A|
  float* amax;
  // kI8GeluFold: the nfold float rows <kI8MaxFold, N> (rows past nfold
  // zero) in the activation dtype: bf16, or for fp32 their tf32 hi plane
  // and fold_lo their lo plane; part <column tiles, M, nfold> fp32
  const void* fold;
  const float* fold_lo;
  int nfold;
  float* part;
  int M, N, K;
};

constexpr int kI8BM = 128;       // tile rows: one 64-row wgmma per consumer
constexpr int kI8BK = 128;       // k bytes per stage: one 128-byte swizzle row
constexpr int kI8Threads = 384;  // consumer warpgroups 0, 1; producer 2

// Tile widths: 192 for the trunk products (N = 768 ... 3072, multiples of
// 192: at M = 12608 that is 3, 9 and 12 full waves of the 132 SMs), else
// 96 (the 96-, 288- and 384-wide side products, which need the narrower
// tiles to spread over the SMs; any other N).  A tile is 128 rows, one
// 64-row wgmma per consumer.  QA (A quantized on load): a stage holds 128 k
// of fp32 A, four 128 x 128-byte boxes, so two stages.
template <int BN, bool QA = false>
struct I8Tile {
  static constexpr int kStages = QA ? 2 : BN == 192 ? 5 : 6;
  static constexpr int kABytes = kI8BM * kI8BK * (QA ? 4 : 1);
  static constexpr int kBBytes = BN * kI8BK;
  // the ring, its full/empty barriers, and slack to align the ring to the
  // 1024 bytes of the 128-byte swizzle pattern
  static constexpr int kSmem =
      kStages * (kABytes + kBBytes) + 2 * kStages * 8 + 1024;
};

// A pair of T from row r, columns c and c + 1 (c + 1 only where `two`), as
// floats; one 4- or 8-byte load where `vec`.
template <typename T>
__device__ __forceinline__ void load_pair(const T* row, int c, bool two,
                                          bool vec, float& x0, float& x1) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(row + c);
      x0 = v.x;
      x1 = v.y;
    } else {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(row + c);
      x0 = __low2float(v);
      x1 = __high2float(v);
    }
  } else {
    x0 = to_f(row[c]);
    x1 = two ? to_f(row[c + 1]) : 0.f;
  }
}

// C tile rows [m0, m0 + 64) of one consumer warpgroup, columns [n0, n0 +
// BN).  Accumulator fragment of wgmma m64nNk32 (s32): warp w, lane l hold,
// for each 8-column group j, d[4j + 2h + e] = D[16w + l/4 + 8h][8j + 2(l%4)
// + e].  The arithmetic of every value is the mma.sync design's: two _rn
// multiplies and an _rn add, exact-erf GELU, the residual added after the
// cast.  Columns go in chunks of 64 (48 for BN = 96): each chunk's scales,
// biases and residuals are loaded together before its stores, so their
// latencies overlap instead of queueing behind each other.  QA: A's row
// scales come from its row maxima (A was quantized on load).
// kI8GeluF32Amax: the four lanes that hold a row reduce their max |gelu|
// and one of them raises amax[row] by atomicMax on the fp32 bits, which
// orders non-negative floats as integers: exact, whatever the order in
// which the blocks arrive.
template <typename T, int EPI, int BN, bool QA>
__device__ __forceinline__ void epilogue(const GemmI8Args& p, const int* acc,
                                         int m0, int n0, bool vec_ok) {
  constexpr int kJ = (BN / 8) % 8 == 0 ? 8 : 6;  // 8-column groups a chunk
  constexpr bool kF32Out = EPI == kI8GeluF32 || EPI == kI8GeluF32Amax;
  static_assert((BN / 8) % kJ == 0, "chunks must tile the columns");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rows[2] = {m0 + 16 * warp + (lane >> 2),
                       m0 + 16 * warp + (lane >> 2) + 8};
  const bool row_ok[2] = {rows[0] < p.M, rows[1] < p.M};
  float sa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sa[h] = !row_ok[h] ? 0.f
            : QA       ? scale_of_amax(p.amax[rows[h]])
                       : p.a_scale[rows[h]];
  float rmax[2] = {0.f, 0.f};
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kJ) {
    float ws[kJ][2], bs[kJ][2], res[kJ][2][2];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int c = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
      const bool one = c < p.N, two = c + 1 < p.N;
      ws[jj][0] = one ? p.w_scale[c] : 0.f;
      bs[jj][0] = one ? p.bias[c] : 0.f;
      ws[jj][1] = two ? p.w_scale[c + 1] : 0.f;
      bs[jj][1] = two ? p.bias[c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        res[jj][h][0] = res[jj][h][1] = 0.f;
        if (EPI == kI8BiasResid && one && row_ok[h])
          load_pair<T>(static_cast<const T*>(p.R) + (size_t)rows[h] * p.ldr,
                       c, two, two && vec_ok, res[jj][h][0], res[jj][h][1]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = j0 + jj;
      const int c = n0 + 8 * j + 2 * (lane & 3);
      if (c >= p.N) continue;
      const bool two = c + 1 < p.N, vec = two && vec_ok;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!row_ok[h]) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + e], sa[h]),
                        ws[jj][e]),
              bs[jj][e]);
          if (EPI != kI8Bias && EPI != kI8BiasResid) v[e] = gelu_erf(v[e]);
        }
        if (EPI == kI8GeluF32Amax)
          rmax[h] = fmaxf(rmax[h], two ? fmaxf(fabsf(v[0]), fabsf(v[1]))
                                       : fabsf(v[0]));
        if (kF32Out) {
          float* out = static_cast<float*>(p.C) + (size_t)rows[h] * p.ldc + c;
          if (vec) {
            *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
          } else {
            out[0] = v[0];
            if (two) out[1] = v[1];
          }
          continue;
        }
        T o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (EPI == kI8BiasResid) v[e] = res[jj][h][e] + round_to<T>(v[e]);
          o[e] = from_f<T>(v[e]);
        }
        T* out = static_cast<T*>(p.C) + (size_t)rows[h] * p.ldc + c;
        if (vec) {
          if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float2*>(out) =
                make_float2(to_f(o[0]), to_f(o[1]));
          else
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __halves2bfloat162(o[0], o[1]);
        } else {
          out[0] = o[0];
          if (two) out[1] = o[1];
        }
      }
    }
  }
  if constexpr (EPI == kI8GeluF32Amax) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m = quad_max(rmax[h]);
      if ((lane & 3) == 0 && row_ok[h])
        atomicMax(reinterpret_cast<int*>(p.amax) + rows[h], __float_as_int(m));
    }
  }
}

// kI8GeluFold (K3's d2 with its float d3 folded in): the tile's cast(gelu)
// values, held in the accumulator's fragment layout, are the A fragments of
// mma.sync products with the fold rows' matching columns: per 8-column group
// one m16n8k8 per 8 fold rows, bf16 exact products with fp32 sums, fp32 as
// 3xTF32 (A split in registers, the rows' tf32 planes made once per weight
// version), so the fold costs a few tensor-core products per group and no
// scalar loop over the rows.  For tf32 the k order inside a group is
// permuted (k = t holds column 2t, k = t + 4 column 2t + 1), which the B
// fragments follow.  The tile's sum over its BN columns for each row and
// fold row goes to part[n0 / BN]: the products' order is fixed, so every
// run gives the same bits.
template <typename T, int BN>
__device__ __forceinline__ void epilogue_fold(const GemmI8Args& p,
                                              const int* acc, int m0,
                                              int n0) {
  constexpr int kG = 4;  // 8-column groups whose loads are issued together
  static_assert((BN / 8) % kG == 0, "load groups must tile the columns");
  constexpr bool kBF16 = sizeof(T) == 2;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {m0 + 16 * warp + g, m0 + 16 * warp + g + 8};
  float sa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sa[h] = rows[h] < p.M ? p.a_scale[rows[h]] : 0.f;
  const bool two_blocks = p.nfold > 8;  // fold rows 8 ... 15 too
  float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kG) {
    // the group's scales, biases and fold columns, loaded together (from
    // column 0 past N, whose values are then not used)
    float ws[kG][2], bs[kG][2];
    uint32_t fb[kG][2][4];  // [group][block]: bf16 {pair}; fp32 {hi, lo} x 2
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) {
      const int c = n0 + 8 * (j0 + jj) + 2 * t;
      const int cc = c < p.N ? c : 0;  // N % 8 == 0: the pair is whole
      ws[jj][0] = p.w_scale[cc];
      ws[jj][1] = p.w_scale[cc + 1];
      bs[jj][0] = p.bias[cc];
      bs[jj][1] = p.bias[cc + 1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const size_t at = (size_t)(8 * k + g) * p.N + cc;  // fold row 8k + g
        if constexpr (kBF16) {
          fb[jj][k][0] = __ldg(reinterpret_cast<const unsigned int*>(
              static_cast<const __nv_bfloat16*>(p.fold) + at));
        } else {
          const float* hi = static_cast<const float*>(p.fold) + at;
          fb[jj][k][0] = __float_as_uint(__ldg(hi));
          fb[jj][k][1] = __float_as_uint(__ldg(hi + 1));
          fb[jj][k][2] = __float_as_uint(__ldg(p.fold_lo + at));
          fb[jj][k][3] = __float_as_uint(__ldg(p.fold_lo + at + 1));
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) {
      const int j = j0 + jj;
      const bool in = n0 + 8 * j + 2 * t < p.N;
      float h2[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * h + e], sa[h]),
                        ws[jj][e]),
              bs[jj][e]);
          h2[h][e] = in ? round_to<T>(gelu_erf(v)) : 0.f;
        }
      uint32_t ah[4], al[4];
      if constexpr (kBF16) {
        ah[0] = pack_bf16(h2[0][0], h2[0][1]);
        ah[1] = pack_bf16(h2[1][0], h2[1][1]);
      } else {
        split_tf32(h2[0][0], ah[0], al[0]);
        split_tf32(h2[1][0], ah[1], al[1]);
        split_tf32(h2[0][1], ah[2], al[2]);
        split_tf32(h2[1][1], ah[3], al[3]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two_blocks) break;
        if constexpr (kBF16) {
          mma_bf16_1688(d[k], ah, fb[jj][k]);
        } else {
          const uint32_t bh[2] = {fb[jj][k][0], fb[jj][k][1]};
          const uint32_t bl[2] = {fb[jj][k][2], fb[jj][k][3]};
          mma_3xtf32(d[k], ah, al, bh, bl);
        }
      }
    }
  }
  float* part = p.part + (size_t)(n0 / BN) * p.M * p.nfold;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = 8 * k + 2 * t + e;
        if (f < p.nfold && rows[h] < p.M)
          part[(size_t)rows[h] * p.nfold + f] = d[k][2 * h + e];
      }
}

// Persistent, warp-specialised int8 GEMM: gridDim.x blocks (at most one per
// SM) walk the 128 x BN output tiles in row-major order, tile t, t +
// gridDim.x, ...  Warpgroup 2 is the producer: one
// thread keeps a ring of kStages stages (the A and W boxes of one 128-byte
// k slice) filled by TMA, each stage guarded by a full barrier (its bytes
// arrived) and an empty barrier (its eight consumer warps are done
// reading).  Warpgroups 0 and 1 each multiply 64 rows of the tile by BN
// columns from the arrived stages (four m64nBNk32 wgmmas per stage) into an
// int32 accumulator in registers, then run the float epilogue from
// registers while the producer already fills the ring with the next tile's
// slices.  A consumer waits for a stage's products before it releases the
// stage: keeping one stage's products in flight (wgmma.wait_group 1) was
// measured on an H100 and ran 0-3% slower or faster by product (PERF.md).
//
// QA (the W2 product of a trunk MLP or a K8q tile): A is the fp32 GELU
// intermediate itself, loaded by TMA as four boxes per 128 k, and each
// consumer thread quantizes its own wgmma A fragments in registers, code =
// rint(x * (127 / (amax[m] + 1e-12))) with the row maxima the W1 product's
// epilogue took: the codes `quant_rows_kernel` would write, with no pass
// and no codes in device memory.  The fp32 A is read once per column tile
// (from L2 after the first).
template <typename T, int EPI, int BN, bool QA>
__global__ void __launch_bounds__(kI8Threads, 1)
    gemm_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_w,
                         GemmI8Args p) {
  using Tile = I8Tile<BN, QA>;
  constexpr int S = Tile::kStages;
  constexpr int kBox = kI8BM * 128;  // one TMA box of A: 128 rows x 128 bytes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;
  uint8_t* sB = smem + S * Tile::kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + S * Tile::kBBytes);
  uint64_t* empty = full + S;

  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + kI8BM - 1) / kI8BM) * tiles_n;
  const int nk = (p.K + kI8BK - 1) / kI8BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kI8BM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Tile::kABytes + Tile::kBBytes);
          uint8_t* a = sA + stage * Tile::kABytes;
          if constexpr (QA) {
#pragma unroll
            for (int j = 0; j < 4; ++j)  // fp32 k 128 kb + 32 j ...
              tma_load_2d(a + j * kBox, &map_a, &full[stage],
                          (kb * kI8BK + 32 * j) * 4, m0);
          } else {
            tma_load_2d(a, &map_a, &full[stage], kb * kI8BK, m0);
          }
          tma_load_2d(sB + stage * Tile::kBBytes, &map_w, &full[stage],
                      kb * kI8BK, n0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const bool vec_ok =
        p.ldc % 2 == 0 &&
        reinterpret_cast<uintptr_t>(p.C) %
                (2 * (EPI == kI8GeluF32 || EPI == kI8GeluF32Amax
                          ? sizeof(float)
                          : sizeof(T))) ==
            0 &&
        (EPI != kI8BiasResid ||
         (p.ldr % 2 == 0 &&
          reinterpret_cast<uintptr_t>(p.R) % (2 * sizeof(T)) == 0));
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = wg * 64;  // this consumer's rows inside the tile
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kI8BM, n0 = (tile % tiles_n) * BN;
      // QA: 127 / (amax + 1e-12) of this thread's two fragment rows, 16
      // warp + g and + 8 of the consumer's 64 (rows past M: zeros by TMA)
      float inv[2] = {0.f, 0.f};
      if constexpr (QA) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + row0 + 16 * warp + g + 8 * r;
          if (row < p.M) inv[r] = inv_of_amax(p.amax[row]);
        }
      }
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* b = sB + stage * Tile::kBBytes;
        if constexpr (QA) {
          // the s8 A fragment of k step kk (m16n8k32 per warp): register
          // 2 half + r holds row g + 8 r, k 16 half + 4 t ... + 3, which is
          // the 16-byte chunk 4 half + t of the fp32 row in box kk, moved
          // by the 128-byte swizzle to chunk ^ (row % 8) = chunk ^ g
          const uint8_t* a = sA + stage * Tile::kABytes + row0 * 128;
          uint32_t af[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = 16 * warp + g + 8 * r;
                const float4 v = *reinterpret_cast<const float4*>(
                    a + kk * kBox + row * 128 + (((4 * half + t) ^ g) << 4));
                const uint32_t q0 = __float2int_rn(__fmul_rn(v.x, inv[r]));
                const uint32_t q1 = __float2int_rn(__fmul_rn(v.y, inv[r]));
                const uint32_t q2 = __float2int_rn(__fmul_rn(v.z, inv[r]));
                const uint32_t q3 = __float2int_rn(__fmul_rn(v.w, inv[r]));
                af[kk][2 * half + r] = (q0 & 0xFFu) | (q1 & 0xFFu) << 8 |
                                       (q2 & 0xFFu) << 16 | q3 << 24;
              }
          fence_regs<BN / 2>(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8_rs<BN>(acc, af[kk], sw128_desc(b + kk * 32));
        } else {
          const uint8_t* a = sA + stage * Tile::kABytes + row0 * kI8BK;
          fence_regs<BN / 2>(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kI8BK / 32; ++kk)
            wgmma_s8<BN>(acc, sw128_desc(a + kk * 32),
                         sw128_desc(b + kk * 32));
        }
        wgmma_commit();
        fence_regs<BN / 2>(acc);
        wgmma_wait_all();
        fence_regs<BN / 2>(acc);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      if constexpr (EPI == kI8GeluFold)
        epilogue_fold<T, BN>(p, acc, m0 + row0, n0);
      else
        epilogue<T, EPI, BN, QA>(p, acc, m0 + row0, n0, vec_ok);
    }
  }
}

template <typename T, int EPI, int BN, bool QA>
static int launch_gemm_i8_tile(const CUtensorMap& ma, const CUtensorMap& mw,
                               const GemmI8Args& p, cudaStream_t s) {
  using Tile = I8Tile<BN, QA>;
  auto kernel = gemm_i8_wgmma_kernel<T, EPI, BN, QA>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const long long tiles = (long long)((p.M + kI8BM - 1) / kI8BM) *
                          ((p.N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, kI8Threads, Tile::kSmem, s>>>(ma, mw, p);
  return (int)cudaGetLastError();
}

// The shape rule: 192-wide tiles where N is a multiple of 192 and at least
// 768, else 96.
static inline int gemm_i8_bn(int N) {
  return N % 192 == 0 && N >= 768 ? 192 : 96;
}

template <typename T, int EPI, bool QA = false>
static int launch_gemm_i8(const CUtensorMap& ma, const void* W,
                          const GemmI8Args& p, cudaStream_t s) {
  const int bn = gemm_i8_bn(p.N);
  CUtensorMap mw;
  if (!tensor_map(&mw, W, p.N, p.K, p.K, bn)) return (int)cudaErrorInvalidValue;
  if (bn == 192) return launch_gemm_i8_tile<T, EPI, 192, QA>(ma, mw, p, s);
  return launch_gemm_i8_tile<T, EPI, 96, QA>(ma, mw, p, s);
}

template <typename T>
static int dispatch_gemm_i8(int epi, const CUtensorMap& ma, const void* W,
                            const GemmI8Args& p, cudaStream_t s) {
  switch (epi) {
    case kI8Bias: return launch_gemm_i8<T, kI8Bias>(ma, W, p, s);
    case kI8BiasResid: return launch_gemm_i8<T, kI8BiasResid>(ma, W, p, s);
    case kI8GeluF32: return launch_gemm_i8<T, kI8GeluF32>(ma, W, p, s);
    case kI8GeluF32Amax:
      return p.amax ? launch_gemm_i8<T, kI8GeluF32Amax>(ma, W, p, s)
                    : (int)cudaErrorInvalidValue;
    case kI8GeluFold:
      return p.fold && p.part && p.nfold > 0 && p.nfold <= kI8MaxFold &&
                     p.N % 8 == 0 && (sizeof(T) == 2 || p.fold_lo)
                 ? launch_gemm_i8<T, kI8GeluFold>(ma, W, p, s)
                 : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_quant_rows(const void* x, int ldx, int M, int N, float eps,
                             const float* lnw, const float* lnb, int weight,
                             int8_t* q, float* scale, float* zero, int nzero,
                             cudaStream_t s) {
  constexpr int threads = 256;  // 8 rows per block
  const int blocks = (M * 32 + threads - 1) / threads;
  const T* xt = static_cast<const T*>(x);
  if (weight && lnw) return (int)cudaErrorInvalidValue;
  if (weight)
    quant_rows_kernel<T, false, true><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale, zero, nzero);
  else if (lnw)
    quant_rows_kernel<T, true, false><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale, zero, nzero);
  else
    quant_rows_kernel<T, false, false><<<blocks, threads, 0, s>>>(
        xt, ldx, M, N, eps, lnw, lnb, q, scale, zero, nzero);
  return (int)cudaGetLastError();
}

}  // namespace ag

using namespace ag;

// Row quantizer.  weight = 1: the per-output-channel weight recipe;
// weight = 0: the per-token activation recipe, with the LN prologue when
// lnw / lnb are given.  q <M, N> is contiguous.  zero <nzero> fp32 (may be
// null): zeroed by the same launch.
extern "C" int ag_quant_rows(int dtype, const void* x, int ldx, int M, int N,
                             float eps, const void* lnw, const void* lnb,
                             int weight, void* q, void* scale, void* zero,
                             int nzero, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(lnw);
  const float* b = static_cast<const float*>(lnb);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  float* z = static_cast<float*>(zero);
  if (nzero < 0 || (nzero > 0 && z == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_quant_rows<float>(x, ldx, M, N, eps, w, b, weight, qq, sc,
                                    z, nzero, s);
  if (dtype == kBF16)
    return launch_quant_rows<__nv_bfloat16>(x, ldx, M, N, eps, w, b, weight,
                                            qq, sc, z, nzero, s);
  return (int)cudaErrorInvalidValue;
}

// int8 GEMM; dtype is the activation type of R and C (C is fp32 for the
// kI8GeluF32 and kI8GeluF32Amax epilogues; amax <M>, zeroed before, is
// raised to each row's max |C| by the latter).  kI8GeluFold writes no C:
// nfold (at most kI8MaxFold) float rows, fold <kI8MaxFold, N> (zero rows
// past nfold) in the activation dtype (fp32: the tf32 hi plane, fold_lo the
// lo plane), N a multiple of 8, and part <the column tiles (`ag_gemm_i8_tiles_n`), M,
// nfold> fp32.  A and W are read by TMA: K, lda and both base pointers
// must be multiples of 16 bytes.
extern "C" int ag_gemm_i8(int dtype, int epi, const void* A, int lda,
                          const void* a_scale, const void* W,
                          const void* w_scale, const void* bias, const void* R,
                          int ldr, void* C, int ldc, void* amax,
                          const void* fold, const void* fold_lo, int nfold,
                          void* part, int M, int N, int K, void* stream) {
  if (K <= 0 || K % 16 != 0 || lda % 16 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  GemmI8Args p{static_cast<const float*>(a_scale),
               static_cast<const float*>(w_scale),
               static_cast<const float*>(bias),
               R,
               ldr,
               C,
               ldc,
               static_cast<float*>(amax),
               fold,
               static_cast<const float*>(fold_lo),
               nfold,
               static_cast<float*>(part),
               M,
               N,
               K};
  CUtensorMap ma;
  if (!tensor_map(&ma, A, M, K, lda, kI8BM)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_gemm_i8<float>(epi, ma, W, p, s);
  if (dtype == kBF16)
    return dispatch_gemm_i8<__nv_bfloat16>(epi, ma, W, p, s);
  return (int)cudaErrorInvalidValue;
}

// The number of column tiles of an int8 GEMM of N output columns (the
// partial sums of kI8GeluFold, one per tile)
extern "C" int ag_gemm_i8_tiles_n(int N) {
  const int bn = gemm_i8_bn(N);
  return (N + bn - 1) / bn;
}

// The int8 GEMM with A quantized on load (the residual epilogue: the W2
// product of a trunk MLP or a K8q tile): A fp32 <M, K> (row stride lda
// elements) and its per-row max |A| (amax <M>); the rest as `ag_gemm_i8`.
// A is read by TMA: its pointer and row stride must be multiples of 16
// bytes, K of 16.
extern "C" int ag_gemm_i8_qa(int dtype, const void* A, int lda,
                             const void* amax, const void* W,
                             const void* w_scale, const void* bias,
                             const void* R, int ldr, void* C, int ldc, int M,
                             int N, int K, void* stream) {
  if (K <= 0 || K % 16 != 0 || lda % 4 != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(W) % 16 != 0 || amax == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  GemmI8Args p{nullptr,
               static_cast<const float*>(w_scale),
               static_cast<const float*>(bias),
               R,
               ldr,
               C,
               ldc,
               const_cast<float*>(static_cast<const float*>(amax)),
               nullptr,
               nullptr,
               0,
               nullptr,
               M,
               N,
               K};
  CUtensorMap ma;
  if (!tensor_map(&ma, A, M, K * 4, lda * 4, kI8BM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_gemm_i8<float, kI8BiasResid, true>(ma, W, p, s);
  if (dtype == kBF16)
    return launch_gemm_i8<__nv_bfloat16, kI8BiasResid, true>(ma, W, p, s);
  return (int)cudaErrorInvalidValue;
}
