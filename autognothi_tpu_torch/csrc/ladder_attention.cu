// The ladder attention core for every branch in one launch (K10), replacing
// autognothi_tpu/ops/ladder_block.py:_make_attn_fn (body `_attn_kernel`,
// math `_xla_ctx`): for each branch b, separate q_b, k_b, v_b <B, T, S>
// read as S / 8 heads of d = 8 (the only head width the ladders build),
// ctx_b = softmax(mask(q_b k_b^T / sqrt(8))) v_b per head, written
// head-merged to out_b <B, T, S>.  Heads of another width run the
// per-branch route on `attention.cu` (`ops/ladder_block.py:
// ladder_attention_route`, by shape).
//
// Math, as the JAX kernel and `ladder_attention_plain`: fp32 scores times
// 1/sqrt(d); the mask multiplied ("mul", the ViT quirk: a masked score
// becomes 0 and keeps weight exp(0 - max)) or added ("add", BERT's
// finfo.min); keys past T at -inf; fp32 softmax with fp32 statistics; p
// cast to v's dtype (bf16: rounded after normalisation, so two passes over
// the keys; fp32: one online pass); P.V summed in fp32, cast to q's dtype.
//
// Design, for the H100 at d = 8:
// - one launch for every branch: the grid is (32-query tiles, branches,
//   images) and the branches' q/k/v/out pointers ride in the kernel's
//   parameters (`LaBranches`, up to kLaMaxBranches);
// - a block holds S / 8 warps, warp h owns head h for two 16-query slabs,
//   so its K and V fragments serve both; two blocks an SM (24 warps at
//   S = 96);
// - key chunks of 32 go through a double-buffered cp.async ring, the K and
//   V rows of every head staged once for the block (a key row is S
//   contiguous values); the image's mask row is staged once, beside them;
//   at T = 197 the keys are walked as 7 chunks and the 8-key tiles past T
//   are skipped in the products (200 keys, not 256);
// - the per-score scalar work is cut down: fp32 folds 1/sqrt(8) * log2(e)
//   into q once (bf16 keeps q's bits and takes one multiply of the fp32
//   score), the softmax runs on ex2.approx in the log2 domain, "add" reads
//   the bias pre-scaled by log2(e) once per key, and "mul" with a 0/1 mask
//   costs nothing per score: a key whose mask value is 0 is staged as a
//   zero K row (its score is then 0 = s * 0 for every query and head), and
//   a row holding a value other than 0 or 1 (a vote as it is staged)
//   multiplies its scores as the plain math does;
// - Q.K and P.V on mma.sync: fp32 as 3xTF32 m16n8k8 (hi = rna_tf32(x), lo =
//   rna_tf32(x - hi)), the P.V of each 32-key chunk into a fresh
//   accumulator added to the running context with rounded fp32 operations;
//   bf16 m16n8k8 for Q.K and m16n8k16 for P.V, K fragments by ldmatrix and
//   V fragments by ldmatrix.trans.
// The <B, heads, T, T> scores and probabilities never reach device memory.
//
// What bounds it: the bytes are q, k, v read once and the context written
// once (2 branches x 4 x <64, 197, 96> fp32: 38.7 MB, 11.6 us at 3.35
// TB/s); the scores are 2 x 64 x 12 x 197^2 = 59.6 M, and each costs about
// a dozen scalar instructions in fp32 (max, the exponent's subtraction and
// ex2, the sum, P's tf32 split, the shares of the K and V splits and of the
// mma issues) and one ex2 per pass in bf16 (two passes: ~30 us at the MUFU
// rate of 16 a clock an SM).  PERF.md holds the measured times.

#include <float.h>

#include "common.cuh"

namespace ag {

constexpr int kLaKC = 32;          // keys per staged chunk (32 or 64)
constexpr int kLaMaxS = 128;       // widest side: 16 heads of d = 8
constexpr int kLaMaxBranches = 16;

// 16-query slabs a warp owns (32 queries a block), and the blocks an SM
// holds at once, which the registers are sized for: two up to W = 96 (24
// warps an SM), one at the widest class, whose 512 threads leave 128
// registers a thread.  Measured on the H100 at 2 x <64, 197, 96> against
// four slabs (one block an SM), one and three slabs (two blocks) and
// 64-key chunks: PERF.md.
constexpr int kLaQS = 2;

template <int W>
__host__ __device__ constexpr int la_min_blocks() {
  return W > 96 ? 1 : 2;
}

// K/V row pitch: fp32 W + 4 (conflict-free 32-bit fragment reads), bf16
// W + 8 (16-byte rows for ldmatrix)
template <typename T, int W>
__host__ __device__ constexpr int la_pitch() {
  return sizeof(T) == 4 ? W + 4 : W + 8;
}

// the K/V ring, then the image's mask row (one value per key, T rounded
// up to whole chunks)
template <typename T, int W>
__host__ __device__ constexpr int la_ring_bytes() {
  return 2 * 2 * kLaKC * la_pitch<T, W>() * (int)sizeof(T);
}

struct LaBranches {
  const void* q[kLaMaxBranches];
  const void* k[kLaMaxBranches];
  const void* v[kLaMaxBranches];
  void* o[kLaMaxBranches];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int W, bool MUL, bool MBF16>
__global__ void __launch_bounds__(4 * W, la_min_blocks<W>())
    ladder_attention_kernel(LaBranches br, const void* __restrict__ mask,
                            int S, int Tn) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool TWO_PASS = !F32;  // bf16: the JAX rounding point of p
  constexpr int PKV = la_pitch<T, W>();
  constexpr int CE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int KC = kLaKC;
  constexpr int NJ = KC / 8;  // 8-key tiles a chunk (a multiple of 4)
  constexpr int QS = kLaQS;
  extern __shared__ __align__(16) unsigned char la_smem[];
  T* Ks = reinterpret_cast<T*>(la_smem);  // [2][KC][PKV]
  T* Vs = Ks + 2 * KC * PKV;              // [2][KC][PKV]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * KC * PKV);  // [nc * KC]

  const int bri = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hd = 8 * warp;  // this warp's head: its first column
  const size_t base = (size_t)b * Tn * S;
  const T* qb = static_cast<const T*>(br.q[bri]) + base;
  const T* kb = static_cast<const T*>(br.k[bri]) + base;
  const T* vb = static_cast<const T*>(br.v[bri]) + base;
  T* ob = static_cast<T*>(br.o[bri]) + base;
  const size_t m0 = (size_t)b * Tn;  // the image's first mask value
  // 1/sqrt(8) * log2(e): scores in the log2 domain, softmax by ex2
  const float c = kLog2e / sqrtf(8.0f);
  const int r0 = blockIdx.x * 16 * QS;             // the tile's first query
  const int nc = (Tn + KC - 1) / KC;
  const int steps = TWO_PASS ? 2 * nc : nc;
  const int cpr = S / CE;  // 16-byte pieces of a row

  // the image's mask row, once: "add" pre-scaled by log2(e) and kept
  // finite, "mul" as it is; keys past T 0.  "mul" votes whether the row
  // holds a value other than 0 or 1 (then its scores are multiplied by the
  // mask; else a key of value 0 gets a zero K row below, and no score
  // takes a mask operation)
  int odd = 0;
  for (int i = tid; i < nc * KC; i += blockDim.x) {
    const float m = i < Tn ? mask_at<MBF16>(mask, m0 + i) : 0.f;
    if constexpr (MUL) {
      Ms[i] = m;
      odd |= i < Tn && m != 0.f && m != 1.f;
    } else {
      Ms[i] = fmaxf(m * kLog2e, -FLT_MAX);
    }
  }
  const bool generic = __syncthreads_or(odd) != 0;

  // step s stages chunk s % nc: K (bf16 pass 1), or K and V; keys past T
  // zero-filled; "mul": a key of mask value 0 gets a zero K row
  auto load = [&](int s, int buf) {
    const int j0 = (s < nc ? s : s - nc) * KC;
    const bool with_v = !TWO_PASS || s >= nc;
    T* ks = Ks + buf * KC * PKV;
    T* vs = Vs + buf * KC * PKV;
    for (int idx = tid; idx < KC * cpr; idx += blockDim.x) {
      const int j = idx / cpr, col = (idx % cpr) * CE;
      const int key = j0 + j;
      const bool ok = key < Tn;
      const size_t off = (size_t)(ok ? key : 0) * S + col;
      const bool k_ok = ok && (!MUL || Ms[key] != 0.f);
      cp_async16(ks + j * PKV + col, kb + off, k_ok);
      if (with_v) cp_async16(vs + j * PKV + col, vb + off, ok);
    }
    cp_async_commit();
  };
  load(0, 0);

  // the warp's Q fragments, one per slab (rows past T are zero); fp32
  // scaled by c and split once
  uint32_t qa[QS][4], qh[QS][4], ql[QS][4];
#pragma unroll
  for (int sl = 0; sl < QS; ++sl)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 16 * sl + g + 8 * (e & 1);
      uint32_t v = 0;
      if (row < Tn && (F32 || e < 2)) {
        const T* q = qb + (size_t)row * S + hd;
        if constexpr (F32)
          v = __float_as_uint(q[t + 4 * (e >> 1)] * c);
        else
          v = *reinterpret_cast<const uint32_t*>(q + 2 * t);
      }
      qa[sl][e] = v;
      if (F32) split_tf32(__uint_as_float(v), qh[sl][e], ql[sl][e]);
    }

  float o[QS][4];
  float mx[QS][2], l[QS][2];
#pragma unroll
  for (int sl = 0; sl < QS; ++sl) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[sl][e] = 0.f;
    mx[sl][0] = mx[sl][1] = -INFINITY;
    l[sl][0] = l[sl][1] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk has landed
    const int buf = s & 1;
    const int j0 = (s < nc ? s : s - nc) * KC;
    const int kv = min(KC, Tn - j0);  // keys of the chunk below T
    const T* ks = Ks + buf * KC * PKV;
    const T* vs = Vs + buf * KC * PKV;
    const bool pass1 = !TWO_PASS || s < nc;

    // scores of every slab against the chunk's keys
    float sc[QS][NJ][4];
#pragma unroll
    for (int sl = 0; sl < QS; ++sl)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[sl][j][e] = 0.f;
    if constexpr (F32) {
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (8 * j >= kv) break;
        const float* bp = kf + (8 * j + g) * PKV + hd + t;
        uint32_t bh[2], bl[2];
        split_tf32(bp[0], bh[0], bl[0]);
        split_tf32(bp[4], bh[1], bl[1]);
#pragma unroll
        for (int sl = 0; sl < QS; ++sl)
          mma_3xtf32(sc[sl][j], qh[sl], ql[sl], bh, bl);
      }
    } else {
      // ldmatrix.x4 gives the K fragments of four key tiles
#pragma unroll
      for (int j4 = 0; j4 < NJ; j4 += 4) {
        uint32_t r4[4];
        ldmatrix_x4(r4, ks + (8 * j4 + lane) * PKV + hd);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (8 * (j4 + u) < kv) {
#pragma unroll
            for (int sl = 0; sl < QS; ++sl)
              mma_bf16_1688(sc[sl][j4 + u], qa[sl], r4 + u);
          }
      }
    }
    // the chunk's mask values of this thread's key columns, 2t and 2t + 1
    // of each 8-key tile
    float2 mk[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mk[j] = *reinterpret_cast<const float2*>(Ms + j0 + 8 * j + 2 * t);

#pragma unroll
    for (int sl = 0; sl < QS; ++sl) {
      // log2-domain scores: scale (bf16), mask, keys past T at -inf
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[sl][j][e];
          if (!F32) v *= c;
          const float m = (e & 1) ? mk[j].y : mk[j].x;
          if constexpr (MUL) {
            if (generic) v *= m;
          } else {
            v += m;
          }
          sc[sl][j][e] = v;
        }
      if (kv < KC) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) >= kv) sc[sl][j][e] = -INFINITY;
      }
      if (pass1) {
        // row max and sum (fp32: the one pass; bf16: pass 1); every chunk
        // holds a key below T, so the new max is finite
        float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cm[e >> 1] = fmaxf(cm[e >> 1], sc[sl][j][e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(mx[sl][h], quad_max(cm[h]));
          const float alpha = ex2_approx(mx[sl][h] - m_new);  // 0 at first
          l[sl][h] *= alpha;
          if (F32) {
            o[sl][2 * h] *= alpha;
            o[sl][2 * h + 1] *= alpha;
          }
          mx[sl][h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2_approx(sc[sl][j][e] - mx[sl][e >> 1]);
            sc[sl][j][e] = p;
            l[sl][e >> 1] += p;
          }
      } else {
        // pass 2: p = exp(s - max) / sum, rounded to bf16 below
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[sl][j][e] =
                ex2_approx(sc[sl][j][e] - mx[sl][e >> 1]) * l[sl][e >> 1];
      }
    }

    if constexpr (F32) {
      // online P.V: this chunk's exp(s - max) . V into a fresh accumulator,
      // then added to the rescaled context; P's keys 2t, 2t + 1 of each
      // group as the fragment's k = t, t + 4, V's rows in the same order
      float pv[QS][4];
#pragma unroll
      for (int sl = 0; sl < QS; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[sl][e] = 0.f;
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (8 * jj >= kv) break;
        const float* bp = vf + (8 * jj + 2 * t) * PKV + hd + g;
        uint32_t bh[2], bl[2];
        split_tf32(bp[0], bh[0], bl[0]);
        split_tf32(bp[PKV], bh[1], bl[1]);
#pragma unroll
        for (int sl = 0; sl < QS; ++sl) {
          uint32_t ah[4], al[4];
          split_tf32(sc[sl][jj][0], ah[0], al[0]);
          split_tf32(sc[sl][jj][2], ah[1], al[1]);
          split_tf32(sc[sl][jj][1], ah[2], al[2]);
          split_tf32(sc[sl][jj][3], ah[3], al[3]);
          mma_3xtf32(pv[sl], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int sl = 0; sl < QS; ++sl)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[sl][e] += pv[sl][e];
    } else {
      if (s == nc - 1) {  // end of pass 1: 1 / the rows' whole sums
#pragma unroll
        for (int sl = 0; sl < QS; ++sl) {
          l[sl][0] = __frcp_rn(quad_sum(l[sl][0]));
          l[sl][1] = __frcp_rn(quad_sum(l[sl][1]));
        }
      }
      if (s >= nc) {
        // pass 2: P rounded to bf16, then P.V
#pragma unroll
        for (int kb2 = 0; kb2 < NJ / 2; ++kb2) {
          if (16 * kb2 >= kv) break;
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, vs + (16 * kb2 + (lane & 15)) * PKV + hd);
#pragma unroll
          for (int sl = 0; sl < QS; ++sl) {
            uint32_t a[4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float* p = sc[sl][2 * kb2 + u];
              a[2 * u] = pack_bf16(p[0], p[1]);
              a[2 * u + 1] = pack_bf16(p[2], p[3]);
            }
            mma_bf16_16816(o[sl], a, bf);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
  }

#pragma unroll
  for (int sl = 0; sl < QS; ++sl) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = F32 ? __frcp_rn(quad_sum(l[sl][h])) : 1.0f;
      const int row = r0 + 16 * sl + g + 8 * h;
      if (row >= Tn) continue;
      T* out = ob + (size_t)row * S + hd + 2 * t;
      out[0] = from_f<T>(o[sl][2 * h] * inv);
      out[1] = from_f<T>(o[sl][2 * h + 1] * inv);
    }
  }
}

struct LaCall {
  LaBranches br;
  const void* mask;
  bool mask_bf16;
  int nb, B, Tn, S;
  cudaStream_t stream;
};

template <typename T, int W, bool MUL, bool MBF16>
static int launch_la(const LaCall& a) {
  auto kernel = ladder_attention_kernel<T, W, MUL, MBF16>;
  const int smem = la_ring_bytes<T, W>() +
                   (a.Tn + kLaKC - 1) / kLaKC * kLaKC * (int)sizeof(float);
  static int attr_bytes = 0;  // the largest set, per instantiation
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes = smem;
  }
  constexpr int qt = 16 * kLaQS;
  dim3 grid((a.Tn + qt - 1) / qt, a.nb, a.B);
  kernel<<<grid, 4 * a.S, smem, a.stream>>>(a.br, a.mask, a.S, a.Tn);
  return (int)cudaGetLastError();
}

template <typename T, bool MUL, bool MBF16>
static int la_pick_w(const LaCall& a) {
  switch ((a.S + 31) / 32) {
    case 1: return launch_la<T, 32, MUL, MBF16>(a);
    case 2: return launch_la<T, 64, MUL, MBF16>(a);
    case 3: return launch_la<T, 96, MUL, MBF16>(a);
    case 4: return launch_la<T, 128, MUL, MBF16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the mask's dtype: fp32, or bf16 with bf16 activations
template <typename T, bool MUL>
static int la_pick_mask(const LaCall& a) {
  if constexpr (sizeof(T) == 2)
    if (a.mask_bf16) return la_pick_w<T, MUL, true>(a);
  if (a.mask_bf16) return (int)cudaErrorInvalidValue;
  return la_pick_w<T, MUL, false>(a);
}

}  // namespace ag

using namespace ag;

// The shapes the one-launch kernel takes: S a multiple of 8 up to 128 in
// S / 8 heads (d = 8), 1 to kLaMaxBranches branches.
extern "C" int ag_ladder_attention_supports(int S, int n_heads, int nb) {
  return S % 8 == 0 && S >= 8 && S <= kLaMaxS && n_heads * 8 == S &&
         nb >= 1 && nb <= kLaMaxBranches;
}

// q, k, v, out: nb pointers each to a contiguous <B, Tn, S> tensor (16-byte
// aligned); mask <B, Tn>: fp32, or bf16 (mask_bf16) with bf16 activations.
// T is bounded by the shared memory its mask row takes (~40,000 keys).
extern "C" int ag_ladder_attention(int dtype, int mul, int nb,
                                   const void* const* q, const void* const* k,
                                   const void* const* v, void* const* out,
                                   const void* mask, int mask_bf16, int B,
                                   int Tn, int S, void* stream) {
  if (!ag_ladder_attention_supports(S, S / 8, nb) || B <= 0 || B > 65535 ||
      Tn <= 0 || Tn > 32768)
    return (int)cudaErrorInvalidValue;
  LaCall a;
  for (int i = 0; i < nb; ++i) {
    a.br.q[i] = q[i];
    a.br.k[i] = k[i];
    a.br.v[i] = v[i];
    a.br.o[i] = out[i];
  }
  a.mask = mask;
  a.mask_bf16 = mask_bf16 != 0;
  a.nb = nb;
  a.B = B;
  a.Tn = Tn;
  a.S = S;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return mul ? la_pick_mask<float, true>(a) : la_pick_mask<float, false>(a);
  if (dtype == kBF16)
    return mul ? la_pick_mask<__nv_bfloat16, true>(a)
               : la_pick_mask<__nv_bfloat16, false>(a);
  return (int)cudaErrorInvalidValue;
}
