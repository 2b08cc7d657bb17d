// Masked multi-head attention core on the tensor cores, the one attention
// kernel of the port:
// - inside the fused attention blocks (the in-kernel attention of
//   autognothi_tpu/ops/attention_block.py:_kernel, `_heads_attention`, K6
//   and K1), reading the packed Q/K/V projections <B*T, 3H> that the GEMM
//   wrote and writing the head-merged context <B*T, H> (the ladder's side
//   attention, K5 and K2, has its own kernel in `ladder.cu`);
// - standalone, as the split-head masked attention of
//   autognothi_tpu/ops/flash_attention.py:_masked_attention_impl (K9) on
//   <N, h, T, D>, and once per branch as the ladder attention of
//   autognothi_tpu/ops/ladder_block.py:_make_attn_fn (K10) on <B, T, S>.
// Q, K, V and the output are separate pointers, each with its own (batch,
// head, row) element strides; rows are contiguous.
//
// Math, as the JAX kernels: s = (q . k) * 1/sqrt(d) in fp32, times the 0/1
// mask ("mul", the ViT quirk: a masked score becomes 0 and keeps weight
// exp(0 - max)) or plus the fp32 bias ("add", BERT's finfo.min); keys past T
// are -inf; fp32 softmax; p rounded to v's dtype; P.V summed in fp32; rows
// past T are not written.
//
// Design, flash-style: one block of 4 warps per (64 queries, head, image);
// each warp owns 16 query rows, with its Q fragments in registers.  K and V
// are staged in chunks of 64 keys in shared memory, in the activation dtype,
// through a double-buffered cp.async ring (rows padded so the fragment reads
// are bank-conflict-free), with the chunk's mask values beside them.
// Scores come from mma.sync into fp32 accumulators: bf16 m16n8k16 (m16n8k8
// at d = 8) with K fragments by ldmatrix, exact products summed in fp32;
// fp32 as 3xTF32 (each operand split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), hi*hi + hi*lo + lo*hi accumulated in fp32, ~2^-21
// relative: fp32-grade).  The softmax stays in registers (quad shuffles for
// the row max and sum; exp by the fast ex2-based __expf, a few ulp), and P
// goes from the score accumulators straight into the A fragments of P.V:
// - bf16 keeps the JAX rounding point exactly: pass 1 over the chunks takes
//   each row's max and sum, pass 2 recomputes the scores, rounds p =
//   exp(s - max) * (1 / sum) to bf16 and runs P.V (V fragments by
//   ldmatrix.trans);
// - fp32 rounds p to fp32, the identity, so it takes one pass with an online
//   softmax (the output rescaled when the row max grows, divided by the sum
//   at the end): one Q.K instead of two, each three tf32 products.  P enters
//   the tf32 A fragment with its keys permuted within each group of 8 (the
//   accumulator holds keys 2t, 2t + 1; the fragment wants t, t + 4), and
//   the V rows are read in the same order.
// The <B, heads, T, T> scores and probabilities never reach device memory.
//
// What bounds it on the H100: mma.sync issue and, per score, the softmax's
// scalar work (mask, max, exp; bf16 twice); in fp32 also the register
// splits of K and V, which every warp of a block repeats (d = 64 fp32 holds
// 208 registers).  At T = 197 the 64-key chunks pad the keys to 256; the
// warps whose 16 query rows all lie past T skip their work (13 of the 16
// warps of a head's four blocks work).  Measured on an H100 80GB HBM3
// (700 W), "add", device time (`kernel_ab.py`): <256, 12, 197, 64> fp32
// 1.10 ms, bf16 0.55 ms; <8, 12, 512, 64> fp32 0.144 ms, bf16 0.077 ms
// (SDPA, CUDA events in `chip_smoke.py`: fp32 1.71 / 0.238 ms, bf16 0.50 /
// 0.057-0.064 ms).  bf16 is slower than SDPA because it takes Q.K and exp
// twice per score to round p where JAX does.  wgmma with the softmax
// overlapped across warp groups (as FlashAttention-3) is the next step.

#include "common.cuh"

namespace ag {

constexpr int kAttWarps = 4;
constexpr int kAttQT = 16 * kAttWarps;  // queries per block
constexpr int kAttKC = 64;              // keys per staged chunk

// Where q, k, v and the output lie: element strides of the batch, head and
// row dimensions of each <N, heads, T, D> view (rows contiguous).
struct HeadViews {
  long long sb[4], sh[4], st[4];  // [q, k, v, out]
};

// Shared-memory row pitch (elements) of a staged K or V chunk: fp32 d + 4
// words (conflict-free 32-bit fragment reads of K rows and of V row pairs),
// bf16 max(d, 16) + 8 (16-byte rows, conflict-free words and ldmatrix).
template <typename T, int D>
__host__ __device__ constexpr int att_pitch() {
  return sizeof(T) == 4 ? D + 4 : (D < 16 ? 16 : D) + 8;
}

// two stages of K and V chunks and of the chunk's mask values
template <typename T, int D>
__host__ __device__ constexpr long long att_smem_bytes() {
  return 2LL * 2 * kAttKC * att_pitch<T, D>() * (long long)sizeof(T) +
         2LL * kAttKC * (long long)sizeof(float);
}

template <typename T, bool MUL, int D, bool MBF16>
__global__ void __launch_bounds__(kAttWarps * 32)
    attention_tc_kernel(const T* __restrict__ qp, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const void* __restrict__ mask, T* __restrict__ op,
                        HeadViews views, int Tn) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool TWO_PASS = !F32;  // bf16: the JAX rounding point of p
  constexpr int P = att_pitch<T, D>();
  constexpr int NJ = kAttKC / 8;   // score tiles (8 keys) per chunk
  constexpr int ND = D / 8;        // output tiles (8 dims)
  constexpr int CE = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = D / CE;      // 16-byte copies per row
  // Q fragments per row block: fp32 k8 steps, bf16 k16 steps (one k8 at d=8)
  constexpr int QK = F32 ? D / 8 : (D >= 16 ? D / 16 : 1);

  extern __shared__ __align__(16) unsigned char att_smem[];
  T* Ks = reinterpret_cast<T*>(att_smem);  // [2][kAttKC][P]
  T* Vs = Ks + 2 * kAttKC * P;             // [2][kAttKC][P]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * kAttKC * P);  // [2][kAttKC]

  const int b = blockIdx.z, head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = qp + b * views.sb[0] + head * views.sh[0];
  const T* kb = kp + b * views.sb[1] + head * views.sh[1];
  const T* vb = vp + b * views.sb[2] + head * views.sh[2];
  T* ob = op + b * views.sb[3] + head * views.sh[3];
  const long long kst = views.st[1], vst = views.st[2];
  const size_t m0 = (size_t)b * Tn;  // the image's first mask value
  const float scale = 1.0f / sqrtf((float)D);
  const int r0 = blockIdx.x * kAttQT + warp * 16;  // the warp's first row
  const int nc = (Tn + kAttKC - 1) / kAttKC;
  const int steps = TWO_PASS ? 2 * nc : nc;

  // step s stages chunk s % nc: K only in bf16's pass 1, K and V otherwise;
  // keys past T are zero-filled (P.V then multiplies them by p = 0).  The
  // chunk's mask values (any alignment) are read into a register here and
  // stored to shared memory at the end of the step before they are used.
  float m_next = 0.f;
  auto load = [&](int s, int buf) {
    const int j0 = (s < nc ? s : s - nc) * kAttKC;
    const bool with_v = !TWO_PASS || s >= nc;
    T* ks = Ks + buf * kAttKC * P;
    T* vs = Vs + buf * kAttKC * P;
    for (int idx = tid; idx < kAttKC * CPR; idx += kAttWarps * 32) {
      const int j = idx / CPR, c = (idx % CPR) * CE;
      const bool ok = j0 + j < Tn;
      cp_async16(ks + j * P + c, ok ? kb + (j0 + j) * kst + c : kb, ok);
      if (with_v)
        cp_async16(vs + j * P + c, ok ? vb + (j0 + j) * vst + c : vb, ok);
    }
    cp_async_commit();
    if (tid < kAttKC)
      m_next = j0 + tid < Tn ? mask_at<MBF16>(mask, m0 + j0 + tid) : 0.f;
  };
  load(0, 0);
  if (tid < kAttKC) Ms[tid] = m_next;

  // the warp's Q fragments (rows past T are zero); fp32 keeps the raw bits
  uint32_t qa[QK][4];
  {
    const int rows[2] = {r0 + g, r0 + g + 8};
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e & 1];
        uint32_t v = 0;
        if (row < Tn && (F32 || D >= 16 || e < 2)) {
          const T* q = qb + row * views.st[0];
          if constexpr (F32) {
            v = __float_as_uint(q[8 * kk + t + 4 * (e >> 1)]);
          } else {
            v = *reinterpret_cast<const uint32_t*>(q + 16 * kk + 2 * t +
                                                    8 * (e >> 1));
          }
        }
        qa[kk][e] = v;
      }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};               // this thread's share of the sum

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
    const int j0 = (s < nc ? s : s - nc) * kAttKC;
    const T* ks = Ks + buf * kAttKC * P;
    const T* vs = Vs + buf * kAttKC * P;

    // a warp whose 16 rows all lie past T (in the last query tile)
    // computes nothing; it still stages chunks and meets the barriers
    if (r0 < Tn) {
      // scores of the warp's 16 rows against the chunk's 64 keys
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      if constexpr (F32) {
        const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
        for (int kk = 0; kk < QK; ++kk) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(qa[kk][e]), ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* bp = kf + (8 * j + g) * P + 8 * kk + t;
            uint32_t bh[2], bl[2];
            split_tf32(bp[0], bh[0], bl[0]);
            split_tf32(bp[4], bh[1], bl[1]);
            mma_3xtf32(sc[j], ah, al, bh, bl);
          }
        }
      } else if constexpr (D >= 16) {
        // K fragments by ldmatrix.x4: two key tiles x (dims 0-7, 8-15)
#pragma unroll
        for (int kk = 0; kk < QK; ++kk)
#pragma unroll
          for (int j = 0; j < NJ; j += 2) {
            uint32_t r4[4];
            ldmatrix_x4(r4, ks + (8 * j + (lane & 7) + 8 * (lane >> 4)) * P +
                                16 * kk + 8 * ((lane >> 3) & 1));
            mma_bf16_16816(sc[j], qa[kk], r4);
            mma_bf16_16816(sc[j + 1], qa[kk], r4 + 2);
          }
      } else {
        // d = 8: ldmatrix.x4 gives the fragments of four key tiles
#pragma unroll
        for (int j = 0; j < NJ; j += 4) {
          uint32_t r4[4];
          ldmatrix_x4(r4, ks + (8 * j + lane) * P);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_bf16_1688(sc[j + u], qa[0], r4 + u);
        }
      }
      float cm[2] = {-INFINITY, -INFINITY};
      const float* ms = Ms + buf * kAttKC;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * j + 2 * t + (e & 1);
          float v = -INFINITY;
          if (key < Tn) {
            const float m = (e & 1) ? m2.y : m2.x;
            v = sc[j][e] * scale;
            v = MUL ? v * m : v + m;
          }
          sc[j][e] = v;
          cm[e >> 1] = fmaxf(cm[e >> 1], v);
        }
      }
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
        for (int j = 0; j < NJ; ++j)
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
        // online P.V: rescale, then add this chunk's exp(s - max) . V
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
        const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          // keys 2t, 2t + 1 of the group as the fragment's k = t, t + 4
          uint32_t ah[4], al[4];
          split_tf32(sc[jj][0], ah[0], al[0]);
          split_tf32(sc[jj][2], ah[1], al[1]);
          split_tf32(sc[jj][1], ah[2], al[2]);
          split_tf32(sc[jj][3], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const float* bp = vf + (8 * jj + 2 * t) * P + 8 * n + g;
            uint32_t bh[2], bl[2];
            split_tf32(bp[0], bh[0], bl[0]);
            split_tf32(bp[P], bh[1], bl[1]);
            mma_3xtf32(o[n], ah, al, bh, bl);
          }
        }
      } else {
        if (s == nc - 1) {  // end of pass 1: 1 / the rows' whole sums
          l[0] = __frcp_rn(quad_sum(l[0]));
          l[1] = __frcp_rn(quad_sum(l[1]));
        }
        if (s >= nc) {
          // pass 2: p = exp(s - max) / sum rounded to bf16, then P.V
#pragma unroll
          for (int kb2 = 0; kb2 < NJ / 2; ++kb2) {
            uint32_t a[4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float* c = sc[2 * kb2 + u];
              a[2 * u] = pack_bf16(__expf(c[0] - mx[0]) * l[0],
                                   __expf(c[1] - mx[0]) * l[0]);
              a[2 * u + 1] = pack_bf16(__expf(c[2] - mx[1]) * l[1],
                                       __expf(c[3] - mx[1]) * l[1]);
            }
            if constexpr (ND % 2 == 0) {
              // x4.trans: the V fragments of two dim tiles
#pragma unroll
              for (int n = 0; n < ND; n += 2) {
                uint32_t r4[4];
                ldmatrix_x4_trans(r4, vs + (16 * kb2 + (lane & 15)) * P +
                                          8 * n + 8 * (lane >> 4));
                mma_bf16_16816(o[n], a, r4);
                mma_bf16_16816(o[n + 1], a, r4 + 2);
              }
            } else {
              uint32_t bf[2];
              ldmatrix_x2_trans(bf, vs + (16 * kb2 + (lane & 15)) * P);
              mma_bf16_16816(o[0], a, bf);
            }
          }
        }
      }
    }
    // the next chunk's mask values, read when its load was issued
    if (s + 1 < steps && tid < kAttKC)
      Ms[((s + 1) & 1) * kAttKC + tid] = m_next;
    __syncthreads();  // the buffer is refilled two steps on
  }

  if constexpr (F32) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= Tn) continue;
    T* out = ob + row * views.st[3];
    const float inv = F32 ? __frcp_rn(l[h]) : 1.0f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = o[n][2 * h + e];
        out[8 * n + 2 * t + e] = from_f<T>(F32 ? v * inv : v);
      }
  }
}

struct AttnCall {
  const void *q, *k, *v;
  const void* mask;
  bool mask_bf16;
  void* out;
  HeadViews views;
  int N, Tn, nh;
  cudaStream_t stream;
};

template <typename T, bool MUL, int D, bool MBF16>
static int launch_attention(const AttnCall& a) {
  auto kernel = attention_tc_kernel<T, MUL, D, MBF16>;
  constexpr int smem = (int)att_smem_bytes<T, D>();
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((a.Tn + kAttQT - 1) / kAttQT, a.nh, a.N);
  kernel<<<grid, kAttWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.views,
      a.Tn);
  return (int)cudaGetLastError();
}

template <typename T, bool MUL, bool MBF16>
static int pick_d(int d, const AttnCall& a) {
  switch (d) {
    case 8: return launch_attention<T, MUL, 8, MBF16>(a);
    case 16: return launch_attention<T, MUL, 16, MBF16>(a);
    case 32: return launch_attention<T, MUL, 32, MBF16>(a);
    case 64: return launch_attention<T, MUL, 64, MBF16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the mask's dtype: fp32, or bf16 with bf16 activations
template <typename T, bool MUL>
static int pick_mask(int d, const AttnCall& a) {
  if constexpr (sizeof(T) == 2)
    if (a.mask_bf16) return pick_d<T, MUL, true>(d, a);
  if (a.mask_bf16) return (int)cudaErrorInvalidValue;
  return pick_d<T, MUL, false>(d, a);
}

}  // namespace ag

using namespace ag;

// Head dims the core is compiled for; others are refused.
extern "C" int ag_attention_supports(int Tn, int d) {
  return (d == 8 || d == 16 || d == 32 || d == 64) && Tn >= 1 && Tn <= 512;
}

// q, k, v, out: <N, nh, Tn, d> views; strides[12] holds the (batch, head,
// row) element strides of q, k, v and out, in that order.  q, k and v must
// be 16-byte aligned with strides of whole 16 bytes (cp.async and the
// 32-bit Q fragment loads).  mask <N, Tn>: fp32, or bf16 (mask_bf16) with
// bf16 activations.
extern "C" int ag_attention(int dtype, int mul, const void* q, const void* k,
                            const void* v, const long long* strides,
                            const void* mask, int mask_bf16, void* out,
                            int N, int Tn, int nh, int d, void* stream) {
  if (nh <= 0 || N <= 0 || !ag_attention_supports(Tn, d))
    return (int)cudaErrorInvalidValue;
  AttnCall a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.mask_bf16 = mask_bf16 != 0;
  a.out = out;
  for (int i = 0; i < 4; ++i) {
    a.views.sb[i] = strides[3 * i];
    a.views.sh[i] = strides[3 * i + 1];
    a.views.st[i] = strides[3 * i + 2];
  }
  a.N = N;
  a.Tn = Tn;
  a.nh = nh;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return mul ? pick_mask<float, true>(d, a) : pick_mask<float, false>(d, a);
  if (dtype == kBF16)
    return mul ? pick_mask<__nv_bfloat16, true>(d, a)
               : pick_mask<__nv_bfloat16, false>(d, a);
  return (int)cudaErrorInvalidValue;
}
