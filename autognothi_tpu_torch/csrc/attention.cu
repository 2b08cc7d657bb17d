// Masked multi-head attention core, the one attention kernel of the port:
// - inside the fused attention and ladder blocks (the in-kernel attention
//   of autognothi_tpu/ops/attention_block.py:_kernel, `_heads_attention`,
//   and of autognothi_tpu/ops/ladder_block.py:_kernel, `_branch_math`),
//   reading the packed Q/K/V projections <B*T, 3H> that the GEMM wrote and
//   writing the head-merged context <B*T, H>;
// - standalone, as the split-head masked attention of
//   autognothi_tpu/ops/flash_attention.py:_masked_attention_impl (K9) on
//   <N, h, T, D>, and once per branch as the ladder attention of
//   autognothi_tpu/ops/ladder_block.py:_make_attn_fn (K10) on <B, T, S>.
// Q, K, V and the output are separate pointers, each with its own (batch,
// head, row) element strides; rows are contiguous.
//
// One block of 8 warps per (query tile of 64, head, image).  The image's K
// and V for that head are staged in shared memory as fp32 (K rows padded to
// D + 4 floats so the lanes' float4 reads of different keys hit different
// banks).  Each warp takes one query at a time, with q in registers: every
// lane scores up to MAXJ keys (j = lane + 32 jj), scores * 1/sqrt(d) are
// multiplied by the 0/1 mask ("mul", the ViT quirk: a masked score becomes
// 0 and keeps weight exp(0 - max)) or added to the bias ("add", BERT), the
// fp32 softmax reduces across the warp with shuffles, and the
// probabilities, rounded to the activation dtype (the JAX cast to v's
// dtype), go to a per-warp row in shared memory.  P.V accumulates in fp32:
// for d >= 32 each lane owns d/32 output columns; for d < 32 the warp
// splits the keys over 32/d lane groups and sums the groups with shuffles,
// so all 32 lanes work at d = 8.  The <B, heads, T, T> scores and
// probabilities never reach device memory.
//
// Long sequences (BERT at T = 512, d = 64): the whole head's K and V in fp32
// need 288,768 B, more than a block's 227 KB, so the chunked variant walks
// the keys in chunks of kAttKC that fit, in two passes.  Each warp owns 8 of
// the block's 64 queries (staged in shared memory) and keeps each query's
// row state in registers.  Pass 1 takes the row max and the softmax sum
// over the chunks (online: the sum is rescaled when the max grows); pass 2
// recomputes each chunk's scores, rounds p = exp(s - max) / sum to the
// activation dtype (the JAX rounding point, unchanged) and accumulates P.V
// in fp32.  The mask rules are the same.  Shapes that fit one stage keep the
// one-stage kernel.
//
// What bounds it on the H100: fp32 FMA issue and shared-memory bandwidth of
// the Q.K and P.V loops, and re-staging K and V for every 64-query tile (the
// chunked variant computes Q.K twice).  Flash-style mma tiles are the work
// of later changes.

#include "common.cuh"

namespace ag {

constexpr int kAttWarps = 8;
constexpr int kAttQT = 64;  // queries per block
constexpr int kAttKC = 128;  // keys per chunk (chunked variant)
constexpr int kAttQPW = kAttQT / kAttWarps;  // queries per warp (chunked)
constexpr long long kMaxSmem = 232448;  // dynamic shared memory of a block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Where q, k, v and the output lie: element strides of the batch, head and
// row dimensions of each <N, heads, T, D> view (rows contiguous).
struct HeadViews {
  long long sb[4], sh[4], st[4];  // [q, k, v, out]
};

template <typename T, bool MUL, int MAXJ, int D>
__global__ void __launch_bounds__(kAttWarps * 32)
    attention_kernel(const T* __restrict__ qp, const T* __restrict__ kp,
                     const T* __restrict__ vp, const float* __restrict__ mask,
                     T* __restrict__ op, HeadViews views, int Tn) {
  constexpr int KS = D + 4;  // K row stride: 16-byte rows, no bank conflicts
  extern __shared__ float4 smem4[];
  const int TP = round4(Tn);  // rows padded to whole float4s of p
  float* Ks = reinterpret_cast<float*>(smem4);  // TP x KS
  float* Vs = Ks + TP * KS;                     // TP x D (pad rows zero)
  float* Ms = Vs + TP * D;                      // TP
  float* Ps = Ms + TP;                          // kAttWarps x TP

  const int b = blockIdx.z, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = qp + b * views.sb[0] + head * views.sh[0];
  const T* kb = kp + b * views.sb[1] + head * views.sh[1];
  const T* vb = vp + b * views.sb[2] + head * views.sh[2];
  T* ob = op + b * views.sb[3] + head * views.sh[3];
  const long long kst = views.st[1], vst = views.st[2];

  for (int idx = threadIdx.x; idx < TP * D; idx += blockDim.x) {
    const int j = idx / D, c = idx % D;
    float k = 0.f, v = 0.f;
    if (j < Tn) {
      k = to_f(kb[j * kst + c]);
      v = to_f(vb[j * vst + c]);
    }
    Ks[j * KS + c] = k;
    Vs[j * D + c] = v;
  }
  for (int j = threadIdx.x; j < TP; j += blockDim.x)
    Ms[j] = j < Tn ? mask[(size_t)b * Tn + j] : 0.f;
  __syncthreads();

  float* p = Ps + warp * TP;
  const float scale = 1.0f / sqrtf((float)D);
  const int q_end = min(Tn, (int)(blockIdx.x + 1) * kAttQT);
  for (int i = blockIdx.x * kAttQT + warp; i < q_end; i += kAttWarps) {
    float q[D];
    const T* qrow = qb + i * views.st[0];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = to_f(qrow[c]);

    float s[MAXJ];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      const int j = lane + 32 * jj;
      s[jj] = -INFINITY;
      if (j < Tn) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * KS);
        float dot = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 k4 = kr[c4];
          dot = fmaf(q[4 * c4], k4.x, dot);
          dot = fmaf(q[4 * c4 + 1], k4.y, dot);
          dot = fmaf(q[4 * c4 + 2], k4.z, dot);
          dot = fmaf(q[4 * c4 + 3], k4.w, dot);
        }
        float sc = dot * scale;
        sc = MUL ? sc * Ms[j] : sc + Ms[j];
        s[jj] = sc;
        mx = fmaxf(mx, sc);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      if (lane + 32 * jj < Tn) {
        s[jj] = expf(s[jj] - mx);
        sum += s[jj];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < Tn)
        p[j] = round_to<T>(s[jj] / sum);
      else if (j < TP)
        p[j] = 0.f;
    }
    __syncwarp();

    T* out = ob + i * views.st[3];
    if constexpr (D >= 32) {
      constexpr int CPL = D / 32;  // output columns per lane
      float acc[CPL];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) acc[cc] = 0.f;
      for (int j = 0; j < TP; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(p + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            acc[cc] = fmaf(pj[u], Vs[(j + u) * D + lane + 32 * cc], acc[cc]);
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) out[lane + 32 * cc] = from_f<T>(acc[cc]);
    } else {
      constexpr int G = 32 / D;  // lane groups splitting the keys
      const int c = lane % D, g = lane / D;
      float acc = 0.f;
      for (int j = g; j < Tn; j += G) acc = fmaf(p[j], Vs[j * D + c], acc);
#pragma unroll
      for (int off = D; off < 32; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) out[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

// The chunked variant (d >= 32).  Shared memory (floats): Qs kAttQT x D,
// Ks kAttKC x (D + 4), Vs kAttKC x D, Ms kAttKC, Ps kAttWarps x kAttKC.
template <typename T, bool MUL, int D>
__global__ void __launch_bounds__(kAttWarps * 32)
    attention_chunked_kernel(const T* __restrict__ qp,
                             const T* __restrict__ kp,
                             const T* __restrict__ vp,
                             const float* __restrict__ mask,
                             T* __restrict__ op, HeadViews views, int Tn) {
  static_assert(D >= 32 && D % 32 == 0, "chunked core: d >= 32");
  constexpr int KS = D + 4;
  constexpr int JPL = kAttKC / 32;  // keys of a chunk per lane
  constexpr int CPL = D / 32;       // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kAttQT x D
  float* Ks = Qs + kAttQT * D;                  // kAttKC x KS
  float* Vs = Ks + kAttKC * KS;                 // kAttKC x D
  float* Ms = Vs + kAttKC * D;                  // kAttKC
  float* Ps = Ms + kAttKC;                      // kAttWarps x kAttKC

  const int b = blockIdx.z, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttQT;
  const T* qb = qp + b * views.sb[0] + head * views.sh[0];
  const T* kb = kp + b * views.sb[1] + head * views.sh[1];
  const T* vb = vp + b * views.sb[2] + head * views.sh[2];
  T* ob = op + b * views.sb[3] + head * views.sh[3];
  const float scale = 1.0f / sqrtf((float)D);

  for (int idx = threadIdx.x; idx < kAttQT * D; idx += blockDim.x) {
    const int i = q0 + idx / D;
    Qs[idx] = i < Tn ? to_f(qb[i * views.st[0] + idx % D]) : 0.f;
  }

  // stage keys [c0, c0 + kAttKC) (and their values when V is set)
  auto stage = [&](int c0, bool with_v) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < kAttKC * D; idx += blockDim.x) {
      const int j = idx / D, c = idx % D, jg = c0 + j;
      const bool ok = jg < Tn;
      Ks[j * KS + c] = ok ? to_f(kb[jg * views.st[1] + c]) : 0.f;
      if (with_v) Vs[j * D + c] = ok ? to_f(vb[jg * views.st[2] + c]) : 0.f;
    }
    for (int j = threadIdx.x; j < kAttKC; j += blockDim.x)
      Ms[j] = c0 + j < Tn ? mask[(size_t)b * Tn + c0 + j] : 0.f;
    __syncthreads();
  };

  // the masked, scaled scores of query row qi against the staged chunk;
  // keys past Tn are -inf
  auto scores = [&](int qi, int c0, float (&s)[JPL]) {
    float q[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = Qs[qi * D + c];
#pragma unroll
    for (int jj = 0; jj < JPL; ++jj) {
      const int j = lane + 32 * jj;
      s[jj] = -INFINITY;
      if (c0 + j < Tn) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * KS);
        float dot = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 k4 = kr[c4];
          dot = fmaf(q[4 * c4], k4.x, dot);
          dot = fmaf(q[4 * c4 + 1], k4.y, dot);
          dot = fmaf(q[4 * c4 + 2], k4.z, dot);
          dot = fmaf(q[4 * c4 + 3], k4.w, dot);
        }
        const float sc = dot * scale;
        s[jj] = MUL ? sc * Ms[j] : sc + Ms[j];
      }
    }
  };

  // pass 1: row max and softmax sum
  float mx[kAttQPW], sum[kAttQPW];
#pragma unroll
  for (int u = 0; u < kAttQPW; ++u) {
    mx[u] = -INFINITY;
    sum[u] = 0.f;
  }
  for (int c0 = 0; c0 < Tn; c0 += kAttKC) {
    stage(c0, false);
#pragma unroll
    for (int u = 0; u < kAttQPW; ++u) {
      const int qi = warp + kAttWarps * u;
      if (q0 + qi >= Tn) continue;  // warp-uniform
      float s[JPL];
      scores(qi, c0, s);
      float cm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj) cm = fmaxf(cm, s[jj]);
      const float m_new = fmaxf(mx[u], warp_max(cm));
      float cs = 0.f;
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj)
        if (c0 + lane + 32 * jj < Tn) cs += expf(s[jj] - m_new);
      sum[u] = sum[u] * expf(mx[u] - m_new) + warp_sum(cs);
      mx[u] = m_new;
    }
  }

  // pass 2: rounded probabilities times V
  float acc[kAttQPW][CPL];
#pragma unroll
  for (int u = 0; u < kAttQPW; ++u)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[u][cc] = 0.f;
  float* p = Ps + warp * kAttKC;
  for (int c0 = 0; c0 < Tn; c0 += kAttKC) {
    stage(c0, true);
#pragma unroll
    for (int u = 0; u < kAttQPW; ++u) {
      const int qi = warp + kAttWarps * u;
      if (q0 + qi >= Tn) continue;  // warp-uniform
      float s[JPL];
      scores(qi, c0, s);
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj) {
        const int j = lane + 32 * jj;
        p[j] = c0 + j < Tn ? round_to<T>(expf(s[jj] - mx[u]) / sum[u]) : 0.f;
      }
      __syncwarp();
      for (int j = 0; j < kAttKC; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(p + j);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            acc[u][cc] = fmaf(pj[w], Vs[(j + w) * D + lane + 32 * cc],
                              acc[u][cc]);
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int u = 0; u < kAttQPW; ++u) {
    const int i = q0 + warp + kAttWarps * u;
    if (i >= Tn) continue;
    T* out = ob + i * views.st[3];
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) out[lane + 32 * cc] = from_f<T>(acc[u][cc]);
  }
}

struct AttnCall {
  const void *q, *k, *v;
  const float* mask;
  void* out;
  HeadViews views;
  int N, Tn, nh;
  size_t smem;
  cudaStream_t stream;
};

template <typename T, bool MUL, int MAXJ, int D>
static int launch_attention(const AttnCall& a) {
  auto kernel = attention_kernel<T, MUL, MAXJ, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tn + kAttQT - 1) / kAttQT, a.nh, a.N);
  kernel<<<grid, kAttWarps * 32, a.smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.views,
      a.Tn);
  return (int)cudaGetLastError();
}

template <typename T, bool MUL, int D>
static int launch_attention_chunked(const AttnCall& a) {
  auto kernel = attention_chunked_kernel<T, MUL, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tn + kAttQT - 1) / kAttQT, a.nh, a.N);
  kernel<<<grid, kAttWarps * 32, a.smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.views,
      a.Tn);
  return (int)cudaGetLastError();
}

template <typename T, bool MUL, int MAXJ>
static int pick_d(int d, const AttnCall& a) {
  switch (d) {
    case 8: return launch_attention<T, MUL, MAXJ, 8>(a);
    case 16: return launch_attention<T, MUL, MAXJ, 16>(a);
    case 32: return launch_attention<T, MUL, MAXJ, 32>(a);
    case 64: return launch_attention<T, MUL, MAXJ, 64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

static long long one_stage_smem_bytes(int Tn, int d) {
  const long long tp = round4(Tn);
  return (long long)sizeof(float) *
         (tp * (d + 4) + tp * d + tp + (long long)kAttWarps * tp);
}

static long long chunked_smem_bytes(int d) {
  return (long long)sizeof(float) *
         ((long long)kAttQT * d + kAttKC * (d + 4) + kAttKC * d + kAttKC +
          kAttWarps * kAttKC);
}

// The chunked variant where one stage exceeds a block's shared memory (at
// T <= 512 only d = 64 does).
static bool chunked(int Tn, int d) {
  return one_stage_smem_bytes(Tn, d) > kMaxSmem;
}

template <typename T, bool MUL>
static int pick_maxj(int d, const AttnCall& a) {
  if (chunked(a.Tn, d))
    return d == 64 ? launch_attention_chunked<T, MUL, 64>(a)
                   : (int)cudaErrorInvalidValue;
  if (a.Tn <= 32 * 8) return pick_d<T, MUL, 8>(d, a);
  if (a.Tn <= 32 * 16) return pick_d<T, MUL, 16>(d, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ag

using namespace ag;

// Dynamic shared memory the attention core needs at (T, d), in bytes: the
// one-stage kernel's where it fits a block, else the chunked variant's.
extern "C" long long ag_attention_smem_bytes(int Tn, int d) {
  return chunked(Tn, d) ? chunked_smem_bytes(d) : one_stage_smem_bytes(Tn, d);
}

// Head dims the core is compiled for; others are refused.
extern "C" int ag_attention_supports(int Tn, int d) {
  return (d == 8 || d == 16 || d == 32 || d == 64) && Tn >= 1 &&
         Tn <= 32 * 16;
}

// q, k, v, out: <N, nh, Tn, d> views; strides[12] holds the (batch, head,
// row) element strides of q, k, v and out, in that order.
extern "C" int ag_attention(int dtype, int mul, const void* q, const void* k,
                            const void* v, const long long* strides,
                            const void* mask, void* out, int N, int Tn,
                            int nh, int d, void* stream) {
  if (nh <= 0 || N <= 0 || !ag_attention_supports(Tn, d))
    return (int)cudaErrorInvalidValue;
  AttnCall a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  for (int i = 0; i < 4; ++i) {
    a.views.sb[i] = strides[3 * i];
    a.views.sh[i] = strides[3 * i + 1];
    a.views.st[i] = strides[3 * i + 2];
  }
  a.N = N;
  a.Tn = Tn;
  a.nh = nh;
  a.smem = (size_t)ag_attention_smem_bytes(Tn, d);
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return mul ? pick_maxj<float, true>(d, a) : pick_maxj<float, false>(d, a);
  if (dtype == kBF16)
    return mul ? pick_maxj<__nv_bfloat16, true>(d, a)
               : pick_maxj<__nv_bfloat16, false>(d, a);
  return (int)cudaErrorInvalidValue;
}
