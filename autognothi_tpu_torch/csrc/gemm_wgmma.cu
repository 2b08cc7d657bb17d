// The float GEMM on Hopper's TMA + wgmma, and the LayerNorm row pass that
// prepares its A operand.  K6, the float attention block
// (autognothi_tpu/ops/attention_block.py:_pallas_attention_block, body
// `_kernel`), runs its two products here: the packed Q|K|V projection
// (bias epilogue) and the out-projection (bias, cast, + residual); K5, the
// float ladder (autognothi_tpu/ops/ladder_block.py:_pallas_ladder), runs
// its side-in product here: h times every branch's map weight at once,
// with bias, exact GELU, the cast and the side added in the epilogue, each
// branch's columns written to its own output (`ladder.cu` has the rest).
// K8, a bf16 tile of the float intermediate-dim split
// (autognothi_tpu/ops/mlp_block.py:_pallas_mlp_sepx, body `_kernel_sepx`),
// runs its two products here: the tile's W1 rows with bias, exact GELU and
// the cast, then the tile's W2 column slice, read in place by TMA through
// its row stride, with bias, cast and the residual; 192-wide tiles at
// BERT-base B=8 (M = 4096: 256 tiles for W1, 128 for W2 on 132 SMs).
//
// C[m, n] = epilogue(sum_k A[m, k] W[n, k]) with A <M, K> and the torch
// (out, in) W <N, K>: both K-major, as tf32 wgmma requires and bf16 allows.
//
// Numerics, as `gemm.cu`: fp32 sums.  bf16: wgmma m64nNk16 on bf16 tiles
// (exact products).  fp32: 3xTF32 on wgmma m64nNk8 .tf32, hi = rna_tf32(x)
// and lo = rna_tf32(x - hi) of each operand, lo*hi + hi*lo + hi*hi into
// the accumulator; the tensor cores do not round their fp32 sums to
// nearest, so each 64-deep k slice (two 32-deep stages) sums into a fresh
// accumulator that a rounded fp32 add joins to the running sum.  The bias
// is added to the fp32 sum; values are rounded to the activation dtype
// where the JAX math casts (after bias or GELU; the projection before the
// residual add).
//
// The planes: the weights' hi and lo planes are made once per weight
// version (`ops/weight_codes.py`), and TMA loads both.  A is loaded once,
// as fp32, and each consumer thread splits its wgmma A fragments in
// registers (wgmma with A from registers), so no pass writes A's planes.
// The other form, A's two planes written by the pass that makes A (the
// LayerNorm prologue, or a split pass) and loaded by TMA, made the GEMM
// alone 1-7% faster but K6 as a whole 6% slower on an H100 at both trunk
// shapes (its passes write twice the bytes; PERF.md section 6), and was
// removed.  The ladder's side-in product reads h the same way, where a
// split pass would be a fifth launch of the ladder step.
//
// Design: persistent, warp-specialised, on the model of `int8.cu`'s int8
// GEMM.  One producer warp keeps a ring of 128-byte k slices (32 fp32 or
// 64 bf16 k) filled by TMA, 128-byte swizzled, each stage behind an
// mbarrier full/empty pair; two consumer warpgroups run wgmma on 64 rows
// each of a 128 x BN tile (setmaxnreg moves registers to them) and the
// epilogue from the accumulator registers while the producer loads the
// next tile.  BN = 96 for fp32 (two accumulators: the running sum and the
// slice's); bf16 256 where N is a multiple of 256 and at least 1536 (fewer
// bytes per product from L2, which bounds these tiles), else 128 or 96.
// TMA zero-fills rows past M and N and k past K.
//
// What bounds it: at K6's trunk products the operations (fp32-grade work
// against 495 / 3 TFLOP/s, bf16 against 989); at the ladder's side-in
// product (N = 96 per branch) the bytes of h.  Times on an H100 are in
// PERF.md.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace ag {

// ------------------------------------------------- wgmma, f32 accumulators
// D[64 x N] (+)= A[64 x k] B[N x k]^T with B K-major in shared memory
// (128-byte swizzle) and A there too (bf16) or in registers (tf32 _rs: the
// fragment of mma.m16n8k8 per warp, rows 16 w ... 16 w + 15); scale_d = 0
// overwrites D.

__device__ __forceinline__ void wgmma_bf16_n96(float* d, uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n192(float* d, uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n96(float* d, const uint32_t* a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n256(float* d, uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  if constexpr (BN == 256)
    wgmma_bf16_n256(d, a, b, scale_d);
  else if constexpr (BN == 192)
    wgmma_bf16_n192(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_bf16_n128(d, a, b, scale_d);
  else
    wgmma_bf16_n96(d, a, b, scale_d);
}

// ------------------------------------------------------------------ GEMM

enum EpiWg {
  kWgBias = 0,            // C = cast(acc + b)
  kWgBiasResid = 1,       // C = R + cast(acc + b)
  kWgGeluResidSplit = 2,  // C_br = R_br + cast(gelu(acc + b)), br = n / split
  kWgBiasGelu = 3         // C = cast(gelu(acc + b))
};

template <int EPI>
__host__ __device__ constexpr bool wg_resid() {
  return EPI == kWgBiasResid || EPI == kWgGeluResidSplit;
}

constexpr int kWgBM = 128;       // tile rows: one 64-row wgmma per consumer
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kWgMaxBranches = 4;

struct GemmWgArgs {
  const float* bias;            // <N>
  const void* R[kWgMaxBranches];  // residuals; [0] unless split
  int ldr;
  void* C;
  int ldc;
  long long c_split;  // elements from one branch's output to the next
  int split;          // output columns per branch (split epilogue)
  int M, N, K;
};

// A stage: the A box, the W box and, in fp32, W's lo-plane box
template <bool F32, int BN>
struct WgTile {
  static constexpr int kA = kWgBM * 128;  // one A box: 128 rows x 128 bytes
  static constexpr int kW = BN * 128;
  static constexpr int kStageBytes = kA + (F32 ? 2 : 1) * kW;
  static constexpr int kFit = (232448 - 2048) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

template <typename T>
__device__ __forceinline__ void ld2(const T* p, bool vec, bool two, float& x0,
                                    float& x1) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x0 = v.x;
      x1 = v.y;
    } else {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
      x0 = __low2float(v);
      x1 = __high2float(v);
    }
  } else {
    x0 = to_f(p[0]);
    x1 = two ? to_f(p[1]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void st2(T* p, bool vec, bool two, float x0,
                                    float x1) {
  if (vec) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __halves2bfloat162(from_f<T>(x0), from_f<T>(x1));
  } else {
    p[0] = from_f<T>(x0);
    if (two) p[1] = from_f<T>(x1);
  }
}

// The tile rows [m0, m0 + 64) of one consumer warpgroup, columns [n0, n0 +
// BN), from the accumulator fragment of wgmma m64nNk*: warp w, lane l hold,
// for each 8-column group j, acc[4j + 2h + e] = D[16w + l/4 + 8h][8j +
// 2(l%4) + e].  Column pairs (c, c + 1) go together: c is even, and the
// split width is a multiple of 8, so a pair never straddles two branches.
// Columns go in chunks of 32: a chunk's biases and residuals are loaded
// together before its stores, so their latencies overlap instead of
// queueing behind the stores (which may alias them).
template <typename T, int EPI, int BN>
__device__ __forceinline__ void wg_epilogue(const GemmWgArgs& p,
                                            const float* acc, int m0, int n0,
                                            bool vec_ok) {
  constexpr int kJ = 4;  // 8-column groups per chunk
  static_assert((BN / 8) % kJ == 0, "chunks must tile the columns");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rows[2] = {m0 + 16 * warp + (lane >> 2),
                       m0 + 16 * warp + (lane >> 2) + 8};
  const bool row_ok[2] = {rows[0] < p.M, rows[1] < p.M};
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kJ) {
    float bs[kJ][2], res[kJ][2][2];
    T* cbase[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int c = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
      const bool one = c < p.N, two = c + 1 < p.N;
      bs[jj][0] = one ? p.bias[c] : 0.f;
      bs[jj][1] = two ? p.bias[c + 1] : 0.f;
      int br = 0, cc = c;
      if (EPI == kWgGeluResidSplit && one) {
        br = c / p.split;
        cc = c - br * p.split;
      }
      cbase[jj] = static_cast<T*>(p.C) + br * p.c_split + cc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        res[jj][h][0] = res[jj][h][1] = 0.f;
        if (wg_resid<EPI>() && one && row_ok[h])
          ld2<T>(static_cast<const T*>(p.R[br]) + (size_t)rows[h] * p.ldr +
                     cc,
                 two && vec_ok, two, res[jj][h][0], res[jj][h][1]);
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
        float v0 = acc[4 * j + 2 * h] + bs[jj][0];
        float v1 = acc[4 * j + 2 * h + 1] + bs[jj][1];
        if (EPI == kWgGeluResidSplit || EPI == kWgBiasGelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (wg_resid<EPI>()) {
          v0 = res[jj][h][0] + round_to<T>(v0);
          v1 = res[jj][h][1] + round_to<T>(v1);
        }
        st2<T>(cbase[jj] + (size_t)rows[h] * p.ldc, vec, two, v0, v1);
      }
    }
  }
}

// Persistent, warp-specialised float GEMM: gridDim.x blocks (at most one
// per SM) walk the 128 x BN output tiles in row-major order.  Warpgroup 2
// is the producer: one thread keeps the ring of kStages stages filled by
// TMA (per stage the A box, the W box and, in fp32, W's lo box), each
// stage guarded by a full barrier (its bytes arrived) and an empty barrier
// (its eight consumer warps are done).
// Warpgroups 0 and 1 each multiply 64 rows of the tile by all BN columns.
template <typename T, int EPI, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_wg_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_wlo,
                   GemmWgArgs p) {
  constexpr bool F32 = sizeof(T) == 4;
  using Tile = WgTile<F32, BN>;
  constexpr int S = Tile::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Tile::kStageBytes);
  uint64_t* empty = full + S;

  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + kWgBM - 1) / kWgBM) * tiles_n;
  const int nk = (p.K * (int)sizeof(T) + 127) / 128;
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
        const int m0 = (tile / tiles_n) * kWgBM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Tile::kStageBytes);
          uint8_t* st = smem + stage * Tile::kStageBytes;
          tma_load_2d(st, &map_a, &full[stage], kb * 128, m0);
          uint8_t* sw = st + Tile::kA;
          tma_load_2d(sw, &map_w, &full[stage], kb * 128, n0);
          if (F32)
            tma_load_2d(sw + Tile::kW, &map_wlo, &full[stage], kb * 128, n0);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // pairs of columns load and store together where every row start is
    // aligned to two elements
    bool vec_ok = p.ldc % 2 == 0 && p.c_split % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(p.C) % (2 * sizeof(T)) == 0;
    if (wg_resid<EPI>()) {
      vec_ok = vec_ok && p.ldr % 2 == 0;
      for (int i = 0; i < kWgMaxBranches; ++i)
        vec_ok = vec_ok &&
                 reinterpret_cast<uintptr_t>(p.R[i]) % (2 * sizeof(T)) == 0;
    }
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kWgBM, n0 = (tile % tiles_n) * BN;
      float acc[BN / 2], part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * Tile::kStageBytes;
        const uint8_t* a = st + wg * 64 * 128;  // this warpgroup's 64 rows
        const uint8_t* w = st + Tile::kA;
        if constexpr (!F32) {
          fence_regs<BN / 2>(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16<BN>(acc, sw128_desc(a + kk * 32),
                           sw128_desc(w + kk * 32), 1);
          wgmma_commit();
          fence_regs<BN / 2>(acc);
          wgmma_wait_all();
          fence_regs<BN / 2>(acc);
        } else {
          static_assert(BN == 96, "the fp32 products take 96-wide tiles");
          const uint8_t* wlo = w + Tile::kW;
          const bool fresh = (kb & 1) == 0;  // a new 64-deep slice
          // the tf32 A fragment of k step kk: e = 0..3 at rows 16 warp + g
          // (+ 8 for odd e), k = 8 kk + t (+ 4 for e >= 2); the 16-byte
          // chunk of the 128-byte row is swizzled by the row's low 3 bits
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * warp + g + 8 * (e & 1);
              const int chunk = (2 * kk + (e >> 1)) ^ (row & 7);
              const float x = *reinterpret_cast<const float*>(
                  a + row * 128 + chunk * 16 + t * 4);
              split_tf32(x, ah[kk][e], al[kk][e]);
            }
          fence_regs<BN / 2>(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int scale = fresh && kk == 0 ? 0 : 1;
            const uint64_t bh = sw128_desc(w + kk * 32);
            const uint64_t bl = sw128_desc(wlo + kk * 32);
            wgmma_tf32_rs_n96(part, al[kk], bh, scale);
            wgmma_tf32_rs_n96(part, ah[kk], bl, 1);
            wgmma_tf32_rs_n96(part, ah[kk], bh, 1);
          }
          wgmma_commit();
          fence_regs<BN / 2>(part);
          wgmma_wait_all();
          fence_regs<BN / 2>(part);
          if (!fresh || kb == nk - 1) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          }
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_epilogue<T, EPI, BN>(p, acc, m0 + wg * 64, n0, vec_ok);
    }
  }
}

template <typename T, int EPI, int BN>
static int launch_wg_tile(const CUtensorMap* maps, const GemmWgArgs& p,
                          cudaStream_t s) {
  using Tile = WgTile<sizeof(T) == 4, BN>;
  auto kernel = gemm_wg_kernel<T, EPI, BN>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const long long tiles = (long long)((p.M + kWgBM - 1) / kWgBM) *
                          ((p.N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, kWgThreads, Tile::kSmem, s>>>(maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

template <typename T, int EPI>
static int launch_wg(const CUtensorMap* maps, int bn, const GemmWgArgs& p,
                     cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (bn == 256) return launch_wg_tile<T, EPI, 256>(maps, p, s);
    if (bn == 192) return launch_wg_tile<T, EPI, 192>(maps, p, s);
    if (bn == 128) return launch_wg_tile<T, EPI, 128>(maps, p, s);
  }
  return launch_wg_tile<T, EPI, 96>(maps, p, s);
}

template <typename T>
static int dispatch_wg(int epi, const CUtensorMap* maps, int bn,
                       const GemmWgArgs& p, cudaStream_t s) {
  switch (epi) {
    case kWgBias: return launch_wg<T, kWgBias>(maps, bn, p, s);
    case kWgBiasResid: return launch_wg<T, kWgBiasResid>(maps, bn, p, s);
    case kWgGeluResidSplit:
      return launch_wg<T, kWgGeluResidSplit>(maps, bn, p, s);
    case kWgBiasGelu: return launch_wg<T, kWgBiasGelu>(maps, bn, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ row pass

// One warp per row of x <M, K> (row stride ldx): out = cast(LN(x)) with
// fp32 statistics, as `_ln32` (the pre-norm prologue of K6's Q|K|V
// product, written once instead of normalised in the GEMM's main loop).
template <typename T>
__global__ void rows_prep_kernel(const T* __restrict__ x, int ldx, int M,
                                 int K, float eps,
                                 const float* __restrict__ lnw,
                                 const float* __restrict__ lnb,
                                 T* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const T* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int c = lane; c < K; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int c = lane; c < K; c += 32) {
    const float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / K + eps);
  for (int c = lane; c < K; c += 32)
    out[(size_t)row * K + c] =
        from_f<T>((to_f(xr[c]) - mu) * rs * lnw[c] + lnb[c]);
}

template <typename T>
static void launch_rows_prep(const void* x, int ldx, int M, int K, float eps,
                             const float* w, const float* b, void* out,
                             cudaStream_t s) {
  constexpr int threads = 256;  // 8 rows per block
  const int blocks = (M * 32 + threads - 1) / threads;
  rows_prep_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), ldx, M, K, eps, w, b, static_cast<T*>(out));
}

}  // namespace ag

using namespace ag;

// Float GEMM.  dtype: the activation type of A, R and C.  W, W_lo: the
// weight (bf16; W_lo unused) or its tf32 hi and lo planes (fp32), <N, K>
// with row stride ldw.  R: kWgMaxBranches residual pointers (the first, or
// one per branch for the split epilogue).  A and W are read by TMA: the
// pointers and the row strides in bytes must be multiples of 16, and so
// must K's bytes.  bn: the tile width (bf16 96, 128, 192 or 256; fp32 96),
// or 0 for the shape rule below.
extern "C" int ag_gemm_wg(int dtype, int epi, const void* A, int lda,
                          const void* W, const void* W_lo, int ldw,
                          const void* bias, const void* const* R, int ldr,
                          void* C, int ldc, long long c_split, int split,
                          int M, int N, int K, int bn, void* stream) {
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  const int es = dtype == kF32 ? 4 : 2;
  if (K <= 0 || K * es % 16 || lda * es % 16 || ldw * es % 16)
    return (int)cudaErrorInvalidValue;
  if (epi == kWgGeluResidSplit &&
      (split <= 0 || split % 8 || (N + split - 1) / split > kWgMaxBranches))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  // bf16: 256-wide tiles where they still make six or more column tiles
  // (the Q|K|V product), else 128 or 96
  if (bn == 0)
    bn = dtype != kBF16                 ? 96
         : N % 256 == 0 && N >= 6 * 256 ? 256
         : N % 128 == 0                 ? 128
                                        : 96;
  else if (dtype == kBF16 ? bn != 96 && bn != 128 && bn != 192 && bn != 256
                          : bn != 96)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* w_lo = dtype == kF32 ? W_lo : W;
  if (!tensor_map(&maps[0], A, M, K * es, lda * es, kWgBM) ||
      !tensor_map(&maps[1], W, N, K * es, ldw * es, bn) ||
      !tensor_map(&maps[2], w_lo, N, K * es, ldw * es, bn))
    return (int)cudaErrorInvalidValue;
  GemmWgArgs p;
  p.bias = static_cast<const float*>(bias);
  for (int i = 0; i < kWgMaxBranches; ++i) p.R[i] = R ? R[i] : nullptr;
  p.ldr = ldr;
  p.C = C;
  p.ldc = ldc;
  p.c_split = c_split;
  p.split = split;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_wg<__nv_bfloat16>(epi, maps, bn, p, s);
  return dispatch_wg<float>(epi, maps, bn, p, s);
}

// The row pass: out <M, K> contiguous = cast(LN(x)) with fp32 LN vectors.
extern "C" int ag_rows_prep(int dtype, const void* x, int ldx, int M, int K,
                            float eps, const void* lnw, const void* lnb,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(lnw);
  const float* b = static_cast<const float*>(lnb);
  if (w == nullptr || b == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  if (dtype == kF32)
    launch_rows_prep<float>(x, ldx, M, K, eps, w, b, out, s);
  else if (dtype == kBF16)
    launch_rows_prep<__nv_bfloat16>(x, ldx, M, K, eps, w, b, out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
