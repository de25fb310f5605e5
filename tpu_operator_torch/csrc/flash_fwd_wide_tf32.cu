// Flash-attention forward on the tensor cores for f32 inputs (K2dt):
// softmax(q k^T * scale) v over [H, T, D] f32 inputs, any D (the routing
// sends it every f32 input), any T, causal or full, every product in three
// TF32 products (3xTF32), so that the scores and the output keep f32 grade.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel for those
// inputs (the Pallas kernel takes any [T, D], with a [block_q, D] f32
// accumulator in VMEM).
//
// Bound on an H100: the operations. 4 D T(T+1)/2 f32 flops a head causal
// (4 D T^2 full). On CUDA cores (67 TFLOP/s) that is 1.026 ms at [2, 4096,
// 1024] causal; here each f32 product is three TF32 products at 495
// TFLOP/s, 165 TFLOP/s of f32 work: 0.417 ms (0.026 ms at [4096, 128]
// causal). Its 4 T D f32 elements a head take 0.04 ms at 3.35 TB/s at
// [2, 4096, 1024], the split copies below 0.12 ms more.
// What the design does about it:
//   1. The products run on wgmma, not as f32 FMAs on CUDA cores. A single
//      TF32 product errs about 1e-3, twenty times attention_tolerance(f32,
//      D, "cuda"), so the products are split: x = big + small, big =
//      tf32(x), small = tf32(x - big), and a product is small*big +
//      big*small + big*big, the two small ones accumulated first (CUTLASS's
//      fast-f32 order), all in f32; small*small (2^-22 relative) is left
//      out. Rounding is to nearest, ties away from zero, by bit mask
//      ((bits + 0x1000) & ~0x1fff), as ops/flash_attention.py::tf32_split
//      does on the CPU: the tensor core is never handed low bits to drop.
//   2. A block's output chunk is as wide as the head up to 256 (DC = 64,
//      128 or 256, the head bucket: ops/flash_attention.py::tf32_chunk), so
//      P V multiplies no zero columns past the bucket; past 256 the scores
//      are formed again for each 256-column chunk, (D/256 + 1)/2 times the
//      least work (2.5x at D = 1024): kept, as in K2dw; partial scores of D
//      slices summed through distributed shared memory would remove them
//      (open, ROADMAP.md).
//
// Design:
//   - A pre-pass writes the split copies once a call: Q and K as
//     [2H][T][Dp] (heads 0 .. H-1 the big parts, H .. 2H-1 the small; Dp =
//     D rounded up to 4, the row stride TMA takes, its pad columns never
//     written or read), and V transposed to [2H][D][Tp] (Tp = T rounded up
//     to 64, zeros past T), since a tf32 wgmma reads only K-major operands
//     from shared memory and V's [keys, columns] tile is MN-major as the B
//     operand of P V; its keys are permuted within each group of 8 to match
//     P's A fragment (a_order). The copies are twice the inputs' bytes,
//     written and read once: 0.12 ms at 3.35 TB/s at [2, 4096, 1024],
//     against the kernel's milliseconds.
//   - The schedule is K2dw's (flash_fwd_wide_wgmma.cu): the units of
//     flash_common.cuh, each cut into ceil(D / DC) chunks of DC output
//     columns, one block a (unit, chunk); the same partial workspace (rows
//     of D rounded up to DC) and the shared merge.
//     ops/flash_attention.py::flash_chunked_tf32_plain is its plain model.
//   - A block is one consumer warpgroup and one producer warp. The consumer
//     owns the unit's 64 rows x DC columns of O in registers, DC / 2 f32 a
//     thread.
//   - A kv step of 64 keys: S = Q K^T over all of D by wgmma m64n64k8.tf32,
//     D walked in k-chunks of 32 columns (one 128-byte row of f32), each a
//     stage of four TMA boxes (Q big, Q small, K big, K small; 8 KiB each)
//     and twelve products (four k-steps of three); Q/K stages with full
//     and empty mbarriers, each released as soon as its products are done
//     (they accumulate into one fragment, so they run in order). Then the
//     online softmax in f32 (flash_common.cuh::softmax_step_f32), P split
//     in registers, and O += P V by wgmma m64nDCk8.tf32, 24 products: P's
//     parts as register A operands (the S fragment's elements, reordered:
//     a_order), V's as K-major B tiles of [DC columns][32 keys], two a
//     part.
//   - Shared memory (Layout): a V stage is 64 keys x DC columns x 4 bytes
//     x 2 parts. At DC = 256 that is 128 KiB, so V has one stage and three
//     Q/K stages of 32 KiB take 96 KiB: 224 KiB and the barriers, one
//     block an SM. The producer issues a step's first Q/K stages before its
//     V (the V stage is free only once the last step's P V is done), so the
//     consumer starts S while V lands. At DC = 64 and 128 two blocks share
//     an SM (two Q/K stages and a 32 KiB V stage at 64, one and 64 KiB at
//     128: 96 KiB each), so that one block's products run while the other
//     waits on its copies or its softmax. Timed against one block an SM
//     with three Q/K stages and two V stages, the next step's V landing
//     while this step's P V runs (chip_smoke.py --flash-times on the two
//     layouts back to back, one H100 80GB HBM3 at 700 W): at f32 [4096,
//     64] causal 0.0366 ms
//     against 0.0479, at [4096, 128] causal 0.0745 against 0.0758 (at
//     [4096, 96] 0.0666 against 0.0650: the two are within 2.5% at DC =
//     128, where one V stage fills a block's share of the SM).
//   - Registers: DC / 2 for O, 32 for S, then 64 for P's two parts while P
//     V runs; ptxas's count is in the build log (chip_smoke.py's [build]
//     lines; two blocks an SM allow 204 a thread).
//   - Ragged shapes: 3-D tensor maps whose inner dim is D, so TMA fills
//     zeros past D (the pad columns of the split copies, and V's rows past
//     D up to DC) and past T; keys past T are masked with the reference's
//     -1e30, rows past T and columns past D are not stored. The output's
//     rows are D floats: a pair of columns goes as one float2 where D is
//     even, else column by column.
//   - m and l agree bit for bit across a unit's chunk blocks: each forms S
//     from the same split copies with the same wgmma sequence over D's
//     chunks in the same order, and V enters neither. A split unit's chunk
//     0 alone writes them.
//   - Numbers: scores, m, l, the accumulator and P in f32 (l sums the
//     unsplit P); the output written once, in f32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bar_expect;
using flash::bar_init;
using flash::bar_wait;
using flash::desc_k_major;
using flash::fence_regs;
using flash::kBlockQ;
using flash::kLog2e;
using flash::smem_addr;
using flash::tma_box;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_wait;

constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kBK = 64;                     // keys a kv step
constexpr int kKC = 32;                     // columns of D a k-chunk
constexpr int kRowBytes = kKC * 4;          // one swizzled 128-byte row
constexpr int kQKBox = 64 * kRowBytes;      // [64 rows][32 columns]: 8 KiB
constexpr int kStage = 4 * kQKBox;          // Q big, Q small, K big, K small
constexpr int kVBoxes = kBK / kKC;          // V boxes a part a kv step

// A block at output chunk width DC (64, 128 or 256 columns): the blocks an
// SM holds (the launch bounds), its Q/K stages in flight and its shared
// memory (the header's "Shared memory"). A V box is [DC columns][32 keys],
// and the V stage its big boxes, then its small ones.
template <int DC>
struct Layout {
  static constexpr int blocks = DC == 256 ? 1 : 2;
  static constexpr int stages = DC == 256 ? 3 : DC == 128 ? 1 : 2;
  static constexpr int v_box = DC * kRowBytes;
  static constexpr int v_stage = 2 * kVBoxes * v_box;
  // byte offsets from a 1024-byte aligned base (the swizzle's period)
  static constexpr int off_qk = 0;
  static constexpr int off_v = off_qk + stages * kStage;
  static constexpr int off_bars = off_v + v_stage;
  // full[stages], empty[stages], v_full, v_empty
  static constexpr int bars = 2 * stages + 2;
  static constexpr int smem = off_bars + 8 * bars + 1024;  // room to align
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static_assert(blocks == 1 || smem <= 113 * 1024,
                "two blocks do not fit an SM's shared memory");
};

// The tf32 A fragment in registers is mma.sync's m16n8k8 one, not the
// accumulator's: register e of thread (row group r0, quad q) holds row r0
// + 8 (e & 1) at logical k q + 4 (e >> 1). The S fragment holds keys 2q and
// 2q + 1 of each n8 block, so register e takes the S element 4 kb + (0, 2,
// 1, 3)[e], and the pre-pass permutes V's keys within each group of 8 to
// match: logical k j < 4 reads key 2j, k 4 + j reads key 2j + 1.
__device__ __forceinline__ int a_order(int e) {
  return e == 1 ? 2 : e == 2 ? 1 : e;
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero, as f32 bits with the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// big and small parts: x = big + small up to small's rounding
__device__ __forceinline__ void tf32_parts(float x, float& big, float& small) {
  big = __uint_as_float(tf32_bits(x));
  small = __uint_as_float(tf32_bits(x - big));
}

// D[64][64] (+)= A[64][8] B[64][8]^T in tf32, A and B K-major in shared
// memory; D is overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64][N] += A[64][8] B[N][8]^T in tf32, N = DC (64, 128 or 256): A in
// registers (four tf32 values a thread, the layout of the accumulator's), B
// K-major in shared memory. One overload a width, by the accumulator's size.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the pre-pass: split copies ---------------------------------------------

// x [rows][d] -> out [2][rows][dp]: the big parts, then the small parts, at
// a row stride of dp >= d; the pad columns d .. dp - 1 are not written.
// Where dp == d, as float4s over the flat array; else row by row, a block a
// row at a time, each thread loading four columns before it stores any (a
// source row starts on a 4-byte boundary only).
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int rows, int d, int dp) {
  const size_t plane = static_cast<size_t>(rows) * dp;
  if (dp == d) {   // d % 4 == 0
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* out4 = reinterpret_cast<float4*>(out);
    const size_t n4 = plane / 4;
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
         i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
      const float4 a = x4[i];
      float4 big, small;
      tf32_parts(a.x, big.x, small.x);
      tf32_parts(a.y, big.y, small.y);
      tf32_parts(a.z, big.z, small.z);
      tf32_parts(a.w, big.w, small.w);
      out4[i] = big;
      out4[n4 + i] = small;
    }
    return;
  }
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* src = x + static_cast<size_t>(r) * d;
    float* dst = out + static_cast<size_t>(r) * dp;
    for (int c0 = threadIdx.x; c0 < d; c0 += 4 * blockDim.x) {
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e * blockDim.x;
        a[e] = c < d ? src[c] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e * blockDim.x;
        if (c >= d) break;
        float big, small;
        tf32_parts(a[e], big, small);
        dst[c] = big;
        dst[plane + c] = small;
      }
    }
  }
}

// v [H][T][D] -> out [2H][D][tp]: out[h][c][t] the big part of
// v[h][t'][c], out[H + h][c][t] its small part, zeros for t' >= T, where
// t' is t with its place in its group of 8 keys permuted as a_order needs.
// Block (x, y, h) moves a 32 x 32 tile through shared memory, columns 32
// x, keys 32 y.
constexpr int kTile = 32;
__global__ void __launch_bounds__(kTile * 8)
tf32_split_transpose_kernel(const float* __restrict__ v,
                            float* __restrict__ out, int heads, int t_len,
                            int d, int tp) {
  __shared__ float tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, t0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  for (int y = threadIdx.y; y < kTile; y += 8) {
    const int t = t0 + y, c = c0 + threadIdx.x;
    tile[y][threadIdx.x] =
        t < t_len && c < d
            ? v[(static_cast<size_t>(h) * t_len + t) * d + c]
            : 0.f;
  }
  __syncthreads();
  for (int y = threadIdx.y; y < kTile; y += 8) {
    const int c = c0 + y, t = t0 + threadIdx.x;
    if (c >= d) continue;
    float big, small;
    // slot k of a group of 8 holds key 2k (k < 4) or 2(k - 4) + 1: the
    // order in which the A fragment takes P's columns (a_order)
    const int k8 = threadIdx.x & 7;
    const int src = (threadIdx.x & ~7) + (k8 < 4 ? 2 * k8 : 2 * k8 - 7);
    tf32_parts(tile[src][y], big, small);
    out[(static_cast<size_t>(h) * d + c) * tp + t] = big;
    out[(static_cast<size_t>(heads + h) * d + c) * tp + t] = small;
  }
}

// ---- the kernel -------------------------------------------------------------

// Block b takes unit b / n_chunks and output columns [DC c, DC c + DC), c =
// b % n_chunks. The wgmma fragments are K2dw's: thread t holds rows r0 and
// r0 + 8. tq and tk map the split copies [2H][T][Dp] (big parts at head h,
// small at H + h), tv the transposed one [2H][D][Tp]; part_acc rows are
// acc_cols floats; o rows are d floats.
template <int DC>
__global__ void __launch_bounds__(kThreads, Layout<DC>::blocks)
flash_wide_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       float* __restrict__ o, const int4* __restrict__ units,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int acc_cols, int heads,
                       int t_len, int d, int n_chunks, float scale_log2,
                       int causal) {
  using L = Layout<DC>;
  constexpr int kStages = L::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s: Q big, Q small, K big, K small
  auto sQK = [&](int s, int box) {
    return base + L::off_qk + s * kStage + box * kQKBox;
  };
  // V's big boxes (keys 0-31, 32-63), then its small ones
  auto sV = [&](int part, int x) {
    return base + L::off_v + (part * kVBoxes + x) * L::v_box;
  };
  const uint32_t bars = base + L::off_bars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t v_full = bars + 8 * (2 * kStages);
  const uint32_t v_empty = bars + 8 * (2 * kStages + 1);

  const int4 unit = units[blockIdx.x / n_chunks];
  const int c0 = (blockIdx.x % n_chunks) * DC;   // this block's columns
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (unit.x % nq) * kBlockQ;
  const int head = unit.x / nq;
  const int first = unit.y;
  const int n = min(unit.z, (t_len + kBK - 1) / kBK) - first;
  const int n_kc = (d + kKC - 1) / kKC;          // k-chunks a kv step
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 4);
    }
    bar_init(v_full, 1);
    bar_init(v_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: one thread issues every copy, stage j % kStages taking
    // the j-th k-chunk of Q and K (kv step by kv step). A stage is refilled
    // once every consumer warp released it (the first round passes: the
    // barrier's previous phase counts as complete).
    if (tid == kConsumers) {
      const CUtensorMap* mq = &tq;
      const CUtensorMap* mk = &tk;
      int j = 0;
      auto issue = [&](int kc, int k0) {
        const int s = j % kStages;
        bar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        bar_expect(full(s), kStage);
        const int col = kKC * kc;
        tma_box(sQK(s, 0), mq, col, q0, head, full(s));
        tma_box(sQK(s, 1), mq, col, q0, heads + head, full(s));
        tma_box(sQK(s, 2), mk, col, k0, head, full(s));
        tma_box(sQK(s, 3), mk, col, k0, heads + head, full(s));
        ++j;
      };
      const int ahead = min(n_kc, kStages);
      for (int it = 0; it < n; ++it) {
        const int k0 = (first + it) * kBK;
        int kc = 0;
        for (; kc < ahead; ++kc) issue(kc, k0);
        bar_wait(v_empty, (it & 1) ^ 1);
        bar_expect(v_full, L::v_stage);
        for (int x = 0; x < kVBoxes; ++x) {
          tma_box(sV(0, x), &tv, k0 + kKC * x, c0, head, v_full);
          tma_box(sV(1, x), &tv, k0 + kKC * x, c0, heads + head, v_full);
        }
        for (; kc < n_kc; ++kc) issue(kc, k0);
      }
    }
  } else {
    const int lane = tid & 31;
    const int quad = tid & 3;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);   // rows r0 and r0 + 8
    // each consumer warp releases a stage once
    auto release = [&](int s) {
      if (lane == 0) bar_arrive(empty(s));
    };
    float acc[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
    float l[2] = {0.f, 0.f};

    int j = 0;
    for (int it = 0; it < n; ++it) {
      const int k0 = (first + it) * kBK;         // the step's first key

      // S = Q K^T over all of D: n_kc stages, four k-steps of 8 each, three
      // products a k-step (the small ones first). Every stage's products
      // accumulate into the same fragment, so they run in order anyway:
      // a stage is waited for and released at once (keeping one committed
      // stage in flight, as K2dw does, measured slower here)
      float sc[kBK / 2] = {};
      for (int kc = 0; kc < n_kc; ++kc, ++j) {
        const int s = j % kStages;
        bar_wait(full(s), (j / kStages) & 1);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t at = 32 * kk;
          wgmma_tf32_ss(sc, desc_k_major(sQK(s, 1) + at),
                        desc_k_major(sQK(s, 2) + at), kc > 0 || kk > 0);
          wgmma_tf32_ss(sc, desc_k_major(sQK(s, 0) + at),
                        desc_k_major(sQK(s, 3) + at), 1);
          wgmma_tf32_ss(sc, desc_k_major(sQK(s, 0) + at),
                        desc_k_major(sQK(s, 2) + at), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        release(s);
      }
      fence_regs(sc);

      // the online softmax on the fragment (flash_common.cuh); P in sc
      flash::softmax_step_f32<kBK, DC / 2, true>(sc, acc, m, l, scale_log2,
                                                 causal, k0, q0, r0, quad,
                                                 t_len);
      // the A fragments of the eight k-steps, big and small parts
      uint32_t pb[kBK / 8][4], ps[kBK / 8][4];
#pragma unroll
      for (int kb = 0; kb < kBK / 8; ++kb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[4 * kb + a_order(e)];
          pb[kb][e] = tf32_bits(x);
          ps[kb][e] = tf32_bits(x - __uint_as_float(pb[kb][e]));
        }
      }

      // O += P V over the step's 64 keys in eight k-steps of 8 (k-step kb:
      // keys 8 kb .. 8 kb + 7, the fragment's n8 block kb), three products
      // each, the small ones first
      bar_wait(v_full, it & 1);
      fence_regs(acc);
      // P's parts defined before the fence: ptxas otherwise moves their
      // arithmetic into the products' pipeline and serialises every wgmma
      // (its C7520 note)
#pragma unroll
      for (int kb = 0; kb < kBK / 8; ++kb) {
        fence_regs(pb[kb]);
        fence_regs(ps[kb]);
      }
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kBK / 8; ++kb) {
        const int x = kb / 4;
        const uint32_t at = 32 * (kb % 4);
        wgmma_tf32_rs(acc, ps[kb], desc_k_major(sV(0, x) + at));
        wgmma_tf32_rs(acc, pb[kb], desc_k_major(sV(1, x) + at));
        wgmma_tf32_rs(acc, pb[kb], desc_k_major(sV(0, x) + at));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) bar_arrive(v_empty);
    }

    if (unit.w >= 0) {
      // a partial: m (log2 units) and l from chunk 0 (every chunk block
      // holds the same), this block's columns of the unnormalised acc
      float* ml = part_ml + static_cast<size_t>(unit.w) * 2 * kBlockQ;
      float* dst =
          part_acc + static_cast<size_t>(unit.w) * kBlockQ * acc_cols + c0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (quad == 0 && c0 == 0) {
          ml[r] = m[h];
          ml[kBlockQ + r] = l[h];
        }
#pragma unroll
        for (int c8 = 0; c8 < DC / 8; ++c8)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * acc_cols +
                                     8 * c8 + 2 * quad) =
              make_float2(acc[4 * c8 + 2 * h], acc[4 * c8 + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + r0 + 8 * h;
        if (row >= t_len) continue;
        const float inv = 1.f / l[h];
        float* dst = o + (static_cast<size_t>(head) * t_len + row) * d + c0;
#pragma unroll
        for (int c8 = 0; c8 < DC / 8; ++c8) {
          const int col = c0 + 8 * c8 + 2 * quad;
          if (col >= d) break;
          const float a = acc[4 * c8 + 2 * h] * inv;
          const float b = acc[4 * c8 + 2 * h + 1] * inv;
          if (d % 2 == 0) {
            // an even row: the pair is 8-byte aligned and ends inside it
            *reinterpret_cast<float2*>(dst + 8 * c8 + 2 * quad) =
                make_float2(a, b);
          } else {
            dst[8 * c8 + 2 * quad] = a;
            if (col + 1 < d) dst[8 * c8 + 2 * quad + 1] = b;
          }
        }
      }
    }
  }
}

// The kernel at chunk width DC on the split copies: n_chunks blocks a unit.
template <int DC>
cudaError_t launch_chunks(void* split_q, void* split_k, void* split_v,
                          float* o, const void* units, int n_units,
                          void* part_acc, void* part_ml, int acc_cols,
                          int heads, int T, int D, int dp, int tp,
                          float scale_log2, int causal, cudaStream_t s) {
  const int n_chunks = (D + DC - 1) / DC;
  CUtensorMap tq, tk, tv;
  if (!flash::tile_map_f32(&tq, split_q, 2 * heads, T, D, dp, kBlockQ) ||
      !flash::tile_map_f32(&tk, split_k, 2 * heads, T, D, dp, kBK) ||
      !flash::tile_map_f32(&tv, split_v, 2 * heads, D, tp, tp, DC))
    return cudaErrorInvalidValue;
  auto kernel = flash_wide_tf32_kernel<DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DC>::smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_units) * n_chunks, kThreads,
           Layout<DC>::smem, s>>>(
      tq, tk, tv, o, static_cast<const int4*>(units),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), acc_cols,
      heads, T, D, n_chunks, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [heads, T, D] f32 contiguous, 16-byte aligned; any D >= 1, T
// >= 1. units, merges, part_acc and part_ml as for flash_fwd_wide_wgmma
// (flash_fwd_wide_wgmma.cu): part_acc f32 [slots][64][acc_cols], acc_cols a
// multiple of 4 and at least D rounded up to a multiple of the chunk width
// DC (ops/flash_attention.py::tf32_chunk: the head bucket 64, 128 or 256 up
// to D = 256, 256 past it). split_q and split_k: f32 [2 heads][T][Dp], Dp =
// D rounded up to 4; split_v: f32 [2 heads][D][tp], tp = T rounded up to
// 64; the pre-pass writes all three (not split_q's and split_k's pad
// columns). Runs on `stream`; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for another D, T, tp or acc_cols, or a refused
// tensor map).
extern "C" int flash_fwd_wide_tf32(const void* q, const void* k,
                                   const void* v, void* o, const void* units,
                                   int n_units, const void* merges,
                                   int n_merges, void* part_acc,
                                   void* part_ml, int acc_cols, void* split_q,
                                   void* split_k, void* split_v, int heads,
                                   int T, int D, float scale, int causal,
                                   void* stream) {
  const int dc = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const int tp = (T + kBK - 1) / kBK * kBK;
  const int dp = (D + 3) / 4 * 4;   // a row stride of a multiple of 16 bytes
  if (D < 1 || T < 1 || heads < 1 || n_units < 1 || acc_cols % 4 != 0 ||
      acc_cols < (D + dc - 1) / dc * dc)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int split_blocks = 132 * 8;
  tf32_split_kernel<<<split_blocks, 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<float*>(split_q), heads * T,
      D, dp);
  tf32_split_kernel<<<split_blocks, 256, 0, s>>>(
      static_cast<const float*>(k), static_cast<float*>(split_k), heads * T,
      D, dp);
  tf32_split_transpose_kernel<<<dim3((D + kTile - 1) / kTile, tp / kTile,
                                     heads),
                                dim3(kTile, 8), 0, s>>>(
      static_cast<const float*>(v), static_cast<float*>(split_v), heads, T, D,
      tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  float* out = static_cast<float*>(o);
  const float scale_log2 = scale * kLog2e;
  err = dc == 64 ? launch_chunks<64>(split_q, split_k, split_v, out, units,
                                     n_units, part_acc, part_ml, acc_cols,
                                     heads, T, D, dp, tp, scale_log2, causal,
                                     s)
      : dc == 128 ? launch_chunks<128>(split_q, split_k, split_v, out, units,
                                       n_units, part_acc, part_ml, acc_cols,
                                       heads, T, D, dp, tp, scale_log2,
                                       causal, s)
                  : launch_chunks<256>(split_q, split_k, split_v, out, units,
                                       n_units, part_acc, part_ml, acc_cols,
                                       heads, T, D, dp, tp, scale_log2,
                                       causal, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash::launch_combine<float>(merges, n_merges, part_acc, part_ml, o, T, D,
                               acc_cols, s);
  return static_cast<int>(cudaGetLastError());
}
