// Flash-attention forward on the tensor cores: softmax(q k^T * scale) v over
// [H, T, D] 16-bit inputs, with an online softmax so the [T, T] score matrix
// never reaches device memory. One kernel template, two names:
//   - K2, the instance (bf16, D = 128, T a multiple of 64) that the node
//     validator's flash leg runs: flash_fwd_bf16;
//   - K2w, every other bf16 or f16 input with D <= 256 and D % 8 == 0, any
//     T >= 1: flash_fwd_wgmma.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel (a Pallas kernel
// whose grid walks (q block, kv block) in order on one TPU core, with the
// online-softmax state carried across the kv axis in VMEM scratch).
//
// Bound on an H100: the tensor cores. At T=4096, D=128, causal the kernel does
// about 2*T^2*D = 4.3 GFLOP against 4 MiB of traffic, far above the card's
// ~295 operations per byte, so the least time is the FLOPs over the 16-bit
// tensor-core peak (989 TFLOP/s on the SXM part). What stands between a
// kernel and that bound: SMs left idle (a causal q tile's kv loop is one
// chain, up to T/64 tiles long), tensor-core instructions below Hopper's
// rate (only wgmma reaches it), scores and accumulators that pass through
// shared memory, and loads that do not overlap the products.
//
// Design:
//   - Units. The wrapper cuts each q tile's kv loop into units of at most
//     SPLIT kv tiles of 64 keys (ops/flash_attention.py::work_list) and
//     orders them longest first; one block takes one unit. A q tile with one
//     unit writes its output. The units of a split q tile write their
//     partial state (row max m in log2 units, row sum l, unnormalised f32
//     acc) to a workspace, and flash_combine_kernel (flash_common.cuh)
//     merges them by the log-sum-exp rule in slot order: no atomics, so the
//     bits are the same on every run. At T=4096 causal, SPLIT=8 gives 288
//     units of at most 8 tiles for 64 q tiles.
//   - The template: the element type (bf16 or f16), the head-dim bucket DP
//     (64, 128 or 256: the smallest that holds D), the keys a kv step takes
//     BK (64, or 32 at DP = 256: chip_smoke.py sweeps it) and whether T and
//     D may leave a tile ragged (kBounded; K2's own instance is not).
//   - One warpgroup (128 threads) owns a unit's 64 q rows. S = Q K^T is
//     wgmma m64n{BK}k16 over DP / 16 k-steps, with Q and K read from shared
//     memory; the 64 x BK f32 scores stay in registers and the online
//     softmax runs on that fragment, with row reductions across the 4 lanes
//     of a quad. O += P V is wgmma m64n{DP}k16 (m64n256 is wgmma's widest,
//     so one instruction a k-step at every bucket) with P rounded in
//     registers to the input type as the A operand (the S fragment's pairs
//     are the A fragment's pairs) and V read from shared memory as an
//     MN-major B operand (the transpose flag), since V is stored [kv][D]. O
//     stays in registers (DP / 2 f32 a thread) for the whole unit and is
//     rescaled there.
//   - Q, K and V arrive by TMA, each tile as DP / 64 boxes of 64 columns
//     (128-byte rows) with 128-byte swizzle (what the wgmma descriptors read
//     without bank conflicts). K and V run through a two-stage ring, each
//     stage with an mbarrier for K and one for V. Thread 0 issues the
//     copies: once step j is done, step j + 2 is loaded into its stage while
//     step j + 1 is in use. Shared memory: Q 128 DP bytes, and 4 BK DP
//     bytes a stage pair: 80 KiB for K2 (two blocks an SM, so one block's
//     softmax overlaps the other's products), 160 KiB at DP = 256, BK = 64,
//     96 KiB at BK = 32.
//   - Ragged shapes. The tensor maps are 3-D, (D, T, heads), so TMA fills
//     zeros past D and past T inside each head: zero columns add nothing to
//     Q K^T, zero rows of V nothing to P V. Keys past T are masked with the
//     reference's -1e30, rows past T and columns past D are not stored. TMA
//     needs a 16-byte row stride, hence D % 8 == 0.
//   - The tensor maps come from cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint so that the library needs no -lcuda.
//   - Causal tiles fall in the reference's three classes: tiles above the
//     diagonal are in no unit, tiles below it run unmasked, and only the
//     kv steps that cross the diagonal are masked, with a -1e30 fill so
//     that no row's online update can become NaN. Every unit's first kv
//     step holds an unmasked key for each of its rows.
//   - Numbers: scores, m, l and acc in f32; P is rounded to the input type
//     before P V, as the reference casts p to v's dtype, and the output is
//     rounded once to the input type (ops/flash_attention.py::
//     kernel_error_limit says why a split keeps that error).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::kBlockQ;
using flash::kLog2e;
using flash::kMaskFill;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;
// A box is [rows][64 columns] of 16-bit elements: 128-byte rows, the widest
// the 128-byte swizzle takes.
constexpr int kBoxRowBytes = 128;

template <int DP, int BK>
struct Smem {
  static constexpr int q_box = kBlockQ * kBoxRowBytes;   // 8 KiB
  static constexpr int kv_box = BK * kBoxRowBytes;
  static constexpr int q_tile = (DP / 64) * q_box;
  static constexpr int kv_tile = (DP / 64) * kv_box;
  // byte offsets from a 1024-byte aligned base (the swizzle's period)
  static constexpr int q = 0;
  static constexpr int k = q + q_tile;                    // [kStages] tiles
  static constexpr int v = k + kStages * kv_tile;         // [kStages] tiles
  static constexpr int bars = v + kStages * kv_tile;      // q, k[2], v[2]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr int alloc = bytes + 1024;              // room to align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
}

// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity to complete. A copy that
// never lands would leave the block waiting for good: after 5 s (the ring
// kernels' limit) the kernel traps, so the launch fails with an error
// instead of hanging.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  unsigned long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = now_ns();
    else if (now_ns() - start > 5000000000ull) __trap();
  }
}

// one box of 64 columns at (column c0, row c1 of head c2) into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// a [rows][DP] tile of one head starting at `row`, every box on `bar`;
// TMA counts the zeros it fills past D and T as bytes that landed
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int box_bytes, int row, int head,
                                         uint32_t bar) {
  bar_expect(bar, (DP / 64) * box_bytes);
#pragma unroll
  for (int b = 0; b < DP / 64; ++b)
    tma_box(dst + b * box_bytes, map, 64 * b, row, head, bar);
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart;
// the leading offset is unused with this swizzle.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major operand (V as B of P V): 64 columns of D in a 128-byte row, the
// next 64 columns in the next box (`box_bytes` on); 8 kv rows 1024 bytes
// apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t box_bytes) {
  return desc_sw128(addr, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses to a register that an asynchronous
// wgmma reads or writes across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The wgmma shapes the kernel issues, each for bf16 and f16 (kF16). The
// operand lists are written out: inline PTX takes no arrays.

// D[64][32] (+)= A[64][16] B[32][16]^T, A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
#define WGMMA_SS_N32(TY)                                                   \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate))

template <bool kF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (kF16) WGMMA_SS_N32("f16");
  else WGMMA_SS_N32("bf16");
}

// D[64][64] (+)= A[64][16] B[64][16]^T, A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
#define WGMMA_SS_N64(TY)                                                   \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate))

template <bool kF16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (kF16) WGMMA_SS_N64("f16");
  else WGMMA_SS_N64("bf16");
}

// D[64][64] += A[64][16] B[16][64], A in registers (16-bit pairs), B
// MN-major in shared memory (the transpose flag set).
#define WGMMA_RS_N64(TY)                                                  \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kF16) WGMMA_RS_N64("f16");
  else WGMMA_RS_N64("bf16");
}

// D[64][128] += A[64][16] B[16][128], A in registers (16-bit pairs), B
// MN-major in shared memory (the transpose flag set).
#define WGMMA_RS_N128(TY)                                                  \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kF16) WGMMA_RS_N128("f16");
  else WGMMA_RS_N128("bf16");
}

// D[64][256] += A[64][16] B[16][256], A in registers (16-bit pairs), B
// MN-major in shared memory (the transpose flag set).
#define WGMMA_RS_N256(TY)                                                  \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7," \
      "%8, %9, %10, %11, %12, %13, %14, %15," \
      "%16, %17, %18, %19, %20, %21, %22, %23," \
      "%24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39," \
      "%40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55," \
      "%56, %57, %58, %59, %60, %61, %62, %63," \
      "%64, %65, %66, %67, %68, %69, %70, %71," \
      "%72, %73, %74, %75, %76, %77, %78, %79," \
      "%80, %81, %82, %83, %84, %85, %86, %87," \
      "%88, %89, %90, %91, %92, %93, %94, %95," \
      "%96, %97, %98, %99, %100, %101, %102, %103," \
      "%104, %105, %106, %107, %108, %109, %110, %111," \
      "%112, %113, %114, %115, %116, %117, %118, %119," \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <bool kF16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kF16) WGMMA_RS_N256("f16");
  else WGMMA_RS_N256("bf16");
}


// ---- the kernel -------------------------------------------------------------

// The wgmma accumulator fragment: thread t of the warpgroup holds, for an
// N-column product, values i = 0 .. N/2 - 1 at row 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2. A thread's two
// rows are r0 and r0 + 8; the four threads of a quad share them.
//
// A unit (flash_common.cuh) covers kv tiles [unit.y, unit.z) of 64 keys: kv
// steps [64 unit.y / BK, 64 unit.z / BK) of BK keys, the last cut at T.
template <typename T, int DP, int BK, bool kBounded>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 T* __restrict__ o, const int4* __restrict__ units,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int t_len, int d, float scale_log2, int causal) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int kSub = kBlockQ / BK;          // kv steps a 64-key tile
  using L = Smem<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::q;
  const uint32_t bar_q = base + L::bars;
  auto sK = [&](int s) { return base + L::k + s * L::kv_tile; };
  auto sV = [&](int s) { return base + L::v + s * L::kv_tile; };
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int4 unit = units[blockIdx.x];
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int qi = unit.x % nq;
  const int head = unit.x / nq;
  const int q0 = qi * kBlockQ;                // first q row in the head
  const int first = unit.y * kSub;
  const int n = min(unit.z * kSub, (t_len + BK - 1) / BK) - first;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int b = 0; b < 1 + 2 * kStages; ++b) bar_init(bar_q + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_tile<DP>(sQ, &tq, L::q_box, q0, head, bar_q);
    for (int s = 0; s < kStages && s < n; ++s) {
      const int row = (first + s) * BK;
      tma_tile<DP>(sK(s), &tk, L::kv_box, row, head, bar_k(s));
      tma_tile<DP>(sV(s), &tv, L::kv_box, row, head, bar_v(s));
    }
  }

  const int quad = tid & 3;
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);  // rows r0 and r0 + 8
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};

  bar_wait(bar_q, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (first + it) * BK;         // the step's first key

    // S = Q K^T over DP in DP / 16 steps of 16
    float sc[BK / 2] = {};
    bar_wait(bar_k(s), parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;     // bytes into a 128-byte row
      wgmma_ss<kF16>(sc, desc_k_major(sQ + (kk / 4) * L::q_box + col),
                     desc_k_major(sK(s) + (kk / 4) * L::kv_box + col), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment, in log2 units; a step is masked where
    // it crosses the diagonal or holds keys past T
    const bool masked = (causal && k0 + BK - 1 > q0) ||
                        (kBounded && k0 + BK > t_len);
    float mx[2] = {kMaskFill, kMaskFill};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale_log2;
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        if ((causal && key > q0 + r0 + 8 * h) || (kBounded && key >= t_len))
          x = kMaskFill;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = flash::exp2_approx(m[h] - m_new);  // 0 on the first step
      m[h] = m_new;
    }
    uint32_t p[BK / 16][4];  // P in 16-bit pairs: the A fragments of k-steps
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float a = flash::exp2_approx(sc[i] - m[h]);
      const float b = flash::exp2_approx(sc[i + 1] - m[h]);
      sum[h] += a + b;
      p[i >> 3][(i >> 1) & 3] = flash::pack2<T>(a, b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V over the step's BK kv rows in BK / 16 steps of 16
    bar_wait(bar_v(s), parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
      wgmma_rs<kF16>(acc, p[kb],
                     desc_mn_major(sV(s) + kb * 16 * kBoxRowBytes, L::kv_box));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // every thread is done with stage s: refill it with step it + kStages
    __syncthreads();
    if (tid == 0 && it + kStages < n) {
      const int row = k0 + kStages * BK;
      tma_tile<DP>(sK(s), &tk, L::kv_box, row, head, bar_k(s));
      tma_tile<DP>(sV(s), &tv, L::kv_box, row, head, bar_v(s));
    }
  }

  if (unit.w >= 0) {
    // a partial: m (log2 units), l and the unnormalised acc for the merge
    float* ml = part_ml + static_cast<size_t>(unit.w) * 2 * kBlockQ;
    float* dst = part_acc + static_cast<size_t>(unit.w) * kBlockQ * DP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (quad == 0) {
        ml[r] = m[h];
        ml[kBlockQ + r] = l[h];
      }
#pragma unroll
      for (int c8 = 0; c8 < DP / 8; ++c8)
        *reinterpret_cast<float2*>(dst + r * DP + 8 * c8 + 2 * quad) =
            make_float2(acc[4 * c8 + 2 * h], acc[4 * c8 + 2 * h + 1]);
    }
    return;
  }
  const int ld = kBounded ? d : DP;           // the output's row stride
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (kBounded && row >= t_len) continue;
    const float inv = 1.f / l[h];
    T* dst = o + (static_cast<size_t>(head) * t_len + row) * ld;
#pragma unroll
    for (int c8 = 0; c8 < DP / 8; ++c8) {
      if (kBounded && 8 * c8 >= d) break;
      *reinterpret_cast<uint32_t*>(dst + 8 * c8 + 2 * quad) =
          flash::pack2<T>(acc[4 * c8 + 2 * h] * inv,
                          acc[4 * c8 + 2 * h + 1] * inv);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that nothing links libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads][T][D] 16-bit as a 3-D map (D, T, heads) in boxes of 64 columns by
// `rows` rows of one head, 128-byte swizzle; reads past D or T fill zeros
template <typename T>
bool tile_map(CUtensorMap* map, const void* ptr, int heads, int t_len, int d,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t_len) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const void* units;
  int n_units;
  const void* merges;
  int n_merges;
  void *part_acc, *part_ml;
  int heads, t_len, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP, int BK, bool kBounded>
int launch(const Args& a) {
  using L = Smem<DP, BK>;
  CUtensorMap tq, tk, tv;
  if (!tile_map<T>(&tq, a.q, a.heads, a.t_len, a.d, kBlockQ) ||
      !tile_map<T>(&tk, a.k, a.heads, a.t_len, a.d, BK) ||
      !tile_map<T>(&tv, a.v, a.heads, a.t_len, a.d, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel<T, DP, BK, kBounded>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_units, kThreads, L::alloc, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), static_cast<const int4*>(a.units),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      a.t_len, a.d, a.scale * kLog2e, a.causal);
  flash::launch_combine<T, DP>(a.merges, a.n_merges, a.part_acc, a.part_ml,
                               a.o, a.t_len, a.d, a.stream);
  return static_cast<int>(cudaGetLastError());
}

// the bucket's kv step: 64 keys, or 32 where asked at DP = 256
template <typename T, int DP>
int launch_bk(const Args& a, int block_k) {
  if constexpr (DP == 256) {
    if (block_k == 32) return launch<T, DP, 32, true>(a);
  }
  if (block_k != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, DP, 64, true>(a);
}

template <typename T>
int launch_bucket(const Args& a, int block_k) {
  if (a.d <= 64) return launch_bk<T, 64>(a, block_k);
  if (a.d <= 128) return launch_bk<T, 128>(a, block_k);
  return launch_bk<T, 256>(a, block_k);
}

}  // namespace

// The arguments of both entry points. q, k, v, o: [heads, T, D] contiguous,
// 16-byte aligned. units: n_units int4 (row tile, first kv tile, end kv
// tile, slot); merges: n_merges int4 (row tile, first slot, count, -);
// part_acc f32 [slots][64][DP] and part_ml f32 [slots][2][64], the partials
// of split q tiles. Each runs on `stream` and returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a shape it does not take or
// a refused tensor map).

// K2: bf16, D = 128, T a multiple of 64.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const void* units, int n_units,
                              const void* merges, int n_merges,
                              void* part_acc, void* part_ml, int heads, int T,
                              int D, float scale, int causal, void* stream) {
  if (D != 128 || T < 1 || T % kBlockQ || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, units, n_units, merges, n_merges, part_acc,
               part_ml, heads, T, D, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<__nv_bfloat16, 128, 64, false>(a);
}

// K2w: dtype 1 f16, 2 bf16; 1 <= D <= 256 with D % 8 == 0; any T >= 1;
// block_k the keys of a kv step, 64, or 32 at D > 128 (DP = 256).
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, const void* units, int n_units,
                               const void* merges, int n_merges,
                               void* part_acc, void* part_ml, int dtype,
                               int heads, int T, int D, int block_k,
                               float scale, int causal, void* stream) {
  if (D < 8 || D > 256 || D % 8 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, units, n_units, merges, n_merges, part_acc,
               part_ml, heads, T, D, scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1:
      return launch_bucket<__half>(a, block_k);
    case 2:
      return launch_bucket<__nv_bfloat16>(a, block_k);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
