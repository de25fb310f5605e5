// What the flash-attention kernels share: K2 and K2w (flash_fwd.cu), K2dw
// (flash_fwd_wide_wgmma.cu) and K2dt (flash_fwd_wide_tf32.cu) run the same
// work list of units
// (ops/flash_attention.py::work_list; K2dw and K2dt cut each unit by output
// columns) and merge the units of a split q tile with the same kernel, whose
// row stride is an argument. The tensor-core kernels (K2, K2w, K2dw, K2dt)
// share their mbarrier, TMA and wgmma tools, the tensor maps and the online
// softmax on a wgmma fragment; K2w and K2dw the copy of a 16-bit head off 8
// into a padded row stride.
//
// A unit is an int4 (row tile, first kv tile, end kv tile, slot): row tile =
// head * ceil(T / 64) + q tile, kv tiles of 64 keys, slot -1 where the unit
// writes the output itself, else its place in the partials workspace:
// part_acc f32 [slots][64][DP] (the unnormalised accumulator) and part_ml f32
// [slots][2][64] (row max m in log2 units, row sum l).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kBlockQ = 64;  // q rows of a unit; keys of a work-list kv tile
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two values rounded to a 16-bit type, packed as one 32-bit word (low first)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// four consecutive outputs of which the first n lie inside the row; vec:
// the row stride keeps dst aligned for one vector store of four
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 a, int n, bool vec) {
  if (vec && n >= 4) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dst) = a;
    } else {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack2<T>(a.x, a.y), pack2<T>(a.z, a.w));
    }
    return;
  }
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) dst[e] = from_float<T>(v[e]);
}

// Merges the units of one split q tile, merge = (row tile, first slot,
// count, -): m = max_u m_u, w_u = 2^(m_u - m), o = sum_u w_u acc_u /
// sum_u w_u l_u, the units taken in slot order (no atomics: the same bits
// on every run). Block (merge, y, z) takes rows 8y .. 8y + 7 of the q tile,
// one a warp, and columns 128 z .. 128 z + 127, four a lane; part_acc rows
// are `stride` floats (a multiple of 4). Rows past T and columns past D are
// not written.
constexpr int kMergeRows = 8;
constexpr int kMergeThreads = 32 * kMergeRows;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_combine_kernel(const int4* __restrict__ merges,
                     const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ o,
                     int t_len, int d, int stride) {
  const int4 merge = merges[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kMergeRows + (threadIdx.x >> 5);
  const int c = 128 * blockIdx.z + 4 * lane;
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int row = (merge.x % nq) * kBlockQ + r;
  if (row >= t_len) return;
  const float* ml = part_ml + static_cast<size_t>(merge.y) * 2 * kBlockQ + r;
  const float* src = part_acc +
                     (static_cast<size_t>(merge.y) * kBlockQ + r) * stride + c;
  float m = __int_as_float(0xff800000);
  for (int u = lane; u < merge.z; u += 32) m = fmaxf(m, ml[u * 2 * kBlockQ]);
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, mask));
  if (c >= d) return;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int u = 0; u < merge.z; ++u) {
    const float w = exp2_approx(ml[u * 2 * kBlockQ] - m);
    l += ml[u * 2 * kBlockQ + kBlockQ] * w;
    const float4 a = *reinterpret_cast<const float4*>(
        src + static_cast<size_t>(u) * kBlockQ * stride);
    acc.x += a.x * w;
    acc.y += a.y * w;
    acc.z += a.z * w;
    acc.w += a.w * w;
  }
  const float inv = 1.f / l;
  T* dst = o + (static_cast<size_t>(merge.x / nq) * t_len + row) * d;
  store4<T>(dst + c,
            make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv),
            d - c, d % 4 == 0);
}

// launches the merge of n_merges split q tiles, if any; part_acc rows are
// `stride` floats
template <typename T>
void launch_combine(const void* merges, int n_merges, const void* part_acc,
                    const void* part_ml, void* o, int t_len, int d,
                    int stride, cudaStream_t s) {
  if (n_merges == 0) return;
  flash_combine_kernel<T>
      <<<dim3(n_merges, kBlockQ / kMergeRows, (d + 127) / 128),
         kMergeThreads, 0, s>>>(
          static_cast<const int4*>(merges),
          static_cast<const float*>(part_acc),
          static_cast<const float*>(part_ml), static_cast<T*>(o), t_len, d,
          stride);
}

// ---- the copy into a padded row stride (K2w, K2dw) -------------------------

// q, k, v [rows][d] of a 16-bit type T -> out [3][rows][dp], dp a multiple
// of 8 and above d: thread i writes one 16-byte group of 8 columns of one
// row, read element by element (a source row starts on a 2-byte boundary
// only), the columns past d as zeros. Block y takes tensor y. A template
// only so that every source that includes this header may instantiate it.
template <typename T>
__global__ void __launch_bounds__(256)
pad_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, uint4* __restrict__ out, int rows,
                int d, int dp) {
  static_assert(sizeof(T) == 2, "the copy moves 16-bit elements");
  const uint16_t* src = reinterpret_cast<const uint16_t*>(
      blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v);
  const int groups = dp / 8;
  const size_t n = static_cast<size_t>(rows) * groups;
  uint4* dst = out + blockIdx.y * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / groups;
    const int c0 = 8 * static_cast<int>(i - r * groups);
    const uint16_t* row = src + r * d;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      const uint32_t lo = c < d ? row[c] : 0u;
      const uint32_t hi = c + 1 < d ? row[c + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The row stride, in elements, at which a [heads][T][d] 16-bit operand goes
// to TMA: d rounded up to 8, a multiple of 16 bytes.
constexpr int padded_width(int d) {
  return (d + 7) / 8 * 8;
}

// Where d % 8 != 0, copies q, k and v into `padded` ([3][rows][dp], dp =
// padded_width(d)) and points them at its three planes; else leaves them.
// Returns the launch's error.
template <typename T>
cudaError_t pad_rows(const void*& q, const void*& k, const void*& v,
                     void* padded, int rows, int d, cudaStream_t s) {
  const int dp = padded_width(d);
  if (dp == d) return cudaSuccess;
  pad_rows_kernel<T><<<dim3(132 * 8, 3), 256, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<uint4*>(padded), rows, d, dp);
  const size_t plane = static_cast<size_t>(rows) * dp * sizeof(T);
  q = padded;
  k = static_cast<const char*>(padded) + plane;
  v = static_cast<const char*>(padded) + 2 * plane;
  return cudaGetLastError();
}

// ---- the tensor-core kernels' tools (K2, K2w in flash_fwd.cu; K2dw in
// flash_fwd_wide_wgmma.cu; K2dt in flash_fwd_wide_tf32.cu): mbarriers,
// TMA, wgmma, tensor maps ----------------------------------------------------

// A TMA box is [rows][64 columns] of 16-bit elements: 128-byte rows, the
// widest the 128-byte swizzle takes.
constexpr int kBoxRowBytes = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

// a barrier whose phase completes after `count` arrivals
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count));
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
// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses to a register that an asynchronous
// wgmma reads or writes across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// The wgmma shapes the kernels issue, each for bf16 and f16 (kF16). The
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

// ---- the online softmax -----------------------------------------------------

// The first half of one kv step's online softmax on the S fragment of a 64
// x BK wgmma product, in log2 units: the scores scaled, masked where the
// step crosses the diagonal or (kBounded) holds keys past T, the row maxima
// m updated across the quad's four lanes, and alpha = 2^(m_old - m_new), the
// factor the sums and the accumulators are rescaled by. Rows r0 and r0 + 8
// of the q tile at q0; keys from k0.
template <int BK, bool kBounded>
__device__ __forceinline__ void softmax_max(
    float (&sc)[BK / 2], float (&m)[2], float (&alpha)[2], float scale_log2,
    int causal, int k0, int q0, int r0, int quad, int t_len) {
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2_approx(m[h] - m_new);  // 0 on the first step
    m[h] = m_new;
  }
}

// The second half: l = l alpha + the quad's row sums of P, and the NACC
// accumulators rescaled by alpha.
template <int NACC>
__device__ __forceinline__ void softmax_rescale(float (&acc)[NACC],
                                                float (&l)[2],
                                                const float (&alpha)[2],
                                                float (&sum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// One kv step's online softmax as K2, K2w and K2dw run it (softmax_max,
// softmax_rescale), with P = 2^(s - m) rounded to T in 16-bit pairs, the A
// fragments of the P V k-steps (the S fragment's pairs are the A fragment's
// pairs).
template <typename T, int BK, int NACC, bool kBounded>
__device__ __forceinline__ void softmax_step(
    float (&sc)[BK / 2], float (&acc)[NACC], float (&m)[2], float (&l)[2],
    uint32_t (&p)[BK / 16][4], float scale_log2, int causal, int k0, int q0,
    int r0, int quad, int t_len) {
  float alpha[2], sum[2] = {0.f, 0.f};
  softmax_max<BK, kBounded>(sc, m, alpha, scale_log2, causal, k0, q0, r0,
                            quad, t_len);
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const float a = exp2_approx(sc[i] - m[h]);
    const float b = exp2_approx(sc[i + 1] - m[h]);
    sum[h] += a + b;
    p[i >> 3][(i >> 1) & 3] = pack2<T>(a, b);
  }
  softmax_rescale(acc, l, alpha, sum);
}

// The same step for f32 inputs (K2dt): P = 2^(s - m) stays f32, in place of
// the scores.
template <int BK, int NACC, bool kBounded>
__device__ __forceinline__ void softmax_step_f32(
    float (&sc)[BK / 2], float (&acc)[NACC], float (&m)[2], float (&l)[2],
    float scale_log2, int causal, int k0, int q0, int r0, int quad,
    int t_len) {
  float alpha[2], sum[2] = {0.f, 0.f};
  softmax_max<BK, kBounded>(sc, m, alpha, scale_log2, causal, k0, q0, r0,
                            quad, t_len);
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int h = (i >> 1) & 1;
    sc[i] = exp2_approx(sc[i] - m[h]);
    sc[i + 1] = exp2_approx(sc[i + 1] - m[h]);
    sum[h] += sc[i] + sc[i + 1];
  }
  softmax_rescale(acc, l, alpha, sum);
}

// ---- host side: tensor maps -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that nothing links libcuda
inline EncodeTiled encode_tiled() {
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

// [heads][T][stride] 16-bit as a 3-D map (D, T, heads) in boxes of 64
// columns by `rows` rows of one head, 128-byte swizzle; reads past D or T
// fill zeros, so columns D .. stride - 1 are never read. TMA needs the row
// stride, stride * 2 bytes, to be a multiple of 16.
template <typename T>
inline bool tile_map(CUtensorMap* map, const void* ptr, int heads, int t_len,
                     int d, int stride, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(stride);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {row * 2, static_cast<cuuint64_t>(t_len) *
                                              row * 2};
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

// [outer][rows][stride] f32 as a 3-D map (inner, rows, outer) in boxes of
// 32 elements (one 128-byte row) by `box_rows` rows of one outer index,
// 128-byte swizzle; reads past inner or rows fill zeros, so columns inner ..
// stride - 1 are never read. TMA needs the row stride, stride * 4 bytes, to
// be a multiple of 16.
inline bool tile_map_f32(CUtensorMap* map, const void* ptr, int outer,
                         int rows, int inner, int stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride) * 4,
                                 static_cast<cuuint64_t>(rows) * stride * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
