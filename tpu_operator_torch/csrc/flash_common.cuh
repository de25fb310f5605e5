// What the flash-attention kernels share: K2 and K2w (flash_fwd.cu) and K2s
// (flash_fwd_generic.cu) run the same work list of units
// (ops/flash_attention.py::work_list) and merge the units of a split q tile
// with the same kernel; K2d (flash_fwd_wide.cu) runs the same units, each
// cut by output columns, and merges with a kernel of its own (a runtime row
// stride in place of DP).
//
// A unit is an int4 (row tile, first kv tile, end kv tile, slot): row tile =
// head * ceil(T / 64) + q tile, kv tiles of 64 keys, slot -1 where the unit
// writes the output itself, else its place in the partials workspace:
// part_acc f32 [slots][64][DP] (the unnormalised accumulator) and part_ml f32
// [slots][2][64] (row max m in log2 units, row sum l).

#pragma once

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// a 16-byte copy into shared memory (L2 only); zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

}  // namespace flash
