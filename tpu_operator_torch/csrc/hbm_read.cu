// HBM read probe kernel: sums an f32 array `sweeps` times over in one launch.
//
// Replaces tpu_operator/ops/hbm.py::_read_kernel (a Pallas kernel that streams
// 2 MiB chunks from HBM through a four-deep VMEM DMA ring into an (8, 1024)
// vector accumulator).
//
// Bound on an H100: device-memory bandwidth. The kernel does one add per
// 4 bytes read, far below the card's compute rate, so the least time it can
// take is sweeps * bytes / peak HBM rate (3.35 TB/s on the SXM part).
//
// Design, and what it does about that bound:
//   - Persistent blocks: the wrapper launches about four blocks per SM, and each
//     thread walks the array with a grid-stride loop of 16-byte loads, so
//     neighbouring threads read neighbouring addresses and every load is a full
//     128-bit transaction.
//   - Loads are ld.global.cg (cache in L2, not L1) and volatile, so the compiler
//     cannot hoist them out of the sweep loop: every sweep really reads memory.
//     The unrolled body keeps four independent loads in flight per thread, which
//     stands in for the TPU kernel's DMA ring.
//   - The sweep loop sits inside the kernel, as in the TPU kernel, so one launch
//     reads the array `sweeps` times and launch overhead is paid once.
//   - The array must be well above the 50 MB L2 cache for the rate to be HBM's:
//     the probe reads 256 MiB by default. A much smaller array is served partly
//     from L2 and reports more than HBM can give.
//
// Precision: each thread sums one sweep of its elements in f32 (a few hundred
// values at 256 MiB), then adds that into an f64 running total. Warp shuffles,
// the per-block partials and the final reduction are all f64: over 2048 sweeps
// of 256 MiB of ones the checksum is about 1.4e11, far past the 2^24 where an
// f32 accumulator stops counting ones, and the validator gates on it to 1e-6.
// There are no atomics: the second kernel adds the block partials in a fixed
// order, so the result is the same on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float4 load_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Sum of `v` over the block; the result is valid in thread 0 only.
__device__ double block_sum(double v) {
  __shared__ double warp_part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.0;
    v = warp_sum(v);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
read_sweeps(const float4* __restrict__ x, long long n4, int sweeps,
            double* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  double total = 0.0;
  for (int s = 0; s < sweeps; ++s) {
    float acc = 0.f;
    long long i = start;
    for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = load_cg(x + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += sum4(v[u]);
    }
    for (; i < n4; i += stride) acc += sum4(load_cg(x + i));
    total += static_cast<double>(acc);
  }
  total = block_sum(total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
reduce_partials(const double* __restrict__ partials, int n,
                double* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) *out = v;
}

}  // namespace

// x: n4 float4s (16-byte aligned); partials: nblocks f64 of scratch;
// out: one f64. Runs on `stream`; returns cudaGetLastError() after the launches.
extern "C" int hbm_read_sum(const void* x, long long n4, int sweeps,
                            void* partials, int nblocks, void* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  read_sweeps<<<nblocks, kThreads, 0, s>>>(static_cast<const float4*>(x), n4,
                                           sweeps,
                                           static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<1, kThreads, 0, s>>>(static_cast<const double*>(partials),
                                         nblocks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
