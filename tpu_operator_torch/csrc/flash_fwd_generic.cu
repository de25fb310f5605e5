// Flash-attention forward for the inputs the wgmma kernel (flash_fwd.cu) does
// not take: f32, f16 and bf16, any head dim D up to 256, any sequence length
// T. softmax(q k^T * scale) v over [H, T, D] with an online softmax, so the
// [T, T] score matrix never reaches device memory.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel for those
// inputs (the Pallas kernel takes any [T, D] and any dtype); flash_fwd.cu
// keeps bf16 with D = 128 and T a multiple of 64.
//
// Bound on an H100: the operations. 4 D T^2 flops (half of it causal)
// against 4 T D elements of traffic is hundreds of operations per byte at
// T = 4096, above the card's ridge for every type. For f32 the least time is
// the flops over the 67 TFLOP/s f32 CUDA-core peak; for f16 and bf16 over the
// 989 TFLOP/s tensor-core peak, which this kernel, on CUDA cores, cannot
// approach.
//
// Design (simple and right first; a wgmma/TMA form is later work):
//   - One block of 128 threads takes one tile of kBlockQ = 32 query rows of
//     one head, the longest causal rows first. It walks the kv tiles of
//     kBlockK = 32 rows in order, as the TPU kernel's sequential grid axis
//     does, carrying the online-softmax state (row max m, row sum l, the
//     unnormalised accumulator) in registers instead of VMEM scratch.
//   - Q, K and V tiles are converted to f32 on their way into shared memory,
//     padded to the head-dim bucket DP (64, 128 or 256, a template
//     parameter) with zeros, which add nothing to a dot product. Rows have
//     DP + 1 floats, so that the threads of a warp, reading eight rows at one
//     column, hit eight banks.
//   - Four threads own one query row: in S = Q K^T each computes 8 of the
//     row's 32 scores, the row's max and sum are taken across the four lanes
//     by shuffles, and in O += P V each keeps DP / 4 of the row's output
//     columns in registers. P passes through shared memory between the two
//     products. Every product is a CUDA-core FMA in f32.
//   - T need not be a multiple of the tiles: rows past T are loaded as zeros
//     and never written, and keys past T are masked.
//   - Causal tiles above the diagonal are skipped; a tile that crosses it is
//     masked with the reference's -1e30 fill, as are keys past T. Every
//     row's first kv tile holds an unmasked key (key 0, or for rows past T,
//     zero scores), so m is finite and no update becomes NaN.
//   - Numbers: scores, m, l and the accumulator in f32; P is rounded to the
//     input type before P V, as the reference casts p to v's dtype; the
//     output acc / l is rounded once to the input type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 32;
constexpr int kBlockK = 32;
constexpr int kThreads = 128;            // four threads a query row
constexpr int kColsPerThread = kBlockK / 4;
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <int DP>
struct Layout {
  static constexpr int stride = DP + 1;               // floats a tile row
  static constexpr int p_stride = kBlockK + 1;
  static constexpr int q = 0;
  static constexpr int k = q + kBlockQ * stride;
  static constexpr int v = k + kBlockK * stride;
  static constexpr int p = v + kBlockK * stride;
  static constexpr int floats = p + kBlockQ * p_stride;
  static constexpr int bytes = floats * 4;
};

// rows [row0, row0 + rows) of a [T, D] matrix into a [rows][DP + 1] f32
// tile; columns past D and rows past T are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int row0,
                                          int rows, int t_len, int d) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = row0 + r;
    dst[r * Layout<DP>::stride + c] =
        (row < t_len && c < d)
            ? to_float(src[static_cast<size_t>(row) * d + c])
            : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int t_len,
                     int d, float scale_log2, int causal) {
  extern __shared__ float smem[];
  using L = Layout<DP>;
  float* sq = smem + L::q;
  float* sk = smem + L::k;
  float* sv = smem + L::v;
  float* sp = smem + L::p;

  const int n_q_tiles = (t_len + kBlockQ - 1) / kBlockQ;
  const int q_tile = n_q_tiles - 1 - blockIdx.x;   // longest rows first
  const size_t head = static_cast<size_t>(blockIdx.y) * t_len * d;
  q += head;
  k += head;
  v += head;
  o += head;
  const int q0 = q_tile * kBlockQ;
  const int row = threadIdx.x / 4;   // the query row this thread helps own
  const int lane4 = threadIdx.x % 4;
  const int q_pos = q0 + row;

  load_tile<T, DP>(sq, q, q0, kBlockQ, t_len, d);

  constexpr int kOut = DP / 4;       // output columns lane4 + 4 i
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
  float m = -CUDART_INF_F, l = 0.0f;

  const int n_kv_tiles = (t_len + kBlockK - 1) / kBlockK;
  const int last_q = min(q0 + kBlockQ, t_len) - 1;
  const int kv_end = causal ? last_q / kBlockK + 1 : n_kv_tiles;
  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();   // the previous tile's K, V and P are no longer read
    load_tile<T, DP>(sk, k, k0, kBlockK, t_len, d);
    load_tile<T, DP>(sv, v, k0, kBlockK, t_len, d);
    __syncthreads();

    // S = Q K^T for columns lane4 + 4 c of this row
    float s[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) s[c] = 0.0f;
    const float* qrow = sq + row * L::stride;
    for (int x = 0; x < DP; ++x) {
      const float qx = qrow[x];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        s[c] = fmaf(qx, sk[(lane4 + 4 * c) * L::stride + x], s[c]);
    }
    const bool crossing = causal && k0 + kBlockK - 1 > q0;
    const bool ragged = k0 + kBlockK > t_len;
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int k_pos = k0 + lane4 + 4 * c;
      s[c] *= scale_log2;            // log2 units: exp2 below
      if ((crossing && k_pos > q_pos) || (ragged && k_pos >= t_len))
        s[c] = kMaskFill;
      tile_max = fmaxf(tile_max, s[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);   // 0 on the first tile
    float row_sum = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const float p = exp2f(s[c] - m_new);
      row_sum += p;
      // P in the input type before P V, as the reference casts p
      sp[row * L::p_stride + lane4 + 4 * c] = to_float(from_float<T>(p));
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;
    __syncthreads();   // P complete

    // O = O * alpha + P V for columns lane4 + 4 i of this row
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] *= alpha;
    const float* prow = sp + row * L::p_stride;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = prow[c];
      const float* vrow = sv + c * L::stride + lane4;
#pragma unroll
      for (int i = 0; i < kOut; ++i) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  if (q_pos < t_len) {
    const float inv = 1.0f / l;
    T* orow = o + static_cast<size_t>(q_pos) * d;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int col = lane4 + 4 * i;
      if (col < d) orow[col] = from_float<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int heads,
           int t_len, int d, float scale, int causal, cudaStream_t s) {
  auto kernel = flash_generic_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DP>::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + kBlockQ - 1) / kBlockQ, heads);
  kernel<<<grid, kThreads, Layout<DP>::bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, d, scale * kLog2e,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bucket(const void* q, const void* k, const void* v, void* o,
                  int heads, int t_len, int d, float scale, int causal,
                  cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, heads, t_len, d, scale, causal, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, heads, t_len, d, scale, causal, s);
  return launch<T, 256>(q, k, v, o, heads, t_len, d, scale, causal, s);
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous, of one type: dtype 0 f32, 1 f16,
// 2 bf16; 1 <= D <= 256, T >= 1. Runs on `stream`; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// dtype, D or T).
extern "C" int flash_fwd_generic(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int heads, int T, int D,
                                 float scale, int causal, void* stream) {
  if (D < 1 || D > 256 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bucket<float>(q, k, v, o, heads, T, D, scale, causal, s);
    case 1:
      return launch_bucket<__half>(q, k, v, o, heads, T, D, scale, causal, s);
    case 2:
      return launch_bucket<__nv_bfloat16>(q, k, v, o, heads, T, D, scale,
                                          causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
