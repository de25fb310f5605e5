// Flash-attention forward: softmax(q k^T * scale) v over [H, T, D] bf16, with
// an online softmax so the [T, T] score matrix never reaches device memory.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel (a Pallas kernel
// whose grid walks (q block, kv block) in order on one TPU core, with the
// online-softmax state carried across the kv axis in VMEM scratch).
//
// Bound on an H100: the tensor cores. At T=4096, D=128, causal the kernel does
// about 2*T^2*D = 4.3 GFLOP against 4 MiB of traffic, far above the card's
// ~295 operations per byte, so the least time is the FLOPs over the bf16
// tensor-core peak (989 TFLOP/s on the SXM part).
//
// Design (a first, simple version: right before fast):
//   - One block per (64-row q tile, head). Blocks run in parallel and in no
//     order, so the TPU kernel's sequential kv grid axis becomes a loop inside
//     the block, and the m / l / acc state lives in the block for the whole loop.
//   - Four warps; each owns 16 q rows and computes its S = Q K^T slice and its
//     P V slice with nvcuda::wmma bf16 16x16x16 fragments accumulating in f32.
//     Only the K/V tile loads need the whole block to synchronise.
//   - Q, K, V, the f32 scores, the bf16 probabilities and the f32 output
//     accumulator take about 104 KiB of shared memory at D=128: more than the
//     48 KiB of static shared memory, so it is dynamic, raised with
//     cudaFuncSetAttribute.
//   - Causal tiles fall in the reference's three classes: tiles above the
//     diagonal are never visited (the loop stops at the diagonal), tiles below
//     it run unmasked, and only the diagonal tile is masked, with a -1e30 fill
//     so a fully masked half-row cannot make the online update NaN.
//   - P is rounded to bf16 before P V, as the reference casts p to v's dtype.
//
// What this version leaves on the table, for a later change: wgmma and TMA
// (wmma reaches only a fraction of Hopper's tensor-core rate), a pipelined K/V
// ring, and keeping the output accumulator in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one wmma tile of rows
constexpr float kMaskFill = -1e30f;

// Byte offsets of each shared-memory region (D = kHeadDim).
struct Smem {
  static constexpr size_t q = 0;                                // bf16 [BQ][D]
  static constexpr size_t k = q + kBlockQ * kHeadDim * 2;       // bf16 [BK][D]
  static constexpr size_t v = k + kBlockK * kHeadDim * 2;       // bf16 [BK][D]
  static constexpr size_t s = v + kBlockK * kHeadDim * 2;       // f32  [BQ][BK]
  static constexpr size_t p = s + kBlockQ * kBlockK * 4;        // bf16 [BQ][BK]
  static constexpr size_t o = p + kBlockQ * kBlockK * 2;        // f32  [BQ][D]
  static constexpr size_t l = o + kBlockQ * kHeadDim * 4;       // f32  [BQ]
  static constexpr size_t bytes = l + kBlockQ * 4;
};

// Copy `rows` contiguous rows of kHeadDim bf16 from global to shared memory
// with 16-byte loads spread over the whole block.
template <int rows>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  constexpr int n = rows * kHeadDim * 2 / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int T, float scale,
                 int causal) {
  constexpr int D = kHeadDim;
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sL = reinterpret_cast<float*>(smem + L::l);

  const int q0 = blockIdx.x * kBlockQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * T * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  copy_tile<kBlockQ>(sQ, q + head + static_cast<size_t>(q0) * D);
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) sO[i] = 0.f;

  // Lanes 2r and 2r+1 own row r of this warp's 16 rows, half the columns each;
  // both keep the row's running max and normaliser in registers.
  const int row = warp * kRowsPerWarp + (lane >> 1);
  const int half = lane & 1;
  const int q_pos = q0 + row;
  float m_run = __int_as_float(0xff800000);  // -inf
  float l_run = 0.f;

  const int num_kv = causal ? (q0 + kBlockQ - 1) / kBlockK + 1 : T / kBlockK;
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    copy_tile<kBlockK>(sK, k + head + static_cast<size_t>(k0) * D);
    copy_tile<kBlockK>(sV, v + head + static_cast<size_t>(k0) * D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: K stored [BK][D] row-major is K^T
    // in column-major order with leading dimension D.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBlockK / 16];
#pragma unroll
      for (int n = 0; n < kBlockK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * kRowsPerWarp * D + kk, D);
#pragma unroll
        for (int n = 0; n < kBlockK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(b, sK + n * 16 * D + kk, D);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kBlockK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * kRowsPerWarp * kBlockK + n * 16,
                                acc[n], kBlockK, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's half row.
    constexpr int kHalf = kBlockK / 2;
    const bool masked = causal && (k0 + kBlockK - 1 > q0);  // diagonal tile
    const float* s_row = sS + row * kBlockK + half * kHalf;
    float sv[kHalf];
    float mx = kMaskFill;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      float x = s_row[c] * scale;
      if (masked && k0 + half * kHalf + c > q_pos) x = kMaskFill;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);  // 0 on the first tile
    __nv_bfloat16* p_row = sP + row * kBlockK + half * kHalf;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      const float p = __expf(sv[c] - m_new);
      sum += p;
      p_row[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* o_row = sO + row * D + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) o_row[c] *= alpha;
    __syncwarp();

    // O += P V for this warp's 16 rows, accumulating in the f32 tile.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* o_tile = sO + warp * kRowsPerWarp * D + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_tile, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBlockK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + warp * kRowsPerWarp * kBlockK + kk,
                               kBlockK);
        wmma::load_matrix_sync(b, sV + kk * D + n * 16, D);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (half == 0) sL[row] = l_run;
  __syncwarp();
  // Write this warp's rows as acc / l, neighbouring lanes on neighbouring
  // columns.
  for (int i = lane; i < kRowsPerWarp * D; i += 32) {
    const int r = warp * kRowsPerWarp + i / D;
    const int c = i % D;
    o[head + static_cast<size_t>(q0 + r) * D + c] =
        __float2bfloat16(sO[r * D + c] / sL[r]);
  }
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous bf16, 16-byte aligned; T a multiple of
// 64; D = 128. Runs on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another D).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, int heads, int T, int D, float scale,
                              int causal, void* stream) {
  if (D != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = Smem::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T / kBlockQ, heads);
  flash_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}
