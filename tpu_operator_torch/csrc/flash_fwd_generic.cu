// Flash-attention forward on CUDA cores (K2s), for f32 inputs with any head
// dim D up to 256 and any sequence length T (every 16-bit input, and f32
// past 256, goes to a tensor-core kernel: flash_fwd.cu,
// flash_fwd_wide_wgmma.cu, flash_fwd_wide_tf32.cu).
// softmax(q k^T * scale) v over [H, T, D] with an online softmax, so the
// [T, T] score matrix never reaches device memory.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel for those
// inputs (the Pallas kernel takes any [T, D] and any dtype).
//
// Bound on an H100: the operations. 4 D T^2 flops (half of it causal)
// against 4 T D elements of traffic is hundreds of operations per byte at
// T = 4096, above the card's ridge. f32 stays exact f32 (one TF32 product
// errs about 1e-3, twenty times attention_tolerance), so the least time is
// the flops over the 67 TFLOP/s f32 CUDA-core peak. What stands between a
// kernel and it: shared-memory loads (one per FMA, as a row-per-thread
// kernel issues them, caps it near a quarter of the peak), global loads
// that do not overlap the products, and SMs left idle by long causal rows.
//
// Design:
//   - Units, as in K2 (flash_common.cuh): one block of 256 threads takes a
//     unit of a 64-row q tile, and the merge kernel joins the units of a
//     split q tile. At T = 4096 causal the work list holds 288 units, not
//     64 q tiles, so every SM has work.
//   - Register tiles, as in an SGEMM. The 256 threads are a 16 x 16 grid;
//     thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the q tile. In
//     S = Q K^T it owns key columns tx + 16 c (c < 4) of a kv step of 64
//     keys and forms them as outer products of float4 fragments of Q's and
//     K's rows: 8 FMAs a 16-byte shared-memory load. In O += P V it owns
//     output columns 4 tx + 64 g .. + 3 (g < DP / 64) of its four rows in
//     registers for the whole unit: per key one float4 of V for each g,
//     and a float4 of P a row per four keys, 8 to 14 FMAs a load.
//   - Shared memory holds Q, one K tile, one V tile and P, in f32 with rows
//     padded by 4 floats (conflict-free float4 reads). K and V alternate:
//     one tile is in flight at a time, this step's V tile while S runs and
//     the next K tile while the softmax and P V run. Rows whose D is a
//     multiple of 4 go by cp.async (16 bytes, .cg: L2 only), zero-filled
//     past T and D; Q, and rows of other widths, are loaded element by
//     element.
//   - Head-dim buckets DP = 64, 128 and 256, 64 keys a kv step (one
//     work-list kv tile), to fit a block's 227 KiB: 212 KiB at DP = 256.
//     Columns past D are zeros, which add nothing to a dot product.
//   - The reference's three causal classes and its -1e30 fill, also for
//     keys past T; every unit's first kv step holds an unmasked key for each
//     row, so m is finite and no update becomes NaN. Rows past T and
//     columns past D are not stored.
//   - Numbers: f32 throughout, as the reference computes f32 inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait_all;
using flash::dot4;
using flash::kBlockQ;
using flash::kLog2e;
using flash::kMaskFill;

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 4;        // q rows a thread owns
constexpr int kBK = kBlockQ;    // keys a kv step: one work-list kv tile

template <int DP>
struct Layout {
  static constexpr int ld = DP + 4;        // floats a Q, K or V row
  static constexpr int p_ld = kBK + 4;     // floats a P row
  static constexpr int q = 0;
  static constexpr int k = q + kBlockQ * ld;
  static constexpr int v = k + kBK * ld;
  static constexpr int p = v + kBK * ld;
  static constexpr int bytes = (p + kBlockQ * p_ld) * 4;
};

// Rows [row0, row0 + rows) of one head's [T, D] into a [rows][DP + 4] f32
// tile, zeros past T and D: by cp.async where D % 4 == 0 (in shared memory
// after the next wait), else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int rows, int t_len,
                                          int d) {
  constexpr int ld = DP + 4;
  if (d % 4 == 0) {
    for (int i = threadIdx.x; i < rows * DP / 4; i += kThreads) {
      const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
      const bool ok = row0 + r < t_len && c < d;
      cp_async16(dst + r * ld + c,
                 ok ? src + static_cast<size_t>(row0 + r) * d + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] = (row0 + r < t_len && c < d)
                            ? src[static_cast<size_t>(row0 + r) * d + c]
                            : 0.f;
    }
  }
}

// A unit (flash_common.cuh) covers kv tiles [unit.y, unit.z) of 64 keys, a
// kv step each, the last cut at T.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  const int4* __restrict__ units, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int t_len, int d,
                  float scale_log2, int causal) {
  using L = Layout<DP>;
  constexpr int kCols = kBK / 16;    // score columns a thread owns
  constexpr int kGroups = DP / 64;   // float4 output groups a row
  extern __shared__ float smem[];
  float* sq = smem + L::q;
  float* sk = smem + L::k;
  float* sv = smem + L::v;
  float* sp = smem + L::p;

  const int4 unit = units[blockIdx.x];
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (unit.x % nq) * kBlockQ;
  const size_t head = static_cast<size_t>(unit.x / nq) * t_len * d;
  q += head;
  k += head;
  v += head;
  o += head;
  const int first = unit.y;
  const int n = min(unit.z, (t_len + kBK - 1) / kBK) - first;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = kRows * ty;        // rows row0 .. row0 + 3 of the tile

  // one K or V tile in flight at a time: issue() starts its copy, land()
  // waits for it and makes it visible to every thread; both are called by
  // every thread, and land() is a barrier
  auto issue = [&](float* dst, const float* src, int row) {
    load_tile<DP>(dst, src, row, kBK, t_len, d);
    cp_async_commit();
  };
  auto land = [&]() {
    cp_async_wait_all();
    __syncthreads();
  };

  load_tile<DP>(sq, q, q0, kBlockQ, t_len, d);
  issue(sk, k, first * kBK);
  land();                              // Q and the first K tile
  issue(sv, v, first * kBK);

  float4 acc[kRows][kGroups];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int g = 0; g < kGroups; ++g) acc[a][g] = make_float4(0.f, 0.f, 0.f,
                                                              0.f);
  float m[kRows], l[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = __int_as_float(0xff800000);
    l[a] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = (first + it) * kBK;
    // this K tile has landed; this V tile is in flight
    // S = Q K^T for rows row0 + a, key columns tx + 16 c
    float s[kRows][kCols] = {};
#pragma unroll 4
    for (int x = 0; x < DP; x += 4) {
      float4 qf[kRows], kf[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
        qf[a] = *reinterpret_cast<const float4*>(sq + (row0 + a) * L::ld + x);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kf[c] = *reinterpret_cast<const float4*>(sk + (tx + 16 * c) * L::ld +
                                                 x);
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[a][c] = dot4(qf[a], kf[c], s[a][c]);
    }
    land();                // this V tile; every thread is done with S
    if (it + 1 < n) issue(sk, k, k0 + kBK);

    // online softmax in log2 units; a step is masked where it crosses the
    // diagonal or holds keys past T
    const bool masked = (causal && k0 + kBK - 1 > q0) || k0 + kBK > t_len;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int row = q0 + row0 + a;
      float mx = kMaskFill;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float x = s[a][c] * scale_log2;
        const int key = k0 + tx + 16 * c;
        if (masked && ((causal && key > row) || key >= t_len)) x = kMaskFill;
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int mask = 1; mask < 16; mask <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, mask));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = exp2f(m[a] - m_new);   // 0 on the first step
      m[a] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = exp2f(s[a][c] - m_new);
        sum += p;
        sp[(row0 + a) * L::p_ld + tx + 16 * c] = p;
      }
#pragma unroll
      for (int mask = 1; mask < 16; mask <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, mask);
      l[a] = l[a] * alpha + sum;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        acc[a][g].x *= alpha;
        acc[a][g].y *= alpha;
        acc[a][g].z *= alpha;
        acc[a][g].w *= alpha;
      }
    }
    __syncthreads();       // P complete

    // O += P V for rows row0 + a, columns 4 tx + 64 g .. + 3
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
        pf[a] = *reinterpret_cast<const float4*>(sp + (row0 + a) * L::p_ld +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sv + (kk + e) * L::ld + 4 * tx;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vf = *reinterpret_cast<const float4*>(vrow + 64 * g);
#pragma unroll
          for (int a = 0; a < kRows; ++a) {
            const float p = e == 0 ? pf[a].x : e == 1 ? pf[a].y
                          : e == 2 ? pf[a].z : pf[a].w;
            acc[a][g].x = fmaf(p, vf.x, acc[a][g].x);
            acc[a][g].y = fmaf(p, vf.y, acc[a][g].y);
            acc[a][g].z = fmaf(p, vf.z, acc[a][g].z);
            acc[a][g].w = fmaf(p, vf.w, acc[a][g].w);
          }
        }
      }
    }
    if (it + 1 < n) {
      land();              // the next K tile; every thread is done with P V
      issue(sv, v, k0 + kBK);
    }
  }

  if (unit.w >= 0) {
    // a partial: m (log2 units), l and the unnormalised acc for the merge
    float* ml = part_ml + static_cast<size_t>(unit.w) * 2 * kBlockQ;
    float* dst = part_acc + static_cast<size_t>(unit.w) * kBlockQ * DP;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      if (tx == 0) {
        ml[row0 + a] = m[a];
        ml[kBlockQ + row0 + a] = l[a];
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        *reinterpret_cast<float4*>(dst + (row0 + a) * DP + 4 * tx + 64 * g) =
            acc[a][g];
    }
    return;
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int row = q0 + row0 + a;
    if (row >= t_len) break;
    const float inv = 1.f / l[a];
    float* dst = o + static_cast<size_t>(row) * d;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = 4 * tx + 64 * g;
      if (c < d)
        flash::store4<float>(dst + c,
                             make_float4(acc[a][g].x * inv, acc[a][g].y * inv,
                                         acc[a][g].z * inv, acc[a][g].w * inv),
                             d - c, d % 4 == 0);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* units, int n_units, const void* merges, int n_merges,
           void* part_acc, void* part_ml, int t_len, int d, float scale,
           int causal, cudaStream_t s) {
  auto kernel = flash_simt_kernel<DP>;
  constexpr int bytes = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_units, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<const int4*>(units), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), t_len, d, scale * kLog2e, causal);
  flash::launch_combine<float>(merges, n_merges, part_acc, part_ml, o, t_len,
                               d, DP, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [heads, T, D] f32 contiguous, 16-byte aligned; dtype 0 (f32:
// the only one K2s takes); 1 <= D <= 256, T >= 1. units, merges, part_acc
// (f32 [slots][64][DP], DP the bucket that holds D) and part_ml as for
// flash_fwd_wgmma (flash_fwd.cu). Runs on `stream`; returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for another
// dtype, D or T).
extern "C" int flash_fwd_generic(const void* q, const void* k, const void* v,
                                 void* o, const void* units, int n_units,
                                 const void* merges, int n_merges,
                                 void* part_acc, void* part_ml, int dtype,
                                 int heads, int T, int D, float scale,
                                 int causal, void* stream) {
  if (dtype != 0 || D < 1 || D > 256 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<64>(q, k, v, o, units, n_units, merges, n_merges, part_acc,
                      part_ml, T, D, scale, causal, s);
  if (D <= 128)
    return launch<128>(q, k, v, o, units, n_units, merges, n_merges,
                       part_acc, part_ml, T, D, scale, causal, s);
  return launch<256>(q, k, v, o, units, n_units, merges, n_merges, part_acc,
                     part_ml, T, D, scale, causal, s);
}
