// Flash-attention forward on CUDA cores (K2s), for the inputs the tensor-core
// kernel (flash_fwd.cu) does not take: f32 with any head dim D up to 512,
// and f16 or bf16 where D % 8 != 0 or 256 < D <= 512; any sequence length T.
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
//     S = Q K^T it owns key columns tx + 16 c (c < BK / 16) and forms them
//     as outer products of float4 fragments of Q's and K's rows: 8 FMAs a
//     16-byte shared-memory load at BK = 64, 5.3 at 32, 3.2 at 16. In
//     O += P V it owns output columns 4 tx + 64 g .. + 3 (g < DP / 64) of
//     its four rows in registers for the whole unit: per key one float4 of
//     V for each g, and a float4 of P a row per four keys, 8 to 14 FMAs a
//     load.
//   - Shared memory holds Q, one K tile, one V tile and P, in f32 with rows
//     padded by 4 floats (conflict-free float4 reads). K and V alternate:
//     one tile is in flight at a time, this step's V tile while S runs and
//     the next K tile while the softmax and P V run. Copies go by cp.async
//     (16 bytes, .cg: L2 only), zero-filled past T and D: f32 rows whose D
//     is a multiple of 4 straight into their f32 tile, 16-bit rows whose D
//     is a multiple of 8 into a staging tile of the input type, converted
//     to f32 once they have landed (one shared-memory pass, no wait on
//     global memory). Q, and the rows of other widths, are loaded and
//     converted in place; so are 16-bit tiles at DP = 256, where no staging
//     tile fits (the routing sends those inputs to K2w).
//   - Head-dim buckets DP = 64, 128, 256 (64 keys a kv step), 384 (32
//     keys) and 512 (16 keys), to fit a block's 227 KiB: 212 KiB at DP =
//     256; 203 KiB at 384, 227 KiB with the 16-bit staging tile; 198.5 KiB
//     at 512, 214.5 KiB with it. Columns past D are zeros, which add
//     nothing to a dot product; the 384 bucket spares D = 384 (Ulysses at
//     3 x 128) a quarter of its products and halves its kv steps.
//   - The reference's three causal classes and its -1e30 fill, also for
//     keys past T; every unit's first kv step holds an unmasked key for each
//     row, so m is finite and no update becomes NaN. Rows past T and
//     columns past D are not stored.
//   - Numbers: scores, m, l and acc in f32; P is rounded to the input type
//     before P V, as the reference casts p to v's dtype; the output is
//     rounded once to the input type.

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
using flash::from_float;
using flash::to_float;

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 4;        // q rows a thread owns
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory a block

template <typename T, int DP, int BK>
struct Layout {
  static constexpr int ld = DP + 4;        // floats a Q, K or V row
  static constexpr int p_ld = BK + 4;      // floats a P row
  static constexpr int q = 0;
  static constexpr int k = q + kBlockQ * ld;
  static constexpr int v = k + BK * ld;
  static constexpr int p = v + BK * ld;
  static constexpr int stage = p + kBlockQ * p_ld;   // [BK][DP] of T
  static constexpr int stage_bytes = BK * DP * 2;
  // 16-bit K and V tiles land in a staging tile where it fits
  static constexpr bool staged =
      sizeof(T) == 2 && stage * 4 + stage_bytes <= kMaxSmem;
  static constexpr int bytes = stage * 4 + (staged ? stage_bytes : 0);
};

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

// Rows [row0, row0 + rows) of one head's [T, D] into a [rows][DP + 4] f32
// tile, zeros past T and D. f32 with D % 4 == 0 goes by cp.async (in shared
// memory after the next wait); 16-bit with D % 8 == 0 by 16-byte loads
// converted to f32; any other shape element by element.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int row0,
                                          int rows, int t_len, int d) {
  constexpr int ld = DP + 4;
  if (std::is_same<T, float>::value && d % 4 == 0) {
    for (int i = threadIdx.x; i < rows * DP / 4; i += kThreads) {
      const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
      const bool ok = row0 + r < t_len && c < d;
      cp_async16(dst + r * ld + c,
                 ok ? src + static_cast<size_t>(row0 + r) * d + c : src, ok);
    }
  } else if (!std::is_same<T, float>::value && d % 8 == 0) {
    for (int i = threadIdx.x; i < rows * DP / 8; i += kThreads) {
      const int r = i / (DP / 8), c = 8 * (i % (DP / 8));
      float f[8] = {};
      if (row0 + r < t_len && c < d) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(row0 + r) * d + c));
        const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = to_float(h[e]);
      }
      float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
      out[0] = make_float4(f[0], f[1], f[2], f[3]);
      out[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] =
          (row0 + r < t_len && c < d)
              ? to_float(src[static_cast<size_t>(row0 + r) * d + c])
              : 0.f;
    }
  }
}

// 16-bit rows [row0, row0 + rows) (D % 8 == 0) by cp.async into a
// [rows][DP] staging tile of T, zeros past T and D.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int row0, int rows, int t_len,
                                           int d) {
  for (int i = threadIdx.x; i < rows * DP / 8; i += kThreads) {
    const int r = i / (DP / 8), c = 8 * (i % (DP / 8));
    const bool ok = row0 + r < t_len && c < d;
    cp_async16(dst + r * DP + c,
               ok ? src + static_cast<size_t>(row0 + r) * d + c : src, ok);
  }
}

// A landed [rows][DP] staging tile into a [rows][DP + 4] f32 tile.
template <typename T, int DP>
__device__ __forceinline__ void convert_stage(float* dst, const T* src,
                                              int rows) {
  constexpr int ld = DP + 4;
  for (int i = threadIdx.x; i < rows * DP / 8; i += kThreads) {
    const int r = i / (DP / 8), c = 8 * (i % (DP / 8));
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * DP + c);
    const T* h = reinterpret_cast<const T*>(&raw);
    float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
    out[0] = make_float4(to_float(h[0]), to_float(h[1]), to_float(h[2]),
                         to_float(h[3]));
    out[1] = make_float4(to_float(h[4]), to_float(h[5]), to_float(h[6]),
                         to_float(h[7]));
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// A unit (flash_common.cuh) covers kv tiles [unit.y, unit.z) of 64 keys: kv
// steps [64 unit.y / BK, 64 unit.z / BK) of BK keys, the last cut at T.
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int4* __restrict__ units, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int t_len, int d,
                  float scale_log2, int causal) {
  using L = Layout<T, DP, BK>;
  constexpr int kCols = BK / 16;     // score columns a thread owns
  constexpr int kGroups = DP / 64;   // float4 output groups a row
  constexpr int kSub = kBlockQ / BK;
  extern __shared__ float smem[];
  float* sq = smem + L::q;
  float* sk = smem + L::k;
  float* sv = smem + L::v;
  float* sp = smem + L::p;
  T* stage = reinterpret_cast<T*>(smem + L::stage);

  const int4 unit = units[blockIdx.x];
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (unit.x % nq) * kBlockQ;
  const size_t head = static_cast<size_t>(unit.x / nq) * t_len * d;
  q += head;
  k += head;
  v += head;
  o += head;
  const int first = unit.y * kSub;
  const int n = min(unit.z * kSub, (t_len + BK - 1) / BK) - first;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = kRows * ty;        // rows row0 .. row0 + 3 of the tile

  // one K or V tile in flight at a time: issue() starts its copy, land()
  // waits for it and makes it visible to every thread; both are called by
  // every thread, and land() is a barrier
  const bool staged = L::staged && d % 8 == 0;
  auto issue = [&](float* dst, const T* src, int row) {
    if (staged) stage_tile<T, DP>(stage, src, row, BK, t_len, d);
    else load_tile<T, DP>(dst, src, row, BK, t_len, d);
    cp_async_commit();
  };
  auto land = [&](float* dst) {
    cp_async_wait_all();
    __syncthreads();
    if (staged) {
      convert_stage<T, DP>(dst, stage, BK);
      __syncthreads();
    }
  };

  load_tile<T, DP>(sq, q, q0, kBlockQ, t_len, d);
  issue(sk, k, first * BK);
  land(sk);                            // Q and the first K tile
  issue(sv, v, first * BK);

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
    const int k0 = (first + it) * BK;
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
    land(sv);              // this V tile; every thread is done with S
    if (it + 1 < n) issue(sk, k, k0 + BK);

    // online softmax in log2 units; a step is masked where it crosses the
    // diagonal or holds keys past T
    const bool masked = (causal && k0 + BK - 1 > q0) || k0 + BK > t_len;
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
        // P in the input type before P V, as the reference casts p
        sp[(row0 + a) * L::p_ld + tx + 16 * c] = to_float(from_float<T>(p));
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
    for (int kk = 0; kk < BK; kk += 4) {
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
      land(sk);            // the next K tile; every thread is done with P V
      issue(sv, v, k0 + BK);
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
    T* dst = o + static_cast<size_t>(row) * d;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = 4 * tx + 64 * g;
      if (c < d)
        flash::store4<T>(dst + c,
                         make_float4(acc[a][g].x * inv, acc[a][g].y * inv,
                                     acc[a][g].z * inv, acc[a][g].w * inv),
                         d - c, d % 4 == 0);
    }
  }
}

template <typename T, int DP, int BK>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* units, int n_units, const void* merges, int n_merges,
           void* part_acc, void* part_ml, int t_len, int d, float scale,
           int causal, cudaStream_t s) {
  auto kernel = flash_simt_kernel<T, DP, BK>;
  constexpr int bytes = Layout<T, DP, BK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_units, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int4*>(units), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), t_len, d, scale * kLog2e, causal);
  flash::launch_combine<T, DP>(merges, n_merges, part_acc, part_ml, o, t_len,
                               d, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bucket(const void* q, const void* k, const void* v, void* o,
                  const void* units, int n_units, const void* merges,
                  int n_merges, void* part_acc, void* part_ml, int t_len,
                  int d, float scale, int causal, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64, 64>(q, k, v, o, units, n_units, merges, n_merges,
                             part_acc, part_ml, t_len, d, scale, causal, s);
  if (d <= 128)
    return launch<T, 128, 64>(q, k, v, o, units, n_units, merges, n_merges,
                              part_acc, part_ml, t_len, d, scale, causal, s);
  if (d <= 256)
    return launch<T, 256, 64>(q, k, v, o, units, n_units, merges, n_merges,
                              part_acc, part_ml, t_len, d, scale, causal, s);
  if (d <= 384)
    return launch<T, 384, 32>(q, k, v, o, units, n_units, merges, n_merges,
                              part_acc, part_ml, t_len, d, scale, causal, s);
  return launch<T, 512, 16>(q, k, v, o, units, n_units, merges, n_merges,
                            part_acc, part_ml, t_len, d, scale, causal, s);
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous, 16-byte aligned, of one type: dtype
// 0 f32, 1 f16, 2 bf16; 1 <= D <= 512, T >= 1. units, merges, part_acc
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
  if (D < 1 || D > 512 || T < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bucket<float>(q, k, v, o, units, n_units, merges,
                                  n_merges, part_acc, part_ml, T, D, scale,
                                  causal, s);
    case 1:
      return launch_bucket<__half>(q, k, v, o, units, n_units, merges,
                                   n_merges, part_acc, part_ml, T, D, scale,
                                   causal, s);
    case 2:
      return launch_bucket<__nv_bfloat16>(q, k, v, o, units, n_units, merges,
                                          n_merges, part_acc, part_ml, T, D,
                                          scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
