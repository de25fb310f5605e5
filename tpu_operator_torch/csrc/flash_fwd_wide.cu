// Flash-attention forward for head dims past the other kernels' reach (K2d):
// softmax(q k^T * scale) v over [H, T, D] with an online softmax, f32, f16 or
// bf16, any D >= 1, any T, causal or full. The routing sends it what no
// tensor-core kernel takes past D = 512: f32 with D % 4 != 0 (K2dt,
// flash_fwd_wide_tf32.cu, takes the rest) and 16-bit with D % 8 != 0.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel for those
// inputs: the Pallas kernel takes any [T, D], with a [block_q, D] f32
// accumulator in VMEM.
//
// Bound on an H100: the operations. 4 D T(T+1)/2 flops a head causal (4 D
// T^2 full) against 4 T D elements of traffic; over the 989 TFLOP/s
// tensor-core peak for 16-bit inputs and the 67 TFLOP/s f32 CUDA-core peak
// for f32 (exact f32 here: no TF32). What stands in the way at D > 512:
// a block cannot hold the Q tile and the accumulator of a 64-row q tile.
// At D = 1024 the f32 accumulator alone is 256 KiB, more than a block's
// 227 KiB of shared memory and as large as an SM's register file.
//
// Design: the output's head dim is split across blocks, and every block
// computes the full scores.
//   - One block of 256 threads per (unit, D chunk): the units of K2 and K2s
//     (flash_common.cuh; at most SPLIT kv tiles of 64 keys, longest first),
//     each cut into ceil(D / 256) chunks of kDC = 256 output columns. The
//     chunk blocks of a unit are neighbours in the grid, so they read the
//     same Q and K rows at about the same time, from L2.
//   - Each block forms S = Q K^T over the whole of D: Q and K stream through
//     shared memory in chunks of kKC = 32 columns, double-buffered, the next
//     chunk loaded into registers (converted to f32 when stored) while the
//     block multiplies the current one. Register tiles as in K2s
//     (flash_fwd_generic.cu): the 256 threads are a 16 x 16 grid, thread
//     (ty, tx) owns rows 4 ty .. 4 ty + 3 and key columns tx + 16 c.
//   - Then the online softmax, and O[:, chunk] += P V[:, chunk], with that
//     chunk's V tile in shared memory (cp.async, issued when the kv step
//     starts so that it lands while S is formed) and the chunk's 4 x 256
//     accumulator slice in registers: 64 floats a thread, for any D.
//   - m and l agree bit for bit across the chunk blocks of a unit: every one
//     forms S, m and l with the same instructions in the same order, and V's
//     chunk enters none of them. So each block normalises its own columns;
//     a split unit's chunk 0 alone writes m and l.
//   - The merge of K2 and K2s (flash_common.cuh), whose row stride is a
//     runtime argument, joins the units of a split q tile, block by block
//     of 128 columns (part_acc is [slots][64][acc_cols], acc_cols at least
//     D rounded up to kDC, as the caller sized it).
//   - The cost, accepted here: the scores are formed once a chunk, so the
//     work is about (D / kDC + 1) / 2 times the least (2.5x at D = 1024).
//     A thread-block cluster that sums partial scores of D slices through
//     distributed shared memory, and tensor cores for 16-bit inputs, would
//     remove it.
//   - Numbers as the reference and K2s: scores, m, l and acc in f32; P
//     rounded to the input type before P V; the three causal tile classes
//     (the work list skips tiles above the diagonal, a step that crosses it
//     or holds keys past T is masked) with the -1e30 fill; the output rounded
//     once to the input type. Offsets that grow with heads T D or slots 64 D
//     are 64-bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
using flash::from_float;
using flash::to_float;

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 4;        // q rows a thread owns
constexpr int kBK = 64;         // keys a kv step (one work-list kv tile)
constexpr int kKC = 32;         // columns of Q and K a chunk of S
constexpr int kDC = 256;        // output columns a block
constexpr int kLdQK = kKC + 4;  // floats a Q or K chunk row
constexpr int kLdV = kDC + 4;   // floats a V row
constexpr int kLdP = kBK + 4;   // floats a P row
// shared memory in floats: two Q and two K chunk buffers, V, P, and the
// 16-bit V staging tile
constexpr int kQBuf = kBlockQ * kLdQK;
constexpr int kKBuf = kBK * kLdQK;
constexpr int kOffK = 2 * kQBuf;
constexpr int kOffV = kOffK + 2 * kKBuf;
constexpr int kOffP = kOffV + kBK * kLdV;
constexpr int kOffStage = kOffP + kBlockQ * kLdP;

template <typename T>
constexpr int smem_bytes() {
  return kOffStage * 4 + (sizeof(T) == 2 ? kBK * kDC * 2 : 0);
}

// Four consecutive elements of a row as loaded from global memory: one
// vector load where the row stride keeps them aligned (D % 4 == 0), else
// element by element; zeros past the row's end or for a row past T.
template <typename T>
struct Quad {
  uint2 raw;   // four 16-bit values
  __device__ __forceinline__ void load(const T* p, int n, bool vec) {
    if (vec && n >= 4) {
      raw = __ldg(reinterpret_cast<const uint2*>(p));
      return;
    }
    uint16_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const T x = e < n ? p[e] : from_float<T>(0.f);
      h[e] = *reinterpret_cast<const uint16_t*>(&x);
    }
    raw = make_uint2(h[0] | (static_cast<uint32_t>(h[1]) << 16),
                     h[2] | (static_cast<uint32_t>(h[3]) << 16));
  }
  __device__ __forceinline__ float4 get() const {
    const T* h = reinterpret_cast<const T*>(&raw);
    return make_float4(to_float(h[0]), to_float(h[1]), to_float(h[2]),
                       to_float(h[3]));
  }
};

template <>
struct Quad<float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p, int n, bool vec) {
    if (vec && n >= 4) {
      raw = __ldg(reinterpret_cast<const float4*>(p));
      return;
    }
    raw.x = n > 0 ? p[0] : 0.f;
    raw.y = n > 1 ? p[1] : 0.f;
    raw.z = n > 2 ? p[2] : 0.f;
    raw.w = n > 3 ? p[3] : 0.f;
  }
  __device__ __forceinline__ float4 get() const { return raw; }
};

// Block b takes unit b / n_chunks and output columns [256 c, 256 c + 256),
// c = b % n_chunks. A unit covers kv tiles [unit.y, unit.z) of 64 keys.
// part_acc rows are acc_cols floats.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int4* __restrict__ units, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int acc_cols, int t_len,
                  int d, int n_chunks, float scale_log2, int causal) {
  constexpr int kGroups = kDC / 64;   // float4 output groups a row
  constexpr int kCols = kBK / 16;     // score columns a thread owns
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = smem + kOffK;
  float* sv = smem + kOffV;
  float* sp = smem + kOffP;
  T* stage = reinterpret_cast<T*>(smem + kOffStage);

  const int4 unit = units[blockIdx.x / n_chunks];
  const int c0 = (blockIdx.x % n_chunks) * kDC;   // this block's columns
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (unit.x % nq) * kBlockQ;
  const size_t head = static_cast<size_t>(unit.x / nq) * t_len * d;
  q += head;
  k += head;
  v += head;
  o += head;
  const int first = unit.y;
  const int n = min(unit.z, (t_len + kBK - 1) / kBK) - first;
  const int n_kc = (d + kKC - 1) / kKC;           // chunks of S a kv step
  const bool vec = d % 4 == 0;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = kRows * ty;

  // The next Q and K chunk in registers: each thread loads two groups of
  // four columns of each, group g = tid + 256 i at row g / 8, columns
  // 4 (g % 8) of the chunk.
  Quad<T> pq[2], pk[2];
  auto prefetch = [&](int step, int chunk) {
    const int kr0 = (first + step) * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = tid + kThreads * i;
      const int r = g / (kKC / 4);
      const int c = chunk * kKC + 4 * (g % (kKC / 4));
      pq[i].load(q + static_cast<size_t>(q0 + r) * d + c,
                 q0 + r < t_len ? d - c : 0, vec);
      pk[i].load(k + static_cast<size_t>(kr0 + r) * d + c,
                 kr0 + r < t_len ? d - c : 0, vec);
    }
  };
  auto store = [&](float* bq, float* bk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = tid + kThreads * i;
      const int at = (g / (kKC / 4)) * kLdQK + 4 * (g % (kKC / 4));
      *reinterpret_cast<float4*>(bq + at) = pq[i].get();
      *reinterpret_cast<float4*>(bk + at) = pk[i].get();
    }
  };

  // This kv step's V columns [c0, c0 + 256): by cp.async straight into the
  // f32 tile (f32, D % 4 == 0) or into the staging tile (16-bit, D % 8 ==
  // 0), else element by element once S is formed; zeros past T and D.
  constexpr bool k16 = sizeof(T) == 2;
  const bool async_v = k16 ? d % 8 == 0 : d % 4 == 0;
  constexpr int kPer = k16 ? 8 : 4;             // elements a 16-byte copy
  auto issue_v = [&](int kr0) {
    if (!async_v) return;
    for (int i = tid; i < kBK * kDC / kPer; i += kThreads) {
      const int r = i / (kDC / kPer), c = kPer * (i % (kDC / kPer));
      const bool ok = kr0 + r < t_len && c0 + c < d;
      const T* src = ok ? v + static_cast<size_t>(kr0 + r) * d + c0 + c : v;
      void* dst = k16 ? static_cast<void*>(stage + r * kDC + c)
                        : static_cast<void*>(sv + r * kLdV + c);
      cp_async16(dst, src, ok);
    }
    cp_async_commit();
  };
  // a barrier: V's tile is in shared memory, in f32, for every thread
  auto land_v = [&](int kr0) {
    if (async_v) {
      cp_async_wait_all();
    } else {
      for (int i = tid; i < kBK * kDC; i += kThreads) {
        const int r = i / kDC, c = i % kDC;
        sv[r * kLdV + c] =
            (kr0 + r < t_len && c0 + c < d)
                ? to_float(v[static_cast<size_t>(kr0 + r) * d + c0 + c])
                : 0.f;
      }
    }
    __syncthreads();
    if (async_v && k16) {   // the landed staging tile into the f32 tile
      for (int i = tid; i < kBK * kDC / 8; i += kThreads) {
        const int r = i / (kDC / 8), c = 8 * (i % (kDC / 8));
        const uint4 raw = *reinterpret_cast<const uint4*>(stage + r * kDC + c);
        const T* h = reinterpret_cast<const T*>(&raw);
        float4* out = reinterpret_cast<float4*>(sv + r * kLdV + c);
        out[0] = make_float4(to_float(h[0]), to_float(h[1]), to_float(h[2]),
                             to_float(h[3]));
        out[1] = make_float4(to_float(h[4]), to_float(h[5]), to_float(h[6]),
                             to_float(h[7]));
      }
      __syncthreads();
    }
  };

  float4 acc[kRows][kGroups];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      acc[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[kRows], l[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = __int_as_float(0xff800000);
    l[a] = 0.f;
  }

  prefetch(0, 0);
  int j = 0;   // chunks stored so far: chunk j goes to buffer j % 2
  for (int it = 0; it < n; ++it) {
    const int k0 = (first + it) * kBK;
    // S = Q K^T over all of D, for rows row0 + a and keys tx + 16 c
    float s[kRows][kCols] = {};
    for (int kc = 0; kc < n_kc; ++kc, ++j) {
      float* bq = sq + (j & 1) * kQBuf;
      float* bk = sk + (j & 1) * kKBuf;
      // buffer j % 2 was last read by chunk j - 2, which every thread had
      // finished before the barrier of chunk j - 1
      store(bq, bk);
      __syncthreads();
      // every thread is past the last step's P V: V's tile is free
      if (kc == 0) issue_v(k0);
      if (kc + 1 < n_kc) prefetch(it, kc + 1);
      else if (it + 1 < n) prefetch(it + 1, 0);
#pragma unroll
      for (int x = 0; x < kKC; x += 4) {
        float4 qf[kRows], kf[kCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a)
          qf[a] = *reinterpret_cast<const float4*>(bq + (row0 + a) * kLdQK +
                                                   x);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          kf[c] = *reinterpret_cast<const float4*>(bk + (tx + 16 * c) * kLdQK +
                                                   x);
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            s[a][c] = dot4(qf[a], kf[c], s[a][c]);
      }
    }
    land_v(k0);   // a barrier: V's tile is in shared memory

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
        // P in the input type before P V, as the reference casts p
        sp[(row0 + a) * kLdP + tx + 16 * c] = to_float(from_float<T>(p));
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
    __syncthreads();   // P complete

    // O[:, chunk] += P V[:, chunk] for rows row0 + a, columns 4 tx + 64 g
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pf[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
        pf[a] = *reinterpret_cast<const float4*>(sp + (row0 + a) * kLdP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = sv + (kk + e) * kLdV + 4 * tx;
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
  }

  if (unit.w >= 0) {
    // a partial: m (log2 units) and l from chunk 0 (every chunk block holds
    // the same), this block's columns of the unnormalised acc
    float* ml = part_ml + static_cast<size_t>(unit.w) * 2 * kBlockQ;
    float* dst =
        part_acc + static_cast<size_t>(unit.w) * kBlockQ * acc_cols + c0;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      if (tx == 0 && c0 == 0) {
        ml[row0 + a] = m[a];
        ml[kBlockQ + row0 + a] = l[a];
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        *reinterpret_cast<float4*>(dst +
                                   static_cast<size_t>(row0 + a) * acc_cols +
                                   4 * tx + 64 * g) = acc[a][g];
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
      const int c = c0 + 4 * tx + 64 * g;
      if (c < d)
        flash::store4<T>(dst + c,
                         make_float4(acc[a][g].x * inv, acc[a][g].y * inv,
                                     acc[a][g].z * inv, acc[a][g].w * inv),
                         d - c, d % 4 == 0);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* units, int n_units, const void* merges, int n_merges,
           void* part_acc, void* part_ml, int acc_cols, int t_len, int d,
           float scale, int causal, cudaStream_t s) {
  auto kernel = flash_wide_kernel<T>;
  constexpr int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (d + kDC - 1) / kDC;
  kernel<<<static_cast<unsigned>(n_units) * n_chunks, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int4*>(units), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), acc_cols, t_len, d, n_chunks,
      scale * kLog2e, causal);
  flash::launch_combine<T>(merges, n_merges, part_acc, part_ml, o, t_len, d,
                           acc_cols, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous, 16-byte aligned, of one type: dtype
// 0 f32, 1 f16, 2 bf16; D >= 1, T >= 1. units, merges and part_ml as for
// flash_fwd_generic (flash_fwd_generic.cu); part_acc f32
// [slots][64][acc_cols], acc_cols a multiple of 4 and at least D rounded up
// to a multiple of 256. Runs on `stream`; returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for another dtype, D, T or acc_cols).
extern "C" int flash_fwd_wide(const void* q, const void* k, const void* v,
                              void* o, const void* units, int n_units,
                              const void* merges, int n_merges,
                              void* part_acc, void* part_ml, int acc_cols,
                              int dtype, int heads, int T, int D, float scale,
                              int causal, void* stream) {
  if (D < 1 || T < 1 || heads < 1 || n_units < 1 || acc_cols % 4 != 0 ||
      acc_cols < (D + kDC - 1) / kDC * kDC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, units, n_units, merges, n_merges,
                           part_acc, part_ml, acc_cols, T, D, scale, causal,
                           s);
    case 1:
      return launch<__half>(q, k, v, o, units, n_units, merges, n_merges,
                            part_acc, part_ml, acc_cols, T, D, scale, causal,
                            s);
    case 2:
      return launch<__nv_bfloat16>(q, k, v, o, units, n_units, merges,
                                   n_merges, part_acc, part_ml, acc_cols, T,
                                   D, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
