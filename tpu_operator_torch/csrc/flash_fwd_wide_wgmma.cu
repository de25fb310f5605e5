// Flash-attention forward on the tensor cores for 16-bit heads past 256
// (K2dw): softmax(q k^T * scale) v over [H, T, D] f16 or bf16 inputs, any D
// (the routing sends it D > 256), any T, causal or full. At D = 384 and 512
// a unit runs two chunk blocks; the last one's columns past D are zeros
// (TMA fills them) and are not stored.
//
// Replaces tpu_operator/ops/flash_attention.py::_flash_kernel for those
// inputs (the Pallas kernel takes any [T, D], with a [block_q, D] f32
// accumulator in VMEM).
//
// Bound on an H100: the operations. 4 D T(T+1)/2 flops a head causal (4 D
// T^2 full) over the 989 TFLOP/s 16-bit tensor-core peak: 0.0695 ms at
// [2, 4096, 1024] causal; its 4 T D elements of traffic a head take 0.02 ms
// at 3.35 TB/s. What the design does about it:
//   1. S = Q K^T and O += P V run on wgmma, not on CUDA cores.
//   2. The scores are formed again for each 256-column output chunk, (D/256
//      + 1)/2 times the least work (2.5x at D = 1024): kept, since a block
//      cannot hold a 64-row accumulator for all of D; on the tensor cores
//      the extra products cost a fraction of what they would on CUDA cores.
//      Partial scores of D slices summed through distributed shared memory
//      would remove them (open).
//   3. Q and K go in boxes of 64 columns by TMA straight into the
//      128-byte-swizzled shared memory the wgmma descriptors read, through
//      a ring of stages that a producer warp keeps ahead of the products,
//      across kv steps; no thread of the consumer touches them.
//
// Design:
//   - The schedule: the units of K2 and K2w (flash_common.cuh; at most
//     SPLIT kv tiles of 64 keys, longest first), each cut into ceil(D / 256)
//     chunks of kDC = 256 output columns, one block a (unit, chunk); a
//     partial workspace with rows of D rounded up to 256, and the shared
//     merge. ops/flash_attention.py::flash_chunked_plain at chunk 256 is its
//     plain model.
//   - A block is one consumer warpgroup and one producer warp. The consumer
//     owns the unit's 64 rows x 256 columns of O in registers, 128 f32 a
//     thread, as K2w does at DP = 256.
//   - A kv step of 64 keys: S = Q K^T over all of D by wgmma m64n64k16, D
//     walked in k-chunks of 64 columns, one TMA box of Q and one of K a
//     chunk, four k-steps each, into one 64 x 64 f32 fragment. The boxes
//     run through a ring of kStages stages of two k-chunks, with full and
//     empty mbarriers; a stage is released once the products that read it
//     are done (one committed stage stays in flight). The producer keeps the
//     ring full across kv steps. V's four 64-column boxes for this block's
//     columns go into a stage of their own (two, alternating), issued when
//     the step begins so that they land while S is formed. Then the online
//     softmax and O += P V (wgmma m64n256k16: P rounded to the input type
//     in registers as the A operand, V an MN-major B operand) exactly as
//     K2w runs them (flash_common.cuh::softmax_step).
//   - No thread-block clusters. Every block of a unit reads the same Q and
//     K boxes, and a cluster of a unit's chunk blocks multicasting each box
//     would cut the L2 bytes of Q and K c-fold; built and measured at
//     [2, 4096, 1024], clusters of 4 were slower than none (PERF.md): the
//     chunk blocks of a unit run side by side and find Q and K in L2, so L2
//     is not what bounds the kernel, and the cluster's lockstep costs more
//     than its bytes save.
//   - Ragged shapes: 3-D tensor maps (D, T, heads), as K2w's, so TMA fills
//     zeros past D and past T; keys past T are masked with the reference's
//     -1e30, rows past T and columns past D are not stored. TMA needs a row
//     stride of a multiple of 16 bytes: where D % 8 != 0, q, k and v are
//     first copied into a workspace [3][H][T][Dp], Dp = D rounded up to 8
//     (flash_common.cuh::pad_rows_kernel, shared with K2w; 0.1 GB at [2,
//     4096, 1020]: about 0.03 ms at 3.35 TB/s against the kernel's 0.5;
//     measured faster than three cudaMemcpy2DAsync calls, PERF.md), and the
//     maps read it at that stride with D as their inner dim, so the pad
//     columns are never read. The
//     output's rows are D elements: a pair of columns goes as one 32-bit
//     word where D is even, else element by element.
//   - m and l agree bit for bit across a unit's chunk blocks: each forms S
//     with the same wgmma sequence over D's chunks in the same order, and V
//     enters neither. A split unit's chunk 0 alone writes them.
//   - Numbers as K2: scores, m, l and acc in f32, P rounded to the input
//     type before P V, the output rounded once to it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::bar_expect;
using flash::bar_init;
using flash::bar_wait;
using flash::desc_k_major;
using flash::desc_mn_major;
using flash::fence_regs;
using flash::kBlockQ;
using flash::kBoxRowBytes;
using flash::kLog2e;
using flash::smem_addr;
using flash::tma_box;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_rs;
using flash::wgmma_ss;
using flash::wgmma_wait;

constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kBK = 64;                     // keys a kv step
constexpr int kDC = 256;                    // output columns a block
constexpr int kBox = 64 * kBoxRowBytes;     // [64 rows][64 columns]: 8 KiB
constexpr int kVBoxes = kDC / 64;
// The ring: two k-chunks a stage (32 KiB) halve the barrier round trips of
// a kv step against one; V takes two stages, or the producer, which issues
// a step's V before its Q and K, would wait for the last step's P V and
// stop running ahead. 192 KiB of shared memory: one block an SM.
constexpr int kChunks = 2;                  // k-chunks of 64 columns a stage
constexpr int kStages = 4;                  // Q and K stages in flight
constexpr int kVStages = 2;                 // V stages, alternating
constexpr int kWait = 1;                    // committed stages left in flight
constexpr int kStage = 2 * kChunks * kBox;  // Q boxes, then K boxes
// byte offsets from a 1024-byte aligned base (the swizzle's period)
constexpr int kOffQK = 0;                               // [kStages]
constexpr int kOffV = kOffQK + kStages * kStage;        // [kVStages]
constexpr int kOffBars = kOffV + kVStages * kVBoxes * kBox;
// full[kStages], empty[kStages], v_full[kVStages], v_empty[kVStages]
constexpr int kBars = 2 * kStages + 2 * kVStages;
constexpr int kSmem = kOffBars + 8 * kBars + 1024;      // room to align

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// ---- the kernel -------------------------------------------------------------

// Block b takes unit b / n_chunks and output columns [256 c, 256 c + 256),
// c = b % n_chunks. The wgmma fragments are K2w's (flash_fwd.cu): thread t
// holds rows r0 and r0 + 8. part_acc rows are acc_cols floats; o rows are d
// elements.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ o, const int4* __restrict__ units,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int acc_cols, int t_len,
                        int d, int n_chunks, float scale_log2, int causal) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  auto sQ = [&](int s) { return base + kOffQK + s * kStage; };
  auto sK = [&](int s) { return base + kOffQK + s * kStage + kChunks * kBox; };
  auto sV = [&](int b) { return base + kOffV + b * kVBoxes * kBox; };
  const uint32_t bars = base + kOffBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto v_full = [&](int b) { return bars + 8 * (2 * kStages + b); };
  auto v_empty = [&](int b) {
    return bars + 8 * (2 * kStages + kVStages + b);
  };

  const int4 unit = units[blockIdx.x / n_chunks];
  const int c0 = (blockIdx.x % n_chunks) * kDC;   // this block's columns
  const int nq = (t_len + kBlockQ - 1) / kBlockQ;
  const int q0 = (unit.x % nq) * kBlockQ;
  const int head = unit.x / nq;
  const int first = unit.y;
  const int n = min(unit.z, (t_len + kBK - 1) / kBK) - first;
  // stages of S a kv step; a stage's k-chunks past D are zeros
  const int n_kc = (d + 64 * kChunks - 1) / (64 * kChunks);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 4);
    }
    for (int b = 0; b < kVStages; ++b) {
      bar_init(v_full(b), 1);
      bar_init(v_empty(b), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: one thread issues every copy, stage j % kStages taking
    // the j-th kChunks k-chunks of Q and K (kv step by kv step). A stage is
    // refilled once every consumer warp released it (the first round
    // passes: the barrier's previous phase counts as complete).
    if (tid == kConsumers) {
      int j = 0;
      for (int it = 0; it < n; ++it) {
        const int k0 = (first + it) * kBK;
        const int b = it % kVStages;
        bar_wait(v_empty(b), ((it / kVStages) & 1) ^ 1);
        bar_expect(v_full(b), kVBoxes * kBox);
        for (int x = 0; x < kVBoxes; ++x)
          tma_box(sV(b) + x * kBox, &tv, c0 + 64 * x, k0, head, v_full(b));
        for (int kc = 0; kc < n_kc; ++kc, ++j) {
          const int s = j % kStages;
          bar_wait(empty(s), ((j / kStages) & 1) ^ 1);
          bar_expect(full(s), kStage);
          for (int x = 0; x < kChunks; ++x) {
            const int col = 64 * (kChunks * kc + x);
            tma_box(sQ(s) + x * kBox, &tq, col, q0, head, full(s));
            tma_box(sK(s) + x * kBox, &tk, col, k0, head, full(s));
          }
        }
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
    float acc[kDC / 2];
#pragma unroll
    for (int i = 0; i < kDC / 2; ++i) acc[i] = 0.f;
    float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
    float l[2] = {0.f, 0.f};

    int j = 0;
    for (int it = 0; it < n; ++it) {
      const int k0 = (first + it) * kBK;         // the step's first key

      // S = Q K^T over all of D: n_kc stages of kChunks k-chunks, four
      // k-steps of 16 each; kWait stages stay in flight
      float sc[kBK / 2] = {};
      for (int kc = 0; kc < n_kc; ++kc, ++j) {
        const int s = j % kStages;
        bar_wait(full(s), (j / kStages) & 1);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * kChunks; ++kk) {
          const uint32_t at = (kk / 4) * kBox + 32 * (kk % 4);
          wgmma_ss<kF16>(sc, desc_k_major(sQ(s) + at),
                         desc_k_major(sK(s) + at), kc > 0 || kk > 0);
        }
        wgmma_commit();
        if (kc >= kWait) {
          wgmma_wait<kWait>();                   // stage j - kWait is done
          release((j - kWait) % kStages);
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      for (int x = min(n_kc, kWait); x > 0; --x) release((j - x) % kStages);

      // the online softmax on the fragment (flash_common.cuh)
      uint32_t p[kBK / 16][4];
      flash::softmax_step<T, kBK, kDC / 2, true>(sc, acc, m, l, p,
                                                  scale_log2, causal, k0, q0,
                                                  r0, quad, t_len);

      // O += P V over the step's 64 kv rows in four k-steps of 16
      const int b = it % kVStages;
      bar_wait(v_full(b), (it / kVStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kBK / 16; ++kb)
        wgmma_rs<kF16>(acc, p[kb],
                       desc_mn_major(sV(b) + kb * 16 * kBoxRowBytes, kBox));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) bar_arrive(v_empty(b));
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
        for (int c8 = 0; c8 < kDC / 8; ++c8)
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
        T* dst = o + (static_cast<size_t>(head) * t_len + row) * d + c0;
#pragma unroll
        for (int c8 = 0; c8 < kDC / 8; ++c8) {
          const int col = c0 + 8 * c8 + 2 * quad;
          if (col >= d) break;
          const float a = acc[4 * c8 + 2 * h] * inv;
          const float b = acc[4 * c8 + 2 * h + 1] * inv;
          if (d % 2 == 0) {
            // an even row: the pair is 4-byte aligned and ends inside it
            *reinterpret_cast<uint32_t*>(dst + 8 * c8 + 2 * quad) =
                flash::pack2<T>(a, b);
          } else {
            dst[8 * c8 + 2 * quad] = flash::from_float<T>(a);
            if (col + 1 < d)
              dst[8 * c8 + 2 * quad + 1] = flash::from_float<T>(b);
          }
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* units, int n_units, const void* merges, int n_merges,
           void* part_acc, void* part_ml, int acc_cols, void* padded,
           int heads, int t_len, int d, float scale, int causal,
           cudaStream_t s) {
  const int dp = flash::padded_width(d);
  cudaError_t err = flash::pad_rows<T>(q, k, v, padded, heads * t_len, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!flash::tile_map<T>(&tq, q, heads, t_len, d, dp, kBlockQ) ||
      !flash::tile_map<T>(&tk, k, heads, t_len, d, dp, kBK) ||
      !flash::tile_map<T>(&tv, v, heads, t_len, d, dp, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wide_wgmma_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (d + kDC - 1) / kDC;
  kernel<<<static_cast<unsigned>(n_units) * n_chunks, kThreads, kSmem, s>>>(
      tq, tk, tv, static_cast<T*>(o), static_cast<const int4*>(units),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), acc_cols,
      t_len, d, n_chunks, scale * kLog2e, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash::launch_combine<T>(merges, n_merges, part_acc, part_ml, o, t_len, d,
                           acc_cols, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous, 16-byte aligned, of one type: dtype
// 1 f16, 2 bf16; any D >= 1, T >= 1. units and merges as
// ops/flash_attention.py::work_list gives them; part_acc f32
// [slots][64][acc_cols], acc_cols a multiple of 4 and at least D rounded up
// to a multiple of 256; part_ml f32 [slots][2][64]. padded: where D % 8 !=
// 0, a workspace of the input type [3][heads][T][Dp], Dp = D rounded up to
// 8, that q, k and v are copied into (unused, and may be null, where D % 8
// == 0). Runs on `stream`; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for another dtype, D, T or acc_cols, a missing
// workspace, or a refused tensor map).
extern "C" int flash_fwd_wide_wgmma(const void* q, const void* k,
                                    const void* v, void* o, const void* units,
                                    int n_units, const void* merges,
                                    int n_merges, void* part_acc,
                                    void* part_ml, int acc_cols, void* padded,
                                    int dtype, int heads, int T, int D,
                                    float scale, int causal, void* stream) {
  const int n_chunks = (D + kDC - 1) / kDC;
  if (D < 1 || T < 1 || heads < 1 || n_units < 1 || acc_cols % 4 != 0 ||
      acc_cols < n_chunks * kDC || (D % 8 != 0 && padded == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch<__half>(q, k, v, o, units, n_units, merges, n_merges,
                            part_acc, part_ml, acc_cols, padded, heads, T, D,
                            scale, causal, s);
    case 2:
      return launch<__nv_bfloat16>(q, k, v, o, units, n_units, merges,
                                   n_merges, part_acc, part_ml, acc_cols,
                                   padded, heads, T, D, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
