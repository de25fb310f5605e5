// Flash-attention forward on the tensor cores: softmax(q k^T * scale) v over
// [H, T, D] 16-bit inputs, with an online softmax so the [T, T] score matrix
// never reaches device memory. One kernel template, two names:
//   - K2, the instance (bf16, D = 128, T a multiple of 64) that the node
//     validator's flash leg runs: flash_fwd_bf16;
//   - K2w, every other bf16 or f16 input with D <= 256, any T >= 1:
//     flash_fwd_wgmma.
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
//     reference's -1e30, rows past T and columns past D are not stored.
//   - TMA needs a row stride of a multiple of 16 bytes. Where D % 8 != 0
//     (K2w only), q, k and v are first copied into a workspace [3][H][T][Dp],
//     Dp = D rounded up to 8 (flash_common.cuh::pad_rows_kernel, K2dw's
//     copy: about 5 MB at [4096, 100], 2 us at 3.35 TB/s), and the maps read
//     it at that stride with D as their inner dim, so the pad columns are
//     never read and TMA's zero fill keeps them out of Q K^T and P V. The
//     output's rows are D elements: a pair of columns goes as one 32-bit word
//     where D is even, else element by element.
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

using flash::bar_init;
using flash::bar_wait;
using flash::desc_k_major;
using flash::desc_mn_major;
using flash::fence_regs;
using flash::kBlockQ;
using flash::kBoxRowBytes;
using flash::kLog2e;
using flash::smem_addr;
using flash::tma_tile;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_rs;
using flash::wgmma_ss;
using flash::wgmma_wait;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;

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
    wgmma_wait<0>();
    fence_regs(sc);

    // the online softmax on the fragment (flash_common.cuh)
    uint32_t p[BK / 16][4];  // P in 16-bit pairs: the A fragments of k-steps
    flash::softmax_step<T, BK, DP / 2, kBounded>(sc, acc, m, l, p, scale_log2,
                                                 causal, k0, q0, r0, quad,
                                                 t_len);

    // O += P V over the step's BK kv rows in BK / 16 steps of 16
    bar_wait(bar_v(s), parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
      wgmma_rs<kF16>(acc, p[kb],
                     desc_mn_major(sV(s) + kb * 16 * kBoxRowBytes, L::kv_box));
    wgmma_commit();
    wgmma_wait<0>();
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
      const int col = 8 * c8 + 2 * quad;
      if (kBounded && col >= d) break;
      const float a = acc[4 * c8 + 2 * h] * inv;
      const float b = acc[4 * c8 + 2 * h + 1] * inv;
      if (!kBounded || d % 2 == 0) {
        // an even row: the pair is 4-byte aligned and ends inside it
        *reinterpret_cast<uint32_t*>(dst + col) = flash::pack2<T>(a, b);
      } else {
        dst[col] = flash::from_float<T>(a);
        if (col + 1 < d) dst[col + 1] = flash::from_float<T>(b);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  const void* units;
  int n_units;
  const void* merges;
  int n_merges;
  void *part_acc, *part_ml;
  void* padded;  // K2w's [3][heads][T][Dp] workspace where D % 8 != 0
  int heads, t_len, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP, int BK, bool kBounded>
int launch(const Args& a) {
  using L = Smem<DP, BK>;
  const void *q = a.q, *k = a.k, *v = a.v;
  const int dp = flash::padded_width(a.d);
  cudaError_t err =
      flash::pad_rows<T>(q, k, v, a.padded, a.heads * a.t_len, a.d, a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!flash::tile_map<T>(&tq, q, a.heads, a.t_len, a.d, dp, kBlockQ) ||
      !flash::tile_map<T>(&tk, k, a.heads, a.t_len, a.d, dp, BK) ||
      !flash::tile_map<T>(&tv, v, a.heads, a.t_len, a.d, dp, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel<T, DP, BK, kBounded>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_units, kThreads, L::alloc, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), static_cast<const int4*>(a.units),
      static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      a.t_len, a.d, a.scale * kLog2e, a.causal);
  flash::launch_combine<T>(a.merges, a.n_merges, a.part_acc, a.part_ml,
                           a.o, a.t_len, a.d, DP, a.stream);
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
               part_ml, nullptr, heads, T, D, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return launch<__nv_bfloat16, 128, 64, false>(a);
}

// K2w: dtype 1 f16, 2 bf16; 1 <= D <= 256; any T >= 1; block_k the keys
// of a kv step, 64, or 32 at D > 128 (DP = 256). padded: where D % 8 != 0,
// a workspace of the input type [3][heads][T][Dp], Dp = D rounded up to 8,
// that q, k and v are copied into (unused, and may be null, where D % 8 ==
// 0).
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, const void* units, int n_units,
                               const void* merges, int n_merges,
                               void* part_acc, void* part_ml, void* padded,
                               int dtype, int heads, int T, int D,
                               int block_k, float scale, int causal,
                               void* stream) {
  if (D < 1 || D > 256 || T < 1 || heads < 1 ||
      (D % 8 != 0 && padded == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, units, n_units, merges, n_merges, part_acc,
               part_ml, padded, heads, T, D, scale, causal,
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
