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
// tensor-core peak (989 TFLOP/s on the SXM part). What stands between a
// kernel and that bound: SMs left idle (a causal q tile's kv loop is one
// chain, up to T/64 tiles long), tensor-core instructions below Hopper's
// rate (only wgmma reaches it), scores and accumulators that pass through
// shared memory, and loads that do not overlap the products.
//
// Design:
//   - Units. The wrapper cuts each q tile's kv loop into units of at most
//     SPLIT kv tiles (ops/flash_attention.py::work_list) and orders them
//     longest first; one block takes one unit. A q tile with one unit writes
//     its output. The units of a split q tile write their partial state (row
//     max m in log2 units, row sum l, unnormalised f32 acc) to a workspace,
//     and flash_combine_kernel merges them by the log-sum-exp rule in slot
//     order: no atomics, so the bits are the same on every run. At T=4096
//     causal, SPLIT=8 gives 288 units of at most 8 tiles for 64 q tiles.
//   - One warpgroup (128 threads) owns a unit's 64 q rows. S = Q K^T is
//     wgmma m64n64k16 with Q and K read from shared memory; the 64x64 f32
//     scores stay in registers (32 a thread) and the online softmax runs on
//     that fragment, with row reductions across the 4 lanes of a quad.
//     O += P V is wgmma m64n128k16 with P converted in registers to bf16 as
//     the A operand (the S fragment's pairs are the A fragment's pairs) and
//     V read from shared memory as an MN-major B operand (the transpose
//     flag), since V is stored [kv][D]. O stays in registers (64 f32 a
//     thread) for the whole unit and is rescaled there.
//   - K and V arrive by TMA into a two-stage ring in shared memory, each
//     tile as two 64x64 boxes with 128-byte swizzle (what the wgmma
//     descriptors read without bank conflicts), each stage with an mbarrier
//     for K and one for V. Thread 0 issues the copies: once tile j is done,
//     tile j + 2 is loaded into its stage while tile j + 1 is in use. 80 KiB
//     of shared memory: two blocks per SM, so one block's softmax overlaps
//     the other's products.
//   - The tensor maps come from cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint so that the library needs no -lcuda.
//   - Causal tiles fall in the reference's three classes: tiles above the
//     diagonal are in no unit, tiles below it run unmasked, and only the
//     diagonal tile is masked, with a -1e30 fill so that no row's online
//     update can become NaN.
//   - Numbers: scores, m, l and acc in f32; P is rounded to bf16 before
//     P V, as the reference casts p to v's dtype, and the output is rounded
//     once to bf16 (ops/flash_attention.py::kernel_error_limit says why a
//     split keeps that error).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;
constexpr float kMaskFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A [64 rows][128] bf16 tile is two TMA boxes of [64 rows][64 columns]
// (128-byte rows, the widest the 128-byte swizzle takes), 8 KiB each.
constexpr int kBoxBytes = 64 * 64 * 2;
constexpr int kTileBytes = 2 * kBoxBytes;

// Byte offsets in shared memory, from a 1024-byte aligned base (the
// swizzle's period).
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + kTileBytes;              // [kStages] tiles
  static constexpr int v = k + kStages * kTileBytes;    // [kStages] tiles
  static constexpr int bars = v + kStages * kTileBytes; // q, k[2], v[2]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages);
  static constexpr int alloc = bytes + 1024;            // room to align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar));
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

// one 64x64 box at (column c0, row c1) of the map into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// a [64 rows][128] tile starting at `row`: both column halves on `bar`
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int row, uint32_t bar) {
  bar_expect(bar, kTileBytes);
  tma_box(dst, map, 0, row, bar);
  tma_box(dst + kBoxBytes, map, 64, row, bar);
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
// other 64 columns in the next box (8 KiB on); 8 kv rows 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return desc_sw128(addr, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accesses to a register that an asynchronous
// wgmma reads or writes across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64][64] (+)= A[64][16] B[64][16]^T, A and B K-major in shared memory;
// D is overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64][128] += A[64][16] B[16][128], A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose flag set).
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernels ------------------------------------------------------------

// The wgmma accumulator fragment: thread t of the warpgroup holds, for an
// N-column product, values i = 0 .. N/2 - 1 at row 16 (t / 32) + (t % 32) / 4
// + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2. A thread's two
// rows are r0 and r0 + 8; the four threads of a quad share them.
//
// A unit of work: (row tile = head * (T / 64) + q tile, first kv tile, end kv
// tile, workspace slot or -1 where the unit writes the output).
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, const int4* __restrict__ units,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int T, float scale_log2, int causal) {
  constexpr int D = kHeadDim;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + Smem::q;
  const uint32_t bar_q = base + Smem::bars;
  auto sK = [&](int s) { return base + Smem::k + s * kTileBytes; };
  auto sV = [&](int s) { return base + Smem::v + s * kTileBytes; };
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int4 unit = units[blockIdx.x];
  const int nq = T / kBlockQ;
  const int qi = unit.x % nq;
  const int row0 = (unit.x / nq) * T + qi * kBlockQ;  // first row in [H*T]
  const int kv0 = row0 - qi * kBlockQ;                // the head's row 0
  const int n = unit.z - unit.y;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int b = 0; b < 1 + 2 * kStages; ++b) bar_init(bar_q + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_tile(sQ, &tq, row0, bar_q);
    for (int s = 0; s < kStages && s < n; ++s) {
      const int row = kv0 + (unit.y + s) * kBlockK;
      tma_tile(sK(s), &tk, row, bar_k(s));
      tma_tile(sV(s), &tv, row, bar_v(s));
    }
  }

  const int quad = tid & 3;
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);  // rows r0 and r0 + 8
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.f, 0.f};

  bar_wait(bar_q, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int j = unit.y + it;

    // S = Q K^T over D in 8 steps of 16
    float sc[32] = {};
    bar_wait(bar_k(s), parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_qk(sc, desc_k_major(sQ + off), desc_k_major(sK(s) + off), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax on the fragment, in log2 units
    const bool masked = causal && j == qi;  // the diagonal tile
    float mx[2] = {kMaskFill, kMaskFill};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale_log2;
      if (masked && 8 * (i >> 2) + 2 * quad + (i & 1) > r0 + 8 * h)
        x = kMaskFill;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2_approx(m[h] - m_new);  // 0 on the first tile
      m[h] = m_new;
    }
    uint32_t p[4][4];  // P in bf16 pairs: the A fragments of 4 k-steps
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float a = exp2_approx(sc[i] - m[h]);
      const float b = exp2_approx(sc[i + 1] - m[h]);
      sum[h] += a + b;
      p[i >> 3][(i >> 1) & 3] = pack_bf16(a, b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V over the tile's 64 kv rows in 4 steps of 16
    bar_wait(bar_v(s), parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBlockK / 16; ++kb)
      wgmma_pv(acc, p[kb], desc_mn_major(sV(s) + kb * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    // every thread is done with stage s: refill it with tile it + kStages
    __syncthreads();
    if (tid == 0 && it + kStages < n) {
      const int row = kv0 + (j + kStages) * kBlockK;
      tma_tile(sK(s), &tk, row, bar_k(s));
      tma_tile(sV(s), &tv, row, bar_v(s));
    }
  }

  if (unit.w >= 0) {
    // a partial: m (log2 units), l and the unnormalised acc for the merge
    float* ml = part_ml + static_cast<size_t>(unit.w) * 2 * kBlockQ;
    float* dst = part_acc + static_cast<size_t>(unit.w) * kBlockQ * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (quad == 0) {
        ml[r] = m[h];
        ml[kBlockQ + r] = l[h];
      }
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8)
        *reinterpret_cast<float2*>(dst + r * D + 8 * c8 + 2 * quad) =
            make_float2(acc[4 * c8 + 2 * h], acc[4 * c8 + 2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];
    __nv_bfloat16* dst = o + static_cast<size_t>(row0 + r0 + 8 * h) * D;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8)
      *reinterpret_cast<uint32_t*>(dst + 8 * c8 + 2 * quad) = pack_bf16(
          acc[4 * c8 + 2 * h] * inv, acc[4 * c8 + 2 * h + 1] * inv);
  }
}

// Merges the units of one split q tile, merge = (row tile, first slot,
// count, -): m = max_u m_u, w_u = 2^(m_u - m), o = sum_u w_u acc_u /
// sum_u w_u l_u, the units taken in slot order (no atomics: the same bits
// on every run). Block (merge, y) takes rows 8y .. 8y + 7 of the q tile,
// one a warp; lane c takes columns 4c .. 4c + 3.
constexpr int kMergeRows = 8;
constexpr int kMergeThreads = 32 * kMergeRows;

__global__ void __launch_bounds__(kMergeThreads)
flash_combine_kernel(const int4* __restrict__ merges,
                     const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ o, int T) {
  constexpr int D = kHeadDim;
  const int4 merge = merges[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kMergeRows + (threadIdx.x >> 5);
  const int nq = T / kBlockQ;
  const float* ml = part_ml + static_cast<size_t>(merge.y) * 2 * kBlockQ + r;
  const float* src = part_acc + (static_cast<size_t>(merge.y) * kBlockQ + r) *
                                    D + 4 * lane;
  float m = __int_as_float(0xff800000);
  for (int u = lane; u < merge.z; u += 32) m = fmaxf(m, ml[u * 2 * kBlockQ]);
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, mask));
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int u = 0; u < merge.z; ++u) {
    const float w = exp2_approx(ml[u * 2 * kBlockQ] - m);
    l += ml[u * 2 * kBlockQ + kBlockQ] * w;
    const float4 a = *reinterpret_cast<const float4*>(
        src + static_cast<size_t>(u) * kBlockQ * D);
    acc.x += a.x * w;
    acc.y += a.y * w;
    acc.z += a.z * w;
    acc.w += a.w * w;
  }
  const float inv = 1.f / l;
  __nv_bfloat16* dst = o + (static_cast<size_t>(merge.x / nq) * T +
                            (merge.x % nq) * kBlockQ + r) * D + 4 * lane;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc.x * inv, acc.y * inv),
                 pack_bf16(acc.z * inv, acc.w * inv));
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that nothing links libcuda
EncodeTiled encode_tiled() {
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

// [rows][128] bf16 in 64x64 boxes with 128-byte swizzle
bool tile_map(CUtensorMap* map, const void* ptr, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {kHeadDim, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kHeadDim * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, o: [heads, T, D] contiguous bf16, 16-byte aligned; T a multiple of
// 64; D = 128. units: n_units int4 (row tile, first kv tile, end kv tile,
// slot); merges: n_merges int4 (row tile, first slot, count, -); part_acc
// f32 [slots][64][D] and part_ml f32 [slots][2][64], the partials of split q
// tiles. Runs on `stream`; returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for another D or a refused tensor map).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, const void* units, int n_units,
                              const void* merges, int n_merges,
                              void* part_acc, void* part_ml, int heads, int T,
                              int D, float scale, int causal, void* stream) {
  if (D != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, heads * T) || !tile_map(&tk, k, heads * T) ||
      !tile_map(&tv, v, heads * T))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem::alloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_fwd_kernel<<<n_units, kThreads, Smem::alloc, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o),
      static_cast<const int4*>(units), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, scale * kLog2e, causal);
  if (n_merges > 0)
    flash_combine_kernel<<<dim3(n_merges, kBlockQ / kMergeRows),
                           kMergeThreads, 0, s>>>(
        static_cast<const int4*>(merges), static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<__nv_bfloat16*>(o), T);
  return static_cast<int>(cudaGetLastError());
}
