// Ring collectives over virtual ranks: all-gather, reduce-scatter, all-reduce
// and bidirectional all-reduce (f32), each one cooperative launch for all ranks.
//
// Replaces the four Pallas kernels of tpu_operator/parallel/ring.py:
//   _ring_all_gather_kernel (K3), _ring_reduce_scatter_kernel (K4),
//   _ring_all_reduce_kernel (K5), _ring_all_reduce_bidir_kernel (K6).
// They compute the same values as those kernels, bit for bit: the same hops,
// the same chunk indices and the same `received + local` f32 adds, in the
// same order. Nothing else is done to the data (no fast math, no multiply),
// so each kernel also equals its plain version in parallel/ring.py exactly.
//
// Ranks. blockIdx.y is the rank. A rank's code reads one RankPtrs entry and
// reaches nothing but what it names: its own input, output, comm slots and
// signal words, and its two neighbours' comm slots and signal words. On one
// card these are separate allocations of virtual ranks; the same code would
// run across cards with peer pointers in the table (and epoch counters in
// place of the signal words that the wrapper zeroes before each launch).
//
// Independent rings per block. Each rank runs on gridDim.x blocks; block b of
// a rank moves the b-th slice of every chunk and signals only block b of its
// neighbours, so the launch holds gridDim.x independent rings and the blocks
// of one rank never wait for each other. The bidirectional kernel gives the
// first half of the blocks the rightward ring over the top half of the
// tensor and the second half the leftward ring over the bottom half; the two
// directions run at once on separate blocks, each with its own slots and
// credits.
//
// The protocol (per block, per rank; words in the rank's signal area):
//   - entry barrier: signal both neighbours' barrier word once, wait for 2;
//   - a hop: wait for a credit for the right neighbour's receive slot
//     (t + 1) % 2, store the payload straight into that slot with 16-byte
//     stores, then raise the neighbour's receive counter for the slot.
//     The TPU kernel's remote DMA becomes these stores; its send semaphore is
//     the __syncthreads() before the signal; the staging copy into comm_buf
//     is gone (the payload is stored from the source chunk);
//   - credits: a slot is granted back to the sender once its contents have
//     been consumed and only if the sender will write it again, so every
//     grant is used. Both slots start free (there is no staging), so the
//     first two hops' slots are granted at entry.
//   - signalling: __syncthreads, then thread 0 does a system fence and a
//     release add at system scope (red.release.sys); waiting: thread 0 spins
//     on acquire loads at system scope (never a plain load, which the
//     compiler may hoist), then __syncthreads. Slots written by a neighbour
//     are read with ld.global.cg so that no stale L1 line is used.
//   - a wait that sees no progress for timeout_ns (the GPU's global timer)
//     writes a code into the rank's status word and ends the block; the
//     wrapper reads the status words after the launch and raises. A stalled
//     ring fails instead of hanging.
//
// Residency. A rank spinning on a neighbour that never got an SM would hang,
// so the launch is cooperative: cudaLaunchCooperativeKernel refuses a grid
// that cannot be resident all at once. The wrapper sizes gridDim.x from
// ring_resident_blocks() / n.
//
// Bound on an H100: device-memory bytes. The kernels only copy and add; on
// one card each hop is a read and a write of a chunk in device memory (the
// least time counts each rank's input read once and its output written once,
// over 3.35 TB/s). Across cards the bound would be the NVLink rate instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSigWords = 16;  // per block: 64 bytes of signal words
constexpr int kBarrier = 0;
constexpr int kRecv = 1;       // kRecv + slot: payloads received into the slot
constexpr int kCap = 3;        // kCap + slot: credits to write the receiver's slot
constexpr int kStatus = 15;    // non-zero: a wait timed out (code below)

enum Mode { kAllGather = 0, kReduceScatter = 1, kAllReduce = 2, kBidir = 3 };
enum Stall { kStallBarrier = 1, kStallCredit = 2, kStallRecv = 3 };

struct RankPtrs {
  const float* in;
  float* out;
  float* slots;        // this rank's receive slots: [directions][2][chunk]
  float* right_slots;  // the right neighbour's receive slots
  float* left_slots;   // the left neighbour's receive slots
  unsigned* sig;       // this rank's signal words: [gridDim.x][kSigWords]
  unsigned* right_sig;
  unsigned* left_sig;
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Raise `word` by one once every thread of the block is done with its loads
// and stores before this point.
__device__ __forceinline__ void signal(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    add_release(word, 1u);
  }
}

// Wait until `word` >= target. False (after writing `code` into the status
// word) if it did not get there within timeout_ns.
__device__ __forceinline__ bool wait_for(const unsigned* word,
                                         unsigned target, unsigned* status,
                                         unsigned code, long long timeout_ns) {
  __shared__ int ok;
  __syncthreads();
  if (threadIdx.x == 0) {
    int good = 1;
    const unsigned long long start = now_ns();
    while (load_acquire(word) < target) {
      if (static_cast<long long>(now_ns() - start) > timeout_ns) {
        good = 0;
        *status = code;
        break;
      }
    }
    __threadfence_system();
    ok = good;
  }
  __syncthreads();
  return ok != 0;
}

// dst[i] = a[i], or a[i] + b[i] (received + local), for the float4s
// i in [lo, hi).
__device__ __forceinline__ void move(float4* dst, const float4* a,
                                     const float4* b, long long lo,
                                     long long hi) {
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    float4 v = __ldcg(a + i);
    if (b != nullptr) {
      const float4 w = __ldcg(b + i);
      v.x = v.x + w.x;
      v.y = v.y + w.y;
      v.z = v.z + w.z;
      v.w = v.w + w.w;
    }
    __stcg(dst + i, v);
  }
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// One block's view of its ring: the slice it moves, where it sends, and the
// counters its thread 0 waits on (every thread keeps the same counts). The
// counts are scalars, not arrays indexed by slot, and every function that
// takes a Ring is inlined, so the struct lives in registers.
struct Ring {
  int n;
  long long chunk4, lo, hi, timeout_ns;
  float4* my_slots;   // my receive slots for this direction
  float4* to_slots;   // the receive slots of the rank I send to
  unsigned* my;       // my signal words (this block)
  unsigned* to;       // the signal words of the rank I send to (this block)
  unsigned* from;     // the signal words of the rank I receive from
  unsigned credits0, credits1;    // credits awaited for the receiver's slots
  unsigned received0, received1;  // payloads awaited in my slots

  __device__ float4* slot(int s) { return my_slots + s * chunk4; }
  __device__ float4* remote_slot(int s) { return to_slots + s * chunk4; }

  // my slot s is free: credit the rank that writes it
  __device__ void grant(int s) { signal(from + kCap + s); }

  // wait for a credit to write the receiver's slot s, store, signal
  __device__ bool send(int s, const float4* a, const float4* b) {
    const unsigned want = s ? ++credits1 : ++credits0;
    if (!wait_for(my + kCap + s, want, my + kStatus, kStallCredit,
                  timeout_ns))
      return false;
    move(remote_slot(s), a, b, lo, hi);
    signal(to + kRecv + s);
    return true;
  }

  __device__ bool receive(int s) {
    const unsigned want = s ? ++received1 : ++received0;
    return wait_for(my + kRecv + s, want, my + kStatus, kStallRecv,
                    timeout_ns);
  }

  __device__ bool enter(const RankPtrs& p, int b) {
    if (threadIdx.x == 0) {
      __threadfence_system();
      add_release(p.right_sig + b * kSigWords + kBarrier, 1u);
      add_release(p.left_sig + b * kSigWords + kBarrier, 1u);
    }
    return wait_for(my + kBarrier, 2u, my + kStatus, kStallBarrier,
                    timeout_ns);
  }

  // both slots start free: credit the first two hops' targets
  __device__ void open(int hops) {
    if (hops >= 1) grant(1);
    if (hops >= 2) grant(0);
  }
};

// K3: out[c] = rank c's input, for every c, in n - 1 hops.
__device__ __forceinline__ void all_gather(Ring& r, const float4* in,
                                           float4* out, int d) {
  const int n = r.n;
  const long long c4 = r.chunk4;
  move(out + d * c4, in, nullptr, r.lo, r.hi);
  const int hops = n - 1;
  r.open(hops);
  for (int t = 0; t < hops; ++t) {
    const int s = (t + 1) & 1;
    // after hop t the chunk that started t ranks to my left is mine
    const float4* src = t == 0 ? in : out + wrap(d - t, n) * c4;
    if (!r.send(s, src, nullptr) || !r.receive(s)) return;
    move(out + wrap(d - t - 1, n) * c4, r.slot(s), nullptr, r.lo, r.hi);
    if (t + 2 < hops) r.grant(s);
  }
}

// K4: out = chunk d of the sum. At hop t rank d sends the running sum of
// chunk d - t - 1; the sum lives in the slots and the input is never written.
__device__ __forceinline__ void reduce_scatter(Ring& r, const float4* in,
                                               float4* out, int d) {
  const int n = r.n;
  const long long c4 = r.chunk4;
  if (n == 1) {
    move(out, in, nullptr, r.lo, r.hi);
    return;
  }
  const int hops = n - 1;
  r.open(hops);
  for (int t = 0; t < hops; ++t) {
    const int s = (t + 1) & 1;
    const float4* local = in + wrap(d - t - 1, n) * c4;
    // hop 0 sends my own copy; later hops send what arrived + my copy
    if (!(t == 0 ? r.send(s, local, nullptr)
                 : r.send(s, r.slot(t & 1), local)))
      return;
    // my slot t & 1 is consumed and is the target of hop t + 1
    if (t >= 1 && t + 1 < hops) r.grant(t & 1);
    if (!r.receive(s)) return;
  }
  move(out, r.slot(hops & 1), in + d * c4, r.lo, r.hi);
}

// K5 (and each direction of K6): reduce-scatter then all-gather, 2(n - 1)
// hops, in place in `out`; chunk c is fully summed on rank c - 1. `rank` is
// the rank's position along the ring's direction and `mirror` maps chunk
// labels back for the leftward ring (rank and chunk both mirrored, which is
// the TPU kernel's reverse index arithmetic).
__device__ __forceinline__ void all_reduce(Ring& r, const float4* in,
                                           float4* out, int rank,
                                           bool mirror) {
  const int n = r.n;
  const long long c4 = r.chunk4;
  for (int c = 0; c < n; ++c)
    move(out + c * c4, in + c * c4, nullptr, r.lo, r.hi);
  const int hops = 2 * (n - 1);
  r.open(hops);
  for (int t = 0; t < hops; ++t) {
    const int s = (t + 1) & 1;
    const bool reduce = t < n - 1;
    const int i = reduce ? t : t - (n - 1);
    int send_c = reduce ? rank - i : rank + 1 - i;
    int recv_c = reduce ? rank - i - 1 : rank - i;
    send_c = wrap(mirror ? -send_c : send_c, n);
    recv_c = wrap(mirror ? -recv_c : recv_c, n);
    if (!r.send(s, out + send_c * c4, nullptr) || !r.receive(s)) return;
    float4* dst = out + recv_c * c4;
    move(dst, r.slot(s), reduce ? dst : nullptr, r.lo, r.hi);
    if (t + 2 < hops) r.grant(s);
  }
}

__global__ void __launch_bounds__(kThreads)
ring_kernel(const RankPtrs* __restrict__ ranks, int n, long long chunk4,
            int mode, long long timeout_ns) {
  const int d = blockIdx.y;
  const RankPtrs p = ranks[d];
  const int b = blockIdx.x;
  int rings = gridDim.x;  // blocks (slices) per direction
  int dir = 0;            // 0: send right; 1: send left (bidir's bottom half)
  if (mode == kBidir) {
    rings = gridDim.x / 2;
    dir = b >= rings;
  }
  const int slice = b - dir * rings;
  Ring r;
  r.n = n;
  r.chunk4 = chunk4;
  r.lo = chunk4 * slice / rings;
  r.hi = chunk4 * (slice + 1) / rings;
  r.timeout_ns = timeout_ns;
  r.my_slots = reinterpret_cast<float4*>(p.slots) + dir * 2 * chunk4;
  r.to_slots = reinterpret_cast<float4*>(dir ? p.left_slots : p.right_slots) +
               dir * 2 * chunk4;
  r.my = p.sig + b * kSigWords;
  r.to = (dir ? p.left_sig : p.right_sig) + b * kSigWords;
  r.from = (dir ? p.right_sig : p.left_sig) + b * kSigWords;
  r.credits0 = r.credits1 = 0;
  r.received0 = r.received1 = 0;

  if (n > 1 && !r.enter(p, b)) return;
  const float4* in = reinterpret_cast<const float4*>(p.in);
  float4* out = reinterpret_cast<float4*>(p.out);
  switch (mode) {
    case kAllGather:
      all_gather(r, in, out, d);
      break;
    case kReduceScatter:
      reduce_scatter(r, in, out, d);
      break;
    case kAllReduce:
      all_reduce(r, in, out, d, false);
      break;
    case kBidir: {
      // the bottom half starts n chunks in
      const long long off = dir * n * chunk4;
      all_reduce(r, in + off, out + off, dir ? wrap(-d, n) : d, dir == 1);
      break;
    }
  }
}

int launch(int mode, const void* ranks, int n, long long chunk4, int blocks,
           long long timeout_ns, void* stream) {
  const RankPtrs* table = static_cast<const RankPtrs*>(ranks);
  void* args[] = {&table, &n, &chunk4, &mode, &timeout_ns};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_kernel), dim3(blocks, n), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a non-sticky error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// ranks: device array of n RankPtrs; chunk4: float4s per chunk; blocks:
// gridDim.x (even for bidir). Runs on `stream`; returns the launch's error.
extern "C" int ring_all_gather_f32(const void* ranks, int n, long long chunk4,
                                   int blocks, long long timeout_ns,
                                   void* stream) {
  return launch(kAllGather, ranks, n, chunk4, blocks, timeout_ns, stream);
}

extern "C" int ring_reduce_scatter_f32(const void* ranks, int n,
                                       long long chunk4, int blocks,
                                       long long timeout_ns, void* stream) {
  return launch(kReduceScatter, ranks, n, chunk4, blocks, timeout_ns, stream);
}

extern "C" int ring_all_reduce_f32(const void* ranks, int n, long long chunk4,
                                   int blocks, long long timeout_ns,
                                   void* stream) {
  return launch(kAllReduce, ranks, n, chunk4, blocks, timeout_ns, stream);
}

extern "C" int ring_all_reduce_bidir_f32(const void* ranks, int n,
                                         long long chunk4, int blocks,
                                         long long timeout_ns, void* stream) {
  return launch(kBidir, ranks, n, chunk4, blocks, timeout_ns, stream);
}

// Blocks of ring_kernel that can be resident at once on the current device.
extern "C" int ring_resident_blocks(int* out) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *out = per_sm * sms;
  return static_cast<int>(err);
}
