// Ring collectives over virtual ranks: all-gather, reduce-scatter, all-reduce
// and bidirectional all-reduce (f32), each one cooperative launch for all ranks.
//
// Replaces the four Pallas kernels of tpu_operator/parallel/ring.py:
//   _ring_all_gather_kernel (K3), _ring_reduce_scatter_kernel (K4),
//   _ring_all_reduce_kernel (K5), _ring_all_reduce_bidir_kernel (K6).
// They compute the same values as those kernels, bit for bit: the same hops,
// the same chunk indices and the same `received + local` f32 adds, in the
// same order. Nothing else is done to the data (no fast math, no multiply),
// so each kernel also equals its plain versions in parallel/ring.py exactly.
//
// Ranks. blockIdx.y is the rank. A rank's code reads one RankPtrs entry and
// reaches nothing but what it names: its own input, output and signal words,
// its right neighbour's output (all four) and its left one's (K6), its own
// and its right neighbour's staging area (K4), and its neighbours' signal
// words. On one card these are separate allocations of virtual ranks; the
// same code would run across cards with peer pointers in the table (and
// epoch counters in place of the signal words that the wrapper zeroes
// before each launch).
//
// Independent rings per block. Each rank runs on gridDim.x blocks; block b of
// a rank moves the b-th slice of every chunk and signals only block b of its
// neighbours, so the launch holds gridDim.x independent rings and the blocks
// of one rank never wait for each other.
//
// What bounds them on an H100: device-memory bytes. They only copy and add;
// on one card every hop is a read and a write of device memory (the least
// time counts each rank's input read once and its output written once, over
// 3.35 TB/s). Across cards the bound would be the NVLink rate instead.
//
// The design (all_gather_kernel, reduce_scatter_kernel, all_reduce_kernel,
// all_reduce_bidir_kernel): the sender writes into memory of its neighbour,
// the neighbour's output wherever the output has room for it. Every
// location a rank writes there is one that nobody reads or writes until the
// rank's signal says it is there, so there are no comm slots and no
// credits (the TPU kernels' two receive slots per rank are reused hop after
// hop, and credits guard that reuse); the only signal is one monotone
// "arrived" counter per block. Per rank, with c the chunk:
//   K3, hop 0:      out[d] and right.out[d] <- in          (read c, write 2c)
//       hop t >= 1: right.out[d-t] <- out[d-t]             (read c, write c)
//   K5 reduce-scatter hop 0:  right.out[d] <- in[d]
//       hop i >= 1:           right.out[d-i] <- out[d-i] + in[d-i]
//      all-gather hop 0:      v = out[d+1] + in[d+1]; out[d+1], right.out[d+1] <- v
//       hop i >= 1:           right.out[d+1-i] <- out[d+1-i]
//   K4, hop 0:               right.stage[0] <- in[d-1]
//       hop t, 1 <= t <= n-2: right.stage[t] <- stage[t-1] + in[d-t-1]
//                            (the last of them, t = n-2, into right.out;
//                            at n = 2 hop 0 goes there)
//       last:                out <- out + in[d], in place
// Per rank K3 moves c(2n - 1) bytes, K4 c(3n - 1) and K5 c(5n - 4), c the
// chunk of a hop. In K5 a partial sum lives in the receiver's own output;
// the all-gather overwrites it only after a chain of signals that passes
// through the rank that read it. Each piece is written exactly once by K3,
// so K3 needs no ordering beyond "arrived". K4's output is one chunk, so the
// partial sums that pass through a rank have no place in it: each rank has a
// staging area of n - 2 chunks, one per hop that forwards, so that every
// staging piece, like every output piece, is written once per launch by the
// left neighbour and read only by its owner after the arrival. (A staging
// chunk reused by a later hop would need a signal back to the sender, which
// is what the TPU kernel's credits are.) A staging piece is read once, a
// few microseconds after it was written, and never again, so its owner
// discards its lines from L2 (discard.global.L2) once it has forwarded
// them: the partial sums need not reach device memory at all, and without
// their write-back K4 is 6-7% faster (PERF.md).
//
// K6 is K5's schedule twice: the first half of a rank's blocks runs it
// rightward over the top half of the tensor, the second half runs its
// mirror image leftward over the bottom half (the rank's position along
// that ring is -d mod n and the chunk labels are mirrored, which is the TPU
// kernel's reverse index arithmetic). Leftward block b writes into its left
// neighbour's output and signals that neighbour's block b. Both directions
// share K5's per-piece body (all_reduce_piece), so K6 makes the same adds in
// the same order as the slot schedule, and moves K5's c(5n - 4) per rank.
//
// Pieces. A block cuts its slice into pieces (the wrapper's PIECE_BYTES or,
// for K6, BIDIR_PIECE_BYTES, each chosen by a sweep on the card) and runs
// each piece through all of its hops before the next (piece-major),
// signalling per piece. A piece is forwarded moments after it arrived. The
// intent is that with some hundred blocks in flight the bytes between a
// write and its forwarding read fit in the 50 MB L2, so that the forwarded
// read is served from there (the hit rate is not measured). The neighbour that sends to a block walks the same (piece, hop)
// order, so the counter stays monotone: the k-th arrival is always the same
// piece and hop. A piece moves through registers (16-byte ld/st.global.cg,
// kUnroll loads in flight per thread). Hopper's bulk copies (cp.async.bulk
// through shared memory on an mbarrier) were timed against this loop on an
// H100 and were no faster (PERF.md), so they are not used.
//
// Common to all: an entry barrier (signal both neighbours' barrier word
// once, wait for 2), which across cards keeps a rank from writing into an
// output or staging area that a previous collective still uses. Signalling
// is __syncthreads, then a release add at system scope (red.release.sys) by
// thread 0; waiting is thread 0 spinning on acquire loads at system scope,
// then __syncthreads. The barrier also puts a system fence before the add
// and after the wait; the hops do not (release() and acquire() below): the
// fences are not needed for the ordering, and they make every hop's
// handshake slower (PERF.md). Data written by a neighbour is
// read with ld.global.cg so that no stale L1 line is used. A wait that sees
// no progress for timeout_ns (the GPU's global timer) writes a code into the
// rank's status word and ends the block; the wrapper reads the status words
// after the launch and raises. Each block waits for its last arrival before
// it ends, so a stalled neighbour is caught there too.
//
// Residency. A rank spinning on a neighbour that never got an SM would hang,
// so the launch is cooperative: cudaLaunchCooperativeKernel refuses a grid
// that cannot be resident all at once. The wrapper sizes gridDim.x from
// ring_resident_blocks() / n, for the kernel it launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // float4s each thread loads before it stores
constexpr int kSigWords = 16;  // per block: 64 bytes of signal words
constexpr int kBarrier = 0;
constexpr int kArrived = 1;    // pieces that arrived in my output or staging
constexpr int kStatus = 15;    // non-zero: a wait timed out (code below)

enum Stall { kStallBarrier = 1, kStallArrival = 2 };
// the kernels, as ring_resident_blocks names them
enum Kernel {
  kAllGatherKernel = 0,
  kReduceScatterKernel = 1,
  kAllReduceKernel = 2,
  kAllReduceBidirKernel = 3
};

struct RankPtrs {
  const float* in;
  float* out;
  float* right_out;    // the right neighbour's output
  float* left_out;     // the left neighbour's output (K6)
  float* stage;        // this rank's staging area (K4): [n - 2][chunk]
  float* right_stage;  // the right neighbour's staging area
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

// The hops' lighter pair. The release at system scope alone orders every
// thread's earlier accesses before the add (__syncthreads orders the other
// threads' before thread 0's), and the acquire every later one after the
// wait, so neither needs a separate system fence.
__device__ __forceinline__ void release(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) add_release(word, 1u);
}

__device__ __forceinline__ bool acquire(const unsigned* word, unsigned target,
                                        unsigned* status, unsigned code,
                                        long long timeout_ns) {
  __shared__ int ok;
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
    ok = good;
  }
  __syncthreads();
  return ok != 0;
}

// Signal both neighbours' barrier word for block b, wait for theirs.
__device__ __forceinline__ bool barrier(const RankPtrs& p, int b, unsigned* my,
                                        long long timeout_ns) {
  if (threadIdx.x == 0) {
    __threadfence_system();
    add_release(p.right_sig + b * kSigWords + kBarrier, 1u);
    add_release(p.left_sig + b * kSigWords + kBarrier, 1u);
  }
  return wait_for(my + kBarrier, 2u, my + kStatus, kStallBarrier, timeout_ns);
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// received + local, in that order
__device__ __forceinline__ float4 sum4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// dst0[i] (and dst1[i], if given) = a[i], or a[i] + b[i] (received + local),
// for the float4s i in [lo, hi). Each thread loads kUnroll vectors of each
// source before it stores any.
__device__ __forceinline__ void forward(float4* dst0, float4* dst1,
                                        const float4* a, const float4* b,
                                        long long lo, long long hi) {
  constexpr long long kStride = static_cast<long long>(kUnroll) * kThreads;
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kStride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(a + i + u * kThreads);
    if (b != nullptr) {
      float4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldcg(b + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = sum4(v[u], w[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      __stcg(dst0 + i + u * kThreads, v[u]);
      if (dst1 != nullptr) __stcg(dst1 + i + u * kThreads, v[u]);
    }
  }
  for (; i < hi; i += kThreads) {
    float4 v = __ldcg(a + i);
    if (b != nullptr) v = sum4(v, __ldcg(b + i));
    __stcg(dst0 + i, v);
    if (dst1 != nullptr) __stcg(dst1 + i, v);
  }
}

// One block of a rank: where its signals go, and the arrivals it has waited
// for (the same count in every thread).
struct Direct {
  int n;
  long long chunk4, timeout_ns;
  unsigned* my;      // my signal words (this block)
  unsigned* to;      // the signal words of the rank I send to (this block)
  unsigned awaited;  // arrivals counted so far

  // float4 offset of chunk c (mod n); kMirror labels the chunks of the
  // leftward ring in the mirror image
  template <bool kMirror = false>
  __device__ long long at(int c) const {
    return static_cast<long long>(wrap(kMirror ? -c : c, n)) * chunk4;
  }
  // wait for the next piece to arrive in my output or staging area
  __device__ bool arrival() {
    return acquire(my + kArrived, ++awaited, my + kStatus, kStallArrival,
                   timeout_ns);
  }
  // a piece arrival that nothing forwards: awaited at the end
  __device__ void skip() { ++awaited; }
  __device__ bool last() {
    return acquire(my + kArrived, awaited, my + kStatus, kStallArrival,
                   timeout_ns);
  }
  // my piece is in the neighbour's memory
  __device__ void sent() { release(to + kArrived); }
  // one hop of one piece [s, e): wait for its arrival if `wait`, then
  // dst0 (and dst1) <- a (+ b), then signal the neighbour
  __device__ bool hop(bool wait, float4* dst0, float4* dst1, const float4* a,
                      const float4* b, long long s, long long e) {
    if (wait && !arrival()) return false;
    forward(dst0, dst1, a, b, s, e);
    sent();
    return true;
  }
};

// `to_sig`: the signal words of the rank this block sends to
__device__ __forceinline__ Direct direct(const RankPtrs& p, unsigned* to_sig,
                                         int n, long long chunk4,
                                         long long timeout_ns) {
  Direct r;
  r.n = n;
  r.chunk4 = chunk4;
  r.timeout_ns = timeout_ns;
  r.my = p.sig + blockIdx.x * kSigWords;
  r.to = to_sig + blockIdx.x * kSigWords;
  r.awaited = 0;
  return r;
}

// K3: out[c] = rank c's input, for every c, in n - 1 hops per piece.
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(const RankPtrs* __restrict__ ranks, int n, long long chunk4,
                  long long piece4, long long timeout_ns) {
  const int d = blockIdx.y;
  const RankPtrs p = ranks[d];
  const long long lo = chunk4 * blockIdx.x / gridDim.x;
  const long long hi = chunk4 * (blockIdx.x + 1) / gridDim.x;
  const float4* in = reinterpret_cast<const float4*>(p.in);
  float4* out = reinterpret_cast<float4*>(p.out);
  float4* right = reinterpret_cast<float4*>(p.right_out);
  if (n == 1) {
    forward(out, nullptr, in, nullptr, lo, hi);
    return;
  }
  Direct r = direct(p, p.right_sig, n, chunk4, timeout_ns);
  if (!barrier(p, blockIdx.x, r.my, timeout_ns)) return;
  for (long long s = lo; s < hi; s += piece4) {
    const long long e = s + piece4 < hi ? s + piece4 : hi;
    // hop 0: my chunk into my output and the right neighbour's
    if (!r.hop(false, out + r.at(d), right + r.at(d), in, nullptr, s, e))
      return;
    // hop t: the chunk that started t ranks to my left arrived at hop t - 1
    for (int t = 1; t < n - 1; ++t) {
      const long long c = r.at(d - t);
      if (!r.hop(true, right + c, nullptr, out + c, nullptr, s, e)) return;
    }
    r.skip();  // chunk d + 1 arrives last and goes no further
  }
  r.last();
}

// Drop the whole 128-byte lines of the float4s [base + s, base + e) from L2
// without writing them back to device memory. Only for data that nothing
// reads again in this launch, after a block barrier that follows the
// block's last load of it: the discard counts as a write of an unspecified
// value.
__device__ __forceinline__ void discard_lines(const float4* base, long long s,
                                              long long e) {
  unsigned long long lo = __cvta_generic_to_global(base + s);
  unsigned long long hi = __cvta_generic_to_global(base + e);
  lo = (lo + 127ull) & ~127ull;
  hi &= ~127ull;
  for (unsigned long long a = lo + threadIdx.x * 128ull; a < hi;
       a += kThreads * 128ull)
    asm volatile("discard.global.L2 [%0], 128;" :: "l"(a) : "memory");
}

// K4: out = chunk d of the sum, in n - 1 hops per piece. The running sum of
// chunk c starts at rank c + 1 and ends at rank c; on its way it rests in
// the staging areas, stage[t] holding what hop t delivered.
__global__ void __launch_bounds__(kThreads)
reduce_scatter_kernel(const RankPtrs* __restrict__ ranks, int n,
                      long long chunk4, long long piece4,
                      long long timeout_ns) {
  const int d = blockIdx.y;
  const RankPtrs p = ranks[d];
  const long long lo = chunk4 * blockIdx.x / gridDim.x;
  const long long hi = chunk4 * (blockIdx.x + 1) / gridDim.x;
  const float4* in = reinterpret_cast<const float4*>(p.in);
  float4* out = reinterpret_cast<float4*>(p.out);
  const float4* stage = reinterpret_cast<const float4*>(p.stage);
  float4* right_stage = reinterpret_cast<float4*>(p.right_stage);
  float4* right_out = reinterpret_cast<float4*>(p.right_out);
  if (n == 1) {
    forward(out, nullptr, in, nullptr, lo, hi);
    return;
  }
  Direct r = direct(p, p.right_sig, n, chunk4, timeout_ns);
  if (!barrier(p, blockIdx.x, r.my, timeout_ns)) return;
  for (long long s = lo; s < hi; s += piece4) {
    const long long e = s + piece4 < hi ? s + piece4 : hi;
    // hop 0: my addend of chunk d - 1 starts its way
    if (!r.hop(false, n == 2 ? right_out : right_stage, nullptr,
               in + r.at(d - 1), nullptr, s, e))
      return;
    // hop t: the partial of chunk d - t - 1 arrived at hop t - 1; add mine
    // (received + local) and pass it on, at the last hop into the output
    // of the rank that owns the chunk
    for (int t = 1; t < n - 1; ++t) {
      float4* to = t == n - 2 ? right_out : right_stage + t * chunk4;
      if (!r.hop(true, to, nullptr, stage + (t - 1) * chunk4,
                 in + r.at(d - t - 1), s, e))
        return;
      // what I forwarded is read: keep L2 from writing it back
      discard_lines(stage + (t - 1) * chunk4, s, e);
    }
    // chunk d arrived in my output with every addend but mine
    if (!r.arrival()) return;
    forward(out, nullptr, out, in + r.at(d), s, e);
  }
}

// One piece [s, e) of K5's schedule: reduce-scatter then all-gather,
// 2(n - 1) hops; chunk c is complete on rank c - 1. Partial sums are held in
// the receiver's output: `to` is the output of the rank this block sends to,
// `pos` the rank's position along the ring, and kMirror labels the chunks of
// the leftward ring (K6's bottom half).
template <bool kMirror>
__device__ __forceinline__ bool all_reduce_piece(Direct& r, const float4* in,
                                                 float4* out, float4* to,
                                                 int pos, long long s,
                                                 long long e) {
  const int n = r.n;
  // reduce-scatter hop 0: my addend of chunk pos starts its way
  const long long c0 = r.at<kMirror>(pos);
  if (!r.hop(false, to + c0, nullptr, in + c0, nullptr, s, e)) return false;
  // hop i: the partial of chunk pos - i arrived; add mine, pass it on
  for (int i = 1; i < n - 1; ++i) {
    const long long c = r.at<kMirror>(pos - i);
    if (!r.hop(true, to + c, nullptr, out + c, in + c, s, e)) return false;
  }
  // all-gather hop 0: my addend completes chunk pos + 1; keep it and send it
  const long long f = r.at<kMirror>(pos + 1);
  if (!r.hop(true, out + f, to + f, out + f, in + f, s, e)) return false;
  // hop i: the sum of chunk pos + 1 - i arrived; pass it on
  for (int i = 1; i < n - 1; ++i) {
    const long long c = r.at<kMirror>(pos + 1 - i);
    if (!r.hop(true, to + c, nullptr, out + c, nullptr, s, e)) return false;
  }
  r.skip();  // the sum of chunk pos + 2 arrives last and goes no further
  return true;
}

// K5: all_reduce_piece rightward, piece by piece.
__global__ void __launch_bounds__(kThreads)
all_reduce_kernel(const RankPtrs* __restrict__ ranks, int n, long long chunk4,
                  long long piece4, long long timeout_ns) {
  const int d = blockIdx.y;
  const RankPtrs p = ranks[d];
  const long long lo = chunk4 * blockIdx.x / gridDim.x;
  const long long hi = chunk4 * (blockIdx.x + 1) / gridDim.x;
  const float4* in = reinterpret_cast<const float4*>(p.in);
  float4* out = reinterpret_cast<float4*>(p.out);
  float4* right = reinterpret_cast<float4*>(p.right_out);
  if (n == 1) {
    forward(out, nullptr, in, nullptr, lo, hi);
    return;
  }
  Direct r = direct(p, p.right_sig, n, chunk4, timeout_ns);
  if (!barrier(p, blockIdx.x, r.my, timeout_ns)) return;
  for (long long s = lo; s < hi; s += piece4) {
    const long long e = s + piece4 < hi ? s + piece4 : hi;
    if (!all_reduce_piece<false>(r, in, out, right, d, s, e)) return;
  }
  r.last();
}

// K6: the first half of the blocks runs K5's schedule rightward over the top
// half of the tensor (n chunks), the second half its mirror image leftward
// over the bottom half; chunk4 is a chunk of one half.
__global__ void __launch_bounds__(kThreads)
all_reduce_bidir_kernel(const RankPtrs* __restrict__ ranks, int n,
                        long long chunk4, long long piece4,
                        long long timeout_ns) {
  const int d = blockIdx.y;
  const RankPtrs p = ranks[d];
  const int rings = gridDim.x / 2;  // blocks per direction
  const bool left = blockIdx.x >= rings;
  const int slice = blockIdx.x - (left ? rings : 0);
  const long long lo = chunk4 * slice / rings;
  const long long hi = chunk4 * (slice + 1) / rings;
  const long long half = left ? n * chunk4 : 0;
  const float4* in = reinterpret_cast<const float4*>(p.in) + half;
  float4* out = reinterpret_cast<float4*>(p.out) + half;
  float4* to = reinterpret_cast<float4*>(left ? p.left_out : p.right_out) +
               half;
  if (n == 1) {
    forward(out, nullptr, in, nullptr, lo, hi);
    return;
  }
  Direct r = direct(p, left ? p.left_sig : p.right_sig, n, chunk4,
                    timeout_ns);
  if (!barrier(p, blockIdx.x, r.my, timeout_ns)) return;
  for (long long s = lo; s < hi; s += piece4) {
    const long long e = s + piece4 < hi ? s + piece4 : hi;
    if (!(left ? all_reduce_piece<true>(r, in, out, to, wrap(-d, n), s, e)
               : all_reduce_piece<false>(r, in, out, to, d, s, e)))
      return;
  }
  r.last();
}

const void* kernel_fn(int kernel) {
  if (kernel == kAllGatherKernel)
    return reinterpret_cast<const void*>(all_gather_kernel);
  if (kernel == kAllReduceKernel)
    return reinterpret_cast<const void*>(all_reduce_kernel);
  if (kernel == kAllReduceBidirKernel)
    return reinterpret_cast<const void*>(all_reduce_bidir_kernel);
  return reinterpret_cast<const void*>(reduce_scatter_kernel);
}

int launch(int kernel, void** args, int n, int blocks, void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_fn(kernel), dim3(blocks, n), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a non-sticky error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

int launch_direct(int kernel, const void* ranks, int n, long long chunk4,
                  int blocks, long long piece4, long long timeout_ns,
                  void* stream) {
  const RankPtrs* table = static_cast<const RankPtrs*>(ranks);
  void* args[] = {&table, &n, &chunk4, &piece4, &timeout_ns};
  return launch(kernel, args, n, blocks, stream);
}

}  // namespace

// ranks: device array of n RankPtrs; chunk4: float4s per chunk (K6: of a
// half); blocks: gridDim.x (even for bidir); piece4: float4s per piece. Runs
// on `stream`; returns the launch's error.
extern "C" int ring_all_gather_f32(const void* ranks, int n, long long chunk4,
                                   int blocks, long long piece4,
                                   long long timeout_ns, void* stream) {
  return launch_direct(kAllGatherKernel, ranks, n, chunk4, blocks, piece4,
                       timeout_ns, stream);
}

extern "C" int ring_reduce_scatter_f32(const void* ranks, int n,
                                       long long chunk4, int blocks,
                                       long long piece4,
                                       long long timeout_ns, void* stream) {
  return launch_direct(kReduceScatterKernel, ranks, n, chunk4, blocks, piece4,
                       timeout_ns, stream);
}

extern "C" int ring_all_reduce_f32(const void* ranks, int n, long long chunk4,
                                   int blocks, long long piece4,
                                   long long timeout_ns, void* stream) {
  return launch_direct(kAllReduceKernel, ranks, n, chunk4, blocks, piece4,
                       timeout_ns, stream);
}

extern "C" int ring_all_reduce_bidir_f32(const void* ranks, int n,
                                         long long chunk4, int blocks,
                                         long long piece4,
                                         long long timeout_ns, void* stream) {
  return launch_direct(kAllReduceBidirKernel, ranks, n, chunk4, blocks,
                       piece4, timeout_ns, stream);
}

// Blocks of one ring kernel that can be resident at once on the current
// device: kernel 0 is K3, 1 is K4, 2 is K5, 3 is K6.
extern "C" int ring_resident_blocks(int kernel, int* out) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_fn(kernel), kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *out = per_sm * sms;
  return static_cast<int>(err);
}
