// K3: the remote-DMA semaphore step program, one co-resident CTA per rank,
// one launch a rep.
//
// Replaces tpu_aggcomm/backends/pallas_dma.py::PallasDmaBackend._lower (the
// Pallas `kernel` at :378-416, launched by pl.pallas_call at :420). There
// every rank was a TPU device: at step st it pushed its send row
// sslot[r, st] into recv row rslot[r, st] of device dst[r, st] with a
// remote DMA, and a wave (s0, s1) posted all its steps, drained its send
// semaphore, then waited for one arrival per step on its recv semaphore.
//
// On one H100 every rank is one CTA of a cooperative launch, grid = n. No
// grid.sync() is used: the cooperative launch is there for its
// co-residency guarantee, since rank CTAs spin on each other and a plain
// launch of more CTAs than fit at once could deadlock. The wrapper refuses
// an n above the cap (blocks per SM x SMs) before launching, and so does
// this file.
//
// The protocol, per wave of w steps (lockstep: w = 1):
//
//   post:   every step of the wave whose send slot is a real row copies it
//           (the wave's row chunks spread over the CTA's warps, so several
//           rows are in flight at once); then one __syncthreads; then
//           threads 0..w-1 each add one arrival to their step's `dst`
//           counter with red.release.gpu. No __threadfence and no
//           returning atomic: the release, after the CTA barrier, covers
//           every thread's stores of the wave.
//   wait:   thread 0 spins with ld.acquire.gpu on its own counter until
//           it has received the wave's cumulative step count s1 (every
//           rank receives exactly one arrival per step, as the TPU's
//           counting recv semaphore assumed), and __syncthreads_or
//           releases the CTA. The wait is bounded from its own start
//           (sync.cuh wait_count).
//
// Waves stay distinct: a step's store is issued only after the previous
// wave's wait has returned, and every step signals once, a step that
// moves no row included. What moves ahead of a wait is only reading: the
// next wave's table entries and each warp's first chunk of it (the send
// arena is never written) are loaded into registers before the spin and
// stored after it, so the chain of a wave holds store, release and the
// receiver's acquire, and no load.
//
// Dummy steps only signal. A step whose send slot is the dummy row (the
// barrier steps, the CTS grants, idle ranks' data steps) moved a zero row
// into the trash row on the TPU, where a DMA semaphore counts DMAs. Here
// the counter counts signals, so the accounting stays exact with no bytes
// moved; the host refuses tables in which a dummy step targets a real row
// or a real step the trash row, and the wrapper's send arena keeps the
// dummy row zero.
//
// One launch a rep, nothing zeroed between launches:
//
//   - the recv rows no real step writes (the trash rows among them) are
//     zeroed inside the kernel, split evenly over the CTAs before their
//     first post. They are disjoint from the written rows, so the zeroing
//     needs no ordering against the copies. (Zeroing a rank's whole arena
//     and trusting the init dissemination barrier to order it before any
//     data would not be safe: the waits count arrivals, not steps, so an
//     arrival of a later step can satisfy a barrier wait, and a rank can
//     leave the barrier before a late rank has started.)
//   - the arrival counters are never reset after the tables are made.
//     Every rank receives exactly n_steps arrivals a launch and its CTA
//     drains them all before it exits, so each rank keeps a base word on
//     the device (its counter at its last exit) that only its CTA reads
//     and writes, and the waits count from it. The base is read on the
//     device, never passed as an argument, so a CUDA graph replays right.
//
// After a timeout the error word stays set, and every later launch on
// those tables returns at once without posting: they stay refused.
//
// What bounds it on an H100: the dependent wave chain, n_waves cross-SM
// release -> acquire signals (chip_smoke.py measures one with an
// independent probe, signal_probe.cu), long before the bytes (the real
// rows read and written once, the rest of the recv arena zeroed: about
// 1 MB at n=32, 2.15 GB at n=1024). Offsets are 64-bit.
//
// With a stamp buffer (diagnostic calls only; the main path passes null)
// thread 0 of rank 0 writes %globaltimer: (start, zeroing done, exit),
// then for each wave (post start, signals issued, wait end).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

namespace {

using aggcomm::global_ns;
using aggcomm::red_release_add;
using aggcomm::wait_count;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// rank CTAs the occupancy must allow per SM: 10 caps the registers at 48
// a thread, so 1320 ranks fit the H100's 132 SMs (1024 need 8)
constexpr int kMinCtasPerSm = 10;
// uint32 words between two ranks' arrival counters: one counter per
// 128-byte line (cuda_dma.COUNTER_STRIDE lays them out)
constexpr long long kCounterStride = 32;

struct StepArgs {
  const unsigned char* send;
  unsigned char* recv;
  const int* dst;
  const int* sslot;
  const int* rslot;
  const int* wave_end;
  const int* zero_start;  // flat recv row where each zero run starts
  const int* zero_ptr;    // prefix row counts of the zero runs
  int n_zero_runs;
  long long zero_rows;
  int n_waves;
  int n_steps;
  int n_send_rows;
  int n_recv_rows;
  long long row_bytes;
  unsigned* arrival;  // rank r's counter at arrival[r * kCounterStride]
  unsigned* base;  // rank r's counter when its CTA last exited
  int* error;      // (rank + 1, step, arrivals) of the first timeout
  unsigned long long timeout_ns;
  long long* stamps;  // null, or (n_waves + 1, 3) of rank 0
};

__device__ __forceinline__ void stamp(long long* stamps, long long slot) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[slot] = global_ns();
}

// Lane l of a warp holds the table entries of step g0 + l of a group of at
// most 32 steps of one wave; `real` has the bit of every lane whose step
// moves a row. Every warp loads the same group.
struct Group {
  int dst;
  int sslot;
  int rslot;
  unsigned real;
};

__device__ __forceinline__ Group load_group(const StepArgs& a, long long tab,
                                            int g0, int g1) {
  const int st = g0 + (int)(threadIdx.x & 31u);
  Group g{0, 0, 0, 0u};
  if (st < g1) {
    g.dst = __ldg(a.dst + tab + st);
    g.sslot = __ldg(a.sslot + tab + st);
    g.rslot = __ldg(a.rslot + tab + st);
  }
  g.real = __ballot_sync(0xffffffffu,
                         st < g1 && g.sslot != a.n_send_rows - 1);
  return g;
}

// A chunk is 32 units (16-byte vectors, words or bytes) of one row; lane
// l moves unit u = 32 * chunk + l, so the CTA's 4 warps move 2 KB of
// 16-byte vectors at once.
template <typename T>
struct Chunk {
  const T* from;
  T* to;
  unsigned u;
};

// Task k of a group is chunk k % cpr of its (k / cpr)-th real step. False
// past the group's tasks (k is warp-uniform, so is the answer).
template <typename T>
__device__ __forceinline__ bool task(const StepArgs& a, int rank,
                                     const Group& g, unsigned k,
                                     unsigned cpr, Chunk<T>* c) {
  if (k >= (unsigned)__popc(g.real) * cpr) return false;
  const unsigned j = cpr == 1 ? k : k / cpr;
  unsigned m = g.real;
  for (unsigned i = 0; i < j; ++i) m &= m - 1;  // drop the first j steps
  const int l = __ffs(m) - 1;
  const int ss = __shfl_sync(0xffffffffu, g.sslot, l);
  const int rs = __shfl_sync(0xffffffffu, g.rslot, l);
  const int to = __shfl_sync(0xffffffffu, g.dst, l);
  c->u = (k - j * cpr) * 32u + (threadIdx.x & 31u);
  c->from = reinterpret_cast<const T*>(
                a.send + ((long long)rank * a.n_send_rows + ss) * a.row_bytes) +
            c->u;
  c->to = reinterpret_cast<T*>(
              a.recv + ((long long)to * a.n_recv_rows + rs) * a.row_bytes) +
          c->u;
  return true;
}

template <typename T>
__device__ __forceinline__ void load_chunk(const Chunk<T>& c, unsigned units,
                                           T* v) {
  if (c.u < units) *v = __ldg(c.from);
}

template <typename T>
__device__ __forceinline__ void store_chunk(const Chunk<T>& c, unsigned units,
                                            const T& v) {
  if (c.u < units) *c.to = v;
}

// This CTA's even share of the never-written recv rows, zeroed; flat zero
// row q lies in run z at zero_start[z] + (q - zero_ptr[z]).
template <typename T>
__device__ __forceinline__ void zero_share(const StepArgs& a) {
  const long long per = (a.zero_rows + gridDim.x - 1) / gridDim.x;
  long long q = (long long)blockIdx.x * per;
  const long long q1 = q + per < a.zero_rows ? q + per : a.zero_rows;
  if (q >= q1) return;
  int z = 0, hi = a.n_zero_runs - 1;  // the last run with zero_ptr <= q
  while (z < hi) {
    const int mid = (z + hi + 1) >> 1;
    if (a.zero_ptr[mid] <= q) z = mid; else hi = mid - 1;
  }
  const long long units = a.row_bytes / (long long)sizeof(T);
  for (; q < q1; ++z) {
    const long long end = q1 < a.zero_ptr[z + 1] ? q1 : a.zero_ptr[z + 1];
    T* d = reinterpret_cast<T*>(
        a.recv + ((long long)a.zero_start[z] + (q - a.zero_ptr[z])) *
                     a.row_bytes);
    const long long total = (end - q) * units;
    for (long long u = threadIdx.x; u < total; u += kThreads) d[u] = T{};
    q = end;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    dma_steps_kernel(StepArgs a) {
  const int rank = blockIdx.x;
  const long long tab = (long long)rank * a.n_steps;  // row `rank` of a table
  const unsigned warp = threadIdx.x >> 5;
  const unsigned units = (unsigned)(a.row_bytes / (long long)sizeof(T));
  const unsigned cpr = (units + 31u) / 32u;
  long long* stamps = rank == 0 ? a.stamps : nullptr;
  stamp(stamps, 0);
  unsigned base = 0;
  int refused = 0;
  if (threadIdx.x == 0) {
    refused = *reinterpret_cast<volatile int*>(a.error) != 0;
    base = a.base[rank];
  }
  if (__syncthreads_or(refused)) return;  // the tables timed out before

  // wave 0's table entries and each warp's first chunk, ahead of the zeroing
  Group g{0, 0, 0, 0u};
  Chunk<T> c{};
  T v;
  bool has = false;
  int s1 = a.n_waves > 0 ? a.wave_end[0] : 0;
  if (a.n_waves > 0) {
    g = load_group(a, tab, 0, s1 < 32 ? s1 : 32);
    has = task(a, rank, g, warp, cpr, &c);
    if (has) load_chunk(c, units, &v);
  }
  zero_share<T>(a);
  if (stamps != nullptr) {
    __syncthreads();
    stamp(stamps, 1);
  }

  int s0 = 0;
  for (int w = 0; w < a.n_waves; ++w) {
    stamp(stamps, 3 * (w + 1));
    // post: this warp's chunks of the wave's real steps
    if (has) store_chunk(c, units, v);
    for (unsigned k = warp + kWarps; task(a, rank, g, k, cpr, &c);
         k += kWarps) {
      T u;
      load_chunk(c, units, &u);
      store_chunk(c, units, u);
    }
    for (int g0 = s0 + 32; g0 < s1; g0 += 32) {  // waves wider than 32
      const Group h = load_group(a, tab, g0, g0 + 32 < s1 ? g0 + 32 : s1);
      for (unsigned k = warp; task(a, rank, h, k, cpr, &c); k += kWarps) {
        T u;
        load_chunk(c, units, &u);
        store_chunk(c, units, u);
      }
    }
    __syncthreads();  // every warp's stores before the releases
    for (int t = threadIdx.x; t < s1 - s0; t += kThreads) {
      // lane t of warp 0 holds step s0 + t of the wave's first group
      const int to = t < 32 ? g.dst : __ldg(a.dst + tab + s0 + t);
      red_release_add(a.arrival + to * kCounterStride, 1u);
    }
    stamp(stamps, 3 * (w + 1) + 1);

    // the next wave's entries and first chunks, loaded before the wait
    const int wait_for = s1;
    s0 = s1;
    has = false;
    if (w + 1 < a.n_waves) {
      s1 = a.wave_end[w + 1];
      g = load_group(a, tab, s0, s0 + 32 < s1 ? s0 + 32 : s1);
      has = task(a, rank, g, warp, cpr, &c);
      if (has) load_chunk(c, units, &v);
    }
    int failed = 0;
    if (threadIdx.x == 0) {
      failed = wait_count(a.arrival + rank * kCounterStride,
                          base, (unsigned)wait_for, a.error, rank,
                          wait_for - 1, a.timeout_ns);
    }
    if (__syncthreads_or(failed)) return;
    stamp(stamps, 3 * (w + 1) + 2);
  }
  if (threadIdx.x == 0) a.base[rank] = base + (unsigned)a.n_steps;
  stamp(stamps, 2);
}

template <typename T>
cudaError_t blocks_per_sm(int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, dma_steps_kernel<T>, kThreads, 0);
}

// Co-resident CTA cap over every instantiation, once per process.
cudaError_t capacity(int device, int* out) {
  static int cap = 0;
  if (cap == 0) {
    int coop = 0, sms = 0, a = 0, b = 0, c = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if ((err = blocks_per_sm<uint4>(&a)) != cudaSuccess) return err;
    if ((err = blocks_per_sm<unsigned int>(&b)) != cudaSuccess) return err;
    if ((err = blocks_per_sm<unsigned char>(&c)) != cudaSuccess) return err;
    int per_sm = a < b ? a : b;
    per_sm = per_sm < c ? per_sm : c;
    cap = per_sm * sms;
  }
  *out = cap;
  return cudaSuccess;
}

template <typename T>
int launch(StepArgs a, int n, cudaStream_t stream) {
  void* args[] = {(void*)&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)dma_steps_kernel<T>, dim3(n), dim3(kThreads), args, 0,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The most rank CTAs K3 can hold co-resident on `device`, into *cap.
// Returns a cudaError_t (0 on success).
extern "C" int aggcomm_dma_capacity(int device, int* cap) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)capacity(device, cap);
}

// One rep. send: (n, n_send_rows, row_bytes) bytes, the dummy row (last)
// zero; recv: (n, n_recv_rows, row_bytes), any contents: every row no
// real step writes is in the zero runs and is zeroed here. dst, sslot,
// rslot: (n, n_steps) int32, row-major; wave_end: n_waves int32
// cumulative wave ends; zero_start: n_zero_runs int32 flat recv rows,
// zero_ptr: n_zero_runs + 1 int32 prefix row counts; arrival: n * 32
// words (a counter every kCounterStride) and base: n words, both zero when
// the tables were made and never reset; error: 3 int32, zero unless an
// earlier launch timed out. stamps: null, or (n_waves + 1, 3) int64. All
// on the device.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aggcomm_dma_steps(
    const void* send, void* recv, const int* dst, const int* sslot,
    const int* rslot, const int* wave_end, const int* zero_start,
    const int* zero_ptr, int n_zero_runs, long long zero_rows, int n,
    int n_waves, int n_steps, int n_send_rows, int n_recv_rows,
    long long row_bytes, void* arrival, void* base, void* error,
    unsigned long long timeout_ns, void* stamps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || row_bytes <= 0) return 0;
  int cap = 0;
  if ((err = capacity(device, &cap)) != cudaSuccess) return (int)err;
  if (n > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  StepArgs a;
  a.send = static_cast<const unsigned char*>(send);
  a.recv = static_cast<unsigned char*>(recv);
  a.dst = dst;
  a.sslot = sslot;
  a.rslot = rslot;
  a.wave_end = wave_end;
  a.zero_start = zero_start;
  a.zero_ptr = zero_ptr;
  a.n_zero_runs = n_zero_runs;
  a.zero_rows = n_zero_runs > 0 ? zero_rows : 0;
  a.n_waves = n_waves;
  a.n_steps = n_steps;
  a.n_send_rows = n_send_rows;
  a.n_recv_rows = n_recv_rows;
  a.row_bytes = row_bytes;
  a.arrival = static_cast<unsigned*>(arrival);
  a.base = static_cast<unsigned*>(base);
  a.error = static_cast<int*>(error);
  a.timeout_ns = timeout_ns;
  a.stamps = static_cast<long long*>(stamps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(send) |
                         reinterpret_cast<uintptr_t>(recv);
  if (row_bytes % 16 == 0 && addr % 16 == 0) return launch<uint4>(a, n, st);
  if (row_bytes % 4 == 0 && addr % 4 == 0) {
    return launch<unsigned int>(a, n, st);
  }
  return launch<unsigned char>(a, n, st);
}
