// K1: the whole dense-exchange chain, permuted copy plus XOR, in one launch.
//
// Replaces tpu_aggcomm/backends/pallas_local.py::fused_exchange_chain (the
// Pallas `kernel` at :76-80, launched at :83, and the `lax.scan` over it
// inside one jitted program at :92-99). Rep r computes
//
//     out[j, s, :] = in[s, order[j], :] ^ rep_word(r)        (uint32 lanes)
//
// where `order` is the ascending-aggregator-rank row order and
// rep_word(r) = (r & 0xFF) * 0x01010101. Rep 0 reads send0 (never
// written); rep r > 0 reads the buffer rep r - 1 wrote; rep r writes
// buf[r % 2]. `out` (cb, n, w) is read as (n, cb, w) by the next rep.
//
// What bounds it on an H100: bytes, 2*n*cb*d per rep (one read, one
// write); at the README shape (1.8 MB a rep) from L2, at 1024x64x2048
// (268 MB a rep) from HBM. The design:
//
//   - one persistent cooperative launch runs every rep, so a rep costs no
//     host launch; the grid is sized once per process from occupancy x
//     SMs (capped by the launch constants and by the work), so every CTA
//     is co-resident and the barrier cannot deadlock;
//   - between reps one grid-wide barrier, the hand-rolled monotone
//     barrier of sync.cuh (release increment, acquire spin until (r + 1)
//     * gridDim arrivals, bounded by %globaltimer): no read of rep r + 1
//     starts before every write of rep r is visible. Reps are never
//     merged, skipped or reordered: every rep reads its whole input from
//     global memory after the barrier, nothing is kept in registers or
//     shared memory across reps, and rows are not followed along the
//     permutation;
//   - CTAs walk the output grid-stride in contiguous tiles of threads x
//     VPT 16-byte vectors (4-byte words when a row or a pointer is not
//     16-byte aligned), so the card sweeps one window of the arena at a
//     time; the grid is sized so every wave of tiles is (nearly) full.
//     Each thread keeps VPT vectors in flight, unrolled: VPT loads, then
//     VPT stores. Neighbouring threads touch neighbouring addresses on
//     both sides. The index splits into (j, s, u) by multiplying with
//     precomputed reciprocals, not by dividing;
//   - the launch constants follow where the two working arenas live: 512
//     threads x 2 vectors, one CTA per SM when they fit 32 MiB of L2;
//     128 threads x 8 vectors, up to 4 CTAs per SM beyond (measured on the
//     card, PERF.md);
//   - the order table is read once per CTA into shared memory;
//   - with a stamp buffer (diagnostic calls only; the main path passes
//     null) thread 0 of each CTA writes %globaltimer before it arrives at
//     each barrier and after it leaves.
//
// The one-rep entry (exchange()) is the same kernel with iters = 1, in an
// ordinary launch (no barrier, so no co-residency is needed).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

namespace {

// flat 32-bit indexing over the output (the wrapper refuses more)
constexpr unsigned long long kMaxUnits = 1ULL << 31;
// both arenas of a rep at most this many bytes: the L2 launch constants
constexpr unsigned long long kL2ChainBytes = 32ULL << 20;
// returned, before any launch, when the barrier's 32-bit arrival counter
// would overflow ((iters - 1) * grid >= 2^32)
constexpr int kRefusedCounter = -1;

struct Launch {
  int threads;
  int vpt;  // 16-byte vectors (or words) in flight per thread
  int ctas_per_sm;
};
constexpr Launch kL2Launch = {512, 2, 1};
constexpr Launch kHbmLaunch = {128, 8, 4};

template <typename T>
struct ChainArgs {
  const T* send0;
  T* buf0;
  T* buf1;
  const int* order;
  int n;
  int cb;
  unsigned units;   // T per row
  unsigned total;   // T in one arena
  unsigned rowlen;  // T per output row group: n * units
  unsigned long long units_magic;  // fast division by units, by rowlen
  unsigned long long rowlen_magic;
  int iters;
  int r0;  // rep index of the first rep (its word)
  aggcomm::BarrierWords sync;
  unsigned long long timeout_ns;
  unsigned long long* stamps;
};

// ceil(2^64 / d): for i < 2^31 and 2 <= d < 2^32, umulhi64(i, magic) is
// exactly i / d (the error i * (magic - 2^64 / d) / 2^64 < 2^-33 stays
// below 1 / d), one multiply instead of a division per vector
unsigned long long magic_of(unsigned d) {
  return d <= 1 ? 0ULL : ~0ULL / d + 1ULL;
}

__device__ __forceinline__ unsigned fast_div(unsigned i, unsigned d,
                                             unsigned long long magic) {
  return d == 1 ? i : (unsigned)__umul64hi((unsigned long long)i, magic);
}

__device__ __forceinline__ uint4 xor_word(uint4 v, unsigned int w) {
  v.x ^= w; v.y ^= w; v.z ^= w; v.w ^= w;
  return v;
}

__device__ __forceinline__ unsigned int xor_word(unsigned int v,
                                                 unsigned int w) {
  return v ^ w;
}

template <typename T, int VPT>
__global__ void exchange_chain_kernel(ChainArgs<T> a) {
  extern __shared__ int s_order[];
  for (int i = threadIdx.x; i < a.cb; i += blockDim.x) s_order[i] = a.order[i];
  __syncthreads();
  const unsigned tile = blockDim.x * VPT;  // a CTA's contiguous tile
  const unsigned first = blockIdx.x * tile + threadIdx.x;
  unsigned long long* stamps =
      a.stamps == nullptr
          ? nullptr
          : a.stamps + (unsigned long long)blockIdx.x * 2 * (a.iters - 1);
  const T* in = a.send0;
  for (int r = 0; r < a.iters; ++r) {
    T* out = (r & 1) ? a.buf1 : a.buf0;
    const unsigned word = ((unsigned)(a.r0 + r) & 0xFFu) * 0x01010101u;
    for (unsigned base = first; base < a.total; base += gridDim.x * tile) {
      T v[VPT];
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const unsigned i = base + k * blockDim.x;
        if (i < a.total) {
          // output index i = (j, s, u) of the (cb, n, units) arena
          const unsigned j = fast_div(i, a.rowlen, a.rowlen_magic);
          const unsigned rest = i - j * a.rowlen;
          const unsigned s = fast_div(rest, a.units, a.units_magic);
          const unsigned u = rest - s * a.units;
          v[k] = in[(s * (unsigned)a.cb + (unsigned)s_order[j]) * a.units + u];
        }
      }
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const unsigned i = base + k * blockDim.x;
        if (i < a.total) out[i] = xor_word(v[k], word);
      }
    }
    in = out;
    if (r + 1 < a.iters) {  // rep r + 1 reads only after this barrier
      if (stamps != nullptr) {
        __syncthreads();
        if (threadIdx.x == 0) stamps[2 * r] = aggcomm::global_ns();
      }
      if (aggcomm::grid_arrive_wait(a.sync, (unsigned)(r + 1) * gridDim.x, r,
                                    a.timeout_ns)) {
        return;
      }
      if (stamps != nullptr && threadIdx.x == 0) {
        stamps[2 * r + 1] = aggcomm::global_ns();
      }
    }
  }
}

struct OccKey {
  const void* fn;
  int threads;
  size_t smem;
  int blocks;
};

// blocks per SM of one instantiation at one block size and shared memory,
// cached for the process
cudaError_t blocks_per_sm(const void* fn, int threads, size_t smem, int* out) {
  static OccKey cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].threads == threads &&
        cache[i].smem == smem) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = OccKey{fn, threads, smem, *out};
  return cudaSuccess;
}

cudaError_t sm_count(int device, int* out) {
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = sms;
  return cudaSuccess;
}

// The launch constants and kernel for a chain over `total` T per arena.
template <typename T>
Launch launch_of(unsigned long long total, const void** fn) {
  if (2 * total * sizeof(T) <= kL2ChainBytes) {
    *fn = (const void*)exchange_chain_kernel<T, kL2Launch.vpt>;
    return kL2Launch;
  }
  *fn = (const void*)exchange_chain_kernel<T, kHbmLaunch.vpt>;
  return kHbmLaunch;
}

// The grid of one chain: co-resident CTAs (occupancy x SMs), at most
// ctas_per_sm x SMs, as many as make the waves of tiles even.
cudaError_t chain_grid(const void* fn, unsigned long long total, int cb,
                       Launch l, int device, int* grid) {
  int per_sm = 0, sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  err = blocks_per_sm(fn, l.threads, (size_t)cb * sizeof(int), &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (l.ctas_per_sm < per_sm) per_sm = l.ctas_per_sm;
  const long long cap = (long long)per_sm * sms;
  const long long tile = (long long)l.threads * l.vpt;
  const long long tiles = (long long)((total + tile - 1) / tile);
  // as few waves of tiles as the cap allows, each as full as it can be: a
  // last wave of a few tiles would run at a fraction of the card
  const long long waves = (tiles + cap - 1) / cap;
  long long g = (tiles + waves - 1) / waves;
  if (g > cap) g = cap;
  if (g < 1) g = 1;
  *grid = (int)g;
  return cudaSuccess;
}

bool vec16(const void* a, const void* b, const void* c, long long w) {
  return (w % 4 == 0) &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) %
              16 ==
          0);
}

template <typename T>
int launch(const void* send0, void* buf0, void* buf1, const int* order, int n,
           int cb, long long w, int iters, int r0, void* sync,
           unsigned long long timeout_ns, void* stamps, cudaStream_t stream,
           int device) {
  const long long units = w * 4 / (long long)sizeof(T);
  const unsigned long long total = (unsigned long long)n * cb * units;
  if (total >= kMaxUnits) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  const Launch l = launch_of<T>(total, &fn);
  int grid = 0;
  cudaError_t err = chain_grid(fn, total, cb, l, device, &grid);
  if (err != cudaSuccess) return (int)err;
  if (iters > 1) {
    if ((unsigned long long)(iters - 1) * grid >= (1ULL << 32))
      return kRefusedCounter;
    err = cudaMemsetAsync(sync, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
  }
  ChainArgs<T> a;
  a.send0 = static_cast<const T*>(send0);
  a.buf0 = static_cast<T*>(buf0);
  a.buf1 = static_cast<T*>(buf1);
  a.order = order;
  a.n = n;
  a.cb = cb;
  a.units = (unsigned)units;
  a.total = (unsigned)total;
  a.rowlen = (unsigned)(n * units);
  a.units_magic = magic_of(a.units);
  a.rowlen_magic = magic_of(a.rowlen);
  a.iters = iters;
  a.r0 = r0;
  a.sync.counter = static_cast<unsigned*>(sync);
  a.sync.error = static_cast<int*>(sync) + 1;
  a.timeout_ns = timeout_ns;
  a.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {(void*)&a};
  const size_t smem = (size_t)cb * sizeof(int);
  // one rep has no barrier: an ordinary launch, no co-residency needed
  err = iters == 1 ? cudaLaunchKernel(fn, dim3(grid), dim3(l.threads), args,
                                      smem, stream)
                   : cudaLaunchCooperativeKernel(fn, dim3(grid),
                                                 dim3(l.threads), args, smem,
                                                 stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `iters` serially dependent reps in one launch. send0: (n, cb, w) uint32
// lanes, never written; buf0, buf1: two (n, cb, w) buffers distinct from
// send0 (buf1 unused when iters == 1); rep r writes buf[r % 2] with the
// word of rep r0 + r. order: cb int32 on the device. sync: 4 int32 on the
// device (the barrier's arrival counter, zeroed here in the stream, and
// its error record, left as it is). stamps: null, or (grid, 2 * (iters -
// 1)) uint64 on the device for the barrier stamps. Returns -1, launching
// nothing, when (iters - 1) * grid arrivals would overflow the 32-bit
// counter; else cudaGetLastError() after the launch.
extern "C" int aggcomm_exchange_chain(const void* send0, void* buf0,
                                      void* buf1, const int* order, int n,
                                      int cb, long long w, int iters, int r0,
                                      void* sync,
                                      unsigned long long timeout_ns,
                                      void* stamps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iters <= 0 || n <= 0 || cb <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16(send0, buf0, buf1, w)) {
    return launch<uint4>(send0, buf0, buf1, order, n, cb, w, iters, r0, sync,
                         timeout_ns, stamps, s, device);
  }
  return launch<unsigned int>(send0, buf0, buf1, order, n, cb, w, iters, r0,
                              sync, timeout_ns, stamps, s, device);
}

// The grid aggcomm_exchange_chain would launch for these arguments (16-byte
// path when `vec` is non-zero), into *grid. Returns a cudaError_t.
extern "C" int aggcomm_exchange_grid(int n, int cb, long long w, int vec,
                                     int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long total =
      (unsigned long long)n * cb * (unsigned long long)(w * 4 / (vec ? 16 : 4));
  const void* fn = nullptr;
  const Launch l = vec ? launch_of<uint4>(total, &fn)
                       : launch_of<unsigned int>(total, &fn);
  return (int)chain_grid(fn, total, cb, l, device, grid);
}
