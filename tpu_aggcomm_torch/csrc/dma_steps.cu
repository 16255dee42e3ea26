// K3: the remote-DMA semaphore step program, one co-resident CTA per rank.
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
//   step: the whole CTA copies the row (16-byte vectors when the row width
//         and pointers allow, else 4-byte words, else bytes); then
//         __syncthreads, and thread 0 runs __threadfence and
//         atomicAdd(arrival[dst], 1): the release that makes the row
//         visible before its count.
//   wave: after posting every step of the wave (copy, signal, copy,
//         signal, ...), thread 0 spins with ld.acquire.gpu on its own
//         counter until it reaches the wave's cumulative step count s1
//         (every rank receives exactly one row per step, as the TPU's
//         counting recv semaphore assumed), and __syncthreads releases
//         the CTA. wait_send needs no wait of its own: a CTA's stores are
//         complete at its __syncthreads.
//
// Every row of the step table moves, dummy rows of idle ranks included, so
// the bytes equal the TPU program's. A spin is bounded by %globaltimer:
// past timeout_ns from the CTA's start it records (rank + 1, step,
// arrivals) in the error word and returns, and every other spinning CTA
// that sees the word set returns too, so a malformed program cannot wedge
// the card; the wrapper reads the word after its sync and raises.
//
// What bounds it on an H100: the dependent wave chain -- NS waves in
// lockstep, each a cross-SM release -> acquire round trip through L2 --
// long before the bytes (n * NS * d read and written, plus zeroing the
// recv arena: 14 us at n=32, NS=353, d=2048). The design keeps one counter
// per rank, so a step costs one atomic and a wave one acquire spin, and a
// concurrent wave pays the round trip once for all its steps. Skipping
// the dummy-row copies is a later, measured change. Offsets are 64-bit:
// at n=1024 the recv arena is 2.15 GB.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

namespace {

using aggcomm::global_ns;
using aggcomm::load_acquire;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dma_steps_kernel(const unsigned char* __restrict__ send,
                     unsigned char* __restrict__ recv,
                     const int* __restrict__ dst,
                     const int* __restrict__ sslot,
                     const int* __restrict__ rslot,
                     const int* __restrict__ wave_end, int n_waves,
                     int n_steps, int n_send_rows, int n_recv_rows,
                     long long row_bytes, unsigned* arrival, int* error,
                     unsigned long long timeout_ns) {
  const int rank = blockIdx.x;
  const long long tab = (long long)rank * n_steps;  // row `rank` of a table
  const long long units = row_bytes / (long long)sizeof(T);
  const unsigned char* mine = send + (long long)rank * n_send_rows * row_bytes;
  const unsigned long long start = global_ns();
  int s0 = 0;
  for (int w = 0; w < n_waves; ++w) {
    const int s1 = wave_end[w];
    for (int st = s0; st < s1; ++st) {  // post every step of the wave
      const int to = dst[tab + st];
      const T* s = reinterpret_cast<const T*>(
          mine + (long long)sslot[tab + st] * row_bytes);
      T* d = reinterpret_cast<T*>(
          recv + ((long long)to * n_recv_rows + rslot[tab + st]) * row_bytes);
      for (long long u = threadIdx.x; u < units; u += kThreads) d[u] = s[u];
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(arrival + to, 1u);
      }
    }
    int failed = 0;
    if (threadIdx.x == 0) {  // wait for s1 arrivals in all
      unsigned got;
      unsigned spins = 0;
      while ((got = load_acquire(arrival + rank)) < (unsigned)s1) {
        if ((++spins & 1023u) != 0) continue;
        if (*reinterpret_cast<volatile int*>(error) != 0) {
          failed = 1;  // another CTA gave up: this program cannot finish
          break;
        }
        if (global_ns() - start > timeout_ns) {
          if (atomicCAS(error, 0, rank + 1) == 0) {
            error[1] = s1 - 1;
            error[2] = (int)got;
          }
          failed = 1;
          break;
        }
      }
    }
    if (__syncthreads_or(failed)) return;
    s0 = s1;
  }
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
int launch(const unsigned char* send, unsigned char* recv, const int* dst,
           const int* sslot, const int* rslot, const int* wave_end, int n,
           int n_waves, int n_steps, int n_send_rows, int n_recv_rows,
           long long row_bytes, unsigned* arrival, int* error,
           unsigned long long timeout_ns, cudaStream_t stream) {
  void* args[] = {(void*)&send,        (void*)&recv,        (void*)&dst,
                  (void*)&sslot,       (void*)&rslot,       (void*)&wave_end,
                  (void*)&n_waves,     (void*)&n_steps,     (void*)&n_send_rows,
                  (void*)&n_recv_rows, (void*)&row_bytes,   (void*)&arrival,
                  (void*)&error,       (void*)&timeout_ns};
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

// send: (n, n_send_rows, row_bytes) bytes; recv: (n, n_recv_rows,
// row_bytes), zeroed by the caller. dst, sslot, rslot: (n, n_steps) int32,
// row-major; wave_end: n_waves int32 cumulative wave ends; arrival: n
// counters zeroed by the caller in the same stream; error: 3 int32, zero
// unless an earlier launch timed out. All on the device. Returns the
// launch's cudaError_t (0 on success).
extern "C" int aggcomm_dma_steps(const void* send, void* recv, const int* dst,
                                 const int* sslot, const int* rslot,
                                 const int* wave_end, int n, int n_waves,
                                 int n_steps, int n_send_rows,
                                 int n_recv_rows, long long row_bytes,
                                 void* arrival, void* error,
                                 unsigned long long timeout_ns, void* stream,
                                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || n_waves <= 0 || row_bytes <= 0) return 0;
  int cap = 0;
  if ((err = capacity(device, &cap)) != cudaSuccess) return (int)err;
  if (n > cap) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned char* s = static_cast<const unsigned char*>(send);
  unsigned char* r = static_cast<unsigned char*>(recv);
  unsigned* arr = static_cast<unsigned*>(arrival);
  int* e = static_cast<int*>(error);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(send) |
                         reinterpret_cast<uintptr_t>(recv);
  if (row_bytes % 16 == 0 && addr % 16 == 0) {
    return launch<uint4>(s, r, dst, sslot, rslot, wave_end, n, n_waves,
                         n_steps, n_send_rows, n_recv_rows, row_bytes, arr, e,
                         timeout_ns, st);
  }
  if (row_bytes % 4 == 0 && addr % 4 == 0) {
    return launch<unsigned int>(s, r, dst, sslot, rslot, wave_end, n, n_waves,
                                n_steps, n_send_rows, n_recv_rows, row_bytes,
                                arr, e, timeout_ns, st);
  }
  return launch<unsigned char>(s, r, dst, sslot, rslot, wave_end, n, n_waves,
                               n_steps, n_send_rows, n_recv_rows, row_bytes,
                               arr, e, timeout_ns, st);
}
