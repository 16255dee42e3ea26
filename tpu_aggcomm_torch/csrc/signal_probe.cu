// Signal-latency probe: how long one release -> acquire signal takes to
// cross from one SM to another on this card, measured apart from any
// kernel of the port.
//
// Two CTAs, each asking for more than half an SM's shared memory so that
// no SM can hold both, ping-pong two counters `iters` times with one
// thread each: CTA 0 adds to CTA 1's counter with red.release.gpu and
// waits with ld.acquire.gpu on its own until CTA 1 has answered, CTA 1
// answers each signal it sees. A round trip is two one-way signals, so
// the one-way latency is the span CTA 0 stamps with %globaltimer over
// 2 * iters. The counters sit 128 bytes apart; each wait is bounded
// (sync.cuh wait_count) so a probe that cannot finish returns.
//
// This is the floor of K3's wave chain: a wave cannot end sooner than one
// such signal after the wave before it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

namespace {

constexpr int kCounterStride = 32;  // 128 bytes between the two counters
constexpr int kSharedBytes = 128 * 1024;  // > half of an SM's 228 KB

__global__ void signal_probe_kernel(unsigned* counters, int iters,
                                    long long* out, int* error,
                                    unsigned long long timeout_ns) {
  extern __shared__ unsigned char reserve[];  // one CTA per SM
  if (threadIdx.x != 0) return;
  const int me = blockIdx.x;
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  out[1 + me] = smid;
  reserve[0] = 0;
  unsigned* mine = counters + me * kCounterStride;
  unsigned* other = counters + (1 - me) * kCounterStride;
  const unsigned long long t0 = aggcomm::global_ns();
  for (int i = 0; i < iters; ++i) {
    if (me == 0) aggcomm::red_release_add(other, 1u);
    if (aggcomm::wait_count(mine, 0u, (unsigned)i + 1, error, me, i,
                            timeout_ns))
      return;
    if (me == 1) aggcomm::red_release_add(other, 1u);
  }
  if (me == 0) out[0] = (long long)(aggcomm::global_ns() - t0);
}

}  // namespace

// counters: 2 * 32 uint32, zeroed by the caller in the stream; out: 3
// int64 (span of CTA 0 in ns, the SM of CTA 0, the SM of CTA 1); error: 3
// int32, zero. All on the device. Returns the launch's cudaError_t.
extern "C" int aggcomm_signal_probe(void* counters, int iters, void* out,
                                    void* error,
                                    unsigned long long timeout_ns,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)signal_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  unsigned* c = static_cast<unsigned*>(counters);
  long long* o = static_cast<long long*>(out);
  int* e = static_cast<int*>(error);
  void* args[] = {(void*)&c, (void*)&iters, (void*)&o, (void*)&e,
                  (void*)&timeout_ns};
  err = cudaLaunchCooperativeKernel((const void*)signal_probe_kernel, dim3(2),
                                    dim3(32), args, kSharedBytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
