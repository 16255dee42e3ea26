// Device-side synchronisation primitives shared by the port's kernels.
//
// A grid-wide barrier between CTAs that are all co-resident (the launch
// is cooperative, or the grid is one thread-block cluster), built from
// one monotone 32-bit arrival counter: a CTA arrives with a release
// increment and waits with an acquire spin until the counter reaches
// `target`. The counter is zeroed in the stream before the launch, so
// barrier b of a launch waits for (b + 1) * gridDim arrivals. Each wait
// is bounded by %globaltimer: a CTA that has spun past `timeout_ns` in one
// wait records (cta + 1, tag, count) in the error word and gives up, and
// every other spinning CTA that sees the word set gives up too, so a CTA
// that never arrives cannot wedge the card. The wrapper reads the word
// after its sync and raises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aggcomm {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// The layout of a barrier's scratch: word 0 the arrival counter, words
// 1-3 the error record (cta + 1, tag, arrivals seen), zero unless a spin
// timed out.
struct BarrierWords {
  unsigned* counter;
  int* error;
};

// Every thread of every CTA calls this. Returns true when the barrier
// failed (this CTA or another timed out); the caller then returns. The
// clock starts at the wait's first check (after 1024 spins), so a wait
// that ends sooner reads no timer.
__device__ __forceinline__ bool grid_arrive_wait(BarrierWords w,
                                                 unsigned target, int tag,
                                                 unsigned long long timeout) {
  __syncthreads();  // the CTA's writes are ordered before thread 0's release
  int failed = 0;
  if (threadIdx.x == 0) {
    red_release_add(w.counter, 1u);  // cumulative: covers the CTA's writes
    unsigned got;
    unsigned spins = 0;
    unsigned long long start = 0;
    while ((got = load_acquire(w.counter)) < target) {
      if ((++spins & 1023u) != 0) continue;
      if (*reinterpret_cast<volatile int*>(w.error) != 0) {
        failed = 1;
        break;
      }
      const unsigned long long now = global_ns();
      if (start == 0) start = now;
      if (now - start > timeout) {
        if (atomicCAS(w.error, 0, (int)blockIdx.x + 1) == 0) {
          w.error[1] = tag;
          w.error[2] = (int)got;
        }
        failed = 1;
        break;
      }
    }
  }
  return __syncthreads_or(failed) != 0;
}

// The same fence across one thread-block cluster: the hardware barrier,
// release on arrival and acquire on the wait, by every thread.
__device__ __forceinline__ void cluster_arrive_wait() {
  __syncwarp();  // .aligned: the whole warp executes the barrier together
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

}  // namespace aggcomm
