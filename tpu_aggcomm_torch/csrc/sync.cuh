// Device-side synchronisation primitives shared by the port's kernels.
//
// wait_count: one thread spins with an acquire load on a monotone 32-bit
// counter until it has moved `target` past `base` (unsigned modular
// arithmetic, so a counter that wraps around is harmless). Each wait is
// bounded by %globaltimer from its own first check: a thread that has
// spun past `timeout` in one wait records (who + 1, tag, count - base) in
// the error word and gives up, and every other spinning thread that sees
// the word set gives up too, so a party that never signals cannot wedge
// the card. The wrapper reads the word after its sync and raises.
//
// grid_arrive_wait: a grid-wide barrier between CTAs that are all
// co-resident (the launch is cooperative, or the grid is one thread-block
// cluster), built from one such counter: a CTA arrives with a release
// increment and waits until the counter reaches `target`. The counter is
// 0 at the launch's start (zeroed in the stream before it, or left so by
// the previous launch's grid_depart), so barrier b of a launch waits for
// (b + 1) * (the CTAs that arrive) arrivals.
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

// One thread calls this. Returns true when the wait failed (this thread
// timed out, or the error word was already set). The clock starts at the
// wait's first check (after 1024 spins), so a wait that ends sooner reads
// no timer.
__device__ __forceinline__ bool wait_count(const unsigned* counter,
                                           unsigned base, unsigned target,
                                           int* error, int who, int tag,
                                           unsigned long long timeout) {
  unsigned got;
  unsigned spins = 0;
  unsigned long long start = 0;
  while ((got = load_acquire(counter)) - base < target) {
    if ((++spins & 1023u) != 0) continue;
    if (*reinterpret_cast<volatile int*>(error) != 0) return true;
    const unsigned long long now = global_ns();
    if (start == 0) start = now;
    if (now - start > timeout) {
      if (atomicCAS(error, 0, who + 1) == 0) {
        error[1] = tag;
        error[2] = (int)(got - base);
      }
      return true;
    }
  }
  return false;
}

// The layout of a barrier's scratch: word 0 the arrival counter, words
// 1-3 the error record (cta + 1, tag, arrivals seen), zero unless a spin
// timed out.
struct BarrierWords {
  unsigned* counter;
  int* error;
};

// Every thread of every CTA calls this. Returns true when the barrier
// failed (this CTA or another timed out); the caller then returns.
__device__ __forceinline__ bool grid_arrive_wait(BarrierWords w,
                                                 unsigned target, int tag,
                                                 unsigned long long timeout) {
  __syncthreads();  // the CTA's writes are ordered before thread 0's release
  int failed = 0;
  if (threadIdx.x == 0) {
    red_release_add(w.counter, 1u);  // cumulative: covers the CTA's writes
    failed = wait_count(w.counter, 0u, target, w.error, (int)blockIdx.x, tag,
                        timeout);
  }
  return __syncthreads_or(failed) != 0;
}

// A CTA that took part in a launch's grid_arrive_wait barriers calls this
// once, after its last one: every thread may call it, thread 0 departs.
// `arrivals` is what the counter reaches when every CTA has arrived at
// every barrier and departed; the last CTA to depart puts the counter back
// to 0 (no CTA reads it after departing), so the next launch on the same
// words needs no memset before it. A CTA that gave up at a barrier does
// not depart: the counter then stays where it was, beside the error word.
__device__ __forceinline__ void grid_depart(BarrierWords w,
                                            unsigned arrivals) {
  if (threadIdx.x == 0 && atomicAdd(w.counter, 1u) == arrivals - 1u) {
    atomicExch(w.counter, 0u);
  }
}

// Every thread of a CTA calls this, at the start of a launch that fences
// with grid_arrive_wait on words that outlive it. True in every thread
// when the error word is set: a barrier on these words timed out and the
// record has not been cleared since, so the counter may stand where the
// failed launch left it, and a barrier on it would not wait. The caller
// then returns, writing nothing.
__device__ __forceinline__ bool grid_failed(BarrierWords w) {
  int failed = 0;
  if (threadIdx.x == 0) {
    failed = *reinterpret_cast<volatile int*>(w.error) != 0;
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
