// Slow-rank delay of a fault-injected rep (kernel "slow_delay").
//
// Replaces the delay loop of tpu_aggcomm/backends/jax_sim.py:435
// (JaxSimBackend._one_rep_faulted.add_slow): an XLA lax.fori_loop, not a
// Pallas kernel. For each slow rank r, with iters[k] iterations and
// row = send[r, 0] read as int32 lanes (or bytes when d % 4 != 0):
//
//   acc = sum_{i < iters} sum_j floor_mod(row_j + i, 251)
//   recv[r, 0, 0] += parity(acc) * parity(acc + 1)
//
// row_j + i and acc wrap as int32, so both are computed in uint32 (signed
// overflow is undefined in C++) and reinterpreted; CUDA's % truncates
// toward zero, so the floor modulo adds 251 to a negative remainder. The
// product of the two parities is always 0, but the read-modify-write of
// recv[r, 0, 0] is real, and acc is returned per slow rank so a test can
// hold it (the bytes cannot: the delta is 0).
//
// What bounds it: latency, not bytes or operations. The reference's loop
// runs its iterations one after another on the TPU's core, and so does
// this kernel: one CTA per slow rank runs its iterations in order, each a
// block reduction of the row, so a slow rank costs iters x one block
// reduction. The slow ranks' CTAs run side by side on the card, where the
// TPU ran the ranks' loops in turn; that changes the time, not the bytes.
// One launch covers every slow rank of the rep.

#include <cuda_runtime.h>

namespace {

constexpr int kMod = 251;

__device__ __forceinline__ unsigned floor_mod(unsigned bits) {
  int s = static_cast<int>(bits);
  int m = s % kMod;
  return static_cast<unsigned>(m < 0 ? m + kMod : m);
}

// One CTA per slow rank: blockIdx.x indexes ranks[] and iters[].
template <typename Lane>
__global__ void slow_delay_kernel(const Lane* __restrict__ send,
                                  Lane* __restrict__ recv,
                                  const int* __restrict__ ranks,
                                  const int* __restrict__ iters,
                                  long long send_stride,
                                  long long recv_stride, int lanes,
                                  int* __restrict__ acc_out) {
  __shared__ unsigned warp_sums[32];
  const int k = blockIdx.x;
  const long long r = ranks[k];
  const int n_iters = iters[k];
  const Lane* row = send + r * send_stride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned acc = 0;  // held by thread 0
  for (int i = 0; i < n_iters; ++i) {
    unsigned part = 0;
    for (int j = threadIdx.x; j < lanes; j += blockDim.x) {
      // a lane's int32 bits (an int32 lane, or a byte widened) plus i
      const unsigned v = static_cast<unsigned>(static_cast<int>(row[j]));
      part += floor_mod(v + static_cast<unsigned>(i));
    }
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) warp_sums[warp] = part;
    __syncthreads();
    if (warp == 0) {
      unsigned s = lane < n_warps ? warp_sums[lane] : 0u;
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) acc += s;
    }
    __syncthreads();  // warp_sums is rewritten by the next iteration
  }
  if (threadIdx.x == 0) {
    const unsigned delta = (acc & 1u) * ((acc + 1u) & 1u);
    Lane* cell = recv + r * recv_stride;
    *cell = static_cast<Lane>(static_cast<unsigned>(*cell) + delta);
    acc_out[k] = static_cast<int>(acc);
  }
}

}  // namespace

// send: (n, S, lanes) lanes, row r slot 0 at send + r * send_stride;
// recv: (n, F + 1, lanes), cell (r, 0, 0) at recv + r * recv_stride;
// lane_bytes 4 (int32 lanes) or 1 (bytes). Returns a cudaError_t.
extern "C" int aggcomm_slow_delay(const void* send, void* recv,
                                  const int* ranks, const int* iters,
                                  int n_slow, long long send_stride,
                                  long long recv_stride, int lanes,
                                  int lane_bytes, int* acc_out,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slow <= 0) return 0;
  if (lanes <= 0 || (lane_bytes != 4 && lane_bytes != 1))
    return (int)cudaErrorInvalidValue;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lane_bytes == 4) {
    slow_delay_kernel<int><<<n_slow, threads, 0, st>>>(
        static_cast<const int*>(send), static_cast<int*>(recv), ranks, iters,
        send_stride, recv_stride, lanes, acc_out);
  } else {
    slow_delay_kernel<unsigned char><<<n_slow, threads, 0, st>>>(
        static_cast<const unsigned char*>(send),
        static_cast<unsigned char*>(recv), ranks, iters, send_stride,
        recv_stride, lanes, acc_out);
  }
  return (int)cudaGetLastError();
}
