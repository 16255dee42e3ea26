// Row copies and row zeroing shared by the port's row-moving kernels
// (fused_rep.cu, deliver_rows.cu).
//
// A row is `row_bytes` wide and moves in lane units of type T: 16-byte
// vectors, or 4-byte words or bytes where the row width or an arena's
// address forbids 16 (lane_size). A warp moves a chunk of 32 * kVpt units:
// lane l takes units u0, u0 + 32, ... (neighbouring lanes on neighbouring
// addresses), with every load issued before the first store, so kVpt loads
// are in flight per lane. With kStream the loads take the read-only path
// and the stores are streaming (evict-first): for arenas this launch never
// reads again.
//
// The rows a kernel zeroes enter as runs of contiguous rows: zero_start[z]
// the run's first row, zero_ptr[z] the count of zero rows before it (so
// zero_ptr[n_runs] is the total).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aggcomm {

constexpr int kVpt = 4;  // lane units in flight per lane

// The widest lane unit (16, 4 or 1 bytes) that the row width and both
// arenas' addresses allow.
inline int lane_size(const void* send, const void* recv, long long row_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(send) |
                         reinterpret_cast<uintptr_t>(recv);
  if (row_bytes % 16 == 0 && addr % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && addr % 4 == 0) return 4;
  return 1;
}

template <typename T, bool kStream>
__device__ __forceinline__ T load_unit(const T* p) {
  if constexpr (kStream) {
    return __ldg(p);
  } else {
    return *p;
  }
}

template <typename T, bool kStream>
__device__ __forceinline__ void store_unit(T* p, T v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// One warp's chunk of one row: units u0 + 32 k (k < kVpt) below `units`.
template <typename T, bool kStream>
__device__ __forceinline__ void copy_chunk(const T* s, T* d, unsigned u0,
                                           unsigned units) {
  T v[kVpt];
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    if (u0 + 32 * k < units) v[k] = load_unit<T, kStream>(s + u0 + 32 * k);
  }
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    if (u0 + 32 * k < units) store_unit<T, kStream>(d + u0 + 32 * k, v[k]);
  }
}

// Share zb of nz of every zero row, warp by warp: a warp's task is one
// chunk of one row; flat zero row q maps to the arena through the runs
// (the warp keeps the run of its last row, so a lookup is rare).
template <typename T, bool kStream>
__device__ __forceinline__ void zero_share(unsigned char* recv,
                                           unsigned row_bytes,
                                           const int* zero_start,
                                           const int* zero_ptr, int n_runs,
                                           unsigned zero_rows, unsigned zb,
                                           unsigned nz) {
  const unsigned units = row_bytes / (unsigned)sizeof(T);
  const unsigned cpr = (units + 32 * kVpt - 1) / (32 * kVpt);
  const unsigned lane = threadIdx.x & 31u, warps = blockDim.x >> 5;
  const unsigned tasks = zero_rows * cpr;
  int z = 0;  // the run of the warp's last row
  for (unsigned t = zb * warps + (threadIdx.x >> 5); t < tasks;
       t += nz * warps) {
    const unsigned q = cpr == 1 ? t : t / cpr;
    const unsigned u0 = (t - q * cpr) * 32 * kVpt + lane;
    if (!((unsigned)zero_ptr[z] <= q && q < (unsigned)zero_ptr[z + 1])) {
      int lo = 0, hi = n_runs - 1;  // last run with zero_ptr <= q
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((unsigned)zero_ptr[mid] <= q) lo = mid; else hi = mid - 1;
      }
      z = lo;
    }
    T* d = reinterpret_cast<T*>(
        recv + ((long long)zero_start[z] + (q - zero_ptr[z])) * row_bytes);
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      if (u0 + 32 * k < units) store_unit<T, kStream>(d + u0 + 32 * k, T{});
    }
  }
}

}  // namespace aggcomm
