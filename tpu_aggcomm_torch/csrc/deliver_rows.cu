// Row delivery: one single-device round of torch_shard in one launch, the
// receive arena's zero fill folded into the rep's first round.
//
// Replaces the single-device round of tpu_aggcomm/backends/jax_shard.py
// (_apply_block_round with single_dev=True: recv.at[scat].set(send[pack]),
// one XLA gather-scatter fusion), which the port had run as three ATen
// kernels: a zero fill of the whole receive arena, a gather of every send
// row into a temporary as large as the payload, and an index_put_ of that
// temporary in 4-byte elements. Here, for every table entry i, send row
// src_row[i] is copied to receive row dst_row[i], `row_bytes` wide, and
// every receive row is written once. The rows the caller lists as zero
// runs (zero_start[Z] with prefix counts zero_ptr[Z+1]: the rows no entry
// of the rep's rounds writes) are zeroed by CTAs after the copying ones,
// in the same launch: zeroed and copied rows are disjoint, so nothing
// orders them. One launch is one round; the stream orders the rounds,
// which are never merged, and no CTA waits on another CTA of its grid.
//
// What bounds it on an H100: bytes. n_rows * row_bytes read and as many
// written, plus the zeroed rows written: at the Theta flagship (4.19M rows
// of 2048 bytes) 17.2 GB, 5.128 ms at 3.35 TB/s. The design:
//
//   - a warp's task is a tile of 32 * kVpt lane units (rows.cuh: 16-byte
//     vectors, or 4-byte words or bytes where the row width or an arena's
//     address forbids 16). A row at least a tile wide is cut into chunks,
//     a task each, copied by rows.cuh's copy_chunk (K2's copy); narrower
//     rows go whole, as many to a tile as fit. Every lane has kVpt loads in
//     flight, issued before its stores; `send` is read through the
//     read-only path and `recv` written with streaming stores, as neither
//     is read again by this launch;
//   - a persistent grid of copying CTAs, as many as the card keeps
//     resident, strides over the tiles. A warp loads the table entries of
//     its next 32 chunk tasks at once, a lane each, and shuffles them to
//     the warp task by task, so a table read does not precede every copy;
//   - the zeroing CTAs come after the copying CTAs, 128 KB each and at
//     most one per SM (rows.cuh's zero_share, with streaming stores);
//   - each launch is a programmatic dependent launch: it may start while
//     the stream's previous kernel drains, and each CTA first waits, with
//     griddepcontrol.wait, until that kernel has completed and its writes
//     are visible, so a round still starts after the previous round ends.
//     What it saves is the gap between back-to-back launches, about 1-2 us
//     a round (256 rounds at the Theta script's -c 64);
//   - byte offsets are 64-bit (a Theta arena is 8.59 GB, which ATen split
//     into 16 launches to keep 32-bit indexing); rows, table entries and
//     task counts stay below 2^31, checked here and by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using aggcomm::kVpt;
constexpr int kThreads = 256;
constexpr unsigned kTile = 32 * kVpt;            // lane units a task moves
constexpr long long kZeroCtaBytes = 128 * 1024;  // per zeroing CTA
constexpr unsigned long long kMaxItems = 1ULL << 31;

struct DeliverArgs {
  const unsigned char* send;
  unsigned char* recv;
  const int* src_row;
  const int* dst_row;
  const int* zero_start;
  const int* zero_ptr;
  unsigned n_rows;
  int n_zero_runs;
  unsigned zero_rows;
  unsigned row_bytes;
  unsigned copy_ctas;  // CTAs [0, copy_ctas) copy; the rest zero
};

// Rows of at least a tile: a task is one chunk of one row (cpr chunks a
// row). Lane l holds the table entries of the warp's task base + l * step.
template <typename T>
__device__ __forceinline__ void copy_wide(const DeliverArgs& a, unsigned w0,
                                          unsigned step, unsigned units) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned cpr = (units + kTile - 1) / kTile;
  const unsigned tasks = a.n_rows * cpr;
  for (unsigned base = w0; base < tasks; base += 32 * step) {
    const unsigned mine = base + lane * step;
    int sr = 0, dr = 0;
    if (mine < tasks) {
      const unsigned e = cpr == 1 ? mine : mine / cpr;
      sr = __ldg(a.src_row + e);
      dr = __ldg(a.dst_row + e);
    }
    const unsigned left = (tasks - base + step - 1) / step;
    const unsigned n = left < 32u ? left : 32u;
    for (unsigned j = 0; j < n; ++j) {
      const unsigned t = base + j * step;
      const unsigned e = cpr == 1 ? t : t / cpr;
      const int s = __shfl_sync(0xffffffffu, sr, j);
      const int d = __shfl_sync(0xffffffffu, dr, j);
      aggcomm::copy_chunk<T, true>(
          reinterpret_cast<const T*>(a.send + (long long)s * a.row_bytes),
          reinterpret_cast<T*>(a.recv + (long long)d * a.row_bytes),
          (t - e * cpr) * kTile + lane, units);
    }
  }
}

// Rows narrower than a tile: a task is `per` whole rows, lane l's k-th
// unit the tile's unit l + 32 k, in row (l + 32 k) / units.
template <typename T>
__device__ __forceinline__ void copy_narrow(const DeliverArgs& a, unsigned w0,
                                            unsigned step, unsigned units) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned per = kTile / units;
  const unsigned tasks = (a.n_rows + per - 1) / per;
  unsigned row[kVpt], unit[kVpt];
#pragma unroll
  for (int k = 0; k < kVpt; ++k) {
    row[k] = (lane + 32 * k) / units;
    unit[k] = lane + 32 * k - row[k] * units;
  }
  for (unsigned t = w0; t < tasks; t += step) {
    T v[kVpt];
    long long at[kVpt];
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      const unsigned e = t * per + row[k];
      at[k] = -1;
      if (row[k] < per && e < a.n_rows) {
        const long long s = __ldg(a.src_row + e);
        at[k] = (long long)__ldg(a.dst_row + e) * units + unit[k];
        v[k] = __ldg(reinterpret_cast<const T*>(a.send) + s * units +
                     unit[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      if (at[k] >= 0) __stcs(reinterpret_cast<T*>(a.recv) + at[k], v[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) deliver_rows_kernel(DeliverArgs a) {
  // launched as a programmatic dependent of the stream's previous kernel:
  // nothing is read or written before that kernel has completed and its
  // writes are visible; then the stream's next such launch may start
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (blockIdx.x >= a.copy_ctas) {
    aggcomm::zero_share<T, true>(a.recv, a.row_bytes, a.zero_start,
                                 a.zero_ptr, a.n_zero_runs, a.zero_rows,
                                 blockIdx.x - a.copy_ctas,
                                 gridDim.x - a.copy_ctas);
    return;
  }
  const unsigned warps = kThreads / 32;
  const unsigned w0 = blockIdx.x * warps + (threadIdx.x >> 5);
  const unsigned step = a.copy_ctas * warps;
  const unsigned units = a.row_bytes / (unsigned)sizeof(T);
  if (units >= kTile) {
    copy_wide<T>(a, w0, step, units);
  } else {
    copy_narrow<T>(a, w0, step, units);
  }
}

const void* pick(int size) {
  if (size == 16) return (const void*)deliver_rows_kernel<uint4>;
  if (size == 4) return (const void*)deliver_rows_kernel<unsigned int>;
  return (const void*)deliver_rows_kernel<unsigned char>;
}

// SMs and resident CTAs per SM of each instantiation, asked once.
cudaError_t residency(const void* fn, int device, int* sms, int* per_sm) {
  static int n_sms = 0;
  static const void* fns[3];
  static int fits[3];
  static int used = 0;
  if (n_sms == 0) {
    cudaError_t err = cudaDeviceGetAttribute(
        &n_sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = n_sms;
  for (int i = 0; i < used; ++i) {
    if (fns[i] == fn) {
      *per_sm = fits[i];
      return cudaSuccess;
    }
  }
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (used < 3) {
    fns[used] = fn;
    fits[used++] = *per_sm;
  }
  return cudaSuccess;
}

struct Plan {
  const void* fn;
  int lane;
  int grid;
  int copy_ctas;
};

// The launch for these arguments: lane width, the copying CTAs (enough
// for the tasks, at most what the card keeps resident) and the zeroing
// CTAs after them.
cudaError_t make_plan(const void* send, const void* recv, long long row_bytes,
                      long long n_rows, long long zero_rows, int device,
                      Plan* p) {
  if (row_bytes <= 0 || row_bytes >= (long long)kMaxItems || n_rows < 0 ||
      zero_rows < 0)
    return cudaErrorInvalidValue;
  p->lane = aggcomm::lane_size(send, recv, row_bytes);
  p->fn = pick(p->lane);
  const unsigned long long units = row_bytes / p->lane;
  const unsigned long long cpr = (units + kTile - 1) / kTile;
  const unsigned long long tasks =
      units >= kTile ? n_rows * cpr : (n_rows + kTile / units - 1) /
                                          (kTile / units);
  if ((unsigned long long)n_rows >= kMaxItems || n_rows * cpr >= kMaxItems ||
      (unsigned long long)zero_rows * cpr >= kMaxItems)
    return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = residency(p->fn, device, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const unsigned long long warps = kThreads / 32;
  unsigned long long copy = (tasks + warps - 1) / warps;
  const unsigned long long cap = (unsigned long long)per_sm * sms;
  if (copy > cap) copy = cap;
  long long zero = 0;
  if (zero_rows > 0) {
    zero = (zero_rows * row_bytes + kZeroCtaBytes - 1) / kZeroCtaBytes;
    if (zero > sms) zero = sms;
  }
  p->copy_ctas = (int)copy;
  p->grid = (int)(copy + zero);
  return cudaSuccess;
}

}  // namespace

// One round. send: (Fs, row_bytes) bytes; recv: (F, row_bytes), any
// contents in the rows this launch neither copies to nor zeroes.
// src_row, dst_row: n_rows int32 rows, on the device; zero_start: Z int32
// rows and zero_ptr: Z+1 int32 prefix row counts (null with Z = 0). No
// launch when there is nothing to copy or zero. Returns the launch's
// cudaError_t (0 on success).
extern "C" int aggcomm_deliver_rows(const void* send, void* recv,
                                    const int* src_row, const int* dst_row,
                                    long long n_rows, const int* zero_start,
                                    const int* zero_ptr, int n_zero_runs,
                                    long long zero_rows, long long row_bytes,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_zero_runs <= 0) zero_rows = 0;
  if (n_rows <= 0 && zero_rows <= 0) return 0;
  Plan p;
  err = make_plan(send, recv, row_bytes, n_rows, zero_rows, device, &p);
  if (err != cudaSuccess) return (int)err;
  DeliverArgs a;
  a.send = static_cast<const unsigned char*>(send);
  a.recv = static_cast<unsigned char*>(recv);
  a.src_row = src_row;
  a.dst_row = dst_row;
  a.zero_start = zero_start;
  a.zero_ptr = zero_ptr;
  a.n_rows = (unsigned)n_rows;
  a.n_zero_runs = n_zero_runs;
  a.zero_rows = (unsigned)zero_rows;
  a.row_bytes = (unsigned)row_bytes;
  a.copy_ctas = (unsigned)p.copy_ctas;
  void* args[] = {(void*)&a};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, p.fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
