// K2: a whole throttled schedule in one launch, recv zeroing included.
//
// Replaces tpu_aggcomm/native/fuse.py::build_fused_rep (the Pallas
// `kernel` at :379-388, launched at :390, and the XLA zeroing of the recv
// arena before it at :406). For each round of a FusePlan it copies every
// edge row send[src, sslot] -> recv[dst, dslot]; no copy of round k+1
// starts before every copy of round k has landed, so throttle rounds stay
// distinct steps inside the kernel as the -c semantics require (the
// Pallas kernel drained a DMA semaphore per round).
//
// The plan enters as int32 device tables in CSR form: round_ptr[R+1]
// delimits each round's slice of src_row, dst_row[E], the flat send row
// src * S + sslot and the flat recv row dst * (R_slots+1) + dslot of each
// edge. The rows no edge of any round writes (the trash row among them)
// enter as runs of contiguous flat recv rows, zero_start[Z] with prefix
// counts zero_ptr[Z+1]. Rows are exactly `row_bytes` wide (no Mosaic
// padding).
//
// Everything but send, recv and the stream is fixed once the tables are
// built: the host binds it once as a RepBlock, and a rep is then one call
// of aggcomm_fused_rep_bound with those three.
//
// What bounds it on an H100: bytes, E*d read and E*d written by the copies
// plus the never-written rows zeroed once; at the README shape (11 rounds
// of about 41 rows) the chain of round fences, not the bytes. The design:
//
//   - one launch a rep, in two kinds of CTA of 128 threads. The copying
//     CTAs (enough for 4 row tasks each per round) run the rounds; a fence
//     cost grows with the CTAs that arrive, so they are few. The zeroing
//     CTAs after them (128 KB each, at most one per SM) zero the
//     never-written rows with wide stores while the rounds run, and take
//     no part in the fences: zeroed rows and written rows are disjoint, so
//     the zeroing needs no fence and cannot weaken one. A cell written in
//     two rounds keeps the later round's row because the rounds are
//     fenced;
//   - one fence per round among the copying CTAs, after every copy of the
//     round, chosen by shape: the hardware barrier of one thread-block
//     cluster, the copying CTAs being cluster 0, where they fit one
//     cluster (16 CTAs on the H100), else the hand-rolled release/acquire
//     barrier of sync.cuh in a cooperative launch. A round's copies, their
//     reads of `send` included, are issued only after the previous round's
//     fence: nothing of round k+1 is fetched early;
//   - a warp's task is a chunk of one row (rows.cuh, shared with
//     deliver_rows.cu): lanes move neighbouring 16-byte vectors (4-byte
//     words or bytes when width or pointers do not allow 16), four in
//     flight per lane. The table entries of a warp's next
//     round are loaded before the fence (one per lane, shuffled to the
//     warp when the task comes): tables, never data, so a round's copies
//     still start with the send row's load after the fence;
//   - with a stamp buffer (diagnostic calls only; the main path passes
//     null) thread 0 of each CTA writes %globaltimer at its start, after
//     each round's copies, after each fence and at its end.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "sync.cuh"

namespace {

constexpr int kFenceHand = 1;
constexpr int kFenceCluster = 2;
constexpr int kThreads = 128;
using aggcomm::kVpt;                      // vectors in flight per thread
constexpr int kRowsPerCta = 4;            // row tasks a copying CTA takes
constexpr long long kZeroCtaBytes = 128 * 1024;  // per zeroing CTA
constexpr unsigned long long kMaxItems = 1ULL << 31;

struct RepArgs {
  const unsigned char* send;
  unsigned char* recv;
  const int* round_ptr;
  const int* src_row;  // flat send row of each edge: src * S + sslot
  const int* dst_row;  // flat recv row of each edge: dst * (R+1) + dslot
  const int* zero_start;
  const int* zero_ptr;
  int n_rounds;
  int n_zero_runs;
  unsigned zero_rows;
  unsigned row_bytes;
  int copy_ctas;  // CTAs [0, copy_ctas) copy and fence; the rest zero
  aggcomm::BarrierWords sync;
  unsigned long long timeout_ns;
  unsigned long long* stamps;
};

__device__ __forceinline__ void stamp(const RepArgs& a, int slot) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    const int per_cta = 2 + 2 * (a.n_rounds > 1 ? a.n_rounds : 1);
    a.stamps[(long long)blockIdx.x * per_cta + slot] = aggcomm::global_ns();
  }
}

// A warp's task is one chunk of 32 * kVpt units of one row: lane l moves
// units chunk + l, chunk + l + 32, ... (neighbouring lanes on
// neighbouring addresses), kVpt loads in flight before the stores.
template <typename T>
__device__ __forceinline__ unsigned units_of(const RepArgs& a) {
  return a.row_bytes / (unsigned)sizeof(T);
}

template <typename T>
__device__ __forceinline__ unsigned chunks_of(const RepArgs& a) {
  return (units_of<T>(a) + 32 * kVpt - 1) / (32 * kVpt);
}

// The table entries of a warp's first 32 tasks of one round: lane l holds
// task l's flat send and recv rows (-1 past the round's tasks). Loaded
// before the previous round's fence: the plan tables are never written,
// so this fetches no data of the round early.
struct TaskRows {
  int src;
  int dst;
};

template <typename T>
__device__ __forceinline__ TaskRows task_rows(const RepArgs& a, int k) {
  TaskRows p{-1, -1};
  if (k >= a.n_rounds) return p;
  const unsigned cpr = chunks_of<T>(a), warps = blockDim.x >> 5;
  const int e0 = a.round_ptr[k], e1 = a.round_ptr[k + 1];
  const unsigned t = blockIdx.x * warps + (threadIdx.x >> 5) +
                     (threadIdx.x & 31u) * (unsigned)a.copy_ctas * warps;
  if (t < (unsigned)(e1 - e0) * cpr) {
    const int e = e0 + (int)(cpr == 1 ? t : t / cpr);
    p.src = a.src_row[e];
    p.dst = a.dst_row[e];
  }
  return p;
}

// this CTA's tasks of one round's edge rows, warp by warp; `pre` holds
// the rows of the warp's first 32 tasks
template <typename T>
__device__ __forceinline__ void copy_rows(const RepArgs& a, int e0, int e1,
                                          TaskRows pre) {
  const unsigned units = units_of<T>(a), cpr = chunks_of<T>(a);
  const unsigned lane = threadIdx.x & 31u, warps = blockDim.x >> 5;
  const unsigned tasks = (unsigned)(e1 - e0) * cpr;
  const unsigned step = (unsigned)a.copy_ctas * warps;
  unsigned j = 0;  // the warp's task number in this round
  for (unsigned t = blockIdx.x * warps + (threadIdx.x >> 5); t < tasks;
       t += step, ++j) {
    const unsigned r = cpr == 1 ? t : t / cpr;
    const unsigned u0 = (t - r * cpr) * 32 * kVpt + lane;
    int sr, dr;
    if (j < 32) {
      sr = __shfl_sync(0xffffffffu, pre.src, j);
      dr = __shfl_sync(0xffffffffu, pre.dst, j);
    } else {
      sr = a.src_row[e0 + r];
      dr = a.dst_row[e0 + r];
    }
    aggcomm::copy_chunk<T, false>(
        reinterpret_cast<const T*>(a.send + (long long)sr * a.row_bytes),
        reinterpret_cast<T*>(a.recv + (long long)dr * a.row_bytes), u0,
        units);
  }
}

template <typename T, int FENCE>
__global__ void fused_rep_kernel(RepArgs a) {
  stamp(a, 0);
  const int P = a.n_rounds > 1 ? a.n_rounds : 1;
  if ((int)blockIdx.x >= a.copy_ctas) {  // a zeroing CTA: no fence to keep
    aggcomm::zero_share<T, false>(a.recv, a.row_bytes, a.zero_start,
                                  a.zero_ptr, a.n_zero_runs, a.zero_rows,
                                  blockIdx.x - a.copy_ctas,
                                  gridDim.x - a.copy_ctas);
    stamp(a, 1 + 2 * P);
    return;
  }
  TaskRows pre = task_rows<T>(a, 0);
  for (int k = 0; k < a.n_rounds; ++k) {
    copy_rows<T>(a, a.round_ptr[k], a.round_ptr[k + 1], pre);
    pre = task_rows<T>(a, k + 1);  // the next round's table entries
    if (a.stamps != nullptr) {
      __syncthreads();
      stamp(a, 1 + 2 * k);
    }
    if (k + 1 < a.n_rounds) {  // the round fence, among the copying CTAs
      if (FENCE == kFenceCluster) {
        aggcomm::cluster_arrive_wait();
      } else if (aggcomm::grid_arrive_wait(
                     a.sync, (unsigned)(k + 1) * (unsigned)a.copy_ctas, k,
                     a.timeout_ns)) {
        return;
      }
    }
    stamp(a, 2 + 2 * k);
  }
  stamp(a, 1 + 2 * P);
}

using aggcomm::lane_size;

template <int FENCE>
const void* pick(int size) {
  if (size == 16) return (const void*)fused_rep_kernel<uint4, FENCE>;
  if (size == 4) return (const void*)fused_rep_kernel<unsigned int, FENCE>;
  return (const void*)fused_rep_kernel<unsigned char, FENCE>;
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

// The largest one-cluster grid of this instantiation: 16 CTAs where the
// card schedules such a cluster, else the portable 8. Once per kernel.
cudaError_t cluster_cap(const void* fn, int* out) {
  static const void* fns[32];
  static int caps[32];
  static int used = 0;
  for (int i = 0; i < used; ++i) {
    if (fns[i] == fn) {
      *out = caps[i];
      return cudaSuccess;
    }
  }
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a fault
    clusters = 0;
  }
  *out = clusters >= 1 ? 16 : 8;
  if (used < 32) {
    fns[used] = fn;
    caps[used++] = *out;
  }
  return cudaSuccess;
}

// How many CTAs of this instantiation one SM holds (the cooperative
// launch's cap). Once per kernel.
cudaError_t blocks_per_sm(const void* fn, int* out) {
  static const void* fns[32];
  static int counts[32];
  static int used = 0;
  for (int i = 0; i < used; ++i) {
    if (fns[i] == fn) {
      *out = counts[i];
      return cudaSuccess;
    }
  }
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (used < 32) {
    fns[used] = fn;
    counts[used++] = *out;
  }
  return cudaSuccess;
}

struct Plan {
  const void* fn;
  int grid;
  int copy_ctas;
  int fence;
};

// The launch for these arguments: lane width, fence, the copying CTAs
// (kRowsPerCta row tasks each per round; a task is a chunk of 32 * kVpt
// units) and the zeroing CTAs after them (kZeroCtaBytes each, at most one
// per SM). The fence is the cluster barrier where the copying CTAs fit
// one cluster, else the hand-rolled one. With the cluster fence the
// copying CTAs are cluster 0 and the zeroing CTAs fill further clusters
// of the same size; otherwise the whole grid is co-resident (a
// cooperative launch).
cudaError_t make_plan(const void* send, const void* recv, long long row_bytes,
                      int max_round_edges, long long zero_rows, int device,
                      Plan* p) {
  const int size = lane_size(send, recv, row_bytes);
  const unsigned long long units = row_bytes / size;
  if ((unsigned long long)max_round_edges * units >= kMaxItems ||
      (unsigned long long)zero_rows * units >= kMaxItems)
    return cudaErrorInvalidValue;
  const long long tasks = (long long)max_round_edges *
                          (long long)((units + 32 * kVpt - 1) / (32 * kVpt));
  long long copy = (tasks + kRowsPerCta - 1) / kRowsPerCta;
  if (copy < 1) copy = 1;
  long long zero = 0;
  if (zero_rows > 0) {
    zero = (zero_rows * row_bytes + kZeroCtaBytes - 1) / kZeroCtaBytes;
  }
  int sms = 0, per_sm = 0, ccap = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  // at most one zeroing CTA per SM: more saturate HBM with zero stores and
  // stretch the latency-bound round chain that runs beside them
  if (zero > sms) zero = sms;
  err = cluster_cap(pick<kFenceCluster>(size), &ccap);
  if (err != cudaSuccess) return err;
  if (copy <= ccap) {
    p->fence = kFenceCluster;
    p->fn = pick<kFenceCluster>(size);
    zero = (zero + copy - 1) / copy * copy;  // whole clusters
  } else {
    p->fence = kFenceHand;
    p->fn = pick<kFenceHand>(size);
    err = blocks_per_sm(p->fn, &per_sm);
    if (err != cudaSuccess) return err;
    const long long cap = (long long)per_sm * sms;
    if (cap < (zero > 0 ? 2 : 1)) return cudaErrorCooperativeLaunchTooLarge;
    if (copy > cap - (zero > 0 ? 1 : 0)) copy = cap - (zero > 0 ? 1 : 0);
    if (zero > cap - copy) zero = cap - copy;
  }
  p->copy_ctas = (int)copy;
  p->grid = (int)(copy + zero);
  return cudaSuccess;
}

// What stays fixed for one plan's tables, from their build on: the
// tables' device pointers, their counts, the row width and the fence's
// record and timeout. native/fuse.py's RepBlock mirrors it field for
// field.
struct RepBlock {
  const int* round_ptr;
  const int* src_row;
  const int* dst_row;
  const int* zero_start;
  const int* zero_ptr;
  void* sync;
  unsigned long long timeout_ns;
  long long zero_rows;
  long long row_bytes;
  int n_rounds;
  int n_zero_runs;
  int max_round_edges;
  int device;
};

// The device the calling thread runs on made `device`; cudaSetDevice only
// when it is another.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// One rep of the block's tables from send into recv on stream.
int launch_rep(const RepBlock& b, const void* send, void* recv, void* stamps,
               void* stream) {
  cudaError_t err = use_device(b.device);
  if (err != cudaSuccess) return (int)err;
  const long long zero_rows = b.n_zero_runs > 0 ? b.zero_rows : 0;
  if (b.row_bytes <= 0 || (b.n_rounds <= 0 && zero_rows <= 0)) return 0;
  Plan p;
  err = make_plan(send, recv, b.row_bytes, b.max_round_edges, zero_rows,
                  b.device, &p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.fence == kFenceHand && b.n_rounds > 1) {
    err = cudaMemsetAsync(b.sync, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
  }
  RepArgs a;
  a.send = static_cast<const unsigned char*>(send);
  a.recv = static_cast<unsigned char*>(recv);
  a.round_ptr = b.round_ptr;
  a.src_row = b.src_row;
  a.dst_row = b.dst_row;
  a.zero_start = b.zero_start;
  a.zero_ptr = b.zero_ptr;
  a.n_rounds = b.n_rounds;
  a.n_zero_runs = b.n_zero_runs;
  a.zero_rows = (unsigned)zero_rows;
  a.row_bytes = (unsigned)b.row_bytes;
  a.copy_ctas = p.copy_ctas;
  a.sync.counter = static_cast<unsigned*>(b.sync);
  a.sync.error = static_cast<int*>(b.sync) + 1;
  a.timeout_ns = b.timeout_ns;
  a.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {(void*)&a};
  if (p.fence == kFenceCluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.copy_ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.grid);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, p.fn, args);
  } else {
    err = cudaLaunchCooperativeKernel(p.fn, dim3(p.grid), dim3(kThreads),
                                      args, 0, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One rep. send: (n, S, row_bytes) bytes; recv: (n, R+1, row_bytes), any
// contents: every row no edge writes is in the zero runs and is zeroed
// here. round_ptr: n_rounds+1 int32; src_row, dst_row: E int32 flat rows;
// zero_start: Z int32 flat rows; zero_ptr: Z+1 int32 prefix row counts;
// all on the device. max_round_edges: the largest round's edge count.
// sync: 4 int32 (the hand-rolled fence's counter, zeroed here in the
// stream, and its error record). stamps: null, or (grid, 2 + 2 *
// max(n_rounds, 1)) uint64. Returns the launch's cudaError_t (0 on
// success).
extern "C" int aggcomm_fused_rep(
    const void* send, void* recv, const int* round_ptr, const int* src_row,
    const int* dst_row, const int* zero_start, const int* zero_ptr,
    int n_rounds, int n_zero_runs, long long zero_rows, long long row_bytes,
    int max_round_edges, void* sync, unsigned long long timeout_ns,
    void* stamps, void* stream, int device) {
  RepBlock b;
  b.round_ptr = round_ptr;
  b.src_row = src_row;
  b.dst_row = dst_row;
  b.zero_start = zero_start;
  b.zero_ptr = zero_ptr;
  b.sync = sync;
  b.timeout_ns = timeout_ns;
  b.zero_rows = zero_rows;
  b.row_bytes = row_bytes;
  b.n_rounds = n_rounds;
  b.n_zero_runs = n_zero_runs;
  b.max_round_edges = max_round_edges;
  b.device = device;
  return launch_rep(b, send, recv, stamps, stream);
}

// One rep, as aggcomm_fused_rep, of the tables a RepBlock binds: send and
// recv as there, no stamps. Returns a cudaError_t.
extern "C" int aggcomm_fused_rep_bound(const void* block, const void* send,
                                       void* recv, void* stream) {
  return launch_rep(*static_cast<const RepBlock*>(block), send, recv,
                    nullptr, stream);
}

// What aggcomm_fused_rep would launch for these arguments, into out[4]:
// grid, copying CTAs, fence (1 hand-rolled, 2 cluster), lane width in
// bytes. Returns a cudaError_t.
extern "C" int aggcomm_fused_rep_plan(const void* send, const void* recv,
                                      long long row_bytes,
                                      int max_round_edges, long long zero_rows,
                                      int device, int* out) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  err = make_plan(send, recv, row_bytes, max_round_edges, zero_rows, device,
                  &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.copy_ctas;
  out[2] = p.fence;
  out[3] = lane_size(send, recv, row_bytes);
  return 0;
}
