// Row delivery: torch_shard's rounds on one device, the receive arena's
// zero fill folded into the rep's first launch.
//
// Replaces the single-device round of tpu_aggcomm/backends/jax_shard.py
// (_apply_block_round with single_dev=True: recv.at[scat].set(send[pack]),
// one XLA gather-scatter fusion), which the port had run as three ATen
// kernels: a zero fill of the whole receive arena, a gather of every send
// row into a temporary as large as the payload, and an index_put_ of that
// temporary in 4-byte elements. Here, for every table entry i of a round,
// send row src_row[i] is copied to receive row dst_row[i], `row_bytes`
// wide, and every receive row a round writes is written once. The rows
// the caller lists as zero runs (zero_start[Z] with prefix counts
// zero_ptr[Z+1]: the rows no entry of the rep's rounds writes) are zeroed
// by CTAs after the copying ones, in the same launch: zeroed and copied
// rows are disjoint, so nothing orders them.
//
// Two entries, one copy of a chunk (rows.cuh's copy_chunk):
//
//   - aggcomm_deliver_rows: one round, one launch. A rep of one round, or
//     of rounds with barrier tokens between them, issues one a round; the
//     stream orders the rounds, and no CTA waits on another CTA of its
//     grid. Its launch takes one of two grids, the persistent grid or
//     the wide-row engine's, by the rule below; aggcomm_deliver_rows_on
//     names one, for readings of the two side by side;
//   - aggcomm_deliver_rounds: a rep of many rounds in one cooperative
//     launch, its rounds in CSR form (round_ptr[R+1] over concatenated
//     src_row and dst_row). The rounds stay distinct steps: after each
//     round every copying CTA passes a grid-wide fence (sync.cuh's
//     release/acquire counter, with its timeout and error word), and no
//     load or store of round k+1's rows issues before every store of
//     round k, by every CTA, has been released and acquired. Only round
//     k+1's table entries are read before the fence (tables are never
//     written); no byte of `send` is fetched early. A row written in two
//     rounds keeps the later round's bytes, as the stream order gives.
//     A CTA that times out at a fence leaves the counter where it stood
//     and sets the error word; until the wrapper clears the word, every
//     later launch on the same words finds it set at its start and writes
//     nothing, so a rep fails visibly and never runs unfenced.
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
//   - a persistent grid of copying CTAs, at most as many as the card keeps
//     resident, strides over a round's tiles. A warp loads the table
//     entries of its next 32 chunk tasks at once, a lane each, and
//     shuffles them to the warp task by task, so a table read does not
//     precede every copy; in the many-round kernel a warp loads the next
//     round's first 32 before the fence;
//   - the zeroing CTAs come after the copying CTAs, 128 KB each and at
//     most one per SM (rows.cuh's zero_share, with streaming stores); in
//     the many-round kernel they take no part in the fences;
//   - a one-round launch is a programmatic dependent launch: it may start
//     while the stream's previous kernel drains, and each CTA first waits,
//     with griddepcontrol.wait, until that kernel has completed and its
//     writes are visible;
//   - the many-round kernel's fence costs more the more CTAs poll it (on
//     an H100 at the Theta -c 64 rounds: 1.4 us at 528 CTAs, 2.1 at 660,
//     4.4 at 1056), and wider CTAs copy no faster, so its copying CTAs are
//     kRoundThreads threads, at most kRoundCtasPerSm an SM. A round's
//     tasks are split over the warps as in the one-round kernel, a fixed
//     split (tasks claimed from a counter cost more than the tail they
//     would save). The last CTA to leave puts the fence's counter
//     back to 0, so a launch needs no memset before it and a CUDA graph
//     of it replays as it is;
//   - a one-round launch of rows at least kWideRowBytes wide in 16-byte
//     lanes takes the wide-row engine instead: the same kernel on a grid
//     of a warp for every chunk, uncapped, so each warp copies ONE chunk
//     and exits, the block scheduler hands chunks out in table order, and
//     the rows in flight stay one window of the arenas wide. On an H100
//     at the Theta pass (4,194,304 rows of 2048 bytes, CUDA events over
//     10 launches) it moves a pass in 5.812-5.815 ms on the Theta tables
//     and 5.679-5.684 ms on identity tables, 0.882 and 0.902 of 3.35
//     TB/s, against 5.973-6.001 ms (0.855-0.859) for the persistent grid
//     on either, whose warps drift apart over a pass; ATen's contiguous
//     copy of the same bytes takes 5.645-5.647 ms (0.908). On this grid,
//     read-only or plain loads, streaming or plain stores, two chunks a
//     warp and CTAs of 64 to 1024 threads read within 0.6% of each other;
//     on the persistent grid two or four chunks in flight a warp gained
//     1.1-1.3% and L2 evict-first hints lost 0.7%. Rows move through
//     registers: a ring of whole rows in shared memory filled and drained
//     by bulk asynchronous copies (cp.async.bulk) read 0.87 at best,
//     since each issuing thread's copies complete one after another (26.6
//     ms a pass with one ring an SM, 5.90 ms with sixteen). No row count
//     enters the rule: a launch whose tasks fit in the resident warps gets
//     the same grid either way, and on the first n rows of the Theta
//     tables, back to back, the persistent and the wide-row grid read 22.5
//     and 22.7 us at 4,096 rows and 24.8 and 24.9 at 16,384 (a launch's
//     latency), then 50.4 and 48.2 at 32,768, 97.2 and 93.3 at 65,536,
//     376.4 and 365.4 at 262,144. The rule reads the lane width and the
//     row width alone, and backends/deliver_rows.py's wide_engine is the
//     same rule;
//   - with a stamp buffer (diagnostic calls only; the main path passes
//     null) thread 0 of each CTA of the many-round kernel writes
//     %globaltimer at its start, after each round's copies, after each
//     fence and at its end, as K2's;
//   - byte offsets are 64-bit (a Theta arena is 8.59 GB, which ATen split
//     into 16 launches to keep 32-bit indexing); rows, table entries and
//     task counts stay below 2^31, checked here and by the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"
#include "sync.cuh"

namespace {

using aggcomm::kVpt;
constexpr int kThreads = 256;
constexpr int kRoundThreads = 256;   // the many-round kernel's CTA
constexpr int kRoundCtasPerSm = 4;   // its launch bound, and its cap
constexpr unsigned kTile = 32 * kVpt;            // lane units a task moves
constexpr long long kZeroCtaBytes = 128 * 1024;  // per zeroing CTA
constexpr unsigned long long kMaxItems = 1ULL << 31;
constexpr long long kWideRowBytes = 2048;  // the wide-row engine's least
// which grid a one-round launch takes: by the rule, or as named
constexpr int kByRule = -1, kPersistent = 0, kWide = 1;

// One round's rows: send row src_row[i] -> receive row dst_row[i].
struct Rows {
  const unsigned char* send;
  unsigned char* recv;
  const int* src_row;
  const int* dst_row;
  unsigned n_rows;
  unsigned row_bytes;
};

struct DeliverArgs {
  Rows rows;
  const int* zero_start;
  const int* zero_ptr;
  int n_zero_runs;
  unsigned zero_rows;
  unsigned copy_ctas;  // CTAs [0, copy_ctas) copy; the rest zero
};

// The table entries of a warp's 32 tasks from task `base` (rows of at
// least a tile, cpr chunks a row): lane l holds task base + l * step's.
struct Lead {
  int src;
  int dst;
};

__device__ __forceinline__ Lead lead_of(const Rows& r, unsigned base,
                                        unsigned step, unsigned cpr) {
  const unsigned mine = base + (threadIdx.x & 31u) * step;
  Lead p{0, 0};
  if (mine < r.n_rows * cpr) {
    const unsigned e = cpr == 1 ? mine : mine / cpr;
    p.src = __ldg(r.src_row + e);
    p.dst = __ldg(r.dst_row + e);
  }
  return p;
}

// Rows of at least a tile: a task is one chunk of one row (cpr chunks a
// row). `lead` holds the entries of the warp's first 32 tasks.
template <typename T>
__device__ __forceinline__ void copy_wide(const Rows& r, unsigned w0,
                                          unsigned step, unsigned units,
                                          Lead lead) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned cpr = (units + kTile - 1) / kTile;
  const unsigned tasks = r.n_rows * cpr;
  for (unsigned base = w0; base < tasks; base += 32 * step) {
    if (base != w0) lead = lead_of(r, base, step, cpr);
    // no sum wraps: the wide-row engine's step reaches `tasks`, so a warp
    // steps on only while 32 more steps stay inside the tasks (a lane's
    // entry past the tasks may wrap in lead_of, and goes unused)
    const unsigned left = (tasks - base - 1) / step + 1;
    const unsigned n = left < 32u ? left : 32u;
    for (unsigned j = 0; j < n; ++j) {
      const unsigned t = base + j * step;
      const unsigned e = cpr == 1 ? t : t / cpr;
      const int s = __shfl_sync(0xffffffffu, lead.src, j);
      const int d = __shfl_sync(0xffffffffu, lead.dst, j);
      aggcomm::copy_chunk<T, true>(
          reinterpret_cast<const T*>(r.send + (long long)s * r.row_bytes),
          reinterpret_cast<T*>(r.recv + (long long)d * r.row_bytes),
          (t - e * cpr) * kTile + lane, units);
    }
    if (left <= 32u) break;
  }
}

// Rows narrower than a tile: a task is `per` whole rows, lane l's k-th
// unit the tile's unit l + 32 k, in row (l + 32 k) / units.
template <typename T>
__device__ __forceinline__ void copy_narrow(const Rows& r, unsigned w0,
                                            unsigned step, unsigned units) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned per = kTile / units;
  const unsigned tasks = (r.n_rows + per - 1) / per;
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
      if (row[k] < per && e < r.n_rows) {
        const long long s = __ldg(r.src_row + e);
        at[k] = (long long)__ldg(r.dst_row + e) * units + unit[k];
        v[k] = __ldg(reinterpret_cast<const T*>(r.send) + s * units +
                     unit[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVpt; ++k) {
      if (at[k] >= 0) __stcs(reinterpret_cast<T*>(r.recv) + at[k], v[k]);
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
    aggcomm::zero_share<T, true>(a.rows.recv, a.rows.row_bytes, a.zero_start,
                                 a.zero_ptr, a.n_zero_runs, a.zero_rows,
                                 blockIdx.x - a.copy_ctas,
                                 gridDim.x - a.copy_ctas);
    return;
  }
  const unsigned warps = kThreads / 32;
  const unsigned w0 = blockIdx.x * warps + (threadIdx.x >> 5);
  const unsigned step = a.copy_ctas * warps;
  const unsigned units = a.rows.row_bytes / (unsigned)sizeof(T);
  if (units >= kTile) {
    copy_wide<T>(a.rows, w0, step, units,
                 lead_of(a.rows, w0, step, (units + kTile - 1) / kTile));
  } else {
    copy_narrow<T>(a.rows, w0, step, units);
  }
}

struct RoundsArgs {
  const unsigned char* send;
  unsigned char* recv;
  const int* round_ptr;  // n_rounds + 1 entry offsets
  const int* src_row;
  const int* dst_row;
  const int* zero_start;
  const int* zero_ptr;
  int n_rounds;
  int n_zero_runs;
  unsigned zero_rows;
  unsigned row_bytes;
  unsigned copy_ctas;  // CTAs [0, copy_ctas) copy and fence; the rest zero
  aggcomm::BarrierWords sync;
  unsigned long long timeout_ns;
  unsigned long long* stamps;
};

// Round k's rows: a table read, never a data read.
__device__ __forceinline__ Rows round_rows(const RoundsArgs& a, int k) {
  const int p0 = __ldg(a.round_ptr + k), p1 = __ldg(a.round_ptr + k + 1);
  return Rows{a.send, a.recv, a.src_row + p0, a.dst_row + p0,
              (unsigned)(p1 - p0), a.row_bytes};
}

__device__ __forceinline__ void stamp(const RoundsArgs& a, int slot) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    a.stamps[(long long)blockIdx.x * (2 + 2 * a.n_rounds) + slot] =
        aggcomm::global_ns();
  }
}

// kWide: rows of at least a tile (copy_wide), else narrower (copy_narrow);
// fixed per launch, so each round's loop holds one of the two.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kRoundThreads, kRoundCtasPerSm)
    deliver_rounds_kernel(RoundsArgs a) {
  // a fence of an earlier launch on these words timed out, and its counter
  // may stand past 0: this launch writes nothing rather than run unfenced
  if (aggcomm::grid_failed(a.sync)) return;
  stamp(a, 0);
  if (blockIdx.x >= a.copy_ctas) {  // a zeroing CTA: no fence to keep
    aggcomm::zero_share<T, true>(a.recv, a.row_bytes, a.zero_start,
                                 a.zero_ptr, a.n_zero_runs, a.zero_rows,
                                 blockIdx.x - a.copy_ctas,
                                 gridDim.x - a.copy_ctas);
    stamp(a, 1 + 2 * a.n_rounds);
    return;
  }
  const unsigned warps = kRoundThreads / 32;
  const unsigned w0 = blockIdx.x * warps + (threadIdx.x >> 5);
  const unsigned step = a.copy_ctas * warps;
  const unsigned units = a.row_bytes / (unsigned)sizeof(T);
  const unsigned cpr = (units + kTile - 1) / kTile;
  Rows rows = round_rows(a, 0);
  Lead lead = kWide ? lead_of(rows, w0, step, cpr) : Lead{0, 0};
  for (int k = 0; k < a.n_rounds; ++k) {
    if (kWide) {
      copy_wide<T>(rows, w0, step, units, lead);
    } else {
      copy_narrow<T>(rows, w0, step, units);
    }
    if (k + 1 < a.n_rounds) {  // the next round's table entries
      rows = round_rows(a, k + 1);
      if (kWide) lead = lead_of(rows, w0, step, cpr);
    }
    if (a.stamps != nullptr) {
      __syncthreads();
      stamp(a, 1 + 2 * k);
    }
    if (k + 1 < a.n_rounds &&
        aggcomm::grid_arrive_wait(a.sync, (unsigned)(k + 1) * a.copy_ctas, k,
                                  a.timeout_ns)) {
      return;
    }
    stamp(a, 2 + 2 * k);
  }
  aggcomm::grid_depart(a.sync, (unsigned)a.n_rounds * a.copy_ctas);
  stamp(a, 1 + 2 * a.n_rounds);
}

const void* pick(int size) {
  if (size == 16) return (const void*)deliver_rows_kernel<uint4>;
  if (size == 4) return (const void*)deliver_rows_kernel<unsigned int>;
  return (const void*)deliver_rows_kernel<unsigned char>;
}

template <bool kWide>
const void* pick_rounds_of(int size) {
  if (size == 16) return (const void*)deliver_rounds_kernel<uint4, kWide>;
  if (size == 4)
    return (const void*)deliver_rounds_kernel<unsigned int, kWide>;
  return (const void*)deliver_rounds_kernel<unsigned char, kWide>;
}

// The instantiation for lane units of `size` bytes and rows of `units`.
const void* pick_rounds(int size, unsigned long long units) {
  return units >= kTile ? pick_rounds_of<true>(size)
                        : pick_rounds_of<false>(size);
}

// SMs and resident CTAs of `threads` threads per SM of each
// instantiation, asked once.
cudaError_t residency(const void* fn, int threads, int device, int* sms,
                      int* per_sm) {
  static int n_sms = 0;
  static const void* fns[16];
  static int fits[16];
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
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) *per_sm = 1;
  if (used < 16) {
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

// Tasks of the widest round, rows of `units` lane units.
unsigned long long tasks_of(unsigned long long n_rows,
                            unsigned long long units) {
  return units >= kTile ? n_rows * ((units + kTile - 1) / kTile)
                        : (n_rows + kTile / units - 1) / (kTile / units);
}

// The lane width and the checks both launches share.
cudaError_t check_sizes(const void* send, const void* recv,
                        long long row_bytes, long long n_rows,
                        long long zero_rows, int* lane) {
  if (row_bytes <= 0 || row_bytes >= (long long)kMaxItems || n_rows < 0 ||
      zero_rows < 0)
    return cudaErrorInvalidValue;
  *lane = aggcomm::lane_size(send, recv, row_bytes);
  const unsigned long long units = row_bytes / *lane;
  const unsigned long long cpr = (units + kTile - 1) / kTile;
  if ((unsigned long long)n_rows >= kMaxItems || n_rows * cpr >= kMaxItems ||
      (unsigned long long)zero_rows * cpr >= kMaxItems)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

long long zero_ctas(long long zero_rows, long long row_bytes, int sms) {
  if (zero_rows <= 0) return 0;
  const long long zero = (zero_rows * row_bytes + kZeroCtaBytes - 1) /
                         kZeroCtaBytes;
  return zero > sms ? sms : zero;
}

// Whether a one-round launch of rows of `row_bytes` in lanes of `lane`
// bytes takes the wide-row engine.
bool wide_engine(int lane, long long row_bytes) {
  return lane == 16 && row_bytes >= kWideRowBytes;
}

// The launch for these arguments on `grid` (kByRule: as wide_engine
// says): lane width, the copying CTAs and the zeroing CTAs after them.
// The copying CTAs are enough for the tasks; on the persistent grid at
// most what the card keeps resident, on the wide-row engine's (16-byte
// lanes only) a warp for every task.
cudaError_t make_plan(const void* send, const void* recv, long long row_bytes,
                      long long n_rows, long long zero_rows, int device,
                      int grid, Plan* p) {
  cudaError_t err =
      check_sizes(send, recv, row_bytes, n_rows, zero_rows, &p->lane);
  if (err != cudaSuccess) return err;
  const bool wide = grid == kByRule ? wide_engine(p->lane, row_bytes)
                                    : grid == kWide;
  if (wide && p->lane != 16) return cudaErrorInvalidValue;
  p->fn = pick(p->lane);
  const unsigned long long tasks = tasks_of(n_rows, row_bytes / p->lane);
  int sms = 0, per_sm = 0;
  err = residency(p->fn, kThreads, device, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const unsigned long long warps = kThreads / 32;
  unsigned long long copy = (tasks + warps - 1) / warps;
  const unsigned long long cap = (unsigned long long)per_sm * sms;
  if (!wide && copy > cap) copy = cap;
  p->copy_ctas = (int)copy;
  p->grid = (int)(copy + zero_ctas(zero_rows, row_bytes, sms));
  return cudaSuccess;
}

// The many-round launch: every CTA resident at once (a cooperative
// launch), at most kRoundCtasPerSm of kRoundThreads an SM; copying CTAs
// enough for the widest round's tasks, and at least one; the zeroing CTAs
// from what is left.
cudaError_t make_rounds_plan(const void* send, const void* recv,
                             long long row_bytes, long long max_round_rows,
                             int n_rounds, long long zero_rows, int device,
                             Plan* p) {
  if (n_rounds < 1) return cudaErrorInvalidValue;
  cudaError_t err =
      check_sizes(send, recv, row_bytes, max_round_rows, zero_rows, &p->lane);
  if (err != cudaSuccess) return err;
  p->fn = pick_rounds(p->lane, row_bytes / p->lane);
  const unsigned long long tasks =
      tasks_of(max_round_rows, row_bytes / p->lane);
  int sms = 0, per_sm = 0;
  err = residency(p->fn, kRoundThreads, device, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm > kRoundCtasPerSm) per_sm = kRoundCtasPerSm;
  const long long cap = (long long)per_sm * sms;
  long long zero = zero_ctas(zero_rows, row_bytes, sms);
  const long long warps = kRoundThreads / 32;
  long long copy = ((long long)tasks + warps - 1) / warps;
  if (copy < 1) copy = 1;
  if (cap < (zero > 0 ? 2 : 1)) return cudaErrorCooperativeLaunchTooLarge;
  if (copy > cap - (zero > 0 ? 1 : 0)) copy = cap - (zero > 0 ? 1 : 0);
  if (zero > cap - copy) zero = cap - copy;
  // fence arrivals and departures on one 32-bit counter
  if ((unsigned long long)n_rounds * (unsigned long long)copy >= kMaxItems)
    return cudaErrorInvalidValue;
  p->copy_ctas = (int)copy;
  p->grid = (int)(copy + zero);
  return cudaSuccess;
}

// What stays fixed for one prefix of a rep's round tables, from their
// build on: the tables' device pointers and counts, the zero runs, the row
// width and the fence's words and timeout. backends/deliver_rows.py's
// RoundsBlock mirrors it field for field.
struct RoundsBlock {
  const int* round_ptr;
  const int* src_row;
  const int* dst_row;
  const int* zero_start;
  const int* zero_ptr;
  void* sync;
  unsigned long long timeout_ns;
  long long max_round_rows;
  long long zero_rows;
  long long row_bytes;
  int n_rounds;
  int n_zero_runs;
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

int launch_rounds(const RoundsBlock& b, const void* send, void* recv,
                  void* stamps, void* stream) {
  cudaError_t err = use_device(b.device);
  if (err != cudaSuccess) return (int)err;
  const long long zero_rows = b.n_zero_runs > 0 ? b.zero_rows : 0;
  Plan p;
  err = make_rounds_plan(send, recv, b.row_bytes, b.max_round_rows,
                         b.n_rounds, zero_rows, b.device, &p);
  if (err != cudaSuccess) return (int)err;
  RoundsArgs a;
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
  a.copy_ctas = (unsigned)p.copy_ctas;
  a.sync.counter = static_cast<unsigned*>(b.sync);
  a.sync.error = static_cast<int*>(b.sync) + 1;
  a.timeout_ns = b.timeout_ns;
  a.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel(p.fn, dim3(p.grid), dim3(kRoundThreads),
                                    args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_round(const void* send, void* recv, const int* src_row,
                 const int* dst_row, long long n_rows, const int* zero_start,
                 const int* zero_ptr, int n_zero_runs, long long zero_rows,
                 long long row_bytes, void* stream, int device, int grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_zero_runs <= 0) zero_rows = 0;
  if (n_rows <= 0 && zero_rows <= 0) return 0;
  Plan p;
  err = make_plan(send, recv, row_bytes, n_rows, zero_rows, device, grid, &p);
  if (err != cudaSuccess) return (int)err;
  DeliverArgs a;
  a.rows.send = static_cast<const unsigned char*>(send);
  a.rows.recv = static_cast<unsigned char*>(recv);
  a.rows.src_row = src_row;
  a.rows.dst_row = dst_row;
  a.rows.n_rows = (unsigned)n_rows;
  a.rows.row_bytes = (unsigned)row_bytes;
  a.zero_start = zero_start;
  a.zero_ptr = zero_ptr;
  a.n_zero_runs = n_zero_runs;
  a.zero_rows = (unsigned)zero_rows;
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

}  // namespace

// One round. send: (Fs, row_bytes) bytes; recv: (F, row_bytes), any
// contents in the rows this launch neither copies to nor zeroes.
// src_row, dst_row: n_rows int32 rows, on the device; zero_start: Z int32
// rows and zero_ptr: Z+1 int32 prefix row counts (null with Z = 0). No
// launch when there is nothing to copy or zero. The grid is the rule's
// (wide_engine). Returns the launch's cudaError_t (0 on success).
extern "C" int aggcomm_deliver_rows(const void* send, void* recv,
                                    const int* src_row, const int* dst_row,
                                    long long n_rows, const int* zero_start,
                                    const int* zero_ptr, int n_zero_runs,
                                    long long zero_rows, long long row_bytes,
                                    void* stream, int device) {
  return launch_round(send, recv, src_row, dst_row, n_rows, zero_start,
                      zero_ptr, n_zero_runs, zero_rows, row_bytes, stream,
                      device, kByRule);
}

// The same round on the grid `grid` names, whatever the rule picks: 0 the
// persistent grid, 1 the wide-row engine's (16-byte lanes only, else
// cudaErrorInvalidValue). For side-by-side readings of the two grids and
// their tests; the main path calls aggcomm_deliver_rows.
extern "C" int aggcomm_deliver_rows_on(int grid, const void* send,
                                       void* recv, const int* src_row,
                                       const int* dst_row, long long n_rows,
                                       const int* zero_start,
                                       const int* zero_ptr, int n_zero_runs,
                                       long long zero_rows,
                                       long long row_bytes, void* stream,
                                       int device) {
  if (grid != kPersistent && grid != kWide) return cudaErrorInvalidValue;
  return launch_round(send, recv, src_row, dst_row, n_rows, zero_start,
                      zero_ptr, n_zero_runs, zero_rows, row_bytes, stream,
                      device, grid);
}

// The first n_rounds rounds of a rep in one launch, from the tables a
// RoundsBlock binds: round_ptr, at least n_rounds + 1 int32 offsets into
// src_row and dst_row (round k is entries [round_ptr[k], round_ptr[k+1])),
// on the device; max_round_rows, the widest of those rounds' entry
// counts; the zero runs as aggcomm_deliver_rows takes them; sync, 4 int32
// (the fence's counter, 0 between launches, and its error record: CTA + 1,
// round, arrivals seen; zero unless a wait timed out). send and recv as
// aggcomm_deliver_rows. stamps: null (the main path), or (grid, 2 + 2 *
// n_rounds) uint64. Returns the launch's cudaError_t (0 on success).
extern "C" int aggcomm_deliver_rounds(const void* block, const void* send,
                                      void* recv, void* stamps,
                                      void* stream) {
  return launch_rounds(*static_cast<const RoundsBlock*>(block), send, recv,
                       stamps, stream);
}

// What aggcomm_deliver_rounds would launch for the same arguments, into
// out[4]: grid, copying CTAs, threads a CTA, lane width in bytes. Returns
// a cudaError_t.
extern "C" int aggcomm_deliver_rounds_plan(const void* block,
                                           const void* send,
                                           const void* recv, int* out) {
  const RoundsBlock& b = *static_cast<const RoundsBlock*>(block);
  cudaError_t err = use_device(b.device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  err = make_rounds_plan(send, recv, b.row_bytes, b.max_round_rows,
                         b.n_rounds, b.n_zero_runs > 0 ? b.zero_rows : 0,
                         b.device, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.copy_ctas;
  out[2] = kRoundThreads;
  out[3] = p.lane;
  return 0;
}
