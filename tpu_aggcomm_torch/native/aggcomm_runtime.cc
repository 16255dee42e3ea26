// Native schedule executor: N-thread rank runtime with MPI-faithful
// message semantics.
//
// This is the framework's native runtime tier (the reference's entire
// program is native C — SURVEY.md §2 "no component may be a pure-Python
// stand-in"). It executes the same compiled op programs as the Python
// backends, but with REAL concurrency semantics:
//
//   - ISSEND (MPI_Issend analog): completes only when the matching receive
//     is posted — true rendezvous, the congestion-exposing behavior the
//     reference builds its sync/half-sync studies on (mpi_test.c Issend
//     call sites).
//   - ISEND: eager — payload buffered at post time, completes immediately.
//   - SEND/RECV/SENDRECV: blocking (standard-mode send = eager buffer).
//   - WAITALL over explicit token sets; BARRIER via shared generation
//     counter; 0-byte SIGNAL channel (the dup'ed signal_comm analog,
//     mpi_test.c:1252); ALLTOALLW as barrier + direct shared-memory copy.
//
// Each rank is one thread; channels are per-(src,dst[,signal]) FIFO queues
// (message matching per directed pair is unique per rep in every reference
// schedule; FIFO covers the multi-rep no-resync case, mpi_test.c:2150).
// Per-op timer buckets mirror the reference's MPI_Wtime bracketing.
//
// C ABI only (ctypes-friendly); no Python.h dependency.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum OpKind : int32_t {
  kIsend = 0,
  kIssend = 1,
  kIrecv = 2,
  kSend = 3,
  kRecv = 4,
  kSendrecv = 5,
  kWaitall = 6,
  kBarrier = 7,
  kCopy = 8,
  kSignalSend = 9,
  kSignalRecv = 10,
  kAlltoallw = 11,
};

enum Bucket : int32_t {
  kPost = 0,
  kRecvWait = 1,
  kSendWait = 2,
  kRecvAndSendWait = 3,
  kBarrierB = 4,
  kNone = 5,
};

struct NOp {
  int32_t kind;
  int32_t peer;
  int32_t slot;
  int32_t peer2;
  int32_t slot2;
  int32_t token;
  int32_t nbytes;
  int32_t bucket;
  int32_t ntokens;   // WAITALL: number of tokens
  int32_t tok_ofs;   // WAITALL: offset into wait_tokens array
};

struct Timer5 {
  double post = 0, send_wait = 0, recv_wait = 0, barrier = 0, total = 0;
};

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// One message in flight on a channel. Rendezvous (Issend) vs eager (Isend/
// Send) is expressed through `send_done`: rendezvous sends pass their token
// flag (set at match time); eager sends pass null (flag set at post time).
struct Msg {
  const uint8_t* src_data = nullptr;  // sender slab (valid whole run)
  int32_t nbytes = 0;
  std::atomic<bool>* send_done = nullptr;
};

struct Channel {
  std::deque<Msg> sends;
  std::deque<std::pair<uint8_t*, std::atomic<bool>*>> recvs;  // dst buf, flag
};

struct Runtime {
  int n;
  std::mutex mu;                 // single lock: correctness over scalability
  std::condition_variable cv;    // (1-core image; contention is the workload)
  std::vector<Channel> data_ch;  // n*n
  std::vector<std::deque<int>> signal_ch;  // n*n: queue of 0-byte signals
  // barrier
  int barrier_waiting = 0;
  int64_t barrier_gen = 0;
  // alltoallw rendezvous
  int a2a_waiting = 0;
  int64_t a2a_gen = 0;

  explicit Runtime(int nprocs)
      : n(nprocs), data_ch(nprocs * nprocs), signal_ch(nprocs * nprocs) {}

  Channel& ch(int src, int dst) { return data_ch[src * n + dst]; }

  // Generation-counted rendezvous of all n ranks; caller holds `lk` on mu.
  void gen_barrier(std::unique_lock<std::mutex>& lk, int& waiting,
                   int64_t& gen) {
    int64_t my_gen = gen;
    if (++waiting == n) {
      waiting = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != my_gen; });
    }
  }

  // Try to match the channel head send/recv; called with mu held.
  void match(int src, int dst) {
    Channel& c = ch(src, dst);
    while (!c.sends.empty() && !c.recvs.empty()) {
      Msg m = c.sends.front();
      c.sends.pop_front();
      auto [buf, rflag] = c.recvs.front();
      c.recvs.pop_front();
      if (m.nbytes > 0 && buf != nullptr && m.src_data != nullptr) {
        std::memcpy(buf, m.src_data, m.nbytes);
      }
      if (m.send_done) m.send_done->store(true, std::memory_order_release);
      if (rflag) rflag->store(true, std::memory_order_release);
    }
  }
};

struct RankCtx {
  Runtime* rt;
  int rank;
  const NOp* ops;
  int nops;
  const int32_t* wait_tokens;
  // slab bases
  const uint8_t* send_base;   // this rank's send slabs (nslots * data_size)
  uint8_t* recv_base;         // this rank's recv slabs
  int data_size;
  // token flags for this rank
  std::vector<std::atomic<bool>> flags;
  Timer5* timers;             // per-rep Timer array (ntimes entries)
  // global alltoallw inputs
  const uint8_t* const* all_send_bases;
  const int32_t* a2a_src_slot;  // per (dst,src): sender slot or -1
  const int32_t* a2a_dst_slot;  // per (dst,src): recv slot
};

void run_rank(RankCtx* cx, int ntimes) {
  Runtime& rt = *cx->rt;
  const int n = rt.n;
  for (int rep = 0; rep < ntimes; ++rep) {
    Timer5& t = cx->timers[rep];
    for (auto& f : cx->flags) f.store(false, std::memory_order_relaxed);
    double rep_start = now_s();
    for (int i = 0; i < cx->nops; ++i) {
      const NOp& op = cx->ops[i];
      double t0 = now_s();
      switch (op.kind) {
        case kIsend:
        case kIssend: {
          std::unique_lock<std::mutex> lk(rt.mu);
          Msg m;
          m.src_data = cx->send_base + (size_t)op.slot * cx->data_size;
          m.nbytes = op.nbytes;
          m.send_done = &cx->flags[op.token];
          if (op.kind == kIsend) {
            // eager: complete at post; payload stays valid (deterministic
            // fill is never overwritten), so the copy happens at match.
            cx->flags[op.token].store(true, std::memory_order_release);
            m.send_done = nullptr;
          }
          rt.ch(cx->rank, op.peer).sends.push_back(m);
          rt.match(cx->rank, op.peer);
          rt.cv.notify_all();
          break;
        }
        case kIrecv: {
          std::unique_lock<std::mutex> lk(rt.mu);
          uint8_t* buf = cx->recv_base + (size_t)op.slot * cx->data_size;
          rt.ch(op.peer, cx->rank).recvs.push_back({buf, &cx->flags[op.token]});
          rt.match(op.peer, cx->rank);
          rt.cv.notify_all();
          break;
        }
        case kSend: {
          // standard-mode blocking send: eager buffer semantics (see the
          // oracle's rationale — strict rendezvous deadlocks m=6/7)
          std::unique_lock<std::mutex> lk(rt.mu);
          Msg m;
          m.src_data = cx->send_base + (size_t)op.slot * cx->data_size;
          m.nbytes = op.nbytes;
          rt.ch(cx->rank, op.peer).sends.push_back(m);
          rt.match(cx->rank, op.peer);
          rt.cv.notify_all();
          break;
        }
        case kRecv: {
          std::unique_lock<std::mutex> lk(rt.mu);
          uint8_t* buf = cx->recv_base + (size_t)op.slot * cx->data_size;
          std::atomic<bool> done{false};
          rt.ch(op.peer, cx->rank).recvs.push_back({buf, &done});
          rt.match(op.peer, cx->rank);
          rt.cv.notify_all();
          rt.cv.wait(lk, [&] { return done.load(std::memory_order_acquire); });
          break;
        }
        case kSendrecv: {
          // pairwise methods post zero-byte slots with slot = -1 and
          // receivers without buffers (mpi_test.c:466-478); never form the
          // pointer in those cases (UB even if unread)
          std::unique_lock<std::mutex> lk(rt.mu);
          Msg m;
          m.src_data = (op.nbytes > 0 && op.slot >= 0)
                           ? cx->send_base + (size_t)op.slot * cx->data_size
                           : nullptr;
          m.nbytes = op.nbytes;
          rt.ch(cx->rank, op.peer).sends.push_back(m);
          rt.match(cx->rank, op.peer);
          uint8_t* buf = (cx->recv_base != nullptr && op.slot2 >= 0)
                             ? cx->recv_base + (size_t)op.slot2 * cx->data_size
                             : nullptr;
          std::atomic<bool> done{false};
          rt.ch(op.peer2, cx->rank).recvs.push_back({buf, &done});
          rt.match(op.peer2, cx->rank);
          rt.cv.notify_all();
          rt.cv.wait(lk, [&] { return done.load(std::memory_order_acquire); });
          break;
        }
        case kWaitall: {
          std::unique_lock<std::mutex> lk(rt.mu);
          rt.cv.wait(lk, [&] {
            for (int k = 0; k < op.ntokens; ++k) {
              int tok = cx->wait_tokens[op.tok_ofs + k];
              if (!cx->flags[tok].load(std::memory_order_acquire)) return false;
            }
            return true;
          });
          break;
        }
        case kBarrier: {
          std::unique_lock<std::mutex> lk(rt.mu);
          rt.gen_barrier(lk, rt.barrier_waiting, rt.barrier_gen);
          break;
        }
        case kCopy: {
          std::memcpy(cx->recv_base + (size_t)op.slot2 * cx->data_size,
                      cx->send_base + (size_t)op.slot * cx->data_size,
                      cx->data_size);
          break;
        }
        case kSignalSend: {
          std::unique_lock<std::mutex> lk(rt.mu);
          rt.signal_ch[cx->rank * n + op.peer].push_back(1);
          if (op.token >= 0)
            cx->flags[op.token].store(true, std::memory_order_release);
          rt.cv.notify_all();
          break;
        }
        case kSignalRecv: {
          std::unique_lock<std::mutex> lk(rt.mu);
          auto& q = rt.signal_ch[op.peer * n + cx->rank];
          rt.cv.wait(lk, [&] { return !q.empty(); });
          q.pop_front();
          break;
        }
        case kAlltoallw: {
          // barrier in, shared-memory exchange, barrier out — the whole
          // pattern in "one collective" (mpi_test.c:627/912)
          std::unique_lock<std::mutex> lk(rt.mu);
          rt.gen_barrier(lk, rt.a2a_waiting, rt.a2a_gen);
          lk.unlock();
          if (cx->recv_base != nullptr) {
            for (int src = 0; src < n; ++src) {
              int32_t ss = cx->a2a_src_slot[cx->rank * n + src];
              if (ss < 0) continue;
              int32_t ds = cx->a2a_dst_slot[cx->rank * n + src];
              std::memcpy(cx->recv_base + (size_t)ds * cx->data_size,
                          cx->all_send_bases[src] + (size_t)ss * cx->data_size,
                          cx->data_size);
            }
          }
          // closing barrier so no rank races into the next rep's exchange
          lk.lock();
          rt.gen_barrier(lk, rt.a2a_waiting, rt.a2a_gen);
          break;
        }
      }
      double dt = now_s() - t0;
      switch (op.bucket) {
        case kPost: t.post += dt; break;
        case kRecvWait: t.recv_wait += dt; break;
        case kSendWait: t.send_wait += dt; break;
        case kRecvAndSendWait: t.recv_wait += dt; t.send_wait += dt; break;
        case kBarrierB: t.barrier += dt; break;
        default: break;
      }
    }
    t.total = now_s() - rep_start;
  }
}

// ---------------------------------------------------------------------------
// Variable-size workload engine: the collective_write proxy route executed
// natively. One thread per rank; the five phases of the reference's
// production engine (intra-node pack+gather to the node proxy, proxy↔proxy
// per-node runs, local delivery, scatter) are real memcpy walks between
// thread-shared staging buffers — the hot loops the reference times
// (pack cursors, run reorder, per-rank re-pack).
//
// Buffer layouts (all byte offsets precomputed before threads start):
//   send_msgs:  per src rank, its G messages in ascending-aggregator order,
//               each msg_sizes[src] bytes (block size G * msg_sizes[src]).
//   aggregate:  per node, local ranks' blocks in ascending-rank order.
//   run b1->b2: for src on b1 ascending, for each aggregator on b2
//               ascending: the (src -> agg) message.
//   delivery / recv_out row of aggregator g: for src in GLOBAL ascending
//               order: the (src -> g) message.

struct WlGeom {
  int n, nn, G;
  const int32_t* node_of;
  const int32_t* proxies;
  const int32_t* aggs;        // ascending aggregator ranks
  const int32_t* msg_sizes;   // per src
  std::vector<std::vector<int>> node_ranks;   // per node, ascending
  std::vector<std::vector<int>> node_aggs;    // per node, ascending gi
  std::vector<int> agg_of_rank;               // rank -> gi or -1
  std::vector<int64_t> block_bytes;           // per src: G * msg_sizes[src]
  std::vector<int64_t> agg_ofs;               // per node: aggregate offset of
                                              // each local rank (flattened)
  std::vector<int64_t> agg_ofs_start;         // per node: index into agg_ofs
  std::vector<int64_t> agg_total;             // per node: aggregate bytes
  std::vector<int64_t> run_bytes;             // (b1, b2) run size
  std::vector<int64_t> src_run_base;          // per src: its base offset in
                                              // the run node_of[src] -> b2,
                                              // PER dest node (n * nn)
  std::vector<int64_t> recv_src_ofs;          // per src: offset of its msg in
                                              // any delivery slab
  int64_t slab_bytes = 0;                     // delivery slab size

  WlGeom(int n_, int nn_, int G_, const int32_t* node_of_,
         const int32_t* proxies_, const int32_t* aggs_,
         const int32_t* msg_sizes_)
      : n(n_), nn(nn_), G(G_), node_of(node_of_), proxies(proxies_),
        aggs(aggs_), msg_sizes(msg_sizes_) {
    node_ranks.resize(nn);
    node_aggs.resize(nn);
    agg_of_rank.assign(n, -1);
    for (int r = 0; r < n; ++r) node_ranks[node_of[r]].push_back(r);
    for (int gi = 0; gi < G; ++gi) {
      agg_of_rank[aggs[gi]] = gi;
      node_aggs[node_of[aggs[gi]]].push_back(gi);
    }
    block_bytes.resize(n);
    for (int r = 0; r < n; ++r)
      block_bytes[r] = (int64_t)G * msg_sizes[r];
    agg_ofs_start.assign(nn + 1, 0);
    agg_total.assign(nn, 0);
    for (int b = 0; b < nn; ++b)
      agg_ofs_start[b + 1] = agg_ofs_start[b] + (int64_t)node_ranks[b].size();
    agg_ofs.assign(agg_ofs_start[nn], 0);
    for (int b = 0; b < nn; ++b) {
      int64_t cur = 0;
      for (size_t i = 0; i < node_ranks[b].size(); ++i) {
        agg_ofs[agg_ofs_start[b] + i] = cur;
        cur += block_bytes[node_ranks[b][i]];
      }
      agg_total[b] = cur;
    }
    run_bytes.assign((int64_t)nn * nn, 0);
    src_run_base.assign((int64_t)n * nn, 0);
    for (int b1 = 0; b1 < nn; ++b1) {
      for (int b2 = 0; b2 < nn; ++b2) {
        int64_t cur = 0;
        for (int src : node_ranks[b1]) {
          src_run_base[(int64_t)src * nn + b2] = cur;
          cur += (int64_t)msg_sizes[src] * node_aggs[b2].size();
        }
        run_bytes[(int64_t)b1 * nn + b2] = cur;
      }
    }
    recv_src_ofs.assign(n, 0);
    int64_t cur = 0;
    for (int src = 0; src < n; ++src) {
      recv_src_ofs[src] = cur;
      cur += msg_sizes[src];
    }
    slab_bytes = cur;
  }

  // position of aggregator gi within its node's ascending list
  int agg_pos_on_node(int gi) const {
    const auto& v = node_aggs[node_of[aggs[gi]]];
    for (size_t j = 0; j < v.size(); ++j)
      if (v[j] == gi) return (int)j;
    return 0;
  }
};

// Eager send: payload stays valid until matched (guaranteed by the
// end-of-rep barrier); completes at post like the runtime's kIsend.
void wl_post_send(Runtime& rt, int src, int dst, const uint8_t* data,
                  int64_t nbytes) {
  if (nbytes <= 0) return;
  std::unique_lock<std::mutex> lk(rt.mu);
  Msg m;
  m.src_data = data;
  m.nbytes = (int32_t)nbytes;
  rt.ch(src, dst).sends.push_back(m);
  rt.match(src, dst);
  rt.cv.notify_all();
}

// Blocking receive into `buf`.
void wl_recv(Runtime& rt, int src, int dst, uint8_t* buf) {
  std::unique_lock<std::mutex> lk(rt.mu);
  std::atomic<bool> done{false};
  rt.ch(src, dst).recvs.push_back({buf, &done});
  rt.match(src, dst);
  rt.cv.notify_all();
  rt.cv.wait(lk, [&] { return done.load(std::memory_order_acquire); });
}

struct WlShared {
  Runtime* rt;
  const WlGeom* g;
  const uint8_t* send_msgs;
  const int64_t* send_block_ofs;   // per src: byte offset of its block
  uint8_t* recv_out;               // G slabs, slab_bytes each
  std::vector<std::vector<uint8_t>> aggregate;   // per node
  std::vector<std::vector<uint8_t>> run_out;     // (b1, b2) packed runs
  std::vector<std::vector<uint8_t>> run_in;      // (b2, b1) received runs
  std::vector<std::vector<uint8_t>> deliver;     // per gi staging slab
};

void wl_run_rank(WlShared* sh, int rank, int ntimes, double* rep_times) {
  Runtime& rt = *sh->rt;
  const WlGeom& g = *sh->g;
  const int b = g.node_of[rank];
  const bool proxy = (g.proxies[b] == rank);
  const int gi_self = g.agg_of_rank[rank];

  for (int rep = 0; rep < ntimes; ++rep) {
    double t0 = now_s();
    // P2: pack + gather at the node proxy (l_d_t.c:1069-1105)
    if (!proxy) {
      wl_post_send(rt, rank, g.proxies[b],
                   sh->send_msgs + sh->send_block_ofs[rank],
                   g.block_bytes[rank]);
    } else {
      uint8_t* abuf = sh->aggregate[b].data();
      for (size_t i = 0; i < g.node_ranks[b].size(); ++i) {
        int lr = g.node_ranks[b][i];
        int64_t ofs = g.agg_ofs[g.agg_ofs_start[b] + i];
        if (lr == rank) {
          std::memcpy(abuf + ofs, sh->send_msgs + sh->send_block_ofs[lr],
                      g.block_bytes[lr]);
        } else if (g.block_bytes[lr] > 0) {
          wl_recv(rt, lr, rank, abuf + ofs);
        }
      }
      // P3: reorder into per-destination-node runs and exchange
      // (l_d_t.c:1121-1194)
      for (int b2 = 0; b2 < g.nn; ++b2) {
        uint8_t* run = sh->run_out[(int64_t)b * g.nn + b2].data();
        int64_t cur = 0;
        for (size_t i = 0; i < g.node_ranks[b].size(); ++i) {
          int src = g.node_ranks[b][i];
          const uint8_t* blk = abuf + g.agg_ofs[g.agg_ofs_start[b] + i];
          for (int gi : g.node_aggs[b2]) {
            std::memcpy(run + cur, blk + (int64_t)gi * g.msg_sizes[src],
                        g.msg_sizes[src]);
            cur += g.msg_sizes[src];
          }
        }
        if (b2 == b) {
          // self-node run: local memcpy (l_d_t.c:1184)
          std::memcpy(sh->run_in[(int64_t)b * g.nn + b].data(), run, cur);
        } else {
          wl_post_send(rt, rank, g.proxies[b2], run, cur);
        }
      }
      for (int b1 = 0; b1 < g.nn; ++b1) {
        if (b1 == b) continue;
        if (g.run_bytes[(int64_t)b1 * g.nn + b] == 0) continue;
        wl_recv(rt, g.proxies[b1], rank,
                sh->run_in[(int64_t)b * g.nn + b1].data());
      }
      // P4: re-pack one delivery slab per local aggregator and deliver
      // (l_d_t.c:1219-1265)
      for (int gi : g.node_aggs[b]) {
        int agg_rank = g.aggs[gi];
        int pos = g.agg_pos_on_node(gi);
        uint8_t* slab = (agg_rank == rank)
                            ? sh->recv_out + (int64_t)gi * g.slab_bytes
                            : sh->deliver[gi].data();
        for (int src = 0; src < g.n; ++src) {
          int b1 = g.node_of[src];
          const uint8_t* run = sh->run_in[(int64_t)b * g.nn + b1].data();
          int64_t o = g.src_run_base[(int64_t)src * g.nn + b] +
                      (int64_t)pos * g.msg_sizes[src];
          std::memcpy(slab + g.recv_src_ofs[src], run + o, g.msg_sizes[src]);
        }
        if (agg_rank != rank) {
          wl_post_send(rt, rank, agg_rank, slab, g.slab_bytes);
        }
      }
    }
    // P5: non-proxy aggregators receive their slab straight into recv_out
    if (gi_self >= 0 && !proxy && g.slab_bytes > 0) {
      wl_recv(rt, g.proxies[b], rank,
              sh->recv_out + (int64_t)gi_self * g.slab_bytes);
    }
    // end-of-rep rendezvous: staging buffers are reused next rep
    {
      std::unique_lock<std::mutex> lk(rt.mu);
      rt.gen_barrier(lk, rt.barrier_waiting, rt.barrier_gen);
    }
    rep_times[rep] = now_s() - t0;
  }
}

// ---------------------------------------------------------------------------
// collective_write2 (l_d_t.c:754-926): two-level local-aggregator route.
//
// Layouts:
//   send block of src:  G messages in ascending-aggregator order
//   group j (laggs[j]): members = ranks with owner_of[r] == laggs[j],
//                       ascending (the local aggregator owns itself)
//   group staging:      members' blocks back-to-back, member-ascending
//   segment (j -> gi):  for member src ascending, the (src -> gi) message
//                       (the inclusive-prefix-sum pack of l_d_t.c:881-904)
//   delivery slab gi:   for src in GLOBAL ascending order, its message
//                       (the hindexed recv view, create_recv_type 1332-1361,
//                       realized as an explicit scatter after the receive)

struct Cw2Shared {
  Runtime* rt;
  int n, G, nl;
  const int32_t* aggs;
  const int32_t* msg_sizes;
  const int32_t* owner_of;
  const int32_t* laggs;
  const uint8_t* send_msgs;
  const int64_t* send_block_ofs;
  uint8_t* recv_out;
  std::vector<std::vector<int>> members;        // per group, ascending
  std::vector<int> group_of_rank;               // rank -> group or -1
  std::vector<int> agg_of_rank;                 // rank -> gi or -1
  std::vector<int64_t> block_bytes;             // per src
  std::vector<int64_t> seg_total;               // per group
  std::vector<int64_t> recv_src_ofs;            // per src
  int64_t slab_bytes = 0;
  std::vector<std::vector<uint8_t>> stage;      // per group
  std::vector<std::vector<int64_t>> stage_ofs;  // per group: member offsets
  std::vector<std::vector<uint8_t>> seg_out;    // per group: G segments
  std::vector<std::vector<uint8_t>> seg_in;     // per gi: staging
};

void cw2_run_rank(Cw2Shared* sh, int rank, int ntimes, double* rep_times) {
  Runtime& rt = *sh->rt;
  const int j_self = sh->group_of_rank[rank];
  const int gi_self = sh->agg_of_rank[rank];
  const int owner = sh->owner_of[rank];
  for (int rep = 0; rep < ntimes; ++rep) {
    double t0 = now_s();
    // hop 1: member -> its local aggregator (packed send, l_d_t.c:848-856)
    if (owner != rank && sh->block_bytes[rank] > 0) {
      wl_post_send(rt, rank, owner,
                   sh->send_msgs + sh->send_block_ofs[rank],
                   sh->block_bytes[rank]);
    }
    if (j_self >= 0) {
      auto& st = sh->stage[j_self];
      for (size_t i = 0; i < sh->members[j_self].size(); ++i) {
        int m = sh->members[j_self][i];
        uint8_t* dstp = st.data() + sh->stage_ofs[j_self][i];
        if (m == rank) {
          std::memcpy(dstp, sh->send_msgs + sh->send_block_ofs[m],
                      sh->block_bytes[m]);
        } else if (sh->block_bytes[m] > 0) {
          wl_recv(rt, m, rank, dstp);
        }
      }
      // hop 2: one packed segment per global destination
      auto& so = sh->seg_out[j_self];
      const int64_t segsz = sh->seg_total[j_self];
      for (int gi = 0; gi < sh->G; ++gi) {
        uint8_t* seg = so.data() + (int64_t)gi * segsz;
        int64_t cur = 0;
        for (size_t i = 0; i < sh->members[j_self].size(); ++i) {
          int src = sh->members[j_self][i];
          const uint8_t* blk = st.data() + sh->stage_ofs[j_self][i];
          std::memcpy(seg + cur, blk + (int64_t)gi * sh->msg_sizes[src],
                      sh->msg_sizes[src]);
          cur += sh->msg_sizes[src];
        }
        int dst = sh->aggs[gi];
        if (dst == rank) {
          // self segment: direct scatter (the memcpy arm)
          uint8_t* slab = sh->recv_out + (int64_t)gi * sh->slab_bytes;
          int64_t o = 0;
          for (int src : sh->members[j_self]) {
            std::memcpy(slab + sh->recv_src_ofs[src], seg + o,
                        sh->msg_sizes[src]);
            o += sh->msg_sizes[src];
          }
        } else if (segsz > 0) {
          wl_post_send(rt, rank, dst, seg, segsz);
        }
      }
    }
    // destination: one segment per group, scattered via the recv index map
    if (gi_self >= 0) {
      uint8_t* slab = sh->recv_out + (int64_t)gi_self * sh->slab_bytes;
      auto& in = sh->seg_in[gi_self];
      for (int j = 0; j < sh->nl; ++j) {
        if (sh->laggs[j] == rank) continue;  // own group handled above
        if (sh->seg_total[j] <= 0) continue;
        wl_recv(rt, sh->laggs[j], rank, in.data());
        int64_t o = 0;
        for (int src : sh->members[j]) {
          std::memcpy(slab + sh->recv_src_ofs[src], in.data() + o,
                      sh->msg_sizes[src]);
          o += sh->msg_sizes[src];
        }
      }
    }
    {
      std::unique_lock<std::mutex> lk(rt.mu);
      rt.gen_barrier(lk, rt.barrier_waiting, rt.barrier_gen);
    }
    rep_times[rep] = now_s() - t0;
  }
}

}  // namespace

extern "C" {

// Execute the collective_write2 two-level route natively. laggs is the
// group order (meta.local_aggregators); owner_of binds each rank to its
// local aggregator. Other layouts match agg_run_workload_proxy.
int agg_run_workload_cw2(int nprocs, int n_aggs, int n_laggs, int ntimes,
                         const int32_t* aggs, const int32_t* msg_sizes,
                         const int32_t* owner_of, const int32_t* laggs,
                         const uint8_t* send_msgs,
                         const int64_t* send_block_ofs,
                         uint8_t* recv_out, double* rep_times_out) {
  Cw2Shared sh;
  Runtime rt(nprocs);
  sh.rt = &rt;
  sh.n = nprocs;
  sh.G = n_aggs;
  sh.nl = n_laggs;
  sh.aggs = aggs;
  sh.msg_sizes = msg_sizes;
  sh.owner_of = owner_of;
  sh.laggs = laggs;
  sh.send_msgs = send_msgs;
  sh.send_block_ofs = send_block_ofs;
  sh.recv_out = recv_out;

  sh.group_of_rank.assign(nprocs, -1);
  for (int j = 0; j < n_laggs; ++j) sh.group_of_rank[laggs[j]] = j;
  sh.agg_of_rank.assign(nprocs, -1);
  for (int gi = 0; gi < n_aggs; ++gi) sh.agg_of_rank[aggs[gi]] = gi;
  sh.members.resize(n_laggs);
  for (int r = 0; r < nprocs; ++r) {
    if (owner_of[r] < 0 || owner_of[r] >= nprocs) return 1;  // unbound rank
    int j = sh.group_of_rank[owner_of[r]];
    if (j < 0) return 1;  // binding points at a non-local-aggregator
    sh.members[j].push_back(r);
  }
  sh.block_bytes.resize(nprocs);
  for (int r = 0; r < nprocs; ++r)
    sh.block_bytes[r] = (int64_t)n_aggs * msg_sizes[r];
  sh.recv_src_ofs.assign(nprocs, 0);
  int64_t cur = 0;
  for (int src = 0; src < nprocs; ++src) {
    sh.recv_src_ofs[src] = cur;
    cur += msg_sizes[src];
  }
  sh.slab_bytes = cur;
  sh.stage.resize(n_laggs);
  sh.stage_ofs.resize(n_laggs);
  sh.seg_total.assign(n_laggs, 0);
  sh.seg_out.resize(n_laggs);
  for (int j = 0; j < n_laggs; ++j) {
    int64_t o = 0;
    for (int m : sh.members[j]) {
      sh.stage_ofs[j].push_back(o);
      o += sh.block_bytes[m];
      sh.seg_total[j] += msg_sizes[m];
    }
    sh.stage[j].resize(std::max<int64_t>(o, 1));
    sh.seg_out[j].resize(
        std::max<int64_t>((int64_t)n_aggs * sh.seg_total[j], 1));
  }
  sh.seg_in.resize(n_aggs);
  int64_t max_seg = 1;
  for (int j = 0; j < n_laggs; ++j)
    max_seg = std::max(max_seg, sh.seg_total[j]);
  for (int gi = 0; gi < n_aggs; ++gi) sh.seg_in[gi].resize(max_seg);

  std::vector<std::thread> threads;
  threads.reserve(nprocs);
  for (int r = 0; r < nprocs; ++r) {
    threads.emplace_back(cw2_run_rank, &sh, r, ntimes,
                         rep_times_out + (size_t)r * ntimes);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// collective_write3 (l_d_t.c:604-728): shared-window intra hop.
//
// The reference allocates an MPI-3 shared window per node (647-663): every
// group member *fills* its staging region, a fence publishes it, and the
// local aggregator *reads* all members' staging zero-copy via
// MPI_Win_shared_query (667-671) before exchanging hindexed segments
// directly with the destination aggregators (705-711). Threads of one
// process genuinely share memory, so the analog is exact here: the window
// is a plain per-node buffer, the fence is the generation barrier, and the
// aggregator's group pack reads members' staging with NO channel traffic —
// the intra-node hop costs zero messages, unlike cw2's member sends.

namespace {

struct Cw3Shared {
  Runtime* rt;
  int G, nl;
  const int32_t* node_of;
  const int32_t* aggs;
  const int32_t* msg_sizes;
  const int32_t* laggs;
  const uint8_t* send_msgs;
  const int64_t* send_block_ofs;
  uint8_t* recv_out;
  std::vector<std::vector<int>> members;        // per group, ascending
  std::vector<int> group_of_rank;               // rank -> group or -1
  std::vector<int> agg_of_rank;                 // rank -> gi or -1
  std::vector<int64_t> block_bytes;             // per src
  std::vector<int64_t> seg_total;               // per group
  std::vector<int64_t> recv_src_ofs;            // per src
  int64_t slab_bytes = 0;
  std::vector<std::vector<uint8_t>> window;     // per node: shared staging
  std::vector<int64_t> win_ofs;                 // per rank: offset in window
  std::vector<std::vector<uint8_t>> seg_out;    // per group: G segments
  std::vector<std::vector<uint8_t>> seg_in;     // per gi: staging
};

void cw3_run_rank(Cw3Shared* sh, int rank, int ntimes, double* rep_times) {
  Runtime& rt = *sh->rt;
  const int b = sh->node_of[rank];
  const int j_self = sh->group_of_rank[rank];
  const int gi_self = sh->agg_of_rank[rank];
  for (int rep = 0; rep < ntimes; ++rep) {
    double t0 = now_s();
    // window fill (l_d_t.c:647-663): my packed block into the node window
    if (sh->block_bytes[rank] > 0) {
      std::memcpy(sh->window[b].data() + sh->win_ofs[rank],
                  sh->send_msgs + sh->send_block_ofs[rank],
                  sh->block_bytes[rank]);
    }
    // the fence (MPI_Win_fence): staging visible node-wide after this
    {
      std::unique_lock<std::mutex> lk(rt.mu);
      rt.gen_barrier(lk, rt.barrier_waiting, rt.barrier_gen);
    }
    if (j_self >= 0) {
      // zero-copy group read (shared_query, 667-671) + hindexed segment
      // exchange with every destination aggregator (705-711)
      auto& so = sh->seg_out[j_self];
      const int64_t segsz = sh->seg_total[j_self];
      for (int gi = 0; gi < sh->G; ++gi) {
        uint8_t* seg = so.data() + (int64_t)gi * segsz;
        int64_t cur = 0;
        for (int src : sh->members[j_self]) {
          const uint8_t* blk =
              sh->window[sh->node_of[src]].data() + sh->win_ofs[src];
          std::memcpy(seg + cur, blk + (int64_t)gi * sh->msg_sizes[src],
                      sh->msg_sizes[src]);
          cur += sh->msg_sizes[src];
        }
        int dst = sh->aggs[gi];
        if (dst == rank) {
          uint8_t* slab = sh->recv_out + (int64_t)gi * sh->slab_bytes;
          int64_t o = 0;
          for (int src : sh->members[j_self]) {
            std::memcpy(slab + sh->recv_src_ofs[src], seg + o,
                        sh->msg_sizes[src]);
            o += sh->msg_sizes[src];
          }
        } else if (segsz > 0) {
          wl_post_send(rt, rank, dst, seg, segsz);
        }
      }
    }
    if (gi_self >= 0) {
      uint8_t* slab = sh->recv_out + (int64_t)gi_self * sh->slab_bytes;
      auto& in = sh->seg_in[gi_self];
      for (int j = 0; j < sh->nl; ++j) {
        if (sh->laggs[j] == rank) continue;  // own group handled above
        if (sh->seg_total[j] <= 0) continue;
        wl_recv(rt, sh->laggs[j], rank, in.data());
        int64_t o = 0;
        for (int src : sh->members[j]) {
          std::memcpy(slab + sh->recv_src_ofs[src], in.data() + o,
                      sh->msg_sizes[src]);
          o += sh->msg_sizes[src];
        }
      }
    }
    // end-of-rep rendezvous: window + segment buffers reused next rep
    {
      std::unique_lock<std::mutex> lk(rt.mu);
      rt.gen_barrier(lk, rt.barrier_waiting, rt.barrier_gen);
    }
    rep_times[rep] = now_s() - t0;
  }
}

}  // namespace

extern "C" {

// Execute the collective_write3 shared-window route natively. Every
// destination must be a local aggregator (rc=2 otherwise — the reference
// sends only to local_aggregators; use meta mode 1) and no group may span
// nodes (rc=3: a shared window lives on one node).
int agg_run_workload_cw3(int nprocs, int n_aggs, int n_laggs, int nnodes,
                         int ntimes, const int32_t* node_of,
                         const int32_t* aggs, const int32_t* msg_sizes,
                         const int32_t* owner_of, const int32_t* laggs,
                         const uint8_t* send_msgs,
                         const int64_t* send_block_ofs,
                         uint8_t* recv_out, double* rep_times_out) {
  Cw3Shared sh;
  Runtime rt(nprocs);
  sh.rt = &rt;
  sh.G = n_aggs;
  sh.nl = n_laggs;
  sh.node_of = node_of;
  sh.aggs = aggs;
  sh.msg_sizes = msg_sizes;
  sh.laggs = laggs;
  sh.send_msgs = send_msgs;
  sh.send_block_ofs = send_block_ofs;
  sh.recv_out = recv_out;

  sh.group_of_rank.assign(nprocs, -1);
  for (int j = 0; j < n_laggs; ++j) sh.group_of_rank[laggs[j]] = j;
  sh.agg_of_rank.assign(nprocs, -1);
  for (int gi = 0; gi < n_aggs; ++gi) {
    sh.agg_of_rank[aggs[gi]] = gi;
    if (sh.group_of_rank[aggs[gi]] < 0) return 2;  // dst not a local agg
  }
  sh.members.resize(n_laggs);
  for (int r = 0; r < nprocs; ++r) {
    if (owner_of[r] < 0 || owner_of[r] >= nprocs) return 1;
    int j = sh.group_of_rank[owner_of[r]];
    if (j < 0) return 1;
    if (node_of[owner_of[r]] != node_of[r]) return 3;  // group spans nodes
    sh.members[j].push_back(r);
  }
  sh.block_bytes.resize(nprocs);
  for (int r = 0; r < nprocs; ++r)
    sh.block_bytes[r] = (int64_t)n_aggs * msg_sizes[r];
  sh.recv_src_ofs.assign(nprocs, 0);
  int64_t cur = 0;
  for (int src = 0; src < nprocs; ++src) {
    sh.recv_src_ofs[src] = cur;
    cur += msg_sizes[src];
  }
  sh.slab_bytes = cur;
  // per-node shared window: node ranks' blocks back-to-back (rank-ascending)
  sh.window.resize(nnodes);
  sh.win_ofs.assign(nprocs, 0);
  {
    std::vector<int64_t> node_cur(nnodes, 0);
    for (int r = 0; r < nprocs; ++r) {
      int b = node_of[r];
      if (b < 0 || b >= nnodes) return 1;
      sh.win_ofs[r] = node_cur[b];
      node_cur[b] += sh.block_bytes[r];
    }
    for (int b = 0; b < nnodes; ++b)
      sh.window[b].resize(std::max<int64_t>(node_cur[b], 1));
  }
  sh.seg_total.assign(n_laggs, 0);
  sh.seg_out.resize(n_laggs);
  for (int j = 0; j < n_laggs; ++j) {
    for (int m : sh.members[j]) sh.seg_total[j] += msg_sizes[m];
    sh.seg_out[j].resize(
        std::max<int64_t>((int64_t)n_aggs * sh.seg_total[j], 1));
  }
  sh.seg_in.resize(n_aggs);
  int64_t max_seg = 1;
  for (int j = 0; j < n_laggs; ++j)
    max_seg = std::max(max_seg, sh.seg_total[j]);
  for (int gi = 0; gi < n_aggs; ++gi) sh.seg_in[gi].resize(max_seg);

  std::vector<std::thread> threads;
  threads.reserve(nprocs);
  for (int r = 0; r < nprocs; ++r) {
    threads.emplace_back(cw3_run_rank, &sh, r, ntimes,
                         rep_times_out + (size_t)r * ntimes);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

extern "C" {

// Execute the collective_write proxy route natively on a variable-size
// workload. Layouts documented above; rep_times_out is n * ntimes doubles
// (per-rank wall time per rep). Returns 0 on success.
int agg_run_workload_proxy(int nprocs, int nnodes, int n_aggs, int ntimes,
                           const int32_t* node_of, const int32_t* proxies,
                           const int32_t* aggs, const int32_t* msg_sizes,
                           const uint8_t* send_msgs,
                           const int64_t* send_block_ofs,
                           uint8_t* recv_out, double* rep_times_out) {
  WlGeom geom(nprocs, nnodes, n_aggs, node_of, proxies, aggs, msg_sizes);
  Runtime rt(nprocs);
  WlShared sh;
  sh.rt = &rt;
  sh.g = &geom;
  sh.send_msgs = send_msgs;
  sh.send_block_ofs = send_block_ofs;
  sh.recv_out = recv_out;
  sh.aggregate.resize(nnodes);
  for (int b = 0; b < nnodes; ++b)
    sh.aggregate[b].resize(std::max<int64_t>(geom.agg_total[b], 1));
  sh.run_out.resize((int64_t)nnodes * nnodes);
  sh.run_in.resize((int64_t)nnodes * nnodes);
  for (int b1 = 0; b1 < nnodes; ++b1) {
    for (int b2 = 0; b2 < nnodes; ++b2) {
      int64_t sz = std::max<int64_t>(geom.run_bytes[(int64_t)b1 * nnodes + b2], 1);
      sh.run_out[(int64_t)b1 * nnodes + b2].resize(sz);
      sh.run_in[(int64_t)b2 * nnodes + b1].resize(sz);
    }
  }
  sh.deliver.resize(n_aggs);
  for (int gi = 0; gi < n_aggs; ++gi)
    sh.deliver[gi].resize(std::max<int64_t>(geom.slab_bytes, 1));

  std::vector<std::thread> threads;
  threads.reserve(nprocs);
  for (int r = 0; r < nprocs; ++r) {
    threads.emplace_back(wl_run_rank, &sh, r, ntimes,
                         rep_times_out + (size_t)r * ntimes);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

extern "C" {

// Execute one compiled schedule. Arrays are flattened per rank:
//   ops[prog_ofs[r] .. prog_ofs[r+1])   rank r's op program
//   wait_tokens                         shared token-id pool for WAITALLs
//   send_slabs + send_ofs[r]*data_size  rank r's send slabs (contiguous)
//   recv_bufs + recv_ofs[r]*data_size   rank r's recv slabs (contiguous;
//                                       recv_ofs[r] < 0 => rank receives
//                                       nothing)
//   a2a_src_slot/a2a_dst_slot           (n*n) alltoallw slot maps, or null
//   timers_out                          n * ntimes * 5 doubles
// Returns 0 on success.
int agg_run_schedule(int nprocs, int ntimes, int data_size,
                     const NOp* ops, const int32_t* prog_ofs,
                     const int32_t* wait_tokens,
                     const uint8_t* send_slabs, const int32_t* send_ofs,
                     uint8_t* recv_bufs, const int32_t* recv_ofs,
                     const int32_t* a2a_src_slot, const int32_t* a2a_dst_slot,
                     int32_t max_token, double* timers_out) {
  Runtime rt(nprocs);
  std::vector<RankCtx> ctxs(nprocs);
  std::vector<std::vector<Timer5>> timers(nprocs,
                                          std::vector<Timer5>(ntimes));
  std::vector<const uint8_t*> send_bases(nprocs);
  for (int r = 0; r < nprocs; ++r) {
    send_bases[r] = send_slabs + (size_t)send_ofs[r] * data_size;
  }
  for (int r = 0; r < nprocs; ++r) {
    RankCtx& cx = ctxs[r];
    cx.rt = &rt;
    cx.rank = r;
    cx.ops = ops + prog_ofs[r];
    cx.nops = prog_ofs[r + 1] - prog_ofs[r];
    cx.wait_tokens = wait_tokens;
    cx.send_base = send_bases[r];
    cx.recv_base =
        recv_ofs[r] < 0 ? nullptr
                        : recv_bufs + (size_t)recv_ofs[r] * data_size;
    cx.data_size = data_size;
    cx.flags = std::vector<std::atomic<bool>>(max_token + 1);
    cx.timers = timers[r].data();
    cx.all_send_bases = send_bases.data();
    cx.a2a_src_slot = a2a_src_slot;
    cx.a2a_dst_slot = a2a_dst_slot;
  }
  std::vector<std::thread> threads;
  threads.reserve(nprocs);
  for (int r = 0; r < nprocs; ++r) {
    threads.emplace_back(run_rank, &ctxs[r], ntimes);
  }
  for (auto& th : threads) th.join();
  for (int r = 0; r < nprocs; ++r) {
    for (int m = 0; m < ntimes; ++m) {
      const Timer5& t = timers[r][m];
      double* o = timers_out + ((size_t)r * ntimes + m) * 5;
      o[0] = t.post;
      o[1] = t.send_wait;
      o[2] = t.recv_wait;
      o[3] = t.barrier;
      o[4] = t.total;
    }
  }
  return 0;
}

}  // extern "C"
