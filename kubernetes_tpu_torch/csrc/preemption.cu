// Preemption pass: the minimal victim set of every pod a batch left out.
//
// Replaces kubernetes_tpu/ops/solver.py:948 `_preemption_pass.pstep`, an XLA
// scan over the batch's pods (no Pallas source). For each pod p that takes
// part (valid and unplaced after the assignment scan and the gang mask), in
// batch order, over the VictimTable's S slots of every node n (ascending by
// priority and pod key; ops/preemption.py gives the function in full):
//
//   cand(n)   = ok & ~taken & (prio < prio_p)          (int32 compare)
//   L(n)      = base(n) + extra(n)                     (f32, per resource)
//   F_k(n)    = the requests of cand's slots among slots 0..k-1, summed in
//               slot order (F_0 = 0; k counts slots, as in the reference)
//   k(n)      = the least k <= popc(cand) with PodFitsResources(p, L - F_k)
//               (L itself for k = 0), on a statically feasible node
//   node      = argmin over n of (top(n), k(n), n), top = the highest
//               priority of cand's first k(n) set slots, INT32_MIN for k = 0
//   extra(node) += req_p - F_k(node);  taken(node) |= those first k slots
//
// and a gang group's bookings revert where the batch leaves the group if
// one of its taking-part members found no node. The wrapper masks such a
// group's verdicts after the launch.
//
// Design: one thread-block cluster over the node axis, a verdict cache a
// node, and the booking worked out while the keys travel.
//
// - A one-block launch first (`schedule_kernel`) compacts the taking-part
//   pods into `meta` rows {pod, priority, tag | entry << 24, changes |
//   IN_GROUP}: the tag is 1 + the first pod of the batch with the same
//   request bits and priority (its class), `changes` counts the gang_id
//   changes up to the pod, so the walk sees a group boundary wherever it
//   differs from the previous taking-part pod's (the pods between take no
//   part, so a group entered and left among them booked nothing and has
//   nothing to revert: one boundary stands for all of them). It also
//   fills the outputs with (-1, 0). The cluster reads the pods' number
//   from device memory: the wrapper never waits on the card.
// - One cluster of CLUSTER = 16 blocks (a non-portable size) of 512
//   threads, launched with cudaLaunchKernelEx. Block b owns the node range
//   [b*NB, (b+1)*NB), NB = 512 * RUN, and thread t of it the nodes t,
//   t + 512, ..., t + 512*(RUN-1) of the range: a warp's column access is
//   then 32 consecutive nodes (coalesced in device memory, one bank each
//   in shared memory). The pick needs no ownership order: the key below
//   carries the node index. RUN is 2 up to N = 16,384, 8 up to 65,536,
//   and past that a run-time count (the RUN = 0 instance); SH, every
//   column in shared memory (the preemption cell's layout), is an
//   instance of its own with the columns' offsets known when compiling.
// - Verdict cache. A node's verdict for a pod, (feasible, k, top), depends
//   only on the node's ledger row, its taken word and its table, and on
//   the pod's requests and priority; the pod's static row only masks it.
//   So each node keeps E verdicts (E = `entries`, at most 8), direct
//   mapped by class: entry (tag - 1) % E holds one 64-bit word, hi = top ^
//   2^31, lo = tag << 8 | feasible << 6 | k. A pod whose tag is in the
//   entry reuses it; a miss evaluates the node afresh (one loop a thread,
//   its code once) and rewrites the entry. A reused verdict is the value
//   the same arithmetic produced on the same inputs, so the pick is
//   bit-identical to evaluating every node every pod.
// - Evaluation (a miss): the candidate word from the slot priorities
//   (four 128-bit shared loads at S = 16), the fits at k = 0, 1, ... with
//   an early exit, adding one slot's requests at a time, and the first k
//   set slots for `top`. No order of the table is assumed: `top` is the
//   maximum over those slots, as in the reference.
// - Per pod, each thread takes the least key (top ^ 2^31, k, node) of its
//   statically feasible nodes, 64 bits most significant first, so the
//   reference's lexicographic pick is an unsigned minimum; a warp reduces
//   (hi, lo) with two redux.sync, and the lanes of each warp read their
//   slot's requests of the warp's best node (lane s, slot s). One
//   __syncthreads, every warp reduces the 16 warp keys, and warp 0's lanes
//   0..15 send the block's key to every block of the cluster with
//   st.async, each store completing its 16 bytes on the receiving block's
//   mbarrier. Warp 0 waits on its own mbarrier until all 16 keys have
//   landed (warps polling it would take the shared-memory pipe from the
//   booking warp), the block meets at a second __syncthreads, and every
//   warp reduces the 16 keys. There is no cluster barrier a pod.
// - The booking is worked out while the keys travel, by the warp that owns
//   the block's best node: the key's k is that node's (its cached
//   verdict), so F_k is the left-to-right sum of its candidate slots below
//   k, shuffled from their lanes, and the slots taken are its first k
//   candidates (one ballot). The new bookings and avail word follow; the
//   node's slot requests are staged in `s_req`, and lane c < entries
//   evaluates the node's new verdict for entry c's class: this pod's, the
//   next pod's where it maps there, else the class the entry holds (from
//   the first pod of that class's row). If the cluster's key names the
//   node, the warp commits all of it (lane 0 the bookings, avail word and
//   undo entry, lane c entry c); the other blocks only learn the key.
// - Keys of a pod arrive in a slot and on an mbarrier of the pod's parity.
//   A block sends its key of pod j+2 only after it has received every
//   block's key of pod j+1, and every block sends that only after its own
//   first __syncthreads() of pod j+1, which all of its threads pass only
//   after they are done with pod j's slots: no key overwrites one still
//   being read, and a barrier's phase for pod j+2 starts only after its
//   phase for pod j has completed. A wait that never completes traps
//   after ~2^33 cycles (the launch fails, nothing hangs).
// - Placement, from N and S alone (`layout_for`; ops/preemption.py
//   `preemption_layout` is the same function, and the host entry refuses a
//   launch whose layout differs from it). Per node, in this order, each
//   column goes to shared memory if it still fits in the card's limit
//   less STATIC_SMEM: the avail word (ok & ~taken, 4 bytes), the verdict
//   cache (8 bytes an entry, as many entries as fit, up to 8), the batch's
//   bookings (4R), then the read-only allocatable (4R), post-scan ledger
//   (4R) and slot priorities (rows of S rounded up to 16 ints, each
//   16-byte chunk c of node l at c ^ ((l >> 1) & 3), so the eight lanes of
//   a quarter warp reading one chunk of eight nodes hit 32 banks). A
//   mutable column that does not fit lives in a block's `arena` in device
//   memory (the wrapper allocates it), a read-only one is read from the
//   caller's rows through L2, and so are the slots' requests always (N *
//   S * R * 4 bytes). At N = 16,384, S = 16 every column but the requests
//   is shared: 204 KiB a block, 8 entries; at N = 65,536 the avail words
//   and 6 entries: 208 KiB, the rest through L2; at N = 2^24 - 1, the
//   largest the key takes, nothing.
// - Static rows and pod rows are loaded one taking-part pod ahead into
//   registers (RUN > 0), issued while the keys travel; both are
//   prefetched into L2 AHEAD pods before that, and the block's rows of
//   every column read from device memory at the start.
// - Group boundaries: where a pod's `changes` moved, a bad group's
//   bookings are restored from the block's undo log newest first (saved
//   values, never subtracted; thread 0, between two block barriers), their
//   verdicts cleared, and the group entered opens an empty log. The log
//   is a block's [P, 2] float4s in device memory: (node, avail word,
//   extra[0..5]).
// f32 order: L - F_k and then r + that, the bookings as one add of
// (req - F_k), F_k a left-to-right sum, as the reference computes them;
// built with --fmad=false.
//
// Bound on an H100 SXM: the function must read the VictimTable (N * S *
// (4 + 4R + 1) bytes), each taking-part pod's row of the static matrix (N *
// 4 bytes), the ledger and allocatable, and write two i32 a pod: ~0.08 ms
// at 3.35 TB/s for the preemption cell's 3,750 pods on 16,384 nodes; its
// operations (candidates, ledger and fits up to each node's k) are below
// that. The pass is a serial chain over the pods: each pod's pick needs
// the previous pod's booking, so the cost is a block reduction, one
// cluster exchange and the booking warp's work a pod, not bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 6;                   // state/layout.py Resource.COUNT
constexpr int PODS = 0, CPU = 1, MEMORY = 2, GPU = 3, SCRATCH = 4, OVERLAY = 5;
constexpr int CLUSTER = 16;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STATIC_SMEM = 2048;      // wslot, cslot, the mbarriers and s_req, rounded up
constexpr int MAX_ENTRIES = 8;         // verdicts a node
constexpr int MAX_SLOTS = 32;
constexpr int MAX_NODES = 1 << 24;     // the key's node field
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr long long WAIT_LIMIT = 1LL << 33;   // cycles (seconds): a lost key
constexpr int INT32_MIN_ = -2147483647 - 1;
constexpr int INT32_MAX_ = 2147483647;
constexpr unsigned KEY_BYTES = 16;
constexpr int AHEAD = 4;               // static rows prefetched into L2, in pods
// a meta row's last word: the gang_id changes so far, IN_GROUP if gang_id > 0
constexpr int CHANGES = (1 << 30) - 1, IN_GROUP = 1 << 30;
// a meta row's tag word: the class tag, its cache entry in bits 24..31
constexpr unsigned TAG = (1u << 24) - 1;
constexpr int SCHEDULE_THREADS = 1024;
// a verdict word's low half: tag << 8 | FEASIBLE | k
constexpr unsigned FEASIBLE = 0x40u, K_MASK = 0x3fu;

// the columns of a node, in placement order
enum Column { AVAIL, CACHE, EXTRA, ALLOC, BASE, PRIO, COLUMNS };

struct Layout {
  int run;          // nodes a thread
  int nb;           // nodes a block: THREADS * run
  int entries;      // verdicts a node
  int shared;       // bit c: column c in shared memory
  long long smem;   // dynamic shared bytes a block
  long long arena;  // a block's mutable columns in device memory, bytes
};

// the ints of a node's row of slot priorities in shared memory
__host__ __device__ constexpr int prio_row(int S) { return (S + 15) & ~15; }

// ops/preemption.py preemption_layout, for N nodes, S slots and the card's
// opt-in shared memory a block (232,448 bytes on an H100)
inline Layout layout_for(int N, int S, long long smem_limit) {
  const long long budget = smem_limit - STATIC_SMEM;
  Layout L;
  const int per_block = (N + CLUSTER - 1) / CLUSTER;
  const int run = (per_block + THREADS - 1) / THREADS;
  L.run = run <= 2 ? 2 : run <= 8 ? 8 : run;
  L.nb = L.run * THREADS;
  const long long nb = L.nb;
  // (the priorities' shared rows: S rounded up to 16 ints, swizzled)
  const long long sizes[COLUMNS] = {4 * nb, 0, 4 * R * nb, 4 * R * nb, 4 * R * nb,
                                    4LL * prio_row(S) * nb};
  long long used = 0, arena = 0;
  L.shared = 0;
  L.entries = MAX_ENTRIES;
  for (int c = 0; c < COLUMNS; ++c) {
    long long size = sizes[c];
    if (c == CACHE) {
      const long long fit = (budget - used) / (8 * nb);
      L.entries = fit >= 1 ? (int)(fit < MAX_ENTRIES ? fit : MAX_ENTRIES) : MAX_ENTRIES;
      size = 8 * nb * L.entries;
    }
    if (used + size <= budget) {
      L.shared |= 1 << c;
      used += size;
    } else if (c <= EXTRA) {
      arena += size;
    }
  }
  L.smem = used;
  L.arena = arena;
  return L;
}

// A column of the block's nodes: element (l, q) at p[l + q * NB], in
// shared memory, when NB > 0 (known when compiling), else at p[l * ls +
// q * qs].
template <typename T, int NB>
struct Col {
  T* p;
  int ls, qs;
  __device__ __forceinline__ T& operator()(int l, int q = 0) const {
    if constexpr (NB > 0) {
      return p[l + q * NB];
    } else {
      return p[(size_t)l * ls + (size_t)q * qs];
    }
  }
};

// The block's slot priorities, four slots a 16-byte chunk. In shared
// memory (`rows`, always when NB > 0): rows of prio_row(S) ints, chunk c
// of node l at chunk c ^ ((l >> 1) & 3) of its row, so the eight lanes of
// a quarter warp reading chunk c of eight consecutive nodes hit 32
// different banks; else the caller's [N, S] rows from the block's first
// node.
template <int NB>
struct Prio {
  const int* p;
  int S;
  bool rows;
  __device__ __forceinline__ int4 chunk(int l, int c) const {
    if (NB > 0 || rows) {
      return *reinterpret_cast<const int4*>(p + l * prio_row(S) + ((c ^ ((l >> 1) & 3)) << 2));
    } else {
      const int* row = p + (size_t)l * S + 4 * c;
      if (S % 4 == 0) return __ldg(reinterpret_cast<const int4*>(row));
      return make_int4(__ldg(row), 4 * c + 1 < S ? __ldg(row + 1) : 0,
                       4 * c + 2 < S ? __ldg(row + 2) : 0, 4 * c + 3 < S ? __ldg(row + 3) : 0);
    }
  }
  __device__ __forceinline__ int operator()(int l, int s) const {
    if (NB > 0 || rows) {
      return p[l * prio_row(S) + (((s >> 2) ^ ((l >> 1) & 3)) << 2) + (s & 3)];
    } else {
      return __ldg(p + (size_t)l * S + s);
    }
  }
};

template <int NB>
struct Nodes {
  Col<uint32_t, NB> avail;              // ok & ~taken, a bit a slot
  Col<unsigned long long, NB> cache;    // [entry] verdict words
  Col<float, NB> extra;                 // the batch's bookings
  Col<const float, NB> alloc, base;
  Prio<NB> prio;
  const float* req;                     // f32[N, S, R] the slots' requests
  int S, entries;
};

struct Args {
  const float* alloc;      // f32[N, R]
  const float* base;       // f32[N, R] the post-scan ledger
  const float* masked;     // f32[P, N] -inf: statically infeasible
  const float* req_p;      // f32[P, R]
  const int* prio_p;       // i32[P]
  const int4* meta;        // i32[P, 4] the taking-part pods, in order (M rows)
  const int* m_count;      // M, written by schedule_kernel
  const int* v_prio;       // i32[N, S]
  const float* v_req;      // f32[N, S, R]
  const uint8_t* v_ok;     // bool[N, S]
  int* out_node;           // i32[P], -1 (schedule_kernel) where no verdict
  int* out_k;              // i32[P], 0 (schedule_kernel) where no verdict
  float4* undo;            // f32[CLUSTER, P, 8] undo log a block
  unsigned char* arena;    // u8[CLUSTER, arena bytes]
  int P, N, S;
  Layout lay;
};

// ---- PTX: mbarriers and st.async to another block of the cluster (as
// csrc/assign_scan.cu)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of stores for the barrier's phase.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity; trap if it never completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long start = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - start > WAIT_LIMIT) __trap();
}

// 16 bytes into another block's shared memory; the store completes its
// bytes on that block's mbarrier.
__device__ __forceinline__ void st_async_v4(unsigned remote, int4 v, unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// `bytes` from `p` into L2, a 128-byte line a thread of `threads` from
// thread `t`
__device__ __forceinline__ void prefetch_range(const void* p, size_t bytes, int t,
                                               int threads) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = (size_t)t * 128; off < bytes; off += (size_t)threads * 128)
    prefetch_l2(c + off);
}

// ---- the pass's arithmetic

// PodFitsResources against one adjusted ledger row (ops/predicates.py
// fits_resources_dyn with gpu and storage dynamic)
__device__ __forceinline__ bool fits(const float a[R], const float r[R],
                                     const float led[R], bool all_zero) {
  if (!(led[PODS] + 1.0f <= a[PODS])) return false;
  if (all_zero) return true;
  const bool basic = a[CPU] >= r[CPU] + led[CPU] && a[MEMORY] >= r[MEMORY] + led[MEMORY]
                     && a[GPU] >= r[GPU] + led[GPU];
  bool storage;
  if (a[OVERLAY] == 0.0f) {
    storage = a[SCRATCH] >= (r[SCRATCH] + r[OVERLAY]) + (led[OVERLAY] + led[SCRATCH]);
  } else {
    storage = a[SCRATCH] >= r[SCRATCH] + led[SCRATCH] && a[OVERLAY] >= r[OVERLAY] + led[OVERLAY];
  }
  return basic && storage;
}

// The node's candidate slots, among its `live` ones, for a pod of this
// priority.
template <class V>
__device__ __forceinline__ uint32_t candidates(const V& v, int l, uint32_t live,
                                               int prio_p) {
  uint32_t lower = 0u;
#pragma unroll
  for (int c = 0; c < MAX_SLOTS / 4; ++c) {
    if (4 * c < v.S) {
      const int4 x = v.prio.chunk(l, c);
      lower |= (x.x < prio_p ? 1u : 0u) << (4 * c) | (x.y < prio_p ? 2u : 0u) << (4 * c)
               | (x.z < prio_p ? 4u : 0u) << (4 * c) | (x.w < prio_p ? 8u : 0u) << (4 * c);
    }
  }
  return live & lower;
}

// The node's ledger row: the post-scan ledger plus the batch's bookings.
template <class V>
__device__ __forceinline__ void ledger(const V& v, int l, float led[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) led[q] = v.base(l, q) + v.extra(l, q);
}

// The node's k for these candidates against this ledger row (-1: no set),
// and its F_k, its first k candidate slots and their highest priority;
// `rq` is the node's [S, R] slot requests.
template <class V>
__device__ __forceinline__ int fit_k(const V& v, int l, const float* rq, uint32_t cand,
                                     const float led[R], const float r[R], bool all_zero,
                                     float F[R], uint32_t& chosen, int& top) {
  const int count = __popc(cand);
  float a[R], adj[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    a[q] = v.alloc(l, q);
    F[q] = 0.0f;
  }
  int k = -1;
  for (int kk = 0; kk <= count; ++kk) {
    if (kk == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) adj[q] = led[q];
    } else {
      if ((cand >> (kk - 1)) & 1u) {
#pragma unroll
        for (int q = 0; q < R; ++q) F[q] = F[q] + rq[(kk - 1) * R + q];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) adj[q] = led[q] - F[q];
    }
    if (fits(a, r, adj, all_zero)) {
      k = kk;
      break;
    }
  }
  chosen = 0u;
  top = INT32_MIN_;
  uint32_t c = cand;
  for (int x = 0; x < k; ++x) {
    const uint32_t bit = c & (0u - c);
    chosen |= bit;
    top = max(top, v.prio(l, __ffs(bit) - 1));
    c &= c - 1u;
  }
  return k;
}

// A verdict word: hi = top ^ 2^31, lo = tag << 8 | FEASIBLE | k (tag << 8
// alone without a set).
__device__ __forceinline__ unsigned long long pack(int k, int top, unsigned tag) {
  const unsigned lo = tag << 8;
  if (k < 0) return lo;
  return ((unsigned long long)((uint32_t)top ^ 0x80000000u) << 32) | lo | FEASIBLE
         | (unsigned)k;
}

// The node's verdict word for a class, from its live slots and ledger row.
template <class V>
__device__ __forceinline__ unsigned long long verdict(const V& v, int l, const float* rq,
                                                      uint32_t live, const float led[R],
                                                      int prio_c, const float r[R],
                                                      bool all_zero, unsigned tag) {
  float F[R];
  uint32_t chosen;
  int top;
  const int k = fit_k(v, l, rq, candidates(v, l, live, prio_c), led, r, all_zero, F,
                      chosen, top);
  return pack(k, top, tag);
}

// The taking-part pods' rows, their requests and static rows, one pod
// ahead in registers; RUN = 0 reads the static row at its use.
__device__ __forceinline__ void load_req(const float* req_p, int pod, float r[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) r[q] = __ldg(req_p + (size_t)pod * R + q);
}

template <int RUN>
__device__ __forceinline__ void load_row(const Args& g, int pod, int n0, int t, float m[]) {
  if constexpr (RUN > 0) {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const int node = n0 + t + j * THREADS;
      m[j] = node < g.N ? __ldg(g.masked + (size_t)pod * g.N + node) : -INFINITY;
    }
  }
}

__device__ __forceinline__ bool requests_zero(const float r[R]) {
  return r[CPU] == 0.0f && r[MEMORY] == 0.0f && r[GPU] == 0.0f && r[SCRATCH] == 0.0f
         && r[OVERLAY] == 0.0f;
}

// this block's segment of a pod's static row into L2, a line a thread,
// and the pod's requests
__device__ __forceinline__ void prefetch_pod(const Args& g, int pod, int n0, int nb, int t) {
  const int first = n0 + t * 32;
  if (t * 32 < nb && first < g.N) prefetch_l2(g.masked + (size_t)pod * g.N + first);
  if (t == THREADS - 1) prefetch_l2(g.req_p + (size_t)pod * R);
}

// RUN nodes a thread (0: a run-time count); SH: every column in shared
// memory, at offsets known when compiling (the preemption cell's layout)
template <int RUN, bool SH>
__global__ void __launch_bounds__(THREADS, 1) preemption_kernel(Args g) {
  constexpr int NBC = SH ? RUN * THREADS : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint2 wslot[2][WARPS];
  __shared__ __align__(16) int4 cslot[2][CLUSTER];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float s_req[MAX_SLOTS * R];   // the booked node's slot requests

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int N = g.N, S = g.S, nb = SH ? NBC : g.lay.nb;
  const int run = RUN > 0 ? RUN : g.lay.run;
  const int n0 = rank * nb;

  // ---- the block's columns: shared memory, its arena, or the caller's rows
  unsigned char* sp = smem;
  unsigned char* ap = g.arena + (size_t)rank * g.lay.arena;
  auto carve = [&](int c, size_t bytes) -> unsigned char* {
    unsigned char*& q = (SH || ((g.lay.shared >> c) & 1)) ? sp : ap;
    unsigned char* at = q;
    q += bytes;
    return at;
  };
  Nodes<NBC> v;
  v.S = S;
  v.entries = g.lay.entries;
  v.req = g.v_req;
  v.avail = {reinterpret_cast<uint32_t*>(carve(AVAIL, (size_t)4 * nb)), 1, nb};
  v.cache = {reinterpret_cast<unsigned long long*>(carve(CACHE, (size_t)8 * nb * v.entries)),
             1, nb};
  v.extra = {reinterpret_cast<float*>(carve(EXTRA, (size_t)4 * R * nb)), 1, nb};
  const bool sh_alloc = SH || ((g.lay.shared >> ALLOC) & 1);
  const bool sh_base = SH || ((g.lay.shared >> BASE) & 1);
  const bool sh_prio = SH || ((g.lay.shared >> PRIO) & 1);
  float* s_alloc = reinterpret_cast<float*>(sp);
  if (sh_alloc) sp += (size_t)4 * R * nb;
  float* s_base = reinterpret_cast<float*>(sp);
  if (sh_base) sp += (size_t)4 * R * nb;
  int* s_prio = reinterpret_cast<int*>(sp);
  v.alloc = sh_alloc ? Col<const float, NBC>{s_alloc, 1, nb}
                     : Col<const float, NBC>{g.alloc + (size_t)n0 * R, R, 1};
  v.base = sh_base ? Col<const float, NBC>{s_base, 1, nb}
                   : Col<const float, NBC>{g.base + (size_t)n0 * R, R, 1};
  v.prio = sh_prio ? Prio<NBC>{s_prio, S, true} : Prio<NBC>{g.v_prio + (size_t)n0 * S, S, false};

  // ---- the block's nodes: avail words, no bookings, no verdicts, and the
  // shared copies of the read-only columns (a node past N: nothing)
  for (int j = 0; j < run; ++j) {
    const int l = t + j * THREADS;
    const int node = n0 + l;
    const bool in = node < N;
    uint32_t okw = 0u;
    for (int s = 0; s < S; ++s)
      if (in && g.v_ok[(size_t)node * S + s]) okw |= 1u << s;
    if (sh_prio)   // (padding slots: never live)
      for (int s = 0; s < prio_row(S); ++s)
        s_prio[l * prio_row(S) + (((s >> 2) ^ ((l >> 1) & 3)) << 2) + (s & 3)] =
            in && s < S ? g.v_prio[(size_t)node * S + s] : 0;
    v.avail(l) = okw;
    for (int e = 0; e < v.entries; ++e) v.cache(l, e) = 0ull;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v.extra(l, q) = 0.0f;
      if (sh_alloc) s_alloc[q * nb + l] = in ? g.alloc[(size_t)node * R + q] : 0.0f;
      if (sh_base) s_base[q * nb + l] = in ? g.base[(size_t)node * R + q] : 0.0f;
    }
  }
  const int M = *g.m_count;   // the taking-part pods (schedule_kernel)

  // ---- into L2: the block's rows of the columns read from device memory,
  // and the first pods' static rows
  {
    const size_t live = (size_t)max(0, min(nb, N - n0));
    prefetch_range(g.v_req + (size_t)n0 * S * R, live * S * R * 4, t, THREADS);
    if (!sh_prio) prefetch_range(g.v_prio + (size_t)n0 * S, live * S * 4, t, THREADS);
    if (!sh_alloc) prefetch_range(g.alloc + (size_t)n0 * R, live * R * 4, t, THREADS);
    if (!sh_base) prefetch_range(g.base + (size_t)n0 * R, live * R * 4, t, THREADS);
    for (int j = 0; j < min(AHEAD, M); ++j) prefetch_pod(g, g.meta[j].x, n0, nb, t);
  }

  // ---- one mbarrier per pod parity: a phase completes when this block has
  // armed it and the keys of all CLUSTER blocks (16 bytes each) landed
  if (t == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&bar[0], CLUSTER * KEY_BYTES);
    mbar_arm(&bar[1], CLUSTER * KEY_BYTES);
  }
  // where warp 0's lane l sends this block's key: block l's slot `rank`
  // and mbarrier, of each parity
  unsigned to_slot0 = 0u, to_slot1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (warp == 0 && lane < CLUSTER) {
    to_slot0 = map_rank(smem_u32(&cslot[0][rank]), lane);
    to_slot1 = map_rank(smem_u32(&cslot[1][rank]), lane);
    to_bar0 = map_rank(smem_u32(&bar[0]), lane);
    to_bar1 = map_rank(smem_u32(&bar[1]), lane);
  }
  cluster.sync();   // every block's nodes and barriers are ready

  float4* undo = g.undo + (size_t)rank * g.P * 2;
  int nlog = 0, changes = 0;
  bool bad = false, in_group = false;
  // the current and the next taking-part pod's rows, one pod ahead
  int4 mc = make_int4(0, 0, 0, 0), mx = mc;
  float rc[R], rx[R];
  float mr[RUN > 0 ? RUN : 1], mn[RUN > 0 ? RUN : 1];
  if (M > 0) {
    mc = g.meta[0];
    load_req(g.req_p, mc.x, rc);
    load_row<RUN>(g, mc.x, n0, t, mr);
    if (M > 1) mx = g.meta[1];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) rx[q] = 0.0f;
  // the pod whose static row this pod prefetches, AHEAD pods on
  int pf = AHEAD < M ? g.meta[AHEAD].x : 0;

  for (int j = 0; j < M; ++j) {
    const int pod = mc.x, prio_p = mc.y;
    const unsigned tag = (unsigned)mc.z & TAG;
    const int e = (int)((unsigned)mc.z >> 24);

    // ---- a group boundary: gang_id changed since the previous taking-part
    // pod (the same for every thread of every block)
    if ((mc.w & CHANGES) != changes) {
      changes = mc.w & CHANGES;
      if (in_group && bad) {
        __syncthreads();   // the block's bookings and log are written
        if (t == 0) {
          for (int x = nlog - 1; x >= 0; --x) {
            const float4 a = undo[2 * x], b = undo[2 * x + 1];
            const int l = __float_as_int(a.x);
            v.avail(l) = __float_as_uint(a.y);
            v.extra(l, 0) = a.z;
            v.extra(l, 1) = a.w;
            v.extra(l, 2) = b.x;
            v.extra(l, 3) = b.y;
            v.extra(l, 4) = b.z;
            v.extra(l, 5) = b.w;
            for (int c = 0; c < v.entries; ++c) v.cache(l, c) = 0ull;
          }
        }
        __syncthreads();   // the restored nodes are visible to their owners
      }
      nlog = 0;
      bad = false;
      in_group = (mc.w & IN_GROUP) != 0;
    }
    const bool all_zero = requests_zero(rc);

    // ---- this thread's least key: cached verdicts, then the misses
    // evaluated (one loop: its code once)
    uint32_t bhi = NONE, blo = NONE;
    auto consider = [&](unsigned long long w, int node) {
      if ((unsigned)w & FEASIBLE) {
        const uint32_t hi = (uint32_t)(w >> 32);
        const uint32_t lo = (((unsigned)w & K_MASK) << 24) | (uint32_t)node;
        if (hi < bhi || (hi == bhi && lo < blo)) {
          bhi = hi;
          blo = lo;
        }
      }
    };
    auto evaluate = [&](int l) {
      float led[R];
      ledger(v, l, led);
      const unsigned long long w = verdict(v, l, v.req + (size_t)(n0 + l) * S * R,
                                           v.avail(l), led, prio_p, rc, all_zero, tag);
      v.cache(l, e) = w;
      consider(w, n0 + l);
    };
    if constexpr (RUN > 0) {
      uint32_t miss = 0u;
#pragma unroll
      for (int jj = 0; jj < RUN; ++jj) {
        const int l = t + jj * THREADS;
        if (!(mr[jj] > -INFINITY)) continue;   // (a node past N reads -inf)
        const unsigned long long w = v.cache(l, e);
        if (((unsigned)w >> 8) != tag) {
          miss |= 1u << jj;
        } else {
          consider(w, n0 + l);
        }
      }
#pragma unroll 1
      for (; miss != 0u; miss &= miss - 1u) evaluate(t + (__ffs(miss) - 1) * THREADS);
    } else {
      for (int jj = 0; jj < run; ++jj) {
        const int l = t + jj * THREADS;
        if (n0 + l >= N) break;
        if (!(__ldg(g.masked + (size_t)pod * N + n0 + l) > -INFINITY)) continue;
        const unsigned long long w = v.cache(l, e);
        if (((unsigned)w >> 8) != tag) {
          evaluate(l);
        } else {
          consider(w, n0 + l);
        }
      }
    }

    // ---- the warp's and the block's least key; warp 0 sends the block's
    const int par = j & 1;
    // (lane s reads slot s's requests of its warp's best node while the
    // block reduces: if the node is the block's best, its booking uses
    // them)
    float rq[R];
    {
      const uint32_t h = __reduce_min_sync(FULL, bhi);
      const uint32_t lo = __reduce_min_sync(FULL, bhi == h ? blo : NONE);
      if (lane == 0) wslot[par][warp] = make_uint2(h, lo);
#pragma unroll
      for (int q = 0; q < R; ++q) rq[q] = 0.0f;
      if (lo != NONE && lane < S)
        load_req(v.req + (size_t)(lo & 0xFFFFFFu) * S * R, lane, rq);
    }
    __syncthreads();
    uint32_t bh, bl;
    {
      const uint2 w = lane < WARPS ? wslot[par][lane] : make_uint2(NONE, NONE);
      bh = __reduce_min_sync(FULL, w.x);
      bl = __reduce_min_sync(FULL, w.x == bh ? w.y : NONE);
    }
    if (warp == 0 && lane < CLUSTER)
      st_async_v4(par ? to_slot1 : to_slot0, make_int4((int)bh, (int)bl, 0, 0),
                  par ? to_bar1 : to_bar0);
    // the next pod's rows while the keys travel, and a later pod's static
    // row into L2
    int4 mnext = mx;
    if (j + 1 < M) {
      load_req(g.req_p, mx.x, rx);
      load_row<RUN>(g, mx.x, n0, t, mn);
      if (j + 2 < M) mnext = g.meta[j + 2];
    }
    if (j + AHEAD < M) {
      prefetch_pod(g, pf, n0, nb, t);
      if (j + AHEAD + 1 < M) pf = g.meta[j + AHEAD + 1].x;
    }

    // ---- the booking of the block's best node, worked out while the keys
    // travel by the warp that owns it, lane s with slot s: the key's k is
    // the node's (its cached verdict, the same arithmetic on the same
    // state), so F_k is the left-to-right sum of its candidate slots below
    // k and the slots taken its first k candidates. Then lane c < entries
    // evaluates the node's new verdict for entry c's class: this pod's, the
    // next pod's where it maps there, else the class the entry holds (from
    // its first pod's row), from the slot requests staged in s_req.
    const int lb = (int)(bl & 0xFFFFFFu) - n0;
    const bool spec = bl != NONE && warp == (lb % THREADS) >> 5;
    const bool next_other = j + 1 < M && ((unsigned)mx.z & TAG) != tag;
    const int e_next = (int)((unsigned)mx.z >> 24);
    float ext0[R], ext1[R];
    uint32_t avail0 = 0u, avail1 = 0u;
    unsigned long long word = 0ull;
    bool job = false;
    if (spec) {
      unsigned tag_c = 0u;
      int prio_c = prio_p;
      float r_c[R];
#pragma unroll
      for (int q = 0; q < R; ++q) r_c[q] = rc[q];
      if (lane < v.entries) {
        if (next_other && lane == e_next) {
          tag_c = (unsigned)mx.z & TAG;
          prio_c = mx.y;
#pragma unroll
          for (int q = 0; q < R; ++q) r_c[q] = rx[q];
        } else if (lane == e) {
          tag_c = tag;
        } else {
          tag_c = (unsigned)v.cache(lb, lane) >> 8;
          if (tag_c != 0u) {
            prio_c = __ldg(g.prio_p + tag_c - 1);
            load_req(g.req_p, (int)tag_c - 1, r_c);
          }
        }
      }
      job = tag_c != 0u;
      avail0 = v.avail(lb);
      const int prio_s = lane < S ? v.prio(lb, lane) : INT32_MAX_;
      const uint32_t cand = avail0 & __ballot_sync(FULL, prio_s < prio_p);
      const int k = (int)(bl >> 24);
      float F[R];
#pragma unroll
      for (int q = 0; q < R; ++q) F[q] = 0.0f;
      for (int x = 0; x < k; ++x) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float y = __shfl_sync(FULL, rq[q], x);
          if ((cand >> x) & 1u) F[q] = F[q] + y;
        }
      }
      const bool in = ((cand >> lane) & 1u) && __popc(cand & ((1u << lane) - 1u)) < k;
      avail1 = avail0 & ~__ballot_sync(FULL, in);
      float led[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        ext0[q] = v.extra(lb, q);
        ext1[q] = ext0[q] + (rc[q] - F[q]);
        led[q] = v.base(lb, q) + ext1[q];
      }
      if (lane < S) {
#pragma unroll
        for (int q = 0; q < R; ++q) s_req[lane * R + q] = rq[q];
      }
      __syncwarp();
      if (job) word = verdict(v, lb, s_req, avail1, led, prio_c, r_c, requests_zero(r_c), tag_c);
    }

    // ---- the cluster's least key: warp 0 waits for the keys, the other
    // warps at the block barrier (warps polling the mbarrier would take
    // the shared-memory pipe from the booking warp)
    if (warp == 0) {
      mbar_wait(&bar[par], (j >> 1) & 1);
      if (lane == 0) mbar_arm(&bar[par], CLUSTER * KEY_BYTES);   // for pod j+2
    }
    __syncthreads();
    const int4 c4 = cslot[par][lane & (CLUSTER - 1)];
    const uint32_t key_hi = __reduce_min_sync(FULL, (uint32_t)c4.x);
    const uint32_t key_lo = __reduce_min_sync(FULL, (uint32_t)c4.x == key_hi ? (uint32_t)c4.y : NONE);

    // ---- the booking: this block's best node picked, its warp commits
    if (key_lo == NONE) {
      bad = bad || in_group;
    } else {
      if (rank == 0 && t == 0) {
        g.out_node[pod] = (int)(key_lo & 0xFFFFFFu);
        g.out_k[pod] = (int)(key_lo >> 24);
      }
      if (key_lo == bl) {   // (the least key names one node)
        if (spec) {
          if (lane == 0) {
            if (in_group) {
              undo[2 * nlog] = make_float4(__int_as_float(lb), __uint_as_float(avail0),
                                           ext0[0], ext0[1]);
              undo[2 * nlog + 1] = make_float4(ext0[2], ext0[3], ext0[4], ext0[5]);
            }
#pragma unroll
            for (int q = 0; q < R; ++q) v.extra(lb, q) = ext1[q];
            v.avail(lb) = avail1;
          }
          if (lane < v.entries) v.cache(lb, lane) = word;   // (0: no class)
          __syncwarp();   // the node's owner lane reads them next pod
        }
        if (in_group) ++nlog;
      }
    }

    mc = mx;
    mx = mnext;
#pragma unroll
    for (int q = 0; q < R; ++q) rc[q] = rx[q];
    if constexpr (RUN > 0) {
#pragma unroll
      for (int jj = 0; jj < RUN; ++jj) mr[jj] = mn[jj];
    }
  }
  cluster.sync();   // no block leaves while another may still store into it
}

// The taking-part pods in batch order, as the cluster walks them
// (ops/preemption.py `pass_schedule` is its plain version): meta[pos] =
// {pod, priority, tag | entry << 24, changes | IN_GROUP where gang_id >
// 0}, pos the pod's rank among the taking-part pods, changes the gang_id
// changes in pods 0..pod (gang_id 0 before the batch), tag 1 + the first
// pod of the batch with the same request bits and priority, entry (tag -
// 1) % entries; *m_count = their number; and every pod's outputs (-1, 0).
// One block: a chunked scan of (takes part, changes); each taking-part
// pod's thread looks for its first equal row from pod 0 on (a warp reads
// one row at a time: ~20 cycles a row, P^2 / 2 rows when all differ).
__global__ void __launch_bounds__(SCHEDULE_THREADS) schedule_kernel(
    const float* req_p, const int* prio_p, const uint8_t* part, const int* gang_id, int P,
    int entries, int4* meta, int* m_count, int* out_node, int* out_k) {
  constexpr int W = SCHEDULE_THREADS / 32;
  __shared__ int2 s_warp[W];
  __shared__ int2 s_base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_base = make_int2(0, 0);
  __syncthreads();
  const unsigned* bits = reinterpret_cast<const unsigned*>(req_p);
  for (int c = 0; c < P; c += SCHEDULE_THREADS) {
    const int i = c + t;
    int takes = 0, change = 0, gid = 0;
    if (i < P) {
      out_node[i] = -1;   // (the cluster writes each pod's verdict it finds)
      out_k[i] = 0;
      takes = part[i] ? 1 : 0;
      gid = gang_id[i];
      change = gid != (i > 0 ? gang_id[i - 1] : 0);
    }
    int a = takes, b = change;   // inclusive scans in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ya = __shfl_up_sync(FULL, a, off);
      const int yb = __shfl_up_sync(FULL, b, off);
      if (lane >= off) {
        a += ya;
        b += yb;
      }
    }
    if (lane == 31) s_warp[warp] = make_int2(a, b);
    __syncthreads();
    if (warp == 0) {   // the warps' exclusive offsets
      const int2 w = lane < W ? s_warp[lane] : make_int2(0, 0);
      int wa = w.x, wb = w.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ya = __shfl_up_sync(FULL, wa, off);
        const int yb = __shfl_up_sync(FULL, wb, off);
        if (lane >= off) {
          wa += ya;
          wb += yb;
        }
      }
      if (lane < W) s_warp[lane] = make_int2(wa - w.x, wb - w.y);
    }
    __syncthreads();
    const int2 base = s_base;
    const int2 wo = s_warp[warp];
    if (takes) {
      unsigned row[R];
#pragma unroll
      for (int q = 0; q < R; ++q) row[q] = __ldg(bits + (size_t)i * R + q);
      const int prio = prio_p[i];
      int first = i;
      for (int j = 0; j < i; ++j) {
        bool same = __ldg(prio_p + j) == prio;
#pragma unroll
        for (int q = 0; q < R; ++q) same = same && __ldg(bits + (size_t)j * R + q) == row[q];
        if (same) {
          first = j;
          break;
        }
      }
      meta[base.x + wo.x + a - 1] = make_int4(
          i, prio, (first + 1) | (first % entries) << 24,
          (base.y + wo.y + b) | (gid > 0 ? IN_GROUP : 0));
    }
    __syncthreads();   // every thread has read s_base and s_warp
    if (t == SCHEDULE_THREADS - 1) s_base = make_int2(base.x + wo.x + a, base.y + wo.y + b);
    __syncthreads();
  }
  if (t == 0) *m_count = s_base.x;
}

template <int RUN, bool SH>
int launch(const Args& g, cudaStream_t stream) {
  auto kernel = preemption_kernel<RUN, SH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.lay.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = (size_t)g.lay.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  // a cluster the card cannot place is an error, never a smaller launch
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The pass: schedule_kernel, then one cluster launch over the taking-part
// pods it wrote to `meta` (i32[P, 4]) and `m_count`. The layout the
// wrapper computed (nodes a thread, entries, shared columns, shared and
// arena bytes) must be layout_for(N, S, smem_limit): anything else is
// refused with cudaErrorInvalidValue, as are N >= 2^24, P >= 2^24 (a tag
// is 24 bits) and S outside 1..32. Returns cudaGetLastError() (or a
// launch's error).
extern "C" int ktpu_preemption_pass(
    const float* alloc, const float* base, const float* masked, const float* req_p,
    const int* prio_p, const uint8_t* part, const int* gang_id, const int* v_prio,
    const float* v_req, const uint8_t* v_ok, int* out_node, int* out_k, int* meta,
    int* m_count, float* undo, unsigned char* arena, int P, int N, int S, int run,
    int entries, int shared, long long smem, long long arena_bytes, long long smem_limit,
    cudaStream_t stream) {
  if (S < 1 || S > MAX_SLOTS || N < 1 || N >= MAX_NODES || P < 0 || P >= MAX_NODES)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout_for(N, S, smem_limit);
  if (lay.run != run || lay.entries != entries || lay.shared != shared || lay.smem != smem
      || lay.arena != arena_bytes)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  schedule_kernel<<<1, SCHEDULE_THREADS, 0, stream>>>(
      req_p, prio_p, part, gang_id, P, lay.entries, reinterpret_cast<int4*>(meta), m_count,
      out_node, out_k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args g;
  g.alloc = alloc;
  g.base = base;
  g.masked = masked;
  g.req_p = req_p;
  g.prio_p = prio_p;
  g.meta = reinterpret_cast<const int4*>(meta);
  g.m_count = m_count;
  g.v_prio = v_prio;
  g.v_req = v_req;
  g.v_ok = v_ok;
  g.out_node = out_node;
  g.out_k = out_k;
  g.undo = reinterpret_cast<float4*>(undo);
  g.arena = arena;
  g.P = P;
  g.N = N;
  g.S = S;
  g.lay = lay;
  if (lay.run == 2)
    return lay.shared == (1 << COLUMNS) - 1 ? launch<2, true>(g, stream)
                                            : launch<2, false>(g, stream);
  if (lay.run == 8) return launch<8, false>(g, stream);
  return launch<0, false>(g, stream);
}
