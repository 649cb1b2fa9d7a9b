// Serial assignment scan (Phase B of the batch solver) in one launch.
//
// Replaces the XLA `lax.scan` of kubernetes_tpu/ops/solver.py::schedule_batch
// (`step`, solver.py:733-811, and `_select_host`, :595-614), which has no
// Pallas source. For each pod p in order, against the ledger carried from
// pods 0..p-1:
//   1. feasible = masked_static[p, n] > -inf and the pod, cpu and memory
//      fit (fits_resources_dyn, predicates.py:93-114);
//   2. score = masked_static[p, n] + w_lr * LeastRequested
//      + w_ba * BalancedAllocation over the non-zero ledger
//      (priorities.py:40-72, FLOOR_EPS floor / trunc);
//   3. best = max score over feasible nodes, ntie = ties at best;
//   4. the (rr mod 2^32 % ntie)-th tie in node order is chosen;
//   5. the pod's requests are added to the chosen node's `requested` and
//      `nonzero` rows, and rr += 1.
// A pod with no feasible node gets assignment -1 and score 0.
//
// Design: one thread-block cluster over the node axis.
//
// - One cluster of CLUSTER = 16 blocks (a non-portable size) of 512
//   threads, launched with cudaLaunchKernelEx. Block b owns the node range
//   [b*NB, (b+1)*NB), NB = 512*RUN, and thread t of it the contiguous run
//   of RUN nodes from b*NB + t*RUN, so node order is (block, thread, j)
//   order and a tie's global rank is the ties of lower blocks, plus those
//   of lower warps, plus the ties of lower lanes. Nodes past N are
//   padding: no allocatable, never feasible.
// - Ledger and term cache in shared memory. Each block loads its nodes'
//   allocatable (pods, cpu, mem), requested (pods, cpu, mem), nonzero
//   (cpu, mem) and the two cached terms into dynamic shared memory once,
//   as columns, and writes the ledger back into the caller's [N, 6] and
//   [N, 2] tensors at the end. A node is only ever read or written by the
//   thread that owns it, so a ledger update needs no barrier. The gpu and
//   storage columns of `requested` are never read by the scan; the owner
//   adds a nonzero request to them in device memory (x + 0 == x, so the
//   main path's zero requests cost no load on the scan's critical path).
// - Rows prefetched asynchronously. masked_static and the pods' requests do
//   not depend on the scan, so each thread keeps its RUN entries of the
//   next rows of masked_static in flight with cp.async into a ring of
//   STAGES shared-memory slots, read in place from the [P, N] layout, and
//   eight threads copy each pod's requests into a ring of pod slots in the
//   same groups. Pod p+3's copies are issued while pod p's triples travel
//   between the blocks, where the threads would otherwise wait. A thread
//   reads back only the row entries it copied, so cp.async.wait_group
//   orders the row ring; the pod slots are waited for one pod early and
//   published to the block by that pod's __syncthreads().
// - Per pod: each thread scores its run (best, a bit mask of the run
//   positions tied at it, feasible count). The warp reduces (best key,
//   ties at best, feasible) with three redux.sync, the scores mapped to
//   ints that order as the floats do; lane 0 writes the warp's triple to a
//   shared slot; __syncthreads(); warp 0 reduces the 16 warp triples, and
//   lanes 0..15 send the block's triple to every block of the cluster with
//   st.async, each store completing its bytes on the receiving block's
//   mbarrier. A block then waits on its own mbarrier until all 16 triples
//   have landed: no cluster-wide barrier per pod. Every warp reduces the
//   16 block triples itself: the global best, ntie, the feasible total and
//   its block's tie offset, and k = rr % ntie on uint32. Only the block
//   that holds the k-th tie continues: its warp offsets come from the warp
//   slots, lane offsets from one ballot per bit of the thread's tie count,
//   and the owning thread reads the node off its tie mask, updates its
//   ledger row and recomputes that node's terms.
// - Slots and mbarriers are double-buffered by pod parity. A block sends
//   its triple of pod p+2 only after it has received every block's triple
//   of pod p+1, and every block sends that only after its own
//   __syncthreads() of pod p+1, which all of its threads pass only after
//   they are done with pod p's slots. So no triple overwrites one still
//   being read, and a barrier's phase for pod p+2 starts only after its
//   phase for pod p has completed.
//
// Term cache. A node's fit, LeastRequested and BalancedAllocation depend
// only on its ledger row and the pod's requests, and one pod changes one
// row. So the kernel keeps both terms per node (LeastRequested -1 for a
// node the pod does not fit), computed for every node whenever a pod's
// request bits differ from the previous pod's; a pod with the same requests
// (replicas of one workload, which batches are mostly made of) reuses them,
// and the owner of the chosen node recomputes that node's entry after its
// ledger update. A reused term is the value the same arithmetic produced on
// the same inputs, so the score is bit-identical to computing it afresh.
// With the node axis over 16 SMs, a pod whose requests differ recomputes
// 1/16 of the nodes on each SM.
//
// Rounding. Every operation that the reference rounds separately is
// written with a round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsub_rn) and the file is built with --fmad=false, so no
// multiply-add is contracted and floor((c-r)*10/c + 1e-6) and
// trunc((1-|a-b|)*10 + 1e-6) round exactly as the unfused ops do.
//
// Bound on an H100 SXM: the scan must read masked_static once (P*N*4
// bytes, 268 MB at P=4096, N=16384: 80 us at 3.35 TB/s). The serial
// dependency between pods puts a chain of block barrier, DSMEM exchange
// and reductions under every pod, which at 4096 pods is far above 80 us.
//
// The spread build (SPREAD = true, entry ktpu_assign_scan_spread) adds
// SelectorSpread, the JAX step's `selector_spread` term and its
// `ledger_add` of the pod-selector counts (kubernetes_tpu/ops/solver.py:
// 579-581, ops/spread.py:29 selector_spread, ops/interpod.py:253
// ledger_add). The main build (SPREAD = false) compiles to the same
// instructions, in the same order, as before the spread build existed
// (registers may be numbered differently; kernel_times.py compares the
// SASS of two trees): every addition is behind `if constexpr (SPREAD)` or
// unused by it, and its parameters are one trailing empty struct. Per
// pod, between the terms and `best`:
//   1. when the pod's spread_q (a word of its pod slot) is -1, every node
//      scores MAX_PRIORITY (spread.py:65) and nothing is exchanged; every
//      block reads the same pod row, so all skip together;
//   2. else each thread reads its run's counts of column spread_q from a
//      transposed [UQ, N] copy of the pod-selector ledger in device
//      memory (the wrapper makes it and returns it as [N, UQ]; a column
//      of the row-major ledger would be a 128-byte stride per node, and
//      the ledger, 2 MiB at N = 16,384, does not fit beside the shared
//      columns), keeps the feasible ones (masked_static > -inf and the
//      pod fits, as the main scan decides it), and the block reduces the
//      max count, the per-zone sums of the feasible counts (GetZoneKey
//      slot TOPO_SPREAD_ZONE, one shared atomicAdd per nonzero count) and
//      whether any feasible node has a zone;
//   3. the 16 blocks exchange these partials (272 bytes each) the same
//      way the triples travel, st.async onto a third mbarrier, whose phase
//      is the parity of the spread pods seen so far; warps 0-1 reduce the
//      16 partials (zone d on thread d), and after one more block barrier
//      every thread has max_node, max_zone, have_zones and the zone sums;
//   4. each thread adds w_ss * SelectorSpread to its feasible nodes'
//      scores, then the main scan's selection follows.
// After the choice, the owner of the chosen node adds the pod's match
// row (pod_matches_q, in its pod slot) to that node's counts in device
// memory. A thread reads and writes only the counts of the nodes it owns,
// the main ledger's ownership rule, so no barrier guards the ledger. The
// partials of one spread pod are all read before any block sends its
// triple of that pod, and a block sends the next spread pod's partials
// only after it has received every triple, so one slot buffer and one
// mbarrier suffice; a wait that never completes traps as the triples'
// does. The 8-node build keeps STAGES = 3 row slots (not 4) to fit the
// spread build's shared memory under the block limit.
//
// Exactness. The counts are integers far below 2^24, so the zone sums
// equal the JAX package's one-hot matmul (spread.py:45) in any order of
// f32 additions, the shared atomics' included. The score is written with
// the _rn intrinsics in spread.py:50-64's order (--fmad=false), and its
// constants are JAX's weakly typed Python floats cast once to f32:
// (float)(1.0 - 2.0 / 3.0) and (float)(2.0 / 3.0).
//
// Bound of the spread build: masked_static read once, plus the
// pod-selector ledger read once and written once (N*UQ*4 bytes each way),
// at 3.35 TB/s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;          // blocks of the cluster (non-portable)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;            // ring slots of masked_static rows
constexpr int STAGES_MAIN = STAGES;
constexpr int POD_SLOTS = 8;         // ring slots of pod rows (> STAGES)
constexpr int POD_ROW = 8;           // floats of a pod slot: requests, nonzero
constexpr int POD_ROW_MAIN = POD_ROW;
constexpr int COLUMNS = 10;          // shared node columns (see Smem)
constexpr int MAX_SMEM = 232448;     // opt-in shared memory of one block
constexpr int R = 6;                 // resource columns of requests / requested
constexpr int PODS = 0, CPU = 1, MEM = 2, GPU = 3, SCRATCH = 4, OVERLAY = 5;
constexpr float FLOOR_EPS = 1e-6f;
constexpr float MAX_PRIORITY = 10.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned TRIPLE_BYTES = 16;            // one st.async.v4 per block
constexpr long long WAIT_LIMIT = 1LL << 33;      // cycles (seconds): a lost triple

static_assert(WARPS <= 32 && CLUSTER <= 32, "one warp reduces the slots");
static_assert(POD_SLOTS > STAGES && R + 2 == POD_ROW, "pod ring");

// ---- the spread build's layout
constexpr int MAX_DOMAINS = 64;      // zone ids a block sums (two warps' lanes)
constexpr int MAX_UQ = 64;           // pod-selector columns
constexpr int SP_Q = R + 2;          // pod-slot word: spread_q
constexpr int SP_M = R + 3;          // pod-slot words: the match row
constexpr int SP_POD_ROW = 80;       // floats of a spread pod slot
constexpr int SP_WORDS = 2 + MAX_DOMAINS;   // max count, any zoned, zone sums
constexpr int SP_CHUNKS = (SP_WORDS + 3) / 4;
constexpr unsigned SP_BYTES = SP_CHUNKS * 16;   // one block's partial
constexpr float ZONE_SHARE = (float)(2.0 / 3.0);        // zoneWeighting
constexpr float NODE_SHARE = (float)(1.0 - 2.0 / 3.0);
static_assert(MAX_DOMAINS == 2 * 32 && SP_M + MAX_UQ <= SP_POD_ROW
              && SP_POD_ROW % 4 == 0, "spread layout");

// Row-ring slots and pod-slot width of one build.
template <int RUN, bool SPREAD>
struct Build {
  static constexpr int STAGES = (SPREAD && RUN == 8) ? 3 : STAGES_MAIN;
  static constexpr int POD_ROW = SPREAD ? SP_POD_ROW : POD_ROW_MAIN;
};

// What the spread build reads beyond the main operands.
struct SpreadArgs {
  float* podsel_t;            // [UQ, N] counts, updated in place
  const int* spread_q;        // [P] union entry, -1 = none
  const float* pod_matches;   // [P, UQ] match rows
  const int* zone;            // [N] TOPO_SPREAD_ZONE domain id, -1 = none
  int uq;
  int nd;                     // zone ids below nd are summed
  float w_ss;
};
struct NoSpread {};
template <bool SPREAD>
using SpreadParam = typename std::conditional<SPREAD, SpreadArgs, NoSpread>::type;

struct Triple {      // a partial reduction: best score's key, ties at it, feasible
  int key;
  int ties;
  int feas;
};

// No nodes: a key below every score's.
__device__ __forceinline__ Triple empty() { return Triple{INT_MIN, 0, 0}; }

// An int that orders as the float does, for the warp's integer max
// (redux.sync). Scores are never NaN, and -0 is made +0 before, so equal
// keys are exactly equal scores.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Dynamic shared memory of one block, NB = THREADS * RUN nodes. The spread
// build's regions follow the main build's.
struct Smem {
  float* a_pods; float* a_cpu; float* a_mem;     // allocatable
  float* r_pods; float* r_cpu; float* r_mem;     // requested
  float* z_cpu; float* z_mem;                    // nonzero
  float* t_lr; float* t_ba;                      // cached terms
  float* ring;                                   // [STAGES][NB]
  uint64_t* bar;                                 // [2] mbarriers
  int4* cslot;                                   // [2][CLUSTER] block triples
  float* pods;                                   // [POD_SLOTS][POD_ROW]
  Triple* wslot;                                 // [2][WARPS] warp triples
  int4* sp_slot;                                 // [CLUSTER][SP_CHUNKS] partials
  int4* sp_out;                                  // [SP_CHUNKS] this block's
  float* zsum;                                   // [MAX_DOMAINS] block sums
  float* zc;                                     // [MAX_DOMAINS] cluster sums
  int2* wsp;                                     // [WARPS] (max count, zoned)
  float* sp_misc;                                // max_node, have_zones, 2 zone maxima
  uint64_t* bar_sp;                              // the partials' mbarrier
};

template <bool SPREAD>
constexpr size_t smem_bytes(int nb, int STAGES, int POD_ROW) {
  return (size_t)(COLUMNS + STAGES) * nb * sizeof(float) + 2 * sizeof(uint64_t)
         + (size_t)2 * CLUSTER * sizeof(int4)
         + (size_t)POD_SLOTS * POD_ROW * sizeof(float)
         + (size_t)2 * WARPS * sizeof(Triple)
         + (SPREAD ? (size_t)(CLUSTER + 1) * SP_CHUNKS * sizeof(int4)
                         + (size_t)2 * MAX_DOMAINS * sizeof(float)
                         + (size_t)WARPS * sizeof(int2) + 4 * sizeof(float)
                         + 2 * sizeof(uint64_t)
                   : 0);
}

template <bool SPREAD, int STAGES, int POD_ROW>
__device__ Smem carve(float* base, int nb) {
  Smem s;
  s.a_pods = base;
  s.a_cpu = base + nb;
  s.a_mem = base + 2 * nb;
  s.r_pods = base + 3 * nb;
  s.r_cpu = base + 4 * nb;
  s.r_mem = base + 5 * nb;
  s.z_cpu = base + 6 * nb;
  s.z_mem = base + 7 * nb;
  s.t_lr = base + 8 * nb;
  s.t_ba = base + 9 * nb;
  s.ring = base + (size_t)COLUMNS * nb;
  // nb is a multiple of 512: everything below stays 16-byte aligned
  s.bar = reinterpret_cast<uint64_t*>(s.ring + (size_t)STAGES * nb);
  s.cslot = reinterpret_cast<int4*>(s.bar + 2);
  s.pods = reinterpret_cast<float*>(s.cslot + 2 * CLUSTER);
  s.wslot = reinterpret_cast<Triple*>(s.pods + POD_SLOTS * POD_ROW);
  if constexpr (SPREAD) {   // every size below is a multiple of 16 bytes
    s.sp_slot = reinterpret_cast<int4*>(s.wslot + 2 * WARPS);
    s.sp_out = s.sp_slot + CLUSTER * SP_CHUNKS;
    s.zsum = reinterpret_cast<float*>(s.sp_out + SP_CHUNKS);
    s.zc = s.zsum + MAX_DOMAINS;
    s.wsp = reinterpret_cast<int2*>(s.zc + MAX_DOMAINS);
    s.sp_misc = reinterpret_cast<float*>(s.wsp + WARPS);
    s.bar_sp = reinterpret_cast<uint64_t*>(s.sp_misc + 4);
  }
  return s;
}

// ---- PTX: cp.async, mbarriers and st.async to another block of the cluster

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's cp.async groups but the newest `pending` have landed.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
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

// Wait for the phase of `bar` with this parity. A phase that never
// completes is a fault: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  const long long start = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - start > WAIT_LIMIT) __trap();
}

// 16 bytes into another block's shared memory; the store completes its
// bytes on that block's mbarrier.
__device__ __forceinline__ void st_async_v4(unsigned remote, int4 v,
                                            unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

// ---- the scoring arithmetic

__device__ __forceinline__ float unused_score(float req, float cap) {
  // floor((cap - req) * 10 / safe_cap + eps); 0 when cap == 0 or req > cap
  const float safe = (cap == 0.0f) ? 1.0f : cap;
  const float s = floorf(__fadd_rn(
      __fdiv_rn(__fmul_rn(__fsub_rn(cap, req), MAX_PRIORITY), safe), FLOOR_EPS));
  return (cap == 0.0f || req > cap) ? 0.0f : s;
}

struct Pod {
  float r_cpu, r_mem, nz_cpu, nz_mem;
  bool all_zero;
};

// The terms of shared node column `c` for the pod's requests and the
// current ledger: *lr = LeastRequested, or -1 when the pod does not fit;
// *ba = BalancedAllocation.
__device__ __forceinline__ void node_terms(const Smem& s, const Pod& pod, int c,
                                           float* lr_out, float* ba_out) {
  const float a_pods = s.a_pods[c];
  const float a_cpu = s.a_cpu[c];
  const float a_mem = s.a_mem[c];
  *lr_out = -1.0f;
  *ba_out = 0.0f;
  if (!(__fadd_rn(s.r_pods[c], 1.0f) <= a_pods)) return;
  if (!pod.all_zero && !(a_cpu >= __fadd_rn(pod.r_cpu, s.r_cpu[c])
                         && a_mem >= __fadd_rn(pod.r_mem, s.r_mem[c])))
    return;

  const float tc = __fadd_rn(s.z_cpu[c], pod.nz_cpu);
  const float tm = __fadd_rn(s.z_mem[c], pod.nz_mem);
  *lr_out = floorf(__fadd_rn(
      __fdiv_rn(__fadd_rn(unused_score(tc, a_cpu), unused_score(tm, a_mem)),
                2.0f),
      FLOOR_EPS));
  const float cf = __fdiv_rn(tc, a_cpu == 0.0f ? 1.0f : a_cpu);
  const float mf = __fdiv_rn(tm, a_mem == 0.0f ? 1.0f : a_mem);
  const float diff = fabsf(__fsub_rn(cf, mf));
  const float ba = truncf(__fadd_rn(
      __fmul_rn(__fsub_rn(1.0f, diff), MAX_PRIORITY), FLOOR_EPS));
  *ba_out = (cf >= 1.0f || mf >= 1.0f || a_cpu == 0.0f || a_mem == 0.0f)
                ? 0.0f : ba;
}

// RUN consecutive floats from shared memory, as vector loads.
template <int RUN>
__device__ __forceinline__ void load_run(const float* p, float (&v)[RUN]) {
  if constexpr (RUN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < RUN; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else if constexpr (RUN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) v[j] = p[j];
  }
}

// The warp's (best key, ties at it, feasible) in three redux.sync.
__device__ __forceinline__ Triple warp_reduce(Triple v) {
  Triple r;
  r.key = __reduce_max_sync(FULL, v.key);
  r.ties = __reduce_add_sync(FULL, v.key == r.key ? v.ties : 0);
  r.feas = __reduce_add_sync(FULL, v.feas);
  return r;
}

// Sum of v over the lanes below this one, for 0 <= v <= RUN (a thread's
// ties): one ballot per bit of v.
template <int RUN>
__device__ __forceinline__ int exclusive_sum_small(int v, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int sum = 0;
#pragma unroll
  for (int i = 0; (1 << i) <= RUN; ++i)
    sum += __popc(__ballot_sync(FULL, (v >> i) & 1) & below) << i;
  return sum;
}

// SelectorSpread of one node (spread.py:50-64): c its count, zc_node its
// zone's feasible count (0 without a zone), has_zone its zone id >= 0.
__device__ __forceinline__ float spread_score(float c, float zc_node,
                                              bool has_zone, float max_node,
                                              float max_zone, bool have_zones) {
  const float node_score =
      max_node > 0.0f
          ? __fdiv_rn(__fmul_rn(MAX_PRIORITY, __fsub_rn(max_node, c)),
                      fmaxf(max_node, 1.0f))
          : MAX_PRIORITY;
  const float zone_score =
      max_zone > 0.0f
          ? __fdiv_rn(__fmul_rn(MAX_PRIORITY, __fsub_rn(max_zone, zc_node)),
                      fmaxf(max_zone, 1.0f))
          : MAX_PRIORITY;
  const float blended =
      (have_zones && has_zone)
          ? __fadd_rn(__fmul_rn(node_score, NODE_SHARE),
                      __fmul_rn(ZONE_SHARE, zone_score))
          : node_score;
  return truncf(__fadd_rn(blended, FLOOR_EPS));
}

// Word w of block b's spread partial in this block's slots.
__device__ __forceinline__ int sp_word(const Smem& s, int b, int w) {
  return reinterpret_cast<const int*>(s.sp_slot + b * SP_CHUNKS)[w];
}

template <int RUN, bool SPREAD>
__global__ void __launch_bounds__(THREADS, 1) assign_scan_kernel(
    const float* __restrict__ masked_static, const float* __restrict__ requests,
    const float* __restrict__ nonzero_requests,
    const float* __restrict__ allocatable, float* __restrict__ requested,
    float* __restrict__ nonzero, int* __restrict__ assignments,
    float* __restrict__ scores, int* __restrict__ feasible_counts,
    long long* __restrict__ rr_io, int P, int N, float w_lr, float w_ba,
    SpreadParam<SPREAD> sp) {
  constexpr int NB = THREADS * RUN;
  constexpr int STAGES = Build<RUN, SPREAD>::STAGES;
  constexpr int POD_ROW = Build<RUN, SPREAD>::POD_ROW;
  extern __shared__ __align__(16) float smem_base[];
  cg::cluster_group cluster = cg::this_cluster();
  const Smem s = carve<SPREAD, STAGES, POD_ROW>(smem_base, NB);
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int c0 = t * RUN;                 // the run's first shared column
  const int g0 = rank * NB + c0;          // and its first node

  // ---- load the run's ledger, fill the ring's padding, start the rows
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int c = c0 + j;
    const int g = g0 + j;
    const bool in = g < N;
    s.a_pods[c] = in ? allocatable[(size_t)g * R + PODS] : 0.0f;
    s.a_cpu[c] = in ? allocatable[(size_t)g * R + CPU] : 0.0f;
    s.a_mem[c] = in ? allocatable[(size_t)g * R + MEM] : 0.0f;
    s.r_pods[c] = in ? requested[(size_t)g * R + PODS] : 0.0f;
    s.r_cpu[c] = in ? requested[(size_t)g * R + CPU] : 0.0f;
    s.r_mem[c] = in ? requested[(size_t)g * R + MEM] : 0.0f;
    s.z_cpu[c] = in ? nonzero[(size_t)g * 2] : 0.0f;
    s.z_mem[c] = in ? nonzero[(size_t)g * 2 + 1] : 0.0f;
    for (int k = 0; k < STAGES; ++k)
      if (!in) s.ring[k * NB + c] = -INFINITY;
  }
  [[maybe_unused]] int dom[RUN];     // the run's zone ids (spread build)
  if constexpr (SPREAD) {
#pragma unroll
    for (int j = 0; j < RUN; ++j) dom[j] = g0 + j < N ? sp.zone[g0 + j] : -1;
    if (t < MAX_DOMAINS) s.zsum[t] = 0.0f;
  }
  auto issue_row = [&](int p) {
    if (p < P) {
      float* slot = s.ring + (p % STAGES) * NB;
      const float* row = masked_static + (size_t)p * N;
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (g0 + j < N) cp_async4(slot + c0 + j, row + g0 + j);
      if constexpr (SPREAD) {   // + spread_q and the match row
        if (t < SP_M + sp.uq)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                    : t < SP_Q ? nonzero_requests + (size_t)p * 2 + (t - R)
                    : t == SP_Q ? reinterpret_cast<const float*>(sp.spread_q + p)
                    : sp.pod_matches + (size_t)p * sp.uq + (t - SP_M));
      } else {
        if (t < POD_ROW)
          cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                    t < R ? requests + (size_t)p * R + t
                          : nonzero_requests + (size_t)p * 2 + (t - R));
      }
    }
    cp_async_commit();    // one group per pod, empty past the last
  };
  for (int p = 0; p < STAGES - 1; ++p) issue_row(p);
  cp_async_wait<STAGES - 2>();  // pod 0's row has landed

  // ---- one mbarrier per pod parity: a phase completes when this block has
  // armed it and the triples of all CLUSTER blocks (16 bytes each) landed
  if (t == 0) {
    mbar_init(&s.bar[0], 1);
    mbar_init(&s.bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(&s.bar[0], CLUSTER * TRIPLE_BYTES);
    mbar_arm(&s.bar[1], CLUSTER * TRIPLE_BYTES);
    if constexpr (SPREAD) {
      mbar_init(s.bar_sp, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_arm(s.bar_sp, CLUSTER * SP_BYTES);
    }
  }
  // where warp 0's lane l sends this block's triples: block l's slot
  // `rank` and mbarrier, of each parity
  unsigned to_slot0 = 0u, to_slot1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (warp == 0 && lane < CLUSTER) {
    to_slot0 = map_rank(smem_u32(&s.cslot[rank]), lane);
    to_slot1 = map_rank(smem_u32(&s.cslot[CLUSTER + rank]), lane);
    to_bar0 = map_rank(smem_u32(&s.bar[0]), lane);
    to_bar1 = map_rank(smem_u32(&s.bar[1]), lane);
  }
  // where warp 0's lane l sends its chunks of this block's spread partial:
  // block (l % 16)'s slot `rank` and mbarrier
  unsigned to_sp_slot = 0u, to_sp_bar = 0u, sp_phase = 0u;
  if constexpr (SPREAD) {
    if (warp == 0) {
      to_sp_slot = map_rank(smem_u32(&s.sp_slot[rank * SP_CHUNKS]), lane % CLUSTER);
      to_sp_bar = map_rank(smem_u32(s.bar_sp), lane % CLUSTER);
    }
  }

  unsigned int rr = (unsigned int)(*rr_io);
  // requests of the pod the cached terms belong to (none yet)
  unsigned key_cpu = 0u, key_mem = 0u, key_nzc = 0u, key_nzm = 0u;
  bool key_zero = false, have_terms = false;
  // barriers initialised and pod 0's row visible in every block before any
  // block sends
  cluster.sync();

  for (int p = 0; p < P; ++p) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of pods p and p+1 landed
    const float* pr = s.pods + (p % POD_SLOTS) * POD_ROW;   // pod p's row
    float rq[R];
#pragma unroll
    for (int f = 0; f < R; ++f) rq[f] = pr[f];
    Pod pod;
    pod.r_cpu = rq[CPU];
    pod.r_mem = rq[MEM];
    pod.nz_cpu = pr[R];
    pod.nz_mem = pr[R + 1];
    pod.all_zero = rq[CPU] == 0.0f && rq[MEM] == 0.0f && rq[GPU] == 0.0f
                   && rq[SCRATCH] == 0.0f && rq[OVERLAY] == 0.0f;
    // the same request bits as the pod the cached terms were computed for
    const bool reuse = have_terms && __float_as_uint(pod.r_cpu) == key_cpu
                       && __float_as_uint(pod.r_mem) == key_mem
                       && __float_as_uint(pod.nz_cpu) == key_nzc
                       && __float_as_uint(pod.nz_mem) == key_nzm
                       && pod.all_zero == key_zero;
    key_cpu = __float_as_uint(pod.r_cpu);
    key_mem = __float_as_uint(pod.r_mem);
    key_nzc = __float_as_uint(pod.nz_cpu);
    key_nzm = __float_as_uint(pod.nz_mem);
    key_zero = pod.all_zero;
    have_terms = true;

    // ---- score the run
    float ms[RUN], lr[RUN], ba[RUN];
    load_run<RUN>(s.ring + (p % STAGES) * NB + c0, ms);
    if (reuse) {
      load_run<RUN>(s.t_lr + c0, lr);
      load_run<RUN>(s.t_ba + c0, ba);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        node_terms(s, pod, c0 + j, &lr[j], &ba[j]);
        s.t_lr[c0 + j] = lr[j];
        s.t_ba[c0 + j] = ba[j];
      }
    }
    // ---- SelectorSpread of the run (spread build)
    [[maybe_unused]] float ss[RUN];
    if constexpr (SPREAD) {
      const int q = __float_as_int(pr[SP_Q]);
      if (q >= sp.uq) __trap();   // not an entry of the ledger
      if (q < 0) {
#pragma unroll
        for (int j = 0; j < RUN; ++j) ss[j] = MAX_PRIORITY;
      } else {
        const float* col = sp.podsel_t + (size_t)q * N;
        float cnt[RUN];
        int cmax = 0;
        bool zoned = false;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          cnt[j] = g0 + j < N ? col[g0 + j] : 0.0f;
          if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;   // infeasible
          cmax = max(cmax, (int)cnt[j]);
          if (dom[j] >= 0) {
            zoned = true;
            if (dom[j] < sp.nd && cnt[j] != 0.0f) atomicAdd(&s.zsum[dom[j]], cnt[j]);
          }
        }
        const int wmax = __reduce_max_sync(FULL, cmax);
        const unsigned wzoned = __ballot_sync(FULL, zoned);
        if (lane == 0) s.wsp[warp] = make_int2(wmax, wzoned != 0u);
        __syncthreads();
        if (warp == 0) {   // the block's partial, into slot `rank` of every block
          const int2 w = lane < WARPS ? s.wsp[lane] : make_int2(0, 0);
          int* out = reinterpret_cast<int*>(s.sp_out);
          const int bmax = __reduce_max_sync(FULL, w.x);
          const unsigned bzoned = __reduce_or_sync(FULL, (unsigned)w.y);
          out[2 + lane] = __float_as_int(s.zsum[lane]);
          out[2 + 32 + lane] = __float_as_int(s.zsum[32 + lane]);
          s.zsum[lane] = 0.0f;
          s.zsum[32 + lane] = 0.0f;
          if (lane == 0) {
            out[0] = bmax;
            out[1] = (int)bzoned;
            for (int k = SP_WORDS; k < 4 * SP_CHUNKS; ++k) out[k] = 0;
          }
          __syncwarp();
          for (int k = lane / CLUSTER; k < SP_CHUNKS; k += 32 / CLUSTER)
            st_async_v4(to_sp_slot + k * 16, s.sp_out[k], to_sp_bar);
        }
        mbar_wait(s.bar_sp, sp_phase);
        if (t == 0) mbar_arm(s.bar_sp, CLUSTER * SP_BYTES);   // next spread pod
        sp_phase ^= 1u;
        if (warp < 2) {   // zone t: the cluster's sum, and the zone maximum
          float zc = 0.0f;
#pragma unroll
          for (int b = 0; b < CLUSTER; ++b)
            zc = __fadd_rn(zc, __int_as_float(sp_word(s, b, 2 + t)));
          s.zc[t] = zc;
          // sums are >= 0: their bits order as the floats do
          const int zmax = __reduce_max_sync(FULL, __float_as_int(zc));
          if (lane == 0) s.sp_misc[2 + warp] = __int_as_float(zmax);
          if (warp == 0) {
            const int m = __reduce_max_sync(FULL, lane < CLUSTER ? sp_word(s, lane, 0) : 0);
            const unsigned z = __reduce_or_sync(
                FULL, lane < CLUSTER ? (unsigned)sp_word(s, lane, 1) : 0u);
            if (lane == 0) {
              s.sp_misc[0] = (float)m;
              s.sp_misc[1] = z ? 1.0f : 0.0f;
            }
          }
        }
        __syncthreads();
        const float max_node = s.sp_misc[0];
        const bool have_zones = s.sp_misc[1] != 0.0f;
        const float max_zone = fmaxf(s.sp_misc[2], s.sp_misc[3]);
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const bool summed = dom[j] >= 0 && dom[j] < sp.nd;
          ss[j] = spread_score(cnt[j], summed ? s.zc[dom[j]] : 0.0f, dom[j] >= 0,
                               max_node, max_zone, have_zones);
        }
      }
    }

    float best = -INFINITY;
    unsigned tied = 0u;     // bit j: run position j ties at `best`
    int feas = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;
      // + 0 turns a -0 score into +0, so equal scores have equal keys
      float sc;
      if constexpr (SPREAD)
        sc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                           __fmul_rn(w_ba, ba[j])),
                                 __fmul_rn(sp.w_ss, ss[j])), 0.0f);
      else
        sc = __fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
                                 __fmul_rn(w_ba, ba[j])), 0.0f);
      ++feas;
      if (sc > best) {
        best = sc;
        tied = 1u << j;
      } else if (sc == best) {
        tied |= 1u << j;
      }
    }

    // ---- (best, ties, feasible) of the warp, the block, the cluster
    const int par = p & 1;
    const int key = order_key(best);
    const int nt = __popc(tied);
    const Triple wt = warp_reduce(Triple{key, nt, feas});
    if (lane == 0) s.wslot[par * WARPS + warp] = wt;
    __syncthreads();
    if (warp == 0) {   // the block's triple, into slot `rank` of every block
      const Triple v = warp_reduce(lane < WARPS ? s.wslot[par * WARPS + lane] : empty());
      if (lane < CLUSTER)
        st_async_v4(par ? to_slot1 : to_slot0, make_int4(v.key, v.ties, v.feas, 0),
                    par ? to_bar1 : to_bar0);
    }
    // start pod p+3's copies while the triples travel: its row slot held
    // row p-1 and its pod slot pod p-5, both read before this barrier
    issue_row(p + STAGES - 1);
    mbar_wait(&s.bar[par], (p >> 1) & 1);
    if (t == 0) mbar_arm(&s.bar[par], CLUSTER * TRIPLE_BYTES);   // for pod p+2

    // ---- every warp: the global best, ntie, this block's tie offset
    const int4 b4 = s.cslot[par * CLUSTER + (lane < CLUSTER ? lane : 0)];
    const Triple bt = lane < CLUSTER ? Triple{b4.x, b4.y, b4.z} : empty();
    const Triple tot = warp_reduce(bt);
    const int ntie = tot.ties;
    if (ntie > 0) {
      const int k = (int)(rr % (unsigned int)ntie);
      const int bties = bt.key == tot.key ? bt.ties : 0;
      const int boff = __reduce_add_sync(FULL, lane < rank ? bties : 0);
      const int bmine = __shfl_sync(FULL, bties, rank);
      if (boff <= k && k < boff + bmine) {      // this block holds the tie
        const Triple w_ = lane < WARPS ? s.wslot[par * WARPS + lane] : empty();
        const int wties = w_.key == tot.key ? w_.ties : 0;
        const int woff = boff + __reduce_add_sync(FULL, lane < warp ? wties : 0);
        const int wmine = __shfl_sync(FULL, wties, warp);
        if (woff <= k && k < woff + wmine) {    // and this warp
          const int tties = key == tot.key ? nt : 0;
          const int excl = woff + exclusive_sum_small<RUN>(tties, lane);
          if (tties > 0 && excl <= k && k < excl + tties) {
            unsigned m = tied;
            for (int r = k - excl; r > 0; --r) m &= m - 1u;
            const int j = __ffs((int)m) - 1;    // the tie's run position
            const int c = c0 + j;
            const int g = g0 + j;
            s.r_pods[c] = __fadd_rn(s.r_pods[c], rq[PODS]);
            s.r_cpu[c] = __fadd_rn(s.r_cpu[c], rq[CPU]);
            s.r_mem[c] = __fadd_rn(s.r_mem[c], rq[MEM]);
#pragma unroll
            for (int f = GPU; f < R; ++f)   // x + 0 == x: no load for a zero request
              if (rq[f] != 0.0f)
                requested[(size_t)g * R + f] =
                    __fadd_rn(requested[(size_t)g * R + f], rq[f]);
            s.z_cpu[c] = __fadd_rn(s.z_cpu[c], pod.nz_cpu);
            s.z_mem[c] = __fadd_rn(s.z_mem[c], pod.nz_mem);
            node_terms(s, pod, c, &s.t_lr[c], &s.t_ba[c]);
            if constexpr (SPREAD) {   // the pod's match row into its counts
              for (int u = 0; u < sp.uq; ++u) {
                const float v = pr[SP_M + u];
                if (v != 0.0f) {
                  float* cell = sp.podsel_t + (size_t)u * N + g;
                  *cell = __fadd_rn(*cell, v);
                }
              }
            }
            assignments[p] = g;
            scores[p] = best;
          }
        }
      }
      rr += 1u;
    } else if (rank == 0 && t == 0) {
      assignments[p] = -1;
      scores[p] = 0.0f;
    }
    if (rank == 0 && t == 0) feasible_counts[p] = tot.feas;
  }

  // ---- write the run's ledger back
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const int c = c0 + j;
    const int g = g0 + j;
    if (g >= N) continue;
    requested[(size_t)g * R + PODS] = s.r_pods[c];
    requested[(size_t)g * R + CPU] = s.r_cpu[c];
    requested[(size_t)g * R + MEM] = s.r_mem[c];
    nonzero[(size_t)g * 2] = s.z_cpu[c];
    nonzero[(size_t)g * 2 + 1] = s.z_mem[c];
  }
  if (rank == 0 && t == 0) *rr_io = (long long)rr;
  cluster.sync();   // no block leaves while another may still store into it
}

// The main operands of one launch.
struct Operands {
  const float* masked_static;
  const float* requests;
  const float* nonzero_requests;
  const float* allocatable;
  float* requested;
  float* nonzero;
  int* assignments;
  float* scores;
  int* feasible_counts;
  long long* rr_io;
  int P;
  int N;
  float w_lr;
  float w_ba;
};

template <int RUN, bool SPREAD>
int launch(const Operands& o, SpreadParam<SPREAD> sp, cudaStream_t stream) {
  auto kernel = assign_scan_kernel<RUN, SPREAD>;
  const size_t smem = smem_bytes<SPREAD>(THREADS * RUN, Build<RUN, SPREAD>::STAGES,
                                         Build<RUN, SPREAD>::POD_ROW);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = smem;
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
  err = cudaLaunchKernelEx(&config, kernel, o.masked_static, o.requests,
                           o.nonzero_requests, o.allocatable, o.requested,
                           o.nonzero, o.assignments, o.scores,
                           o.feasible_counts, o.rr_io, o.P, o.N, o.w_lr,
                           o.w_ba, sp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The build for `run` nodes per thread (1, 2, 4 or 8), with
// N <= CLUSTER * 512 * run.
template <bool SPREAD>
int launch_run(const Operands& o, int run, SpreadParam<SPREAD> sp,
               cudaStream_t stream) {
  if (o.P <= 0) return (int)cudaSuccess;
  if (o.N <= 0 || o.N > CLUSTER * THREADS * run) return (int)cudaErrorInvalidValue;
  switch (run) {
    case 1: return launch<1, SPREAD>(o, sp, stream);
    case 2: return launch<2, SPREAD>(o, sp, stream);
    case 4: return launch<4, SPREAD>(o, sp, stream);
    case 8: return launch<8, SPREAD>(o, sp, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// masked_static [P, N], requests [P, 6], nonzero_requests [P, 2],
// allocatable [N, 6]; requested [N, 6] and nonzero [N, 2] hold the
// batch-start ledger and are updated in place. run = nodes per thread
// (1, 2, 4 or 8), with N <= CLUSTER * 512 * run.
extern "C" int ktpu_assign_scan(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    cudaStream_t stream) {
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba};
  return launch_run<false>(o, run, NoSpread{}, stream);
}

// The spread build: the operands of ktpu_assign_scan, and podsel_t
// [uq, N] (the pod-selector counts, transposed; updated in place),
// spread_q [P] (-1 or an entry below uq), pod_matches [P, uq], zone [N]
// (the GetZoneKey domain id, -1 = none; ids below nd are summed),
// 1 <= nd <= 64, 0 <= uq <= 64, and the SelectorSpread weight w_ss.
extern "C" int ktpu_assign_scan_spread(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, int* assignments, float* scores, int* feasible_counts,
    long long* rr_io, int P, int N, int run, float w_lr, float w_ba,
    float* podsel_t, const int* spread_q, const float* pod_matches,
    const int* zone, int uq, int nd, float w_ss, cudaStream_t stream) {
  if (uq < 0 || uq > MAX_UQ || nd < 1 || nd > MAX_DOMAINS)
    return (int)cudaErrorInvalidValue;
  const Operands o{masked_static, requests, nonzero_requests, allocatable,
                   requested, nonzero, assignments, scores, feasible_counts,
                   rr_io, P, N, w_lr, w_ba};
  const SpreadArgs sp{podsel_t, spread_q, pod_matches, zone, uq, nd, w_ss};
  return launch_run<true>(o, run, sp, stream);
}
