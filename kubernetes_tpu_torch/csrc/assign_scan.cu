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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;          // blocks of the cluster (non-portable)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;            // ring slots of masked_static rows
constexpr int POD_SLOTS = 8;         // ring slots of pod rows (> STAGES)
constexpr int POD_ROW = 8;           // floats of a pod slot: requests, nonzero
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

// Dynamic shared memory of one block, NB = THREADS * RUN nodes.
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
};

constexpr size_t smem_bytes(int nb) {
  return (size_t)(COLUMNS + STAGES) * nb * sizeof(float) + 2 * sizeof(uint64_t)
         + (size_t)2 * CLUSTER * sizeof(int4)
         + (size_t)POD_SLOTS * POD_ROW * sizeof(float)
         + (size_t)2 * WARPS * sizeof(Triple);
}

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

template <int RUN>
__global__ void __launch_bounds__(THREADS, 1) assign_scan_kernel(
    const float* __restrict__ masked_static, const float* __restrict__ requests,
    const float* __restrict__ nonzero_requests,
    const float* __restrict__ allocatable, float* __restrict__ requested,
    float* __restrict__ nonzero, int* __restrict__ assignments,
    float* __restrict__ scores, int* __restrict__ feasible_counts,
    long long* __restrict__ rr_io, int P, int N, float w_lr, float w_ba) {
  constexpr int NB = THREADS * RUN;
  extern __shared__ __align__(16) float smem_base[];
  cg::cluster_group cluster = cg::this_cluster();
  const Smem s = carve(smem_base, NB);
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
  auto issue_row = [&](int p) {
    if (p < P) {
      float* slot = s.ring + (p % STAGES) * NB;
      const float* row = masked_static + (size_t)p * N;
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (g0 + j < N) cp_async4(slot + c0 + j, row + g0 + j);
      if (t < POD_ROW)
        cp_async4(s.pods + (p % POD_SLOTS) * POD_ROW + t,
                  t < R ? requests + (size_t)p * R + t
                        : nonzero_requests + (size_t)p * 2 + (t - R));
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
    float best = -INFINITY;
    unsigned tied = 0u;     // bit j: run position j ties at `best`
    int feas = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (!(ms[j] > -INFINITY) || lr[j] < 0.0f) continue;
      // + 0 turns a -0 score into +0, so equal scores have equal keys
      const float sc = __fadd_rn(__fadd_rn(__fadd_rn(ms[j], __fmul_rn(w_lr, lr[j])),
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

template <int RUN>
int launch(const float* masked_static, const float* requests,
           const float* nonzero_requests, const float* allocatable,
           float* requested, float* nonzero, int* assignments, float* scores,
           int* feasible_counts, long long* rr_io, int P, int N, float w_lr,
           float w_ba, cudaStream_t stream) {
  auto kernel = assign_scan_kernel<RUN>;
  const size_t smem = smem_bytes(THREADS * RUN);
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
  err = cudaLaunchKernelEx(&config, kernel, masked_static, requests,
                           nonzero_requests, allocatable, requested, nonzero,
                           assignments, scores, feasible_counts, rr_io, P, N,
                           w_lr, w_ba);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  if (P <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > CLUSTER * THREADS * run) return (int)cudaErrorInvalidValue;
  switch (run) {
    case 1: return launch<1>(masked_static, requests, nonzero_requests, allocatable,
                             requested, nonzero, assignments, scores,
                             feasible_counts, rr_io, P, N, w_lr, w_ba, stream);
    case 2: return launch<2>(masked_static, requests, nonzero_requests, allocatable,
                             requested, nonzero, assignments, scores,
                             feasible_counts, rr_io, P, N, w_lr, w_ba, stream);
    case 4: return launch<4>(masked_static, requests, nonzero_requests, allocatable,
                             requested, nonzero, assignments, scores,
                             feasible_counts, rr_io, P, N, w_lr, w_ba, stream);
    case 8: return launch<8>(masked_static, requests, nonzero_requests, allocatable,
                             requested, nonzero, assignments, scores,
                             feasible_counts, rr_io, P, N, w_lr, w_ba, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
