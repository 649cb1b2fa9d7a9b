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
// Design. One block of 1024 threads walks the pods in order; thread t owns
// the contiguous node run [t*per, (t+1)*per), which keeps node order for
// the tie rank. The wrapper hands the kernel every node-axis input in a
// thread-interleaved layout (node t*per + j at column j*1024 + t, padded
// to a multiple of 1024 with infeasible nodes), so for each j the 1024
// threads read 1024 consecutive floats: every load is coalesced although
// each thread's run is contiguous in node order. The ledger is kept as
// columns (structure of arrays) in the same layout. Per pod: each thread
// evaluates its run, keeping its best score, a bit mask of the positions
// tied at it and its feasible count; a block max gives `best`; an
// exclusive block scan of the per-thread tie counts (at `best`) finds the
// thread that owns the k-th tie, which reads the node off its mask and
// updates the ledger columns in global memory. At 16384 x 8 floats the
// ledger stays in L2. A __syncthreads() at the end of each pod makes the
// update visible to the next pod.
//
// Term cache. A node's fit, LeastRequested and BalancedAllocation depend
// only on its ledger row and the pod's requests, and one pod changes one
// row. So the kernel keeps both terms per node (LeastRequested -1 for a
// node the pod does not fit) in two scratch columns, computed for every
// node whenever a pod's requests differ from the previous pod's; a pod
// with the same requests (replicas of one workload, which batches are
// mostly made of) reuses them, and the owner of the chosen node recomputes
// that node's entry after its ledger update. A reused term is the value
// the same arithmetic produced on the same inputs, so the score is
// bit-identical to computing it afresh.
//
// Rounding. Every operation that the reference rounds separately is
// written with a round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsub_rn) and the file is built with --fmad=false, so no
// multiply-add is contracted and floor((c-r)*10/c + 1e-6) and
// trunc((1-|a-b|)*10 + 1e-6) round exactly as the unfused ops do.
//
// Bound on an H100 SXM: the scan must read masked_static once (P*N*4
// bytes, 268 MB at P=4096, N=16384: 80 us at 3.35 TB/s). This version
// runs on one SM by design (the serial dependency is carried in one
// block), so it sits far above that bound; a cluster/DSMEM version that
// spreads the node axis over several SMs is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int R = 6;            // resource columns of requests / requested
constexpr int PODS = 0, CPU = 1, MEM = 2, GPU = 3, SCRATCH = 4, OVERLAY = 5;
constexpr float FLOOR_EPS = 1e-6f;
constexpr float MAX_PRIORITY = 10.0f;

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

// The per-node terms of the node at interleaved column `c` for the pod's
// requests and the current ledger: *lr = LeastRequested, or -1 when the pod
// does not fit; *ba = BalancedAllocation. alloc: [3, np] (pods, cpu, mem);
// req: [6, np]; nz: [2, np].
__device__ __forceinline__ void node_terms(
    const float* __restrict__ alloc, const float* req, const float* nz, int np,
    const Pod& pod, int c, float* lr_out, float* ba_out) {
  const float a_pods = alloc[c];
  const float a_cpu = alloc[np + c];
  const float a_mem = alloc[2 * np + c];
  *lr_out = -1.0f;
  *ba_out = 0.0f;
  if (!(__fadd_rn(req[PODS * np + c], 1.0f) <= a_pods)) return;
  if (!pod.all_zero && !(a_cpu >= __fadd_rn(pod.r_cpu, req[CPU * np + c])
                         && a_mem >= __fadd_rn(pod.r_mem, req[MEM * np + c])))
    return;

  const float tc = __fadd_rn(nz[c], pod.nz_cpu);
  const float tm = __fadd_rn(nz[np + c], pod.nz_mem);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS, 1) assign_scan_kernel(
    const float* __restrict__ masked_static, const float* __restrict__ requests,
    const float* __restrict__ nonzero_requests, const float* __restrict__ alloc,
    float* req, float* nz, float* term_lr, float* term_ba,
    int* __restrict__ assignments, float* __restrict__ scores,
    int* __restrict__ feasible_counts, long long* __restrict__ rr_io, int P,
    int np, float w_lr, float w_ba) {
  __shared__ float s_wmax[WARPS];
  __shared__ float s_best;
  __shared__ int s_wties[WARPS];   // per-warp tie totals, then exclusive
  __shared__ int s_wfeas[WARPS];
  __shared__ int s_ntie;
  __shared__ int s_nfeas;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int per = np / THREADS;    // nodes per thread (<= 64: the tie mask)
  unsigned int rr = (unsigned int)(*rr_io);
  // requests of the pod the cached terms belong to (none yet)
  unsigned key_cpu = 0u, key_mem = 0u, key_nzc = 0u, key_nzm = 0u;
  bool key_zero = false, have_terms = false;

  for (int p = 0; p < P; ++p) {
    const float* ms_row = masked_static + (size_t)p * np;
    const float* rq = requests + (size_t)p * R;
    Pod pod;
    pod.r_cpu = rq[CPU];
    pod.r_mem = rq[MEM];
    pod.nz_cpu = nonzero_requests[(size_t)p * 2 + 0];
    pod.nz_mem = nonzero_requests[(size_t)p * 2 + 1];
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

    float best = -INFINITY;
    unsigned long long tied = 0;   // bit j: run position j ties at `best`
    int feas = 0;
    for (int j = 0; j < per; ++j) {
      const int c = j * THREADS + t;
      float lr, ba;
      if (reuse) {
        lr = term_lr[c];
        ba = term_ba[c];
      } else {
        node_terms(alloc, req, nz, np, pod, c, &lr, &ba);
        term_lr[c] = lr;
        term_ba[c] = ba;
      }
      const float ms = ms_row[c];
      if (!(ms > -INFINITY) || lr < 0.0f) continue;
      const float s = __fadd_rn(__fadd_rn(ms, __fmul_rn(w_lr, lr)),
                                __fmul_rn(w_ba, ba));
      ++feas;
      if (s > best) {
        best = s;
        tied = 1ull << j;
      } else if (s == best) {
        tied |= 1ull << j;
      }
    }

    // block max of the best scores
    float m = warp_max(best);
    if (lane == 0) s_wmax[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = warp_max(s_wmax[lane]);
      if (lane == 0) s_best = m;
    }
    __syncthreads();
    const float block_best = s_best;

    // exclusive scan of the tie counts at the block best, and the
    // feasible total
    const int mine = (tied != 0ull && best == block_best) ? __popcll(tied) : 0;
    const int incl = warp_inclusive_scan(mine, lane);
    const int wfeas = warp_sum(feas);
    if (lane == 31) s_wties[warp] = incl;
    if (lane == 0) s_wfeas[warp] = wfeas;
    __syncthreads();
    if (warp == 0) {
      const int w = s_wties[lane];
      const int wincl = warp_inclusive_scan(w, lane);
      s_wties[lane] = wincl - w;
      const int f = warp_sum(s_wfeas[lane]);
      if (lane == 31) s_ntie = wincl;
      if (lane == 0) s_nfeas = f;
    }
    __syncthreads();
    const int ntie = s_ntie;
    const int excl = s_wties[warp] + incl - mine;

    if (ntie > 0) {
      const int k = (int)(rr % (unsigned int)ntie);
      if (mine > 0 && excl <= k && k < excl + mine) {
        for (int r = k - excl; r > 0; --r) tied &= tied - 1ull;
        const int j = __ffsll((long long)tied) - 1;   // the tie's position
        const int c = j * THREADS + t;
#pragma unroll
        for (int f = 0; f < R; ++f)
          req[f * np + c] = __fadd_rn(req[f * np + c], rq[f]);
        nz[c] = __fadd_rn(nz[c], pod.nz_cpu);
        nz[np + c] = __fadd_rn(nz[np + c], pod.nz_mem);
        node_terms(alloc, req, nz, np, pod, c, &term_lr[c], &term_ba[c]);
        assignments[p] = t * per + j;
        scores[p] = block_best;
      }
      rr += 1u;
    } else if (t == 0) {
      assignments[p] = -1;
      scores[p] = 0.0f;
    }
    if (t == 0) feasible_counts[p] = s_nfeas;
    __syncthreads();  // the ledger update is visible to the next pod
  }
  if (t == 0) *rr_io = (long long)rr;
}

}  // namespace

// Node-axis arguments in the interleaved layout (see Design), np a
// multiple of 1024 and at most 64 * 1024: masked_static [P, np],
// allocatable [3, np] (pods, cpu, mem), requested [6, np] and nonzero
// [2, np] (updated in place); term_lr / term_ba [np] are scratch.
extern "C" int ktpu_assign_scan(
    const float* masked_static, const float* requests,
    const float* nonzero_requests, const float* allocatable, float* requested,
    float* nonzero, float* term_lr, float* term_ba, int* assignments,
    float* scores, int* feasible_counts, long long* rr_io, int P, int np,
    float w_lr, float w_ba, cudaStream_t stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (np <= 0 || np % THREADS != 0 || np / THREADS > 64)
    return (int)cudaErrorInvalidValue;
  assign_scan_kernel<<<1, THREADS, 0, stream>>>(
      masked_static, requests, nonzero_requests, allocatable, requested,
      nonzero, term_lr, term_ba, assignments, scores, feasible_counts, rr_io,
      P, np, w_lr, w_ba);
  return (int)cudaGetLastError();
}
