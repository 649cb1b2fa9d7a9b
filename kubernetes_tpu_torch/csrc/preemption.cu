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
// Design: one cooperative launch a batch, B <= #SMs blocks of 128 threads,
// each owning a contiguous range of NB = ceil(N / B) nodes.
// 1. A block loads its range once into shared memory: the slots'
//    priorities and requests (requests stay in device memory, read through
//    L2, where the range does not fit: past ~57,000 nodes), the evictable
//    and taken slot sets as 32-bit words, and allocatable, the post-scan
//    ledger and the batch's bookings a node. At N = 16,384 that is 67.6 KB
//    a block, 8.6 MB across the grid; nothing of it leaves the SMs again.
// 2. Every block walks every pod: the group boundary (below), then, for a
//    pod that takes part, each thread evaluates its nodes (the candidate
//    word, the fits at k = 0, 1, ... with an early exit, the first k set
//    slots) and packs its best (top ^ 2^31, k, node) into one 64-bit key,
//    most significant first, so the reference's lexicographic pick is an
//    unsigned minimum; the block reduces its keys with warp shuffles.
// 3. The exchange: thread 0 takes atomicMin of the block's key into the
//    pod's word in device memory, fences, and adds one to the pod's
//    arrival count; it then spins (ld.acquire) until all B blocks have
//    arrived and reads the pod's key. Counts and keys are per pod, so no
//    word is ever reset. A wait that never completes traps after ~2^35
//    cycles (the launch fails, nothing hangs).
// 4. The block owning the picked node books it: thread 0 recomputes that
//    node's candidates, F_k and first k slots (the same arithmetic, so the
//    same values), logs the node's old bookings and taken word while a
//    group is open, and updates them. A pod without a node marks its open
//    group bad.
// 5. Group boundaries: where gang_id changes, a bad group's bookings are
//    restored from the block's undo log newest first (saved values, never
//    subtracted), and a group entered opens an empty log. Every block sees
//    every pod's gang_id, so boundaries are seen where the reference's scan
//    sees them; a pod that does not take part costs a block two loads and
//    no exchange.
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
// the previous pod's booking, so the cost is one grid-wide exchange a pod
// (an L2 atomic round trip and a spin), not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 6;                   // state/layout.py Resource.COUNT
constexpr int PODS = 0, CPU = 1, MEMORY = 2, GPU = 3, SCRATCH = 4, OVERLAY = 5;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;       // opt-in shared memory of one block
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int INT32_MIN_ = -2147483647 - 1;
constexpr long long SPIN_LIMIT = 1ll << 35;

struct Args {
  const float* alloc;      // f32[N, R]
  const float* base;       // f32[N, R] the post-scan ledger
  const float* masked;     // f32[P, N] -inf: statically infeasible
  const float* req_p;      // f32[P, R]
  const int* prio_p;       // i32[P]
  const uint8_t* part;     // bool[P]
  const int* gang_id;      // i32[P]
  const int* v_prio;       // i32[N, S]
  const float* v_req;      // f32[N, S, R]
  const uint8_t* v_ok;     // bool[N, S]
  int* out_node;           // i32[P], -1 prefilled
  int* out_k;              // i32[P], 0 prefilled
  unsigned long long* keys;  // u64[P], all ones prefilled
  int* arrive;             // i32[P], zero prefilled
  float* undo;             // f32[B, P, 2 + R] undo log a block
  int P, N, S, NB;
  bool req_smem;
};

// shared layout of one block: prio [S][NB] i32, req [S][R][NB] f32 (if
// req_smem), ok [NB] u32, taken [NB] u32, alloc, base, extra [R][NB] f32
__host__ __device__ inline size_t smem_bytes(int S, int NB, bool req_smem) {
  return (size_t)NB * 4 * (S + (req_smem ? S * R : 0) + 2 + 3 * R);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

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

struct Block {
  int* prio;
  float* req;       // shared [S][R][NB], or the range's rows in device memory
  uint32_t* ok;
  uint32_t* taken;
  float* alloc;
  float* base;
  float* extra;
  int NB, S;
  bool req_smem;

  __device__ __forceinline__ float slot_req(int l, int s, int r) const {
    return req_smem ? req[(s * R + r) * NB + l] : __ldg(req + ((size_t)l * S + s) * R + r);
  }
};

// One node's evaluation for a pod: returns k (-1: no set) and leaves the
// node's candidate word, F_k and first-k slot word in its outputs.
__device__ __forceinline__ int eval_node(const Block& b, int l, int prio_p,
                                         const float r[R], bool all_zero,
                                         uint32_t& cand, float F[R],
                                         uint32_t& chosen) {
  cand = 0u;
  const uint32_t live = b.ok[l] & ~b.taken[l];
  for (int s = 0; s < b.S; ++s)
    if (((live >> s) & 1u) && b.prio[s * b.NB + l] < prio_p) cand |= 1u << s;
  const int count = __popc(cand);
  float a[R], led[R], adj[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    a[q] = b.alloc[q * b.NB + l];
    led[q] = b.base[q * b.NB + l] + b.extra[q * b.NB + l];
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
        for (int q = 0; q < R; ++q) F[q] = F[q] + b.slot_req(l, kk - 1, q);
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
  if (k > 0) {
    uint32_t c = cand;
    for (int t = 0; t < k; ++t) {
      chosen |= c & (0u - c);
      c &= c - 1u;
    }
  }
  return k;
}

__global__ void __launch_bounds__(THREADS) preemption_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_red[WARPS];
  __shared__ unsigned long long s_key;

  const float NEG_INF = __uint_as_float(0xff800000u);
  const int tid = threadIdx.x;
  const int NB = g.NB, S = g.S;
  const int n0 = blockIdx.x * NB;
  const int live = max(0, min(NB, g.N - n0));
  Block b;
  b.NB = NB;
  b.S = S;
  b.req_smem = g.req_smem;
  unsigned char* p = smem;
  b.prio = reinterpret_cast<int*>(p);
  p += (size_t)S * NB * 4;
  if (g.req_smem) {
    b.req = reinterpret_cast<float*>(p);
    p += (size_t)S * R * NB * 4;
  } else {
    b.req = const_cast<float*>(g.v_req) + (size_t)n0 * S * R;
  }
  b.ok = reinterpret_cast<uint32_t*>(p);
  p += (size_t)NB * 4;
  b.taken = reinterpret_cast<uint32_t*>(p);
  p += (size_t)NB * 4;
  b.alloc = reinterpret_cast<float*>(p);
  p += (size_t)R * NB * 4;
  b.base = reinterpret_cast<float*>(p);
  p += (size_t)R * NB * 4;
  b.extra = reinterpret_cast<float*>(p);

  // 1. the block's node range
  for (int l = tid; l < NB; l += THREADS) {
    const int n = n0 + l;
    uint32_t okw = 0u;
    for (int s = 0; s < S; ++s) {
      b.prio[s * NB + l] = l < live ? g.v_prio[(size_t)n * S + s] : 0;
      if (l < live && g.v_ok[(size_t)n * S + s]) okw |= 1u << s;
      if (g.req_smem)
        for (int q = 0; q < R; ++q)
          b.req[(s * R + q) * NB + l] = l < live ? g.v_req[((size_t)n * S + s) * R + q] : 0.0f;
    }
    b.ok[l] = okw;
    b.taken[l] = 0u;
    for (int q = 0; q < R; ++q) {
      b.alloc[q * NB + l] = l < live ? g.alloc[(size_t)n * R + q] : 0.0f;
      b.base[q * NB + l] = l < live ? g.base[(size_t)n * R + q] : 0.0f;
      b.extra[q * NB + l] = 0.0f;
    }
  }
  __syncthreads();

  float* undo = g.undo + (size_t)blockIdx.x * g.P * (2 + R);
  int cur = 0, nlog = 0;
  bool bad = false;
  for (int i = 0; i < g.P; ++i) {
    // 5. group boundary (uniform across the block)
    const int gid = g.gang_id[i];
    if (gid != cur) {
      if (cur > 0 && bad && tid == 0) {
        for (int e = nlog - 1; e >= 0; --e) {
          const float* u = undo + (size_t)e * (2 + R);
          const int l = __float_as_int(u[0]);
          b.taken[l] = __float_as_uint(u[1]);
          for (int q = 0; q < R; ++q) b.extra[q * NB + l] = u[2 + q];
        }
      }
      nlog = 0;
      bad = false;
      cur = gid;
      __syncthreads();
    }
    if (!g.part[i]) continue;

    // 2. this block's best key for pod i
    const int prio_i = g.prio_p[i];
    float r[R];
#pragma unroll
    for (int q = 0; q < R; ++q) r[q] = g.req_p[(size_t)i * R + q];
    const bool all_zero = r[CPU] == 0.0f && r[MEMORY] == 0.0f && r[GPU] == 0.0f
                          && r[SCRATCH] == 0.0f && r[OVERLAY] == 0.0f;
    unsigned long long best = NO_KEY;
    const float* mrow = g.masked + (size_t)i * g.N + n0;
    for (int l = tid; l < live; l += THREADS) {
      if (!(mrow[l] > NEG_INF)) continue;
      uint32_t cand, chosen;
      float F[R];
      const int k = eval_node(b, l, prio_i, r, all_zero, cand, F, chosen);
      if (k < 0) continue;
      int top = INT32_MIN_;
      for (int s = 0; s < S; ++s)
        if ((chosen >> s) & 1u) top = max(top, b.prio[s * NB + l]);
      const unsigned long long key =
          ((unsigned long long)((uint32_t)top ^ 0x80000000u) << 32)
          | ((unsigned long long)k << 24) | (unsigned long long)(n0 + l);
      best = min(best, key);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if ((tid & 31) == 0) s_red[tid >> 5] = best;
    __syncthreads();

    // 3. the exchange
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) best = min(best, s_red[w]);
      if (best != NO_KEY) atomicMin(&g.keys[i], best);
      __threadfence();
      atomicAdd(&g.arrive[i], 1);
      const long long t0 = clock64();
      while (ld_acquire(&g.arrive[i]) < (int)gridDim.x) {
        if (clock64() - t0 > SPIN_LIMIT) __trap();
      }
      s_key = atomicOr(&g.keys[i], 0ull);
    }
    __syncthreads();
    const unsigned long long key = s_key;

    // 4. the booking
    if (key == NO_KEY) {
      bad = bad || gid > 0;
    } else if (tid == 0) {
      const int node = (int)(key & 0xFFFFFFull);
      const int k = (int)((key >> 24) & 0xFFull);
      if (blockIdx.x == 0) {
        g.out_node[i] = node;
        g.out_k[i] = k;
      }
      const int l = node - n0;
      if (l >= 0 && l < live) {
        uint32_t cand, chosen;
        float F[R];
        eval_node(b, l, prio_i, r, all_zero, cand, F, chosen);
        if (cur > 0) {
          float* u = undo + (size_t)nlog * (2 + R);
          u[0] = __int_as_float(l);
          u[1] = __uint_as_float(b.taken[l]);
          for (int q = 0; q < R; ++q) u[2 + q] = b.extra[q * NB + l];
          ++nlog;
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          b.extra[q * NB + l] = b.extra[q * NB + l] + (r[q] - F[q]);
        b.taken[l] |= chosen;
      }
    }
    // nlog is thread 0's; the others only need the barrier
    __syncthreads();
  }
}

}  // namespace

// One cooperative launch. `blocks` (at most the card's SMs) must be
// co-resident, which the cooperative launch checks: it fails rather than
// hang. Returns cudaGetLastError() (or the launch's error).
extern "C" int ktpu_preemption_pass(
    const float* alloc, const float* base, const float* masked, const float* req_p,
    const int* prio_p, const uint8_t* part, const int* gang_id, const int* v_prio,
    const float* v_req, const uint8_t* v_ok, int* out_node, int* out_k,
    unsigned long long* keys, int* arrive, float* undo, int P, int N, int S,
    int blocks, cudaStream_t stream) {
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  if (S < 1 || S > 32 || blocks < 1 || N >= (1 << 24)) return (int)cudaErrorInvalidValue;
  Args g;
  g.alloc = alloc;
  g.base = base;
  g.masked = masked;
  g.req_p = req_p;
  g.prio_p = prio_p;
  g.part = part;
  g.gang_id = gang_id;
  g.v_prio = v_prio;
  g.v_req = v_req;
  g.v_ok = v_ok;
  g.out_node = out_node;
  g.out_k = out_k;
  g.keys = keys;
  g.arrive = arrive;
  g.undo = undo;
  g.P = P;
  g.N = N;
  g.S = S;
  g.NB = (N + blocks - 1) / blocks;
  g.req_smem = smem_bytes(S, g.NB, true) <= (size_t)MAX_SMEM;
  const size_t smem = smem_bytes(S, g.NB, g.req_smem);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      preemption_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)preemption_kernel, dim3(blocks),
                                    dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
