// Fused static feasibility mask for a (pods x nodes) batch.
//
// Replaces kubernetes_tpu/ops/pallas_kernels.py::fused_static_mask (body
// `_kernel`). For every (pod p, node n) it writes one byte:
//
//   valid(n)                                  sign bit of node_bits clear
//   & no hard condition bit (NotReady, NetworkUnavailable, OutOfDisk,
//     DiskPressure, Unschedulable)
//   & !(MemoryPressure(n) & best_effort(p))
//   & sel_onehot[p] . sel_member[n]  >= sel_count[p]     (nodeSelector)
//   & untol[p]      . hard_member[n] == 0                 (hard taints)
//   & (pod_lo[p] == 0 | (pod_lo[p] == name_lo[n] & pod_hi[p] == name_hi[n]))
//
// Design: bit-set operands, a byte-bound epilogue.
//
// 1. Packing (`pack_rows`, one launch over the P pod rows and the N node
//    rows). The four matching operands are 0/1 by construction (one-hot
//    selector terms, membership rows, untolerated = 1 - tolerated), so
//    each row is packed into 32-bit words with __ballot_sync(x != 0): bit b
//    of word w is column 32w + b, the selector words first, then the taint
//    words, zero past the last column. Then, exactly for 0/1 operands,
//      sel_onehot[p] . sel_member[n]  = sum_w popc(sel_p[w] & sel_n[w])
//      untol[p] . hard_member[n] == 0  <=> OR_w (untol_p[w] & hard_n[w]) == 0
//    and no product is run at all. The launch reads each f32 row once,
//    coalesced (one warp per row, 128 bytes per ballot).
// 2. The mask (`static_mask_kernel`). One block of 256 threads covers 64
//    pods x 512 nodes. The tile's node words, a per-node condition code
//    (bit 0: valid and no hard condition; bit 1: also no MemoryPressure,
//    the test for BestEffort pods) and the two name lanes, and the tile's
//    pod words, counts and name lanes, are staged in shared memory once.
//    A warp takes one pod at a time; lane l owns nodes 16l .. 16l+15 of
//    the tile, kept at [j][33]-padded positions j*33 + l, so a warp's
//    shared reads hit 32 distinct banks. The pod's words are warp-uniform:
//    a zero word (a pod with no selector, a tolerated taint word) is
//    skipped by the whole warp. Each lane then packs its 16 bytes and
//    stores them with one 16-byte store, so a warp writes 512 consecutive
//    bytes of one mask row. Where N is not a multiple of 16 the rows are
//    not 16-byte aligned, and the lane stores byte by byte, masked at the
//    row's end.
//
// Bound on an H100 SXM: the function must write the P*N-byte mask and read
// its operands once (about 83 MB at P=4096, N=16384: 25 us at 3.35 TB/s).
// The packed words are 1/32 of the f32 operands, and the epilogue's integer
// work per output (a few ANDs, a popc per nonzero selector word, compares)
// is below that bytes floor, so the kernel is write-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TP = 64;                 // pods per block
constexpr int PER_LANE = 16;           // consecutive nodes per lane
constexpr int TN = 32 * PER_LANE;      // nodes per block (one warp row)
constexpr int LD = 33;                 // padded row of a shared plane
constexpr int PLANE = PER_LANE * LD;   // words of one shared node plane
constexpr int POD_COLUMNS = 4;         // shared pod columns: count, shift, lo, hi
constexpr int MAX_SMEM = 232448;       // opt-in shared memory of one block

constexpr unsigned NOT_READY = 1u << 0;
constexpr unsigned MEMORY_PRESSURE = 1u << 1;
constexpr unsigned DISK_PRESSURE = 1u << 2;
constexpr unsigned NETWORK_UNAVAILABLE = 1u << 3;
constexpr unsigned OUT_OF_DISK = 1u << 4;
constexpr unsigned UNSCHEDULABLE = 1u << 5;
constexpr unsigned HARD_BITS = NOT_READY | NETWORK_UNAVAILABLE | OUT_OF_DISK
                               | DISK_PRESSURE | UNSCHEDULABLE;
constexpr unsigned INVALID_ROW = 0x80000000u;

// Row r < P of the launch is pod row r, row P + i is node row i. Its words
// are the bits of a[r, :Ka] in words 0..Wa-1, then the bits of b[r, :Kb] in
// words Wa..W-1 (Wa = ceil(Ka/32)). One warp per row.
__global__ void __launch_bounds__(THREADS) pack_rows(
    const float* __restrict__ pod_a, const float* __restrict__ pod_b, int P,
    const float* __restrict__ node_a, const float* __restrict__ node_b, int N,
    int Ka, int Kb, uint32_t* __restrict__ pod_out,
    uint32_t* __restrict__ node_out, int W) {
  const int lane = threadIdx.x % 32;
  int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= P + N) return;
  const bool pod = row < P;
  if (!pod) row -= P;
  const float* a = pod ? pod_a : node_a;
  const float* b = pod ? pod_b : node_b;
  uint32_t* out = (pod ? pod_out : node_out) + (size_t)row * W;
  const int Wa = (Ka + 31) / 32;
  for (int w = 0; w < W; ++w) {
    const bool first = w < Wa;
    const int k = (first ? w : w - Wa) * 32 + lane;
    const int K = first ? Ka : Kb;
    const float* src = first ? a : b;
    const float x = k < K ? src[(size_t)row * K + k] : 0.0f;
    const unsigned bits = __ballot_sync(0xffffffffu, x != 0.0f);
    if (lane == 0) out[w] = bits;
  }
}

constexpr size_t mask_smem_bytes(int W) {
  // W node-word planes, then code, lo and hi planes; the pods' words and
  // their four columns
  return ((size_t)(W + 3) * PLANE + (size_t)TP * (W + POD_COLUMNS))
         * sizeof(uint32_t);
}

__global__ void __launch_bounds__(THREADS) static_mask_kernel(
    const uint32_t* __restrict__ pod_words, const float* __restrict__ sel_count,
    const uint8_t* __restrict__ best_effort, const int* __restrict__ pod_lo,
    const int* __restrict__ pod_hi, const uint32_t* __restrict__ node_words,
    const int* __restrict__ node_bits, const int* __restrict__ name_lo,
    const int* __restrict__ name_hi, uint8_t* __restrict__ out, int P, int N,
    int WS, int W) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_code = smem + W * PLANE;
  int* s_lo = reinterpret_cast<int*>(s_code + PLANE);
  int* s_hi = s_lo + PLANE;
  uint32_t* s_pw = reinterpret_cast<uint32_t*>(s_hi + PLANE);   // [TP][W]
  float* s_count = reinterpret_cast<float*>(s_pw + TP * W);
  int* s_shift = reinterpret_cast<int*>(s_count + TP);
  int* s_plo = s_shift + TP;
  int* s_phi = s_plo + TP;

  const int n0 = blockIdx.x * TN;
  const int p0 = blockIdx.y * TP;
  const int t = threadIdx.x;

  // ---- stage the tile's node side (node i of the tile at (i%16)*LD + i/16)
  for (int f = t; f < TN * W; f += THREADS) {   // coalesced over [n][w]
    const int i = f / W;
    const int w = f % W;
    const int n = n0 + i;
    smem[w * PLANE + (i % PER_LANE) * LD + i / PER_LANE] =
        n < N ? node_words[(size_t)n * W + w] : 0u;
  }
  for (int i = t; i < TN; i += THREADS) {
    const int n = n0 + i;
    const int s = (i % PER_LANE) * LD + i / PER_LANE;
    unsigned code = 0u;
    int lo = 0, hi = 0;
    if (n < N) {
      const unsigned bits = (unsigned)node_bits[n];
      const unsigned base = (bits & (HARD_BITS | INVALID_ROW)) == 0u ? 1u : 0u;
      code = base | ((base && (bits & MEMORY_PRESSURE) == 0u) ? 2u : 0u);
      lo = name_lo[n];
      hi = name_hi[n];
    }
    s_code[s] = code;
    s_lo[s] = lo;
    s_hi[s] = hi;
  }
  // ---- and its pod side (rows past P: no words, never stored)
  for (int f = t; f < TP * W; f += THREADS)
    s_pw[f] = p0 + f / W < P ? pod_words[(size_t)p0 * W + f] : 0u;
  for (int q = t; q < TP; q += THREADS) {
    const int p = p0 + q;
    const bool in = p < P;
    s_count[q] = in ? sel_count[p] : 0.0f;
    s_shift[q] = in && best_effort[p] != 0 ? 1 : 0;
    s_plo[q] = in ? pod_lo[p] : 0;
    s_phi[q] = in ? pod_hi[p] : 0;
  }
  __syncthreads();

  const int lane = t % 32;
  const int warp = t / 32;
  unsigned code[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) code[j] = s_code[j * LD + lane];
  const int n = n0 + lane * PER_LANE;   // the lane's first node
  const bool vector_store = (N % PER_LANE) == 0 && n + PER_LANE <= N
                            && (reinterpret_cast<uintptr_t>(out) % 16) == 0;

  for (int q = warp; q < TP; q += WARPS) {
    const int p = p0 + q;
    if (p >= P) break;                   // warp-uniform
    const uint32_t* pw = s_pw + q * W;
    int sat[PER_LANE];
    unsigned viol[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      sat[j] = 0;
      viol[j] = 0u;
    }
    for (int w = 0; w < WS; ++w) {
      const unsigned a = pw[w];          // uniform: the warp skips zero words
      if (a == 0u) continue;
      const uint32_t* plane = smem + w * PLANE + lane;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) sat[j] += __popc(a & plane[j * LD]);
    }
    for (int w = WS; w < W; ++w) {
      const unsigned a = pw[w];
      if (a == 0u) continue;
      const uint32_t* plane = smem + w * PLANE + lane;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) viol[j] |= a & plane[j * LD];
    }
    const float count = s_count[q];
    const bool check_sel = !(count <= 0.0f);   // NaN counts fail every node
    const int shift = s_shift[q];
    const int lo = s_plo[q];
    const int hi = s_phi[q];

    unsigned packed[PER_LANE / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      bool ok = ((code[j] >> shift) & 1u) != 0u && viol[j] == 0u;
      if (check_sel) ok = ok && (float)sat[j] >= count;
      if (lo != 0) ok = ok && s_lo[j * LD + lane] == lo && s_hi[j * LD + lane] == hi;
      packed[j / 4] |= (ok ? 1u : 0u) << (8 * (j % 4));
    }
    uint8_t* row = out + (size_t)p * N;
    if (vector_store) {
      *reinterpret_cast<uint4*>(row + n) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (n + j < N) row[n + j] = (uint8_t)((packed[j / 4] >> (8 * (j % 4))) & 1u);
    }
  }
}

}  // namespace

// words u32[P + N, W] is scratch the caller allocates, the pods' rows
// first, W = ceil(US/32) + ceil(UT/32).
extern "C" int ktpu_static_mask(
    const float* sel_onehot, const float* sel_count, const float* untol,
    const uint8_t* best_effort, const int* pod_lo, const int* pod_hi,
    const float* sel_member, const float* hard_member, const int* node_bits,
    const int* name_lo, const int* name_hi, uint8_t* out, uint32_t* words,
    int P, int N, int US, int UT, cudaStream_t stream) {
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  const int WS = (US + 31) / 32;
  const int W = WS + (UT + 31) / 32;
  const size_t smem = mask_smem_bytes(W);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      static_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  uint32_t* pod_words = words;
  uint32_t* node_words = words + (size_t)P * W;
  if (W > 0) {
    pack_rows<<<(P + N + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
        sel_onehot, untol, P, sel_member, hard_member, N, US, UT, pod_words,
        node_words, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + TN - 1) / TN, (P + TP - 1) / TP);
  static_mask_kernel<<<grid, THREADS, smem, stream>>>(
      pod_words, sel_count, best_effort, pod_lo, pod_hi, node_words, node_bits,
      name_lo, name_hi, out, P, N, WS, W);
  return (int)cudaGetLastError();
}
