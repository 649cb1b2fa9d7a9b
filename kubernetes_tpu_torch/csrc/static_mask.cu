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
// Design. One block per 64-pod x 64-node output tile, 256 threads, each
// thread owning a 4 x 4 sub-tile (pods ty + 16i, nodes tx + 16j, so shared
// memory reads are conflict-free). The two products are plain tiled f32
// products: 32-deep chunks of the pod rows and node rows are staged
// transposed in shared memory and accumulated in registers. The operands
// are one-hot 0/1 values, so every partial sum is a small integer and the
// result is exact in any summation order. The compares are fused into the
// epilogue and the mask is written as bytes, so no (P x N) intermediate
// (counts, per-check masks) ever reaches device memory.
//
// Bound on an H100 SXM: the function must write the P*N-byte mask and read
// its operands once (about 83 MB at P=4096, N=16384: 25 us at 3.35 TB/s);
// the products are sparse (one-hot rows), so the operations the data needs
// are far below the f32 rate. This first version runs the dense f32
// products on the CUDA cores, which makes it compute-bound well above that
// floor; packing the one-hot operands as bit sets is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;       // pods per block tile
constexpr int TN = 64;       // nodes per block tile
constexpr int TK = 32;       // depth of one staged chunk
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

constexpr int NOT_READY = 1 << 0;
constexpr int MEMORY_PRESSURE = 1 << 1;
constexpr int DISK_PRESSURE = 1 << 2;
constexpr int NETWORK_UNAVAILABLE = 1 << 3;
constexpr int OUT_OF_DISK = 1 << 4;
constexpr int UNSCHEDULABLE = 1 << 5;
constexpr int HARD_BITS = NOT_READY | NETWORK_UNAVAILABLE | OUT_OF_DISK
                          | DISK_PRESSURE | UNSCHEDULABLE;
constexpr unsigned INVALID_ROW = 0x80000000u;

// acc[i][j] += A[p0 + ty + 16i, :] . B[n0 + tx + 16j, :] over depth K.
__device__ __forceinline__ void accumulate(
    const float* __restrict__ A, const float* __restrict__ B, int K,
    int P, int N, int p0, int n0, float (&As)[TK][TP + 1],
    float (&Bs)[TK][TN + 1], float (&acc)[4][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    // stage: (TP x TK) pod chunk and (TN x TK) node chunk, 8 loads each
    // per thread; neighbouring threads read neighbouring k (coalesced)
#pragma unroll
    for (int i = 0; i < (TP * TK) / THREADS; ++i) {
      const int idx = t + i * THREADS;
      const int r = idx / TK;
      const int k = idx % TK;
      const int p = p0 + r;
      const int n = n0 + r;
      const bool kin = k0 + k < K;
      As[k][r] = (p < P && kin) ? A[(size_t)p * K + k0 + k] : 0.0f;
      Bs[k][r] = (n < N && kin) ? B[(size_t)n * K + k0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) static_mask_kernel(
    const float* __restrict__ sel_onehot, const float* __restrict__ sel_count,
    const float* __restrict__ untol, const uint8_t* __restrict__ best_effort,
    const int* __restrict__ pod_lo, const int* __restrict__ pod_hi,
    const float* __restrict__ sel_member, const float* __restrict__ hard_member,
    const int* __restrict__ node_bits, const int* __restrict__ name_lo,
    const int* __restrict__ name_hi, uint8_t* __restrict__ out, int P, int N,
    int US, int UT) {
  __shared__ float As[TK][TP + 1];
  __shared__ float Bs[TK][TN + 1];
  const int p0 = blockIdx.y * TP;
  const int n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float sat[4][4] = {};
  float viol[4][4] = {};
  accumulate(sel_onehot, sel_member, US, P, N, p0, n0, As, Bs, sat);
  accumulate(untol, hard_member, UT, P, N, p0, n0, As, Bs, viol);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= P) continue;
    const float count = sel_count[p];
    const bool be = best_effort[p] != 0;
    const int lo = pod_lo[p];
    const int hi = pod_hi[p];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const unsigned bits = (unsigned)node_bits[n];
      bool ok = sat[i][j] >= count;
      ok &= viol[i][j] == 0.0f;
      ok &= (bits & HARD_BITS) == 0u;
      ok &= !((bits & MEMORY_PRESSURE) != 0u && be);
      ok &= (bits & INVALID_ROW) == 0u;
      ok &= lo == 0 || (lo == name_lo[n] && hi == name_hi[n]);
      out[(size_t)p * N + n] = ok ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int ktpu_static_mask(
    const float* sel_onehot, const float* sel_count, const float* untol,
    const uint8_t* best_effort, const int* pod_lo, const int* pod_hi,
    const float* sel_member, const float* hard_member, const int* node_bits,
    const int* name_lo, const int* name_hi, uint8_t* out, int P, int N, int US,
    int UT, cudaStream_t stream) {
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + TN - 1) / TN, (P + TP - 1) / TP);
  static_mask_kernel<<<grid, THREADS, 0, stream>>>(
      sel_onehot, sel_count, untol, best_effort, pod_lo, pod_hi, sel_member,
      hard_member, node_bits, name_lo, name_hi, out, P, N, US, UT);
  return (int)cudaGetLastError();
}
