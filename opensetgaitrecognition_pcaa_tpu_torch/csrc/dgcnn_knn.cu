// The k-nearest-neighbour graph of DGCNN's EdgeConv layers, in feature
// space, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no DGCNN. Added for PCAA V4
// with a DGCNN encoder (models/dgcnn.py), whose four EdgeConv layers each
// rebuild the graph of every frame on their own input features. For each
// frame f and point i, out[f, i, :] holds the k points j of the smallest
//
//   d_ij = sum over c of (h_ic - h_jc)^2
//
// summed in channel order from 0, each difference, product and sum rounded
// on its own (__fsub_rn, __fmul_rn, __fadd_rn: no fused multiply-add), the
// point itself included, nearest first, ties to the lower index: the plain
// version's arithmetic and order (ops/dgcnn_knn.py), so the indices are its
// bits.
//
// What bounds it: f32 arithmetic outside the tensor cores, 3 operations a
// pair and channel that cannot fuse: 3 x N^2 x C a frame (at the cell's
// 480 frames of 150 points, 8.4 GFLOP over the four layers' 260 input
// channels, 0.13 ms at 67 TFLOP/s, twice that at one instruction an
// operation); the selection of k of N is latency: k rounds of a warp's
// argmin.
//
// Design: a block per frame stages the frame's rows in shared memory at an
// odd stride (a lane's rows fall in different banks) and gives each warp
// rows i in turn. A lane holds the distances of j = lane + 32 t (t < 8, so
// N <= 256) in registers, each summed over the channels with h_ic read as a
// broadcast; then k rounds of a warp argmin by (distance, index) pick the
// neighbours in order, the winner's lane striking it from its set. (Four
// rows a warp, each h_jc read serving four, measured slower: 0.84 -> 1.00 ms
// at 128 channels.)

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 8;  // distances a lane: N <= 256

__device__ __forceinline__ bool before(float d0, int j0, float d1, int j1) {
  return d0 < d1 || (d0 == d1 && j0 < j1);
}

// The k nearest of one row, whose distances to j = lane + 32 t a lane holds
// in d[t]: k rounds of a warp argmin, nearest first, into oi[0..k).
__device__ __forceinline__ void pick_nearest(const float (&d)[kSlots], int lane, int slots,
                                             int n, int k, long long* __restrict__ oi) {
  unsigned taken = 0;
#pragma unroll
  for (int t = 0; t < kSlots; ++t)
    if (t >= slots || lane + 32 * t >= n) taken |= 1u << t;
  for (int r = 0; r < k; ++r) {
    float best = INFINITY;
    int bj = INT_MAX;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (!(taken >> t & 1u) && before(d[t], j, best, bj)) {
        best = d[t];
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (before(ob, oj, best, bj)) {
        best = ob;
        bj = oj;
      }
    }
    if (bj % 32 == lane) {
#pragma unroll
      for (int t = 0; t < kSlots; ++t)
        if (lane + 32 * t == bj) taken |= 1u << t;
    }
    if (lane == 0) oi[r] = bj;
  }
}

__global__ void __launch_bounds__(kThreads)
    dgcnn_knn_select(const float* __restrict__ h, int n, int c, int k,
                     long long* __restrict__ out) {
  extern __shared__ float rows[];  // n x stride
  const int stride = c | 1;
  const int f = blockIdx.x;
  const float* hf = h + (long long)f * n * c;
  for (int e = threadIdx.x; e < n * c; e += kThreads) rows[(e / c) * stride + e % c] = hf[e];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int slots = (n + 31) / 32;
  for (int i = threadIdx.x / 32; i < n; i += kWarps) {
    float d[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) d[t] = 0.0f;
    const float* hi = rows + i * stride;
    for (int ch = 0; ch < c; ++ch) {
      const float a = hi[ch];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int j = lane + 32 * t;
        if (t < slots && j < n) {
          const float diff = __fsub_rn(a, rows[j * stride + ch]);
          d[t] = __fadd_rn(d[t], __fmul_rn(diff, diff));
        }
      }
    }
    pick_nearest(d, lane, slots, n, k, out + ((long long)f * n + i) * k);
  }
}

}  // namespace

// Plain C entry point for ctypes; returns the cudaError_t of its launch (0
// on success). h: (frames, n, c) f32 contiguous; out: (frames, n, k) int64,
// k <= n <= 256; 4 x n x (c | 1) bytes of shared memory a block.
extern "C" int dgcnn_knn(const float* h, int frames, int n, int c, int k, long long* out,
                         void* stream) {
  if (n < 1 || n > 32 * kSlots || k < 1 || k > n || c < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n * (size_t)(c | 1);
  cudaError_t err = cudaFuncSetAttribute(dgcnn_knn_select,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dgcnn_knn_select<<<frames, kThreads, smem, (cudaStream_t)stream>>>(h, n, c, k, out);
  return (int)cudaGetLastError();
}
