// Per-frame bidirectional Chamfer sums, written by hand for Hopper (sm_90a),
// f32 on the CUDA cores.
//
// Replaces opensetgaitrecognition_pcaa_tpu/ops/pallas/chamfer_kernel.py::
// _chamfer_frame_kernel. Same function: for each frame f, with gt points
// x_i (N of them) and predicted points y_j (M), the squared distances
// d_ij = |x_i|^2 + |y_j|^2 - 2 x_i.y_j, and
//   out[f] = sum_j min_i d_ij + sum_i min_j d_ij.
// The N x M distance matrix never reaches device memory.
//
// What bounds it: f32 arithmetic. A frame of 150 x 150 points at C = 4 is
// 22,500 distances of about 12 FLOP each against 4.8 KB of input, so the
// work is about 56 FLOP per byte read, above the H100's f32 ridge (67
// TFLOP/s over 3.35 TB/s, 20 FLOP/B). C = 4 leaves nothing for the tensor
// cores.
//
// Design, simple first:
// - one block per frame: no cross-block reduction, no atomics, and the
//   same result whatever the batch;
// - two sweeps over the same distances: each thread owns points of one
//   cloud (in registers) and walks the other cloud, staged in shared
//   memory with its squared norms, keeping the running min; then the roles
//   swap. d_ij is computed as (|x_i|^2 + |y_j|^2) - 2 (x_i.y_j) in both
//   sweeps, and IEEE addition and fma are commutative, so both sweeps see
//   the same matrix, rounded as ops/chamfer.py::pairwise_sq_dists rounds
//   it (the product by 2 is exact, so one fma does the subtraction);
// - the staged cloud is cut into tiles of kTile points, so any N and M
//   fit;
// - each thread sums its points' minima in order, then the block sums the
//   threads' partials in a fixed tree: the result is deterministic.
//
// Later work: several owned points per thread (each shared-memory read
// then feeds more arithmetic), one sweep that keeps both minima, and the
// argmins for the backward.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 1024;      // staged points per tile
constexpr int kMaxThreads = 256;  // threads per block at most

// Sum over this thread's points p of `own` (n_own, C) of min_q d_pq, q
// over `other` (n_other, C). Every thread of the block calls it.
template <int C>
__device__ float sweep(const float* __restrict__ own, int n_own,
                       const float* __restrict__ other, int n_other,
                       float* __restrict__ tile_pts, float* __restrict__ tile_sq) {
  float sum = 0.f;
  // each thread's owned points, in order i = tid, tid + blockDim, ...
  const int per_thread = (n_own + blockDim.x - 1) / blockDim.x;
  for (int k = 0; k < per_thread; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const bool valid = i < n_own;
    float p[C];
    float pp = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      p[c] = valid ? own[static_cast<size_t>(i) * C + c] : 0.f;
      pp = c == 0 ? __fmul_rn(p[0], p[0]) : __fmaf_rn(p[c], p[c], pp);
    }
    float best = __int_as_float(0x7f800000);  // +inf
    for (int t0 = 0; t0 < n_other; t0 += kTile) {
      const int rows = n_other - t0 < kTile ? n_other - t0 : kTile;
      __syncthreads();  // the previous tile is no longer read
      for (int q = threadIdx.x; q < rows * C; q += blockDim.x) {
        tile_pts[q] = other[static_cast<size_t>(t0) * C + q];
      }
      __syncthreads();
      for (int q = threadIdx.x; q < rows; q += blockDim.x) {
        float s = __fmul_rn(tile_pts[q * C], tile_pts[q * C]);
#pragma unroll
        for (int c = 1; c < C; ++c) s = __fmaf_rn(tile_pts[q * C + c], tile_pts[q * C + c], s);
        tile_sq[q] = s;
      }
      __syncthreads();
      for (int q = 0; q < rows; ++q) {
        float dot = __fmul_rn(p[0], tile_pts[q * C]);
#pragma unroll
        for (int c = 1; c < C; ++c) dot = __fmaf_rn(p[c], tile_pts[q * C + c], dot);
        const float d = __fmaf_rn(-2.f, dot, __fadd_rn(pp, tile_sq[q]));
        best = fminf(best, d);
      }
    }
    if (valid) sum = __fadd_rn(sum, best);
  }
  return sum;
}

// Fixed-order sum of one value per thread; the result is valid in thread 0.
__device__ float block_sum(float v, float* __restrict__ scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read as a tile
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) s += scratch[w];
  }
  return s;
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
chamfer_kernel(const float* __restrict__ gts, int n, const float* __restrict__ preds, int m,
               float* __restrict__ out) {
  __shared__ __align__(16) float tile_pts[kTile * C];
  __shared__ float tile_sq[kTile];
  const size_t f = blockIdx.x;
  const float* x = gts + f * n * C;
  const float* y = preds + f * m * C;
  // min over preds for each gt point, then min over gts for each pred point
  const float to_preds = sweep<C>(x, n, y, m, tile_pts, tile_sq);
  const float to_gts = sweep<C>(y, m, x, n, tile_pts, tile_sq);
  const float a = block_sum(to_gts, tile_sq);
  const float b = block_sum(to_preds, tile_sq);
  if (threadIdx.x == 0) out[f] = __fadd_rn(a, b);
}

template <int C>
cudaError_t launch(const float* gts, const float* preds, float* out, int frames, int n, int m,
                   int threads, cudaStream_t stream) {
  chamfer_kernel<C><<<frames, threads, 0, stream>>>(gts, n, preds, m, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. gts: (frames, n, c) f32; preds:
// (frames, m, c) f32, both contiguous; out: (frames,) f32, the per-frame
// sum of min-over-gts for each pred point plus min-over-preds for each gt
// point. c: the channels a crop has, 4 (x, y, z, Doppler) or 5 (with the
// power in dB). threads: a multiple of 32 up to 256. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int seq_chamfer_frames_f32(const float* gts, const float* preds, float* out,
                                      int frames, int n, int m, int c, int threads,
                                      void* stream) {
  if (frames < 1 || n < 1 || m < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 4: return static_cast<int>(launch<4>(gts, preds, out, frames, n, m, threads, s));
    case 5: return static_cast<int>(launch<5>(gts, preds, out, frames, n, m, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
