// Point grouping of P4Transformer's tube embedding (P4DConv), written by hand
// for Hopper (sm_90a): farthest-point sampling of each anchor frame, and
// the ball query of each anchor on the frames of its temporal kernel.
//
// Replaces no TPU kernel: the JAX package has no P4Transformer. Added for
// PCAA V4 with a P4Transformer encoder (models/p4t.py), whose anchors and
// balls pointnet2's CUDA ops compute in the published code.
//
// Both kernels give the plain PyTorch versions' indices bit for bit
// (ops/p4t_group.py): every squared distance is ((dx*dx + dy*dy) + dz*dz)
// with dx = p - a, each product and sum rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), as the plain version's
// separate elementwise ops round them.
//
// Farthest-point sampling: from index 0, each next anchor is the point of
// the largest squared distance to its nearest chosen anchor (the minimum
// runs over every point, chosen ones included), ties to the lowest index, as
// torch.argmax gives them. What bounds it: latency. m - 1 dependent rounds of
// a scan over n points and an argmax, about 75 rounds of 150 points a frame
// at the published sizes. Design: one warp per frame, the frame's points and
// running distances in shared memory, each lane scanning its points in
// ascending order and a butterfly of shuffles reducing (distance, index)
// with the lowest index winning a tie, so every lane holds the anchor.
//
// Ball query (pointnet2's ball_query): for each anchor and each frame of its
// temporal kernel, the first K point indices, ascending, with squared
// distance below r2; the slots left are filled with the first index found,
// or 0 where none is. What bounds it: latency of the scans, 54,000 of them at
// the published sizes. Design: one block per (crop, output frame, kernel
// frame), the neighbour frame's points in shared memory, one warp per anchor
// testing 32 points at a time, __ballot_sync and a population count giving
// each found point its slot in index order, the scan stopping once K are
// found.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBallThreads = 256;

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float ax, float ay,
                                         float az) {
  const float dx = __fsub_rn(px, ax), dy = __fsub_rn(py, ay), dz = __fsub_rn(pz, az);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// points: frame f = (b, l) at points + b * batch_stride + l * frame_stride,
// point k at + k * point_stride, coordinates 0..2; one warp (block) a frame.
__global__ void p4t_fps_kernel(const float* __restrict__ points, long long batch_stride,
                               long long frame_stride, int point_stride, int frames, int n,
                               int m, long long* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* dist = pz + n;
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  const float* p = points + (frame / frames) * batch_stride + (frame % frames) * frame_stride;
  for (int k = lane; k < n; k += 32) {
    px[k] = p[(long long)k * point_stride];
    py[k] = p[(long long)k * point_stride + 1];
    pz[k] = p[(long long)k * point_stride + 2];
    dist[k] = INFINITY;
  }
  __syncwarp();
  long long* o = out + (long long)frame * m;
  int old = 0;
  if (lane == 0) o[0] = 0;
  for (int j = 1; j < m; ++j) {
    const float ax = px[old], ay = py[old], az = pz[old];
    float best = -1.0f;
    int besti = 0;
    for (int k = lane; k < n; k += 32) {  // each lane's points ascending: its first maximum
      const float d = fminf(sq_dist(px[k], py[k], pz[k], ax, ay, az), dist[k]);
      dist[k] = d;
      if (d > best) {
        best = d;
        besti = k;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, besti, off);
      if (ob > best || (ob == best && oi < besti)) {
        best = ob;
        besti = oi;
      }
    }
    old = besti;
    if (lane == 0) o[j] = old;
  }
}

// x: (B, T, N, C) contiguous; anchor: (B, L, M) indices into the anchor
// frames; out: (B, L, M, KT, K). Block (b, l, s): the neighbour frame
// clamp(stride * l + s - pad, 0, T - 1), the anchors on frame
// stride * l + KT / 2 - pad.
__global__ void p4t_ball_query_kernel(const float* __restrict__ x,
                                      const long long* __restrict__ anchor, int t_len, int n,
                                      int c, int l_len, int m, int kt, int stride, int pad,
                                      float r2, int k_max, long long* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  const int s = blockIdx.x % kt;
  const int bl = blockIdx.x / kt;
  const int l = bl % l_len;
  const int b = bl / l_len;
  const int nb_frame = min(max(stride * l + s - pad, 0), t_len - 1);
  const int an_frame = stride * l + kt / 2 - pad;
  const float* fr = x + ((long long)b * t_len + nb_frame) * n * c;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    px[k] = fr[(long long)k * c];
    py[k] = fr[(long long)k * c + 1];
    pz[k] = fr[(long long)k * c + 2];
  }
  __syncthreads();
  const float* af = x + ((long long)b * t_len + an_frame) * n * c;
  const int lane = threadIdx.x & 31;
  for (int mi = threadIdx.x >> 5; mi < m; mi += blockDim.x >> 5) {
    const long long ai = anchor[(long long)bl * m + mi];
    const float ax = af[ai * c], ay = af[ai * c + 1], az = af[ai * c + 2];
    long long* o = out + (((long long)bl * m + mi) * kt + s) * k_max;
    int cnt = 0, first = 0;
    for (int base = 0; base < n && cnt < k_max; base += 32) {
      const int k = base + lane;
      const bool in = k < n && sq_dist(px[k], py[k], pz[k], ax, ay, az) < r2;
      const unsigned mask = __ballot_sync(kFull, in);
      if (mask == 0) continue;
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int slot = cnt + __popc(mask & ((1u << lane) - 1u));
      if (in && slot < k_max) o[slot] = k;
      cnt += __popc(mask);
    }
    for (int q = min(cnt, k_max) + lane; q < k_max; q += 32) o[q] = first;
  }
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of its
// launch (0 on success).
//
// p4t_fps: the first three f32 of each point of batch_frames frames (frame f
// = (f / frames, f % frames) at points + (f / frames) * batch_stride +
// (f % frames) * frame_stride, points point_stride floats apart) → out
// (batch_frames, m) int64. 1 <= m <= n.
extern "C" int p4t_fps(const float* points, long long batch_stride, long long frame_stride,
                       int point_stride, int batch_frames, int frames, int n, int m,
                       long long* out, void* stream) {
  const size_t smem = 4 * sizeof(float) * (size_t)n;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p4t_fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p4t_fps_kernel<<<batch_frames, 32, smem, (cudaStream_t)stream>>>(
      points, batch_stride, frame_stride, point_stride, frames, n, m, out);
  return (int)cudaGetLastError();
}

// p4t_ball_query: x (b, t_len, n, c) f32 contiguous, anchor (b, l_len, m)
// int64 → out (b, l_len, m, kt, k_max) int64 (module comment).
extern "C" int p4t_ball_query(const float* x, const long long* anchor, int b, int t_len, int n,
                              int c, int l_len, int m, int kt, int stride, int pad, float r2,
                              int k_max, long long* out, void* stream) {
  const size_t smem = 3 * sizeof(float) * (size_t)n;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p4t_ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p4t_ball_query_kernel<<<b * l_len * kt, kBallThreads, smem, (cudaStream_t)stream>>>(
      x, anchor, t_len, n, c, l_len, m, kt, stride, pad, r2, k_max, out);
  return (int)cudaGetLastError();
}
