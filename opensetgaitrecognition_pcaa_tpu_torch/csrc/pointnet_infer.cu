// Eval-mode PointNet stack + mean pooling over points, written by hand for
// Hopper (sm_90a) on the tensor cores, in the exact three-pass TF32 mode of
// tf32x3.cuh.
//
// Replaces opensetgaitrecognition_pcaa_tpu/ops/pallas/pointnet_infer.py::
// _pointnet_kernel. Same function: BatchNorm is folded into W', b', and
// every point of a frame runs 4 x (matmul -> + b' -> ELU) over the widths
// C -> H -> H -> D -> D (H = D // 2 in the models), then the frame's N
// points are averaged. Any widths: the engine needs C, H and D to be
// multiples of 4, and the wrapper pads them with zero weight rows and
// columns and zero biases. A padded column is ELU(0) = 0 through every
// layer and adds exact zeros to the real columns' sums; the wrapper slices
// the output back to D.
//
// What bounds it: the 3xTF32 operations. A crop of 30 frames x 150 points
// costs about 16.5 GFLOP at D = 1024 and C = 4, three tensor-core passes
// each, at 495 TFLOP/s dense TF32: 25.65 ms for a chunk of 256 crops,
// against 63.17 ms for f32 FFMA on the CUDA cores.
//
// Design: the stack runs layer by layer, four launches of the persistent
// wgmma engine of tf32x3_wgmma.cuh (TMA producer warp, two consumer
// warpgroups, A split in registers):
// - its split kernel first writes each weight transposed as two K-major
//   TF32 planes, hi and lo (tf32x3_split_planes_f32, one launch for the
//   four layers: the weights of a call are split once, not once per tile);
// - the wrapper hands the kernel x with each frame's points padded to
//   Np = N rounded up to 16 and the channels to a multiple of 4 (zeros),
//   so that every 16-row group of the engine's fragments lies inside one
//   frame (the engine's tiles start on 16-row boundaries);
// - layers 1-3: the epilogue adds b' and applies ELU (a branch-free
//   expm1f, bit for bit F.elu's value) and stores the
//   activations (2 x D/2 + D floats a point, written and read once: at
//   (256, 30, 150) about 19 GB of device memory traffic, some 6 ms at
//   3.35 TB/s, under the bound);
// - layer 4: its epilogue adds b', applies ELU and sums each warp's 16 rows
//   over the frame's valid points (a fixed butterfly over the lanes) into
//   one partial row per 16 points; a last small kernel adds a frame's
//   Np / 16 partial rows in order and divides by N.
// No atomics: every sum has a fixed order, and a frame's pooled row does
// not depend on the other frames of the batch (each output value is one
// fixed-order dot product, and the 16-point groups start at the frame's
// first point), so serving a few crops gives the rows a 256-crop chunk
// gives. The wrapper allocates the activations for at most
// `frames_per_pass` frames and the kernel walks the batch in such passes,
// so it takes any number of frames and points.

#include <cuda_runtime.h>

#include <cstddef>

#include "tf32x3_wgmma.cuh"

namespace {

using tf32x3_wgmma::Acc;
using tf32x3_wgmma::elu;
using tf32x3_wgmma::frag_col;
using tf32x3_wgmma::frag_row;

constexpr int kGroup = 16;  // points per partial row: a warp's rows of an m64 tile
constexpr int kPoolThreads = 256;
constexpr int kColSteps = tf32x3_wgmma::kBN / 8;  // n8 column steps of a tile

// y[r][c] = ELU(acc + b[c]) for r < rows.
struct BiasEluStore {
  const float* bias;
  float* y;
  int rows, n;
  __device__ void operator()(Acc& acc, int row0, int col0) const {
#pragma unroll
    for (int j = 0; j < kColSteps; ++j) {
      const int c = col0 + frag_col(j, 0);
      if (c >= n) continue;  // n % 4 == 0: both columns of the pair are in or out
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
      for (int m = 0; m < tf32x3_wgmma::kMT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + frag_row(m, 2 * h);
          if (r < rows) {
            *reinterpret_cast<float2*>(y + static_cast<size_t>(r) * n + c) = make_float2(
                elu(acc[m][4 * j + 2 * h] + b0), elu(acc[m][4 * j + 2 * h + 1] + b1));
          }
        }
      }
    }
  }
};

// partial[r / 16][c] = sum of ELU(acc + b[c]) over a warp's 16 rows of an
// m64 tile that are valid points (frame-local index < n_points), for the
// padded layout of np points a frame.
struct BiasEluGroupSum {
  const float* bias;
  float* partial;
  int rows, n, np, n_points;
  __device__ void operator()(Acc& acc, int row0, int col0) const {
    const int lane = threadIdx.x % 32;
    bool valid[tf32x3_wgmma::kMT][2];
#pragma unroll
    for (int m = 0; m < tf32x3_wgmma::kMT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + frag_row(m, 2 * h);
        valid[m][h] = r < rows && r % np < n_points;
      }
    }
#pragma unroll
    for (int j = 0; j < kColSteps; ++j) {
      const int c = col0 + frag_col(j, 0);
      const bool col_ok = c < n;
      const float b0 = col_ok ? __ldg(bias + c) : 0.f;
      const float b1 = col_ok ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int m = 0; m < tf32x3_wgmma::kMT; ++m) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (valid[m][h]) {
            s0 += elu(acc[m][4 * j + 2 * h] + b0);
            s1 += elu(acc[m][4 * j + 2 * h + 1] + b1);
          }
        }
        // every lane takes part in the shuffles
        s0 = tf32x3::sum_row_groups(s0);
        s1 = tf32x3::sum_row_groups(s1);
        const int r = row0 + frag_row(m, 0);  // the group's first row for lanes 0-3
        if (lane < 4 && col_ok && r < rows) {
          *reinterpret_cast<float2*>(partial + static_cast<size_t>(r / kGroup) * n + c) =
              make_float2(s0, s1);
        }
      }
    }
  }
};

// out[f][c] = (sum over g < groups of partial[f * groups + g][c]) / n_points.
__global__ void __launch_bounds__(kPoolThreads)
group_mean_kernel(const float* __restrict__ partial, int groups, int d, int n_points,
                  float* __restrict__ out) {
  const int c = blockIdx.y * kPoolThreads + threadIdx.x;
  if (c >= d) return;
  const float* p = partial + static_cast<size_t>(blockIdx.x) * groups * d + c;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += p[static_cast<size_t>(g) * d];
  out[static_cast<size_t>(blockIdx.x) * d + c] = s / static_cast<float>(n_points);
}

// The weights' TF32 planes: layer l's hi[l] and lo[l], each (out, in).
struct Planes {
  const float* hi[4];
  const float* lo[4];
};

cudaError_t run_pass(const float* x, int frames, int n_points, int np, int c, int h, int d,
                     const Planes& w, const float* const (&b)[4], float* act_a, float* act_b,
                     float* partial, float* out, cudaStream_t s) {
  using tf32x3_wgmma::launch;
  const int rows = frames * np;
  cudaError_t err;
  err = launch(x, w.hi[0], w.lo[0], rows, c, h, BiasEluStore{b[0], act_a, rows, h}, s);
  if (err != cudaSuccess) return err;
  err = launch(act_a, w.hi[1], w.lo[1], rows, h, h, BiasEluStore{b[1], act_b, rows, h}, s);
  if (err != cudaSuccess) return err;
  err = launch(act_b, w.hi[2], w.lo[2], rows, h, d, BiasEluStore{b[2], act_a, rows, d}, s);
  if (err != cudaSuccess) return err;
  err = launch(act_a, w.hi[3], w.lo[3], rows, d, d,
               BiasEluGroupSum{b[3], partial, rows, d, np, n_points}, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(frames, (d + kPoolThreads - 1) / kPoolThreads);
  group_mean_kernel<<<grid, kPoolThreads, 0, s>>>(partial, np / kGroup, d, n_points, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. All arrays f32, contiguous, on the card,
// 16-byte aligned; each returns the cudaError_t of its launches (0 on
// success).
//
// tf32x3_split_planes_f32: the folded weights as the JAX package stores
// them, (in, out): w1 (c, h), w2 (h, h), w3 (h, d), w4 (d, d), with c, h and
// d multiples of 4, into planes of 2 * (c*h + h*h + h*d + d*d) floats: for
// each layer in order, W^T's hi plane then its lo plane, (out, in) each.
extern "C" int tf32x3_split_planes_f32(const float* w1, const float* w2, const float* w3,
                                       const float* w4, float* planes, int c, int h, int d,
                                       void* stream) {
  if (c < 4 || c % 4 != 0 || h < 4 || h % 4 != 0 || d < 4 || d % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* const w[4] = {w1, w2, w3, w4};
  const int k_of[4] = {c, h, h, d}, n_of[4] = {h, h, d, d};
  tf32x3_wgmma::SplitArgs args;
  float* p = planes;
  for (int l = 0; l < 4; ++l) {
    const size_t size = static_cast<size_t>(k_of[l]) * n_of[l];
    args.p[l] = {w[l], p, p + size, k_of[l], n_of[l]};
    p += 2 * size;
  }
  return static_cast<int>(tf32x3_wgmma::split_planes(args, static_cast<cudaStream_t>(stream)));
}

// tf32x3_epilogue_elu_f32: the epilogues' ELU on x (n,) -> out (n,), for
// the card test that holds it to F.elu on every f32.
extern "C" int tf32x3_epilogue_elu_f32(const float* x, float* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  tf32x3_wgmma::elu_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

// pointnet_pool_infer_f32: x (frames, np, c), each frame's points past
// n_points and channels past the real ones zero; np a multiple of 16; c, h
// and d multiples of 4 with h <= d; planes as tf32x3_split_planes_f32
// writes them; b1..b4; out (frames, d). Scratch: act_a of frames_per_pass *
// np * d floats, act_b of frames_per_pass * np * h, partial of
// frames_per_pass * np / 16 * d.
extern "C" int pointnet_pool_infer_f32(const float* x, const float* planes, const float* b1,
                                       const float* b2, const float* b3, const float* b4,
                                       float* out, float* act_a, float* act_b, float* partial,
                                       int frames, int n_points, int np, int c, int h, int d,
                                       int frames_per_pass, void* stream) {
  if (frames < 1 || n_points < 1 || np < n_points || np % kGroup != 0 || c < 4 || c % 4 != 0 ||
      h < 4 || h % 4 != 0 || d < h || d % 4 != 0 || frames_per_pass < 1 ||
      static_cast<long long>(frames_per_pass) * np * d > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_of[4] = {c, h, h, d}, n_of[4] = {h, h, d, d};
  Planes w;
  const float* p = planes;
  for (int l = 0; l < 4; ++l) {
    const size_t size = static_cast<size_t>(k_of[l]) * n_of[l];
    w.hi[l] = p;
    w.lo[l] = p + size;
    p += 2 * size;
  }
  const float* const b[4] = {b1, b2, b3, b4};
  for (int f0 = 0; f0 < frames; f0 += frames_per_pass) {
    const int nf = frames - f0 < frames_per_pass ? frames - f0 : frames_per_pass;
    const cudaError_t err =
        run_pass(x + static_cast<size_t>(f0) * np * c, nf, n_points, np, c, h, d, w, b, act_a,
                 act_b, partial, out + static_cast<size_t>(f0) * d, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
