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
// Design: the stack runs layer by layer, four launches of the one engine:
// - the wrapper hands the kernel x with each frame's points padded to
//   Np = N rounded up to 16 and the channels to a multiple of 4 (zeros),
//   so that every m16 row tile of the engine lies inside one frame;
// - layers 1-3: identity prologue; the epilogue adds b' and applies ELU
//   and stores the activations (2 x D/2 + D floats a point, written and
//   read once: at (256, 30, 150) about 19 GB of device memory traffic,
//   some 6 ms at 3.35 TB/s, well under the bound);
// - layer 4: its epilogue adds b', applies ELU and sums each m16 tile's
//   16 rows over the frame's valid points (a fixed butterfly over the
//   lanes) into one partial row per 16 points; a last small kernel adds a
//   frame's Np / 16 partial rows in order and divides by N.
// No atomics: every sum has a fixed order, and a frame's pooled row does
// not depend on the other frames of the batch (each output value is one
// fixed-order dot product, and the 16-point groups start at the frame's
// first point), so serving a few crops gives the rows a 256-crop chunk
// gives. The wrapper allocates the activations for at most
// `frames_per_pass` frames and the kernel walks the batch in such passes,
// so it takes any number of frames and points.

#include <cuda_runtime.h>

#include <cstddef>

#include "tf32x3.cuh"

namespace {

using tf32x3::Acc;
using tf32x3::elu;
using tf32x3::frag_col;
using tf32x3::frag_row;

constexpr int kGroup = 16;  // points per partial row: the m16 tile
constexpr int kPoolThreads = 256;

// y[r][c] = ELU(acc + b[c]) for r < rows.
struct BiasEluStore {
  const float* bias;
  float* y;
  int rows, n;
  __device__ void operator()(Acc& acc, int row0, int col0, float*) const {
#pragma unroll
    for (int j = 0; j < tf32x3::kNT; ++j) {
      const int c = col0 + frag_col(j, 0);
      if (c >= n) continue;  // n % 4 == 0: both columns of the pair are in or out
      const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
      for (int i = 0; i < tf32x3::kMT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + frag_row(i, 2 * h);
          if (r < rows) {
            *reinterpret_cast<float2*>(y + static_cast<size_t>(r) * n + c) =
                make_float2(elu(acc[i][j][2 * h] + b0), elu(acc[i][j][2 * h + 1] + b1));
          }
        }
      }
    }
  }
};

// partial[r / 16][c] = sum of ELU(acc + b[c]) over the m16 tile's rows that
// are valid points (frame-local index < n_points), for the padded layout of
// np points a frame.
struct BiasEluGroupSum {
  const float* bias;
  float* partial;
  int rows, n, np, n_points;
  __device__ void operator()(Acc& acc, int row0, int col0, float*) const {
    const int lane = threadIdx.x % 32;
    bool valid[tf32x3::kMT][2];
#pragma unroll
    for (int i = 0; i < tf32x3::kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + frag_row(i, 2 * h);
        valid[i][h] = r < rows && r % np < n_points;
      }
    }
#pragma unroll
    for (int j = 0; j < tf32x3::kNT; ++j) {
      const int c = col0 + frag_col(j, 0);
      const bool col_ok = c < n;
      const float b0 = col_ok ? __ldg(bias + c) : 0.f;
      const float b1 = col_ok ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < tf32x3::kMT; ++i) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (valid[i][h]) {
            s0 += elu(acc[i][j][2 * h] + b0);
            s1 += elu(acc[i][j][2 * h + 1] + b1);
          }
        }
        // every lane takes part in the shuffles
        s0 = tf32x3::sum_row_groups(s0);
        s1 = tf32x3::sum_row_groups(s1);
        const int r = row0 + frag_row(i, 0);  // the tile's first row for lanes 0-3
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

cudaError_t run_pass(const float* x, int frames, int n_points, int np, int c, int h, int d,
                     const float* const (&w)[4], const float* const (&b)[4], float* act_a,
                     float* act_b, float* partial, float* out, cudaStream_t s) {
  using tf32x3::Identity;
  const int rows = frames * np;
  cudaError_t err;
  err = tf32x3::launch(x, w[0], rows, c, h, Identity{}, BiasEluStore{b[0], act_a, rows, h}, s);
  if (err != cudaSuccess) return err;
  err = tf32x3::launch(act_a, w[1], rows, h, h, Identity{}, BiasEluStore{b[1], act_b, rows, h}, s);
  if (err != cudaSuccess) return err;
  err = tf32x3::launch(act_b, w[2], rows, h, d, Identity{}, BiasEluStore{b[2], act_a, rows, d}, s);
  if (err != cudaSuccess) return err;
  err = tf32x3::launch(act_a, w[3], rows, d, d, Identity{},
                       BiasEluGroupSum{b[3], partial, rows, d, np, n_points}, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(frames, (d + kPoolThreads - 1) / kPoolThreads);
  group_mean_kernel<<<grid, kPoolThreads, 0, s>>>(partial, np / kGroup, d, n_points, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x: (frames, np, c) f32, each frame's
// points past n_points and channels past the real ones zero; np a multiple
// of 16; c, h and d multiples of 4 with h <= d. The weights transposed,
// (out, in): w1t (h, c), w2t (h, h), w3t (d, h), w4t (d, d); b1..b4; out
// (frames, d). Scratch: act_a of frames_per_pass * np * d floats, act_b of
// frames_per_pass * np * h, partial of frames_per_pass * np / 16 * d. All
// f32, contiguous, on the card. Returns the cudaError_t of the launches (0
// on success).
extern "C" int pointnet_pool_infer_f32(const float* x, const float* w1t, const float* b1,
                                       const float* w2t, const float* b2, const float* w3t,
                                       const float* b3, const float* w4t, const float* b4,
                                       float* out, float* act_a, float* act_b, float* partial,
                                       int frames, int n_points, int np, int c, int h,
                                       int d, int frames_per_pass, void* stream) {
  if (frames < 1 || n_points < 1 || np < n_points || np % kGroup != 0 || c < 4 || c % 4 != 0 ||
      h < 4 || h % 4 != 0 || d < h || d % 4 != 0 || frames_per_pass < 1 ||
      static_cast<long long>(frames_per_pass) * np * d > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* const w[4] = {w1t, w2t, w3t, w4t};
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
