// The rate of mma.sync m16n8k8 TF32 on this card, with nothing else in the
// loop, and with the three-pass product of tf32x3.cuh (three MMAs per
// product) around it, both operands split in registers (as the engine
// does) or only A (as with weights split ahead of time). It bounds what
// the engine of the PointNet kernels can reach with mma.sync;
// ops/mma_probe.py runs it.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kTiles = 16;  // independent accumulators per warp

// One TF32 pass per step on kTiles accumulators.
__global__ void __launch_bounds__(256) one_pass(const float* in, float* out, int steps) {
  uint32_t a[4], b[2];
  const float x = in[threadIdx.x % 32];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(x + q);
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(x - q);
  float acc[kTiles][4] = {};
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) tf32x3::mma(acc[i], a, b);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) sum += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// The engine's inner step: 4 x 4 A and, if SPLIT_B, 8 x 2 B fragment
// values of a fresh k8 step split in registers, then 3 passes on each of
// 4 x 8 accumulators (kept as 16 here, reused twice, for the register
// budget).
template <bool SPLIT_B>
__global__ void __launch_bounds__(256) three_pass(const float* in, float* out, int steps) {
  const float x = in[threadIdx.x % 32];
  float acc[kTiles][4] = {};
  for (int s = 0; s < steps; ++s) {
    const float v = x + static_cast<float>(s);
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32x3::split(v * (i + 1) + q, ahi[i][q], alo[i][q]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bhi[2], blo[2];
      if constexpr (SPLIT_B) {
        tf32x3::split(v - j, bhi[0], blo[0]);
        tf32x3::split(v + j, bhi[1], blo[1]);
      } else {
        bhi[0] = __float_as_uint(x - j);
        bhi[1] = __float_as_uint(x + j);
        blo[0] = __float_as_uint(x * j);
        blo[1] = __float_as_uint(x / (j + 1));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float(&c)[4] = acc[(i * 8 + j) % kTiles];
        tf32x3::mma(c, alo[i], bhi);
        tf32x3::mma(c, ahi[i], blo);
        tf32x3::mma(c, ahi[i], bhi);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) sum += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// which 0: one_pass (kTiles MMAs a step), 1: three_pass splitting A and B,
// 2: three_pass splitting A only (96 MMAs a step).
// in: 32 floats; out: blocks * 256 floats. Returns the launch's cudaError_t.
extern "C" int mma_probe(int which, const float* in, float* out, int blocks, int steps,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    one_pass<<<blocks, 256, 0, s>>>(in, out, steps);
  } else if (which == 1) {
    three_pass<true><<<blocks, 256, 0, s>>>(in, out, steps);
  } else {
    three_pass<false><<<blocks, 256, 0, s>>>(in, out, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
