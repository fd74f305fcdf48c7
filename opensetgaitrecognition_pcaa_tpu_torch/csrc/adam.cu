// One-pass Adam update of one f32 leaf, written by hand for Hopper (sm_90a).
//
// Replaces opensetgaitrecognition_pcaa_tpu/ops/pallas/adam_kernel.py::
// _adam_block_kernel. Same update, in the same order of operations:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   w' = w - (s1 m') / (sqrt(v' s2) + eps)      s1 = lr / c1, s2 = 1 / c2
//
// with g, w, m, v read once and w, m, v written once, in place.
//
// What bounds it: device memory. 16 bytes read and 12 written per element:
// about 6.0 GB per step over the 215.2M elements of the four big decoder
// matrices at the published widths, so about 1.8 ms at 3.35 TB/s.
//
// Design: a grid-stride loop over float4 groups (16-byte loads and stores,
// neighbouring threads on neighbouring addresses), and a scalar loop for a
// tail of fewer than 4 elements. Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no FMA contraction), and sqrt and division are
// the correctly rounded ones, so the kernel gives the plain PyTorch
// version's bits.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

struct Coeffs {
  float b1, omb1, b2, omb2, s1, s2, eps;
};

__device__ __forceinline__ void adam_one(float g, float& w, float& m, float& v, const Coeffs& k) {
  const float m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, k.s2)), k.eps);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(k.s1, m2), den));
  m = m2;
  v = v2;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ g, float* __restrict__ w, float* __restrict__ m,
            float* __restrict__ v, long long n, Coeffs k) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* w4 = reinterpret_cast<float4*>(w);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = __ldg(g4 + i);
    float4 ww = w4[i], mm = m4[i], vv = v4[i];
    adam_one(gg.x, ww.x, mm.x, vv.x, k);
    adam_one(gg.y, ww.y, mm.y, vv.y, k);
    adam_one(gg.z, ww.z, mm.z, vv.z, k);
    adam_one(gg.w, ww.w, mm.w, vv.w, k);
    w4[i] = ww;
    m4[i] = mm;
    v4[i] = vv;
  }
  // the tail of n % 4 elements
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    float ww = w[i], mm = m[i], vv = v[i];
    adam_one(g[i], ww, mm, vv, k);
    w[i] = ww;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// Plain C entry point for ctypes. g, w, m, v: n contiguous f32 each,
// 16-byte aligned; w, m and v are updated in place. omb1 = 1 - b1 and
// omb2 = 1 - b2 come from the caller, rounded to f32 once, as the JAX
// package's weakly typed Python scalars are. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int adam_update_f32(const float* g, float* w, float* m, float* v, long long n,
                               float b1, float omb1, float b2, float omb2, float s1, float s2,
                               float eps, int num_sms, void* stream) {
  if (n < 1 || num_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * 8;  // enough blocks in flight
  if (blocks > cap) blocks = cap;
  const Coeffs k{b1, omb1, b2, omb2, s1, s2, eps};
  adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(g, w, m, v, n, k);
  return static_cast<int>(cudaGetLastError());
}
