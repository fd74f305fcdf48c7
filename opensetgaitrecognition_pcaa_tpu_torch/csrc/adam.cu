// One-pass Adam update of one leaf, written by hand for Hopper (sm_90a): g
// and w f32, the moments m and v each f32 or bf16 (four variants: f32;
// m bf16; m and v bf16; v bf16), and for the two layouts of bf16 compute (m
// bf16; m and v bf16) a fifth output on request: w16, the updated weight
// rounded to bf16, the decoder's weight cache (Config.BF16_WEIGHT_CACHE).
//
// Replaces opensetgaitrecognition_pcaa_tpu/ops/pallas/adam_kernel.py::
// _adam_block_kernel. Same update, in the same order of operations:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   w' = w - (s1 m') / (sqrt(v' s2) + eps)      s1 = lr / c1, s2 = 1 / c2
//
// with g, w, m, v read once and w, m, v written once, in place. The
// arithmetic is f32 whatever the storage: a bf16 moment is upcast when
// read, the update is formed from the f32 m' and v', and m' and v' are
// rounded to bf16 (nearest even, __float2bfloat16_rn) only when stored, as
// the TPU kernel's .astype at its store and adam_lowmem do. The copy w16 is
// __float2bfloat16_rn of the updated f32 weight, taken while it is still in
// registers: the JAX package's _cache_tree cast of the new parameters, fused
// into the update's pass.
//
// What bounds it: device memory. 28 bytes per element with f32 moments
// (16 read, 12 written), 24 with m or v bf16, 20 with m and v bf16: about
// 6.0, 5.2 or 4.3 GB per step over the 215.2M elements of the four big
// decoder matrices at the published widths, so about 1.8, 1.5 or 1.3 ms at
// 3.35 TB/s. The copy adds 2 bytes an element written: 26 with m bf16, 22
// with m and v bf16.
//
// Design: a grid-stride loop over float4 groups (16-byte loads and stores,
// neighbouring threads on neighbouring addresses), and a scalar loop for a
// tail of fewer than 4 elements. Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no FMA contraction), and sqrt and division are
// the correctly rounded ones, so the kernel gives the plain PyTorch
// version's bits. A bf16 moment moves as 4 values in 8 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

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

// Group i of 4 values, and one value, of an f32 or bf16 array.
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ void store4(float* p, long long i, float4 x) {
  reinterpret_cast<float4*>(p)[i] = x;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(p)[i] = u;
}
__device__ __forceinline__ float load1(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ void store1(float* p, long long i, float x) { p[i] = x; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, long long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// kCopy: also write w16, the updated weight rounded to bf16 (a template flag:
// the variants without the copy carry no branch for it).
template <class M, class V, bool kCopy>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ g, float* __restrict__ w, M* __restrict__ m,
            V* __restrict__ v, __nv_bfloat16* __restrict__ w16, long long n, Coeffs k) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = __ldg(g4 + i);
    float4 ww = load4(w, i), mm = load4(m, i), vv = load4(v, i);
    adam_one(gg.x, ww.x, mm.x, vv.x, k);
    adam_one(gg.y, ww.y, mm.y, vv.y, k);
    adam_one(gg.z, ww.z, mm.z, vv.z, k);
    adam_one(gg.w, ww.w, mm.w, vv.w, k);
    store4(w, i, ww);
    store4(m, i, mm);
    store4(v, i, vv);
    if constexpr (kCopy) store4(w16, i, ww);
  }
  // the tail of n % 4 elements
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    float ww = w[i], mm = load1(m, i), vv = load1(v, i);
    adam_one(g[i], ww, mm, vv, k);
    w[i] = ww;
    store1(m, i, mm);
    store1(v, i, vv);
    if constexpr (kCopy) store1(w16, i, ww);
  }
}

template <class M, class V, bool kCopy = false>
int launch(const float* g, float* w, M* m, V* v, __nv_bfloat16* w16, long long n, float b1,
           float omb1, float b2, float omb2, float s1, float s2, float eps, int num_sms,
           void* stream) {
  if (n < 1 || num_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * 8;  // enough blocks in flight
  if (blocks > cap) blocks = cap;
  const Coeffs k{b1, omb1, b2, omb2, s1, s2, eps};
  adam_kernel<M, V, kCopy><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(g, w, m, v, w16, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. g, w: n contiguous f32 each, m and v n
// contiguous values of the type in the name (f32 unless named: m16, m bf16;
// mv16, m and v bf16; v16, v bf16), the f32 arrays 16-byte and the bf16 ones 8-byte
// aligned; w, m and v are updated in place. The _w16 entry points take w16, n
// contiguous bf16 (8-byte aligned), and write the updated weight there too. omb1 = 1 - b1 and omb2 = 1 - b2
// come from the caller, rounded to f32 once, as the JAX package's weakly
// typed Python scalars are. Each returns the cudaError_t of the launch (0 on
// success).
extern "C" int adam_update_f32(const float* g, float* w, float* m, float* v, long long n,
                               float b1, float omb1, float b2, float omb2, float s1, float s2,
                               float eps, int num_sms, void* stream) {
  return launch(g, w, m, v, nullptr, n, b1, omb1, b2, omb2, s1, s2, eps, num_sms, stream);
}

extern "C" int adam_update_m16(const float* g, float* w, __nv_bfloat16* m, float* v, long long n,
                               float b1, float omb1, float b2, float omb2, float s1, float s2,
                               float eps, int num_sms, void* stream) {
  return launch(g, w, m, v, nullptr, n, b1, omb1, b2, omb2, s1, s2, eps, num_sms, stream);
}

extern "C" int adam_update_mv16(const float* g, float* w, __nv_bfloat16* m, __nv_bfloat16* v,
                                long long n, float b1, float omb1, float b2, float omb2, float s1,
                                float s2, float eps, int num_sms, void* stream) {
  return launch(g, w, m, v, nullptr, n, b1, omb1, b2, omb2, s1, s2, eps, num_sms, stream);
}

extern "C" int adam_update_v16(const float* g, float* w, float* m, __nv_bfloat16* v, long long n,
                               float b1, float omb1, float b2, float omb2, float s1, float s2,
                               float eps, int num_sms, void* stream) {
  return launch(g, w, m, v, nullptr, n, b1, omb1, b2, omb2, s1, s2, eps, num_sms, stream);
}

extern "C" int adam_update_m16_w16(const float* g, float* w, __nv_bfloat16* m, float* v,
                                   __nv_bfloat16* w16, long long n, float b1, float omb1,
                                   float b2, float omb2, float s1, float s2, float eps,
                                   int num_sms, void* stream) {
  if (w16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<__nv_bfloat16, float, true>(g, w, m, v, w16, n, b1, omb1, b2, omb2, s1, s2, eps,
                                            num_sms, stream);
}

extern "C" int adam_update_mv16_w16(const float* g, float* w, __nv_bfloat16* m,
                                    __nv_bfloat16* v, __nv_bfloat16* w16, long long n, float b1,
                                    float omb1, float b2, float omb2, float s1, float s2,
                                    float eps, int num_sms, void* stream) {
  if (w16 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<__nv_bfloat16, __nv_bfloat16, true>(g, w, m, v, w16, n, b1, omb1, b2, omb2, s1,
                                                    s2, eps, num_sms, stream);
}
