// The tube embedding of P4Transformer (P4DConv with operator '+', max
// pooling over space and time, no norm, no activation), written by hand for
// Hopper (sm_90a): forward, and the weight gradient of its backward.
//
// Replaces no TPU kernel: the JAX package has no P4Transformer. Added for
// PCAA V4 with a P4Transformer encoder (models/p4t.py). For each token
// (crop b, output frame l, anchor a) and channel c:
//
//   out[c] = max over samples i of  w[c] . u_i,   w = [W_d | W_f]  (D, 5)
//   u_i    = (p_j - a, s - KT/2, f_j)   (dx, dy, dz, dt, Doppler)
//
// where sample i = s * K + k is slot k of the ball of frame s of the
// temporal kernel (ops/p4t_group.py) and j its point. Done plainly, the
// tube holds tokens x KT x K rows of D channels: 7.08 GB at the published
// sizes (18,000 tokens x 96 samples x 1024 x 4 B), and as much again in the
// max's backward. Here it stays in registers: the forward writes the
// (tokens, D) maximum and a one-byte argmax (the first maximal sample, as
// torch's running max with a strict > keeps it), and the backward reads the
// argmax to form dW[c] = sum over tokens of g[c] * u_argmax. No gradient
// reaches the crop.
//
// What bounds it: f32 arithmetic. 2 x rows x 5 x D operations forward
// (17.7 GFLOP, 0.26 ms at 67 TFLOP/s); 92 MB written (27 us at 3.35 TB/s).
// Each product and sum of w[c] . u_i is rounded on its own, in the plain
// version's order ((((w0 u0 + w1 u1) + w2 u2) + w3 u3) + w4 u4), so the
// forward gives the plain version's bits and the same argmax.
//
// Design: a block of 256 threads takes a few tokens and 1024 channels (4 a
// thread, 256 apart, so stores coalesce), its weights in registers; per
// token the block stages the KT x K sample vectors u in shared memory
// (gathered from the crop by the ball's indices), then each thread runs its
// 4 channels over them, every shared read a broadcast. The backward stages u
// the same way, accumulates its 4 x 5 sums over a chunk of tokens, and
// writes them as partials that a second kernel sums in a fixed order, in
// f64: no atomics, the same bits every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // channels a thread
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxSamples = 256;  // the argmax is one byte
constexpr int kFwdTokens = 8;
constexpr int kBwdTokens = 64;

struct Geometry {
  const float* x;               // (B, T, N, 4)
  const long long* anchor;      // (B, L, M)
  const long long* ball;        // (B, L, M, KT, K)
  int t_len, n, l_len, m, kt, k, stride, pad, tokens;
};

// Stage the sample vectors of token `tok` into u[5][samples].
__device__ __forceinline__ void stage(const Geometry& g, int tok, float (*u)[kMaxSamples]) {
  const int samples = g.kt * g.k;
  const int bl = tok / g.m;
  const int l = bl % g.l_len;
  const int b = bl / g.l_len;
  const float* af = g.x + ((long long)b * g.t_len + g.stride * l + g.kt / 2 - g.pad) * g.n * 4;
  const long long ai = g.anchor[tok];
  const float ax = af[ai * 4], ay = af[ai * 4 + 1], az = af[ai * 4 + 2];
  for (int i = threadIdx.x; i < samples; i += blockDim.x) {
    const int s = i / g.k;
    const int frame = min(max(g.stride * l + s - g.pad, 0), g.t_len - 1);
    const long long j = g.ball[(long long)tok * samples + i];
    const float* p = g.x + (((long long)b * g.t_len + frame) * g.n + j) * 4;
    u[0][i] = __fsub_rn(p[0], ax);
    u[1][i] = __fsub_rn(p[1], ay);
    u[2][i] = __fsub_rn(p[2], az);
    u[3][i] = (float)(s - g.kt / 2);
    u[4][i] = p[3];
  }
}

__device__ __forceinline__ float dot5(const float* w, float u0, float u1, float u2, float u3,
                                      float u4) {
  float v = __fmul_rn(w[0], u0);
  v = __fadd_rn(v, __fmul_rn(w[1], u1));
  v = __fadd_rn(v, __fmul_rn(w[2], u2));
  v = __fadd_rn(v, __fmul_rn(w[3], u3));
  return __fadd_rn(v, __fmul_rn(w[4], u4));
}

__global__ void __launch_bounds__(kThreads)
    p4t_tube_fwd_kernel(Geometry g, const float* __restrict__ w, int d, float* __restrict__ out,
                        uint8_t* __restrict__ arg) {
  __shared__ float u[5][kMaxSamples];
  const int samples = g.kt * g.k;
  const int c0 = blockIdx.y * kTile + threadIdx.x;
  float wr[kPerThread][5];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int c = c0 + q * kThreads;
#pragma unroll
    for (int e = 0; e < 5; ++e) wr[q][e] = c < d ? w[c * 5 + e] : 0.0f;
  }
  const int tok_end = min(g.tokens, (int)(blockIdx.x + 1) * kFwdTokens);
  for (int tok = blockIdx.x * kFwdTokens; tok < tok_end; ++tok) {
    __syncthreads();  // the previous token's reads are done
    stage(g, tok, u);
    __syncthreads();
    float best[kPerThread];
    int besti[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      best[q] = dot5(wr[q], u[0][0], u[1][0], u[2][0], u[3][0], u[4][0]);
      besti[q] = 0;
    }
    for (int i = 1; i < samples; ++i) {
      const float u0 = u[0][i], u1 = u[1][i], u2 = u[2][i], u3 = u[3][i], u4 = u[4][i];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const float v = dot5(wr[q], u0, u1, u2, u3, u4);
        if (v > best[q]) {
          best[q] = v;
          besti[q] = i;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int c = c0 + q * kThreads;
      if (c < d) {
        out[(long long)tok * d + c] = best[q];
        arg[(long long)tok * d + c] = (uint8_t)besti[q];
      }
    }
  }
}

// partial: (chunks, d, 5), the sums of one chunk of kBwdTokens tokens.
__global__ void __launch_bounds__(kThreads)
    p4t_tube_bwd_kernel(Geometry g, const float* __restrict__ grad,
                        const uint8_t* __restrict__ arg, int d, float* __restrict__ partial) {
  __shared__ float u[5][kMaxSamples];
  const int c0 = blockIdx.y * kTile + threadIdx.x;
  float acc[kPerThread][5];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q)
#pragma unroll
    for (int e = 0; e < 5; ++e) acc[q][e] = 0.0f;
  const int tok_end = min(g.tokens, (int)(blockIdx.x + 1) * kBwdTokens);
  for (int tok = blockIdx.x * kBwdTokens; tok < tok_end; ++tok) {
    __syncthreads();
    stage(g, tok, u);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int c = c0 + q * kThreads;
      if (c < d) {
        const float gv = grad[(long long)tok * d + c];
        const int i = arg[(long long)tok * d + c];
#pragma unroll
        for (int e = 0; e < 5; ++e) acc[q][e] = fmaf(gv, u[e][i], acc[q][e]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int c = c0 + q * kThreads;
    if (c < d) {
#pragma unroll
      for (int e = 0; e < 5; ++e) partial[((long long)blockIdx.x * d + c) * 5 + e] = acc[q][e];
    }
  }
}

__global__ void p4t_tube_reduce_kernel(const float* __restrict__ partial, int chunks, int n,
                                       float* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += (double)partial[(long long)k * n + i];
  dw[i] = (float)s;
}

Geometry geometry(const float* x, const long long* anchor, const long long* ball, int b,
                  int t_len, int n, int l_len, int m, int kt, int k, int stride, int pad) {
  return Geometry{x, anchor, ball, t_len, n, l_len, m, kt, k, stride, pad, b * l_len * m};
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of its
// launch (0 on success). x: (b, t_len, n, 4) f32 contiguous; anchor (b,
// l_len, m) and ball (b, l_len, m, kt, k) int64; w: (d, 5) f32, [W_d | W_f].
// kt * k <= 256.
//
// p4t_tube_forward → out (b, l_len, m, d) f32 and arg (the same shape)
// uint8: each channel's maximum and its first maximal sample.
extern "C" int p4t_tube_forward(const float* x, const long long* anchor, const long long* ball,
                                int b, int t_len, int n, int l_len, int m, int kt, int k,
                                int stride, int pad, const float* w, int d, float* out,
                                uint8_t* arg, void* stream) {
  if (kt * k > kMaxSamples || kt * k < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(x, anchor, ball, b, t_len, n, l_len, m, kt, k, stride, pad);
  const dim3 grid((g.tokens + kFwdTokens - 1) / kFwdTokens, (d + kTile - 1) / kTile);
  p4t_tube_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g, w, d, out, arg);
  return (int)cudaGetLastError();
}

// p4t_tube_chunks: the number of token chunks of the backward's partials.
extern "C" int p4t_tube_chunks(int tokens) { return (tokens + kBwdTokens - 1) / kBwdTokens; }

// p4t_tube_backward: grad (b, l_len, m, d) f32 and forward's arg → dw (d, 5)
// f32, through partial (p4t_tube_chunks(b * l_len * m), d, 5) f32 scratch.
extern "C" int p4t_tube_backward(const float* x, const long long* anchor, const long long* ball,
                                 int b, int t_len, int n, int l_len, int m, int kt, int k,
                                 int stride, int pad, const float* grad, const uint8_t* arg,
                                 int d, float* partial, float* dw, void* stream) {
  if (kt * k > kMaxSamples || kt * k < 1) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(x, anchor, ball, b, t_len, n, l_len, m, kt, k, stride, pad);
  const int chunks = (g.tokens + kBwdTokens - 1) / kBwdTokens;
  const dim3 grid(chunks, (d + kTile - 1) / kTile);
  p4t_tube_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g, grad, arg, d, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = d * 5;
  p4t_tube_reduce_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(partial, chunks, n_out, dw);
  return (int)cudaGetLastError();
}
