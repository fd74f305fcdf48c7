// The edge pass of DGCNN's EdgeConv layer (BatchNorm over the edges, the
// extremum over each point's neighbours, LeakyReLU), forward and backward,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no DGCNN. Added for PCAA V4
// with a DGCNN encoder (models/dgcnn.py). The published layer forms the
// edge tensor [x_j - x_i, x_i] of every point and neighbour, a 1x1 conv,
// BatchNorm over every edge, LeakyReLU and a max over the k neighbours: at
// the cell's sizes (1,440,000 edges a layer, widths 64..256) autograd keeps
// about 12 GB of edges a step. Here the conv is split into per-point
// products, A = (W_b - W_a) x and B = W_a x (cuBLAS), so that an edge is
// e_ij = A_i + B_j, and the edges are never stored: the forward keeps the
// extremum over each point's neighbours (the max where gamma >= 0, the min
// where gamma < 0: BatchNorm's affine map and LeakyReLU are monotone in each
// channel) and its one-byte slot; BatchNorm's statistics are sums over the
// edges formed on the fly (ops/dgcnn_edge.py has the equations).
//
// What bounds it: memory. A forward reads A and B (4 B a point and channel
// each) and the graph, and writes the output; a backward reads the output's
// gradient, A, B and the graph and writes dA and dB; the operations, a few a
// edge and channel, take less time than those bytes at 3.35 TB/s.
//
// Design: a block takes one frame and 32 channels. It stages the frame's
// operands as (n, 32) tiles in shared memory (the forward B, the backward A,
// B, dz and the slots; 19 KB a float tile at n = 150) with the graph as
// bytes, then runs a lane a channel and a warp a point at a time: a
// neighbour's 32 channels are one conflict-free shared read. (Gathered from
// L1 instead, the layer-4 forward and backward took 0.57 and 1.63 ms at the
// cell's shapes; staged, 0.46 and 1.19.)
// - forward: the extremum, its slot and each block's f64 sums of e and e^2
//   (each thread's in a fixed order, then the warps' in order), summed over
//   the frames in order by a second kernel into the mean and the biased
//   variance; a third writes y = LeakyReLU((ext - mu) * (inv * gamma) + beta)
//   in TorchBatchNorm's order of operations.
// - backward: dz (the gradient through LeakyReLU) and the frames' f64 sums
//   of dz and dz * xhat (dbeta, dgamma) the same way; the reverse graph of
//   each frame (each point's in-edges, in edge order, by a counting pass and
//   a filling pass over the frame's edges in shared memory); then dA over
//   each point's out-edges and dB over its in-edges, each sum in edge order.
// No atomics: the same bits every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // channels a block
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kOutRows = 64;  // rows a block of the elementwise output

struct Shape {
  int frames, n, k, o;
  __host__ __device__ long long row() const { return 2LL * o; }  // ab's row: [A | B]
};

// A warp's per-lane f64 pair summed over the block's warps in order →
// partial[(f * 2 + {0, 1}) * o + c].
__device__ __forceinline__ void block_sums(double s1, double s2, const Shape& s, int f, int c,
                                           double* __restrict__ partial) {
  __shared__ double red[2][kWarps][kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  red[0][warp][lane] = s1;
  red[1][warp][lane] = s2;
  __syncthreads();
  if (warp == 0 && c < s.o) {
    double t1 = 0.0, t2 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      t1 += red[0][w][lane];
      t2 += red[1][w][lane];
    }
    partial[((long long)f * 2) * s.o + c] = t1;
    partial[((long long)f * 2 + 1) * s.o + c] = t2;
  }
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// Stage the block's frame in shared memory: `tiles` operands as (n, 32)
// tiles of the block's channels (operand t's row r at src[t] + r *
// stride[t]), the graph as bytes (n * k), and where slot_tile is given the
// extremum's slots as a byte tile after them.
struct Staged {
  unsigned char* graph;
  float* tile[3];
};

__device__ __forceinline__ Staged stage(const Shape& s, const long long* __restrict__ idx,
                                        const float* const (&src)[3], const long long (&stride)[3],
                                        int tiles, uint8_t* __restrict__ slot_tile,
                                        const uint8_t* __restrict__ slot, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  Staged st;
  float* at = reinterpret_cast<float*>(smem);
  for (int t = 0; t < tiles; ++t) st.tile[t] = at + t * s.n * kLanes;
  st.graph = smem + sizeof(float) * tiles * s.n * kLanes;
  const long long* nbf = idx + (long long)blockIdx.x * s.n * s.k;
  for (int e = threadIdx.x; e < s.n * s.k; e += kThreads) st.graph[e] = (unsigned char)nbf[e];
  const int lane = threadIdx.x % kLanes;
  const int cc = c < s.o ? c : 0;
  for (int r = threadIdx.x / kLanes; r < s.n; r += kWarps) {
    for (int t = 0; t < tiles; ++t) st.tile[t][r * kLanes + lane] = src[t][r * stride[t] + cc];
    if (slot_tile != nullptr) slot_tile[r * kLanes + lane] = slot[r * (long long)s.o + cc];
  }
  __syncthreads();
  return st;
}

__host__ __device__ size_t staged_bytes(const Shape& s, int tiles, int byte_tiles) {
  return sizeof(float) * tiles * s.n * kLanes + (size_t)s.n * s.k +
         (size_t)byte_tiles * s.n * kLanes;
}

__global__ void __launch_bounds__(kThreads)
    dgcnn_edge_fwd(Shape s, const float* __restrict__ ab, const long long* __restrict__ idx,
                   const float* __restrict__ gamma, float* __restrict__ ext,
                   uint8_t* __restrict__ slot, double* __restrict__ partial) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int c = blockIdx.y * kLanes + lane;
  const int cc = c < s.o ? c : 0;  // lanes past the width read channel 0 and write nothing
  const bool take_max = gamma[cc] >= 0.0f;
  const long long row = s.row();
  const float* abf = ab + (long long)f * s.n * row;
  const float* const src[3] = {abf + s.o, nullptr, nullptr};
  const long long strides[3] = {row, 0, 0};
  const Staged st = stage(s, idx, src, strides, 1, nullptr, nullptr, c);
  const float* sb = st.tile[0];
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x / kLanes; i < s.n; i += kWarps) {
    const unsigned char* nb = st.graph + i * s.k;
    const float a = abf[i * row + cc];
    float best = __fadd_rn(a, sb[nb[0] * kLanes + lane]);
    int arg = 0;
    s1 += best;
    s2 = fma((double)best, (double)best, s2);
    for (int q = 1; q < s.k; ++q) {
      const float e = __fadd_rn(a, sb[nb[q] * kLanes + lane]);
      if (take_max ? e > best : e < best) {
        best = e;
        arg = q;
      }
      s1 += e;
      s2 = fma((double)e, (double)e, s2);
    }
    if (c < s.o) {
      const long long at = ((long long)f * s.n + i) * s.o + c;
      ext[at] = best;
      slot[at] = (uint8_t)arg;
    }
  }
  if (partial != nullptr) block_sums(s1, s2, s, f, c, partial);
}

// The frames' sums in frame order → mean and biased variance (forward), or
// dbeta and dgamma (backward: the sums as they are).
__global__ void dgcnn_edge_moments(Shape s, const double* __restrict__ partial, int normalise,
                                   float* __restrict__ first, float* __restrict__ second) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= s.o) return;
  double t1 = 0.0, t2 = 0.0;
  for (int f = 0; f < s.frames; ++f) {
    t1 += partial[((long long)f * 2) * s.o + c];
    t2 += partial[((long long)f * 2 + 1) * s.o + c];
  }
  if (normalise) {
    const double m = (double)s.frames * s.n * s.k;
    const double mean = t1 / m;
    t1 = mean;
    t2 = fmax(t2 / m - mean * mean, 0.0);
  }
  first[c] = (float)t1;
  second[c] = (float)t2;
}

__global__ void __launch_bounds__(kThreads)
    dgcnn_edge_out(Shape s, const float* __restrict__ ext, const float* __restrict__ mean,
                   const float* __restrict__ var, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float eps, float slope,
                   float* __restrict__ y) {
  const int c = blockIdx.y * kLanes + threadIdx.x % kLanes;
  if (c >= s.o) return;
  const float scale = __fmul_rn(inv_std(var[c], eps), gamma[c]);
  const float mu = mean[c], b = beta[c];
  const long long rows = (long long)s.frames * s.n;
  const long long end = min(rows, (long long)(blockIdx.x + 1) * kOutRows);
  for (long long r = (long long)blockIdx.x * kOutRows + threadIdx.x / kLanes; r < end;
       r += kWarps) {
    const float z = __fadd_rn(__fmul_rn(__fsub_rn(ext[r * s.o + c], mu), scale), b);
    y[r * s.o + c] = z > 0.0f ? z : __fmul_rn(z, slope);
  }
}

// dz = dy through LeakyReLU; the block's f64 sums of dz and dz * xhat.
__global__ void __launch_bounds__(kThreads)
    dgcnn_edge_bwd_prep(Shape s, const float* __restrict__ dy, const float* __restrict__ ext,
                        const float* __restrict__ mean, const float* __restrict__ var,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        float eps, float slope, float* __restrict__ dz,
                        double* __restrict__ partial) {
  const int f = blockIdx.x;
  const int c = blockIdx.y * kLanes + threadIdx.x % kLanes;
  const int cc = c < s.o ? c : 0;
  const float inv = inv_std(var[cc], eps);
  const float scale = __fmul_rn(inv, gamma[cc]);
  const float mu = mean[cc], b = beta[cc];
  double s1 = 0.0, s2 = 0.0;
  if (c < s.o) {
    for (int i = threadIdx.x / kLanes; i < s.n; i += kWarps) {
      const long long at = ((long long)f * s.n + i) * s.o + c;
      const float centred = __fsub_rn(ext[at], mu);
      const float z = __fadd_rn(__fmul_rn(centred, scale), b);
      const float g = z > 0.0f ? dy[at] : __fmul_rn(dy[at], slope);
      dz[at] = g;
      s1 += g;
      s2 = fma((double)g, (double)__fmul_rn(centred, inv), s2);
    }
  }
  block_sums(s1, s2, s, f, c, partial);
}

// Each frame's reverse graph: rev[f] = (n + 1 offsets, then the n * k edges
// q = i * k + slot grouped by their target point, in edge order).
__global__ void __launch_bounds__(kThreads)
    dgcnn_edge_rev(Shape s, const long long* __restrict__ idx, int* __restrict__ rev) {
  // the frame's n * k targets, then n + 1 offsets
  extern __shared__ __align__(16) unsigned char nb[];
  const int edges = s.n * s.k;
  const int words = edges / 4;
  int* offs = reinterpret_cast<int*>(nb + ((edges + 15) & ~15));
  const long long* nbf = idx + (long long)blockIdx.x * edges;
  for (int e = threadIdx.x; e < edges; e += kThreads) nb[e] = (unsigned char)nbf[e];
  __syncthreads();
  const unsigned* nb4 = reinterpret_cast<const unsigned*>(nb);
  for (int j = threadIdx.x; j < s.n; j += kThreads) {
    const unsigned key = 0x01010101u * (unsigned)j;
    int count = 0;
    for (int w = 0; w < words; ++w) count += __popc(__vcmpeq4(nb4[w], key)) / 8;
    for (int e = 4 * words; e < edges; ++e) count += nb[e] == j;
    offs[j + 1] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    offs[0] = 0;
    for (int j = 0; j < s.n; ++j) offs[j + 1] += offs[j];
  }
  __syncthreads();
  int* out = rev + (long long)blockIdx.x * (edges + s.n + 1);
  for (int j = threadIdx.x; j <= s.n; j += kThreads) out[j] = offs[j];
  int* list = out + s.n + 1;
  for (int j = threadIdx.x; j < s.n; j += kThreads) {
    const unsigned key = 0x01010101u * (unsigned)j;
    int at = offs[j];
    for (int w = 0; w < words; ++w) {
      if (__vcmpeq4(nb4[w], key) == 0u) continue;
      for (int e = 4 * w; e < 4 * w + 4; ++e)
        if (nb[e] == j) list[at++] = e;
    }
    for (int e = 4 * words; e < edges; ++e)
      if (nb[e] == j) list[at++] = e;
  }
}

// dA over each point's out-edges, dB over its in-edges.
__global__ void __launch_bounds__(kThreads)
    dgcnn_edge_bwd(Shape s, const float* __restrict__ ab, const long long* __restrict__ idx,
                   const uint8_t* __restrict__ slot, const float* __restrict__ dz,
                   const int* __restrict__ rev, const float* __restrict__ mean,
                   const float* __restrict__ var, const float* __restrict__ gamma,
                   const float* __restrict__ dgamma, const float* __restrict__ dbeta, int train,
                   float eps, float* __restrict__ d_ab) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int c = blockIdx.y * kLanes + lane;
  const long long row = s.row();
  const float* abf = ab + (long long)f * s.n * row;
  const long long base = (long long)f * s.n;
  const float* const src[3] = {abf, abf + s.o, dz + base * s.o};
  const long long strides[3] = {row, row, s.o};
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* sslot = smem + staged_bytes(s, 3, 0);
  const Staged st = stage(s, idx, src, strides, 3, sslot, slot + base * s.o, c);
  if (c >= s.o) return;
  const float *sa = st.tile[0], *sb = st.tile[1], *sdz = st.tile[2];
  const float inv = inv_std(var[c], eps);
  const float scale = __fmul_rn(inv, gamma[c]);
  const float mu = mean[c];
  const float m = (float)((double)s.frames * s.n * s.k);
  const float c1 = train ? dbeta[c] / m : 0.0f;
  const float c2 = train ? dgamma[c] / m : 0.0f;
  const int* offs = rev + (long long)f * (s.n * s.k + s.n + 1);
  const int* list = offs + s.n + 1;
  for (int p = threadIdx.x / kLanes; p < s.n; p += kWarps) {
    const unsigned char* nb = st.graph + p * s.k;
    const float a = sa[p * kLanes + lane];
    float sx = 0.0f;
    for (int q = 0; q < s.k; ++q) {
      const float e = __fadd_rn(a, sb[nb[q] * kLanes + lane]);
      sx += (e - mu) * inv;
    }
    const float da = scale * (sdz[p * kLanes + lane] - s.k * c1 - c2 * sx);

    const float b = sb[p * kLanes + lane];
    float sg = 0.0f, sxi = 0.0f;
    for (int t = offs[p]; t < offs[p + 1]; ++t) {
      const int e = list[t];
      const int i = e / s.k;
      if (sslot[i * kLanes + lane] == e - i * s.k) sg += sdz[i * kLanes + lane];
      sxi += (__fadd_rn(sa[i * kLanes + lane], b) - mu) * inv;
    }
    const float db = scale * (sg - (offs[p + 1] - offs[p]) * c1 - c2 * sxi);
    d_ab[(base + p) * row + c] = da;
    d_ab[(base + p) * row + s.o + c] = db;
  }
}

dim3 tiles(const Shape& s) { return dim3(s.frames, (s.o + kLanes - 1) / kLanes); }

size_t rev_smem(const Shape& s) {
  return (size_t)((s.n * s.k + 15) & ~15) + sizeof(int) * (size_t)(s.n + 1);
}

bool valid(const Shape& s) {
  return s.frames >= 1 && s.n >= 1 && s.n <= 256 && s.k >= 1 && s.k <= s.n && s.k <= 256 &&
         s.o >= 1;
}

}  // namespace

// Plain C entry points for ctypes; each returns the first cudaError_t of its
// launches (0 on success). ab: (frames, n, 2 o) f32, [A | B]; idx: (frames,
// n, k) int64, k <= n <= 256; gamma, beta, mean, var: (o,) f32; ext, y, dz,
// d_ab's halves: (frames, n, o) f32; slot: (frames, n, o) uint8; partial:
// (frames, 2, o) f64 scratch; rev: (frames, n k + n + 1) int32 scratch.
//
// dgcnn_edge_forward: train → ext, slot, the batch mean and biased variance
// into mean and var, and y; eval (train 0, partial unused) → ext, slot and y
// from the given mean and var.
extern "C" int dgcnn_edge_forward(const float* ab, const long long* idx, const float* gamma,
                                  const float* beta, int frames, int n, int k, int o, int train,
                                  float eps, float slope, float* ext, uint8_t* slot,
                                  double* partial, float* mean, float* var, float* y,
                                  void* stream) {
  const Shape s{frames, n, k, o};
  if (!valid(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = staged_bytes(s, 1, 0);
  cudaError_t err = cudaFuncSetAttribute(dgcnn_edge_fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dgcnn_edge_fwd<<<tiles(s), kThreads, smem, st>>>(s, ab, idx, gamma, ext, slot,
                                                    train ? partial : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (train) {
    dgcnn_edge_moments<<<(o + kThreads - 1) / kThreads, kThreads, 0, st>>>(s, partial, 1, mean,
                                                                            var);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = (long long)frames * n;
  const dim3 grid((unsigned)((rows + kOutRows - 1) / kOutRows), (o + kLanes - 1) / kLanes);
  dgcnn_edge_out<<<grid, kThreads, 0, st>>>(s, ext, mean, var, gamma, beta, eps, slope, y);
  return (int)cudaGetLastError();
}

// dgcnn_edge_backward: dy (frames, n, o) → d_ab, dgamma, dbeta; dz, partial
// and rev are scratch. train 0 leaves out BatchNorm's terms over the edges
// (eval mode's fixed statistics).
extern "C" int dgcnn_edge_backward(const float* dy, const float* ab, const long long* idx,
                                   const float* ext, const uint8_t* slot, const float* mean,
                                   const float* var, const float* gamma, int frames, int n,
                                   int k, int o, int train, float eps, float slope,
                                   const float* beta, float* dz, double* partial, int* rev,
                                   float* d_ab, float* dgamma, float* dbeta, void* stream) {
  const Shape s{frames, n, k, o};
  if (!valid(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dgcnn_edge_bwd_prep<<<tiles(s), kThreads, 0, st>>>(s, dy, ext, mean, var, gamma, beta, eps,
                                                      slope, dz, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dgcnn_edge_moments<<<(o + kThreads - 1) / kThreads, kThreads, 0, st>>>(s, partial, 0, dbeta,
                                                                          dgamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dgcnn_edge_rev, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rev_smem(s));
  if (err != cudaSuccess) return (int)err;
  dgcnn_edge_rev<<<frames, kThreads, rev_smem(s), st>>>(s, idx, rev);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = staged_bytes(s, 3, 1);
  err = cudaFuncSetAttribute(dgcnn_edge_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dgcnn_edge_bwd<<<tiles(s), kThreads, smem, st>>>(s, ab, idx, slot, dz, rev, mean, var, gamma,
                                                    dgamma, dbeta, train, eps, d_ab);
  return (int)cudaGetLastError();
}
