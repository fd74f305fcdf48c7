// Per-frame bidirectional Chamfer sums, written by hand for Hopper (sm_90a),
// f32 on the CUDA cores.
//
// Replaces opensetgaitrecognition_pcaa_tpu/ops/pallas/chamfer_kernel.py::
// _chamfer_frame_kernel. Same function: for each frame f, with gt points
// x_i (N of them, the rows) and predicted points y_j (M, the columns), the
// squared distances d_ij = |x_i|^2 + |y_j|^2 - 2 x_i.y_j, and
//   out[f] = sum_j min_i d_ij + sum_i min_j d_ij.
// The N x M distance matrix never reaches device memory.
//
// What bounds it: the issue rate of the CUDA cores. A frame of 150 x 150
// points at C = 4 is 22,500 distances against 4.8 KB of input. One distance
// that feeds both minima is 8 instructions (FMUL + 3 FFMA for the dot, FADD
// for |x|^2 + |y|^2, FFMA for -2 dot, 2 FMNMX), far above the H100's f32
// ridge (67 TFLOP/s over 3.35 TB/s). Why not the tensor cores: C = 4 is a
// K too small to feed them, a TF32 dot would change the rounding the
// tolerances rely on, and the add and both minima would stay on the CUDA
// cores anyway.
//
// Design:
// - one sweep: each distance is computed once and feeds both its row
//   minimum (nearest pred of a gt point) and its column minimum (nearest gt
//   of a pred point);
// - register tiles: a warp is 16 row lanes x 2 column lanes. A thread
//   holds R gt points of a pass of 16R rows in registers, with their norms
//   and running row minima (R = 10: 160 rows cover the published NMAX =
//   150 in one pass, in few enough registers that the 1920 one-warp frames
//   of an orced_inference chunk are all resident at once). A step
//   takes kGroup = 8 staged pred points (a float4 and the norm for C = 4)
//   against the R rows: 80 distances, 8 partial column minima;
// - the 8 column minima are reduce-scattered over the 16 row lanes (3
//   halving exchanges of shuffles, then one pairing): 8 shuffles and 8
//   minima for 8 columns where one shuffle tree a column takes 32 of each.
//   A row's minimum is reduced over the 2 column lanes by a shuffle and
//   over the block's warps through shared memory, once a pass;
// - every d_ij is rounded as ops/chamfer.py::pairwise_sq_dists rounds it:
//   |x|^2, |y|^2 and x.y by __fmul_rn then __fmaf_rn in channel order,
//   d = __fmaf_rn(-2, x.y, |x|^2 + |y|^2) (the product by 2 is exact);
// - loads without branches, all in flight at once: rows and staged points
//   past the cloud repeat its last point and carry a +inf norm, so their
//   distances are +inf, never win, and stay out of the sums; the SM's
//   shared memory is all asked for, so that registers alone bound the
//   blocks an SM holds;
// - any N and M: rows are walked in passes of 16R, columns in staged tiles
//   of at most kColTile points. The per-point minima live in shared memory,
//   or, when they do not fit, in a scratch buffer the wrapper allocates;
// - any C: the tiled kernel is instantiated for C = 4 and 5 (a crop's
//   channels: x, y, z, Doppler and, with NFEATURES = 5, the power in dB)
//   and C = 8. The wrapper pads fewer than 4 channels to 4, and 6 or 7 to
//   8, with zeros in preds and gts alike: a zero channel adds an exact 0 to
//   each norm and dot (a fused multiply-add of 0 x 0), so every distance
//   and the result keep their bits. Above 8 channels a plain kernel with C
//   at run time (chamfer_any_kernel) computes each distance once for each
//   direction, rounded alike, and is slow but exact in the same way;
// - deterministic: a minimum is exact in any order, and the two sums of
//   minima are taken by one warp in a fixed order that depends only on N
//   and M. A frame's result is the same bits whatever the batch and
//   whatever launch geometry the wrapper picked
//   (ops/chamfer_kernel.py::launch_geometry: R from N, warps per frame
//   from the number of frames, so that 1920 and 480 frames both fill the
//   card).
//
// What holds it back, as measured (PERF.md): the frames of a launch start
// together, so the load of the inputs and the final reductions of every
// frame happen in step across the card and are not hidden behind another
// frame's arithmetic; and 1920 one-warp frames over 528 schedulers leave
// some with 4 warps where the mean is 3.6.
//
// Later work: the argmins for a CUDA backward; frames pipelined within a
// block so that one frame's loads overlap another's sweep.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRowLanes = 16;   // lanes of a warp that share a column
constexpr int kColLanes = 2;    // lanes of a warp that share a row: 32 / kRowLanes
constexpr int kGroup = 8;       // columns a column lane takes in a step
constexpr int kMaxWarps = 8;    // warps per block at most
constexpr int kStage = 8;       // points a thread stages at once
constexpr int kColTile = 1024;  // staged columns per tile at most
constexpr int kSmemLimit = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <int C>
__device__ __forceinline__ float sq_norm(const float (&p)[C]) {
  float s = __fmul_rn(p[0], p[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) s = __fmaf_rn(p[c], p[c], s);
  return s;
}

// Points idx[0..P) of a cloud of C channels, without a branch, so that
// all the loads are in flight at once.
template <int C, int P>
__device__ __forceinline__ void load_points(const float* __restrict__ cloud, const int (&idx)[P],
                                            float (&q)[P][C]) {
#pragma unroll
  for (int u = 0; u < P; ++u) {
#pragma unroll
    for (int c = 0; c < C; ++c) q[u][c] = __ldg(cloud + static_cast<size_t>(idx[u]) * C + c);
  }
}

// Fixed-order sum of v[0..count) by one warp; the result is valid in lane 0.
__device__ float warp_sum(const float* v, int count, int lane) {
  float s = 0.f;
  int i = lane;
  for (; i + 96 < count; i += 128) {  // the same order, four loads in flight
    const float a = v[i], b = v[i + 32], c = v[i + 64], d = v[i + 96];
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, a), b), c), d);
  }
  for (; i < count; i += 32) s = __fadd_rn(s, v[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  return s;
}

// The minima of kGroup columns over the 16 row lanes, reduce-scattered:
// in each of 3 halving exchanges a lane sends the half of its columns it
// gives up and keeps the half it takes on (by one bit of its row lane);
// a last exchange pairs lanes tr and tr ^ 1. 8 shuffles where one tree a
// column would take 32. Lane tr returns the minimum of column tr >> 1.
__device__ __forceinline__ float group_min(float (&cm)[kGroup], int tr) {
#pragma unroll
  for (int half = kGroup / 2, bit = kRowLanes / 2; half > 0; half /= 2, bit /= 2) {
    const bool upper = tr & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? cm[i] : cm[i + half];
      const float keep = upper ? cm[i + half] : cm[i];
      cm[i] = fminf(keep, __shfl_xor_sync(kFull, send, bit));
    }
  }
  return fminf(cm[0], __shfl_xor_sync(kFull, cm[0], 1));
}

// Floats of shared memory a block needs: the staged tile (coordinates,
// norm and column minimum), the warps' row minima of a pass and, unless
// they go to scratch, the N + M per-point minima.
__host__ __device__ int smem_floats(int c, int rows, int warps, int tile_cap, int n, int m,
                                    bool mins_in_smem) {
  return tile_cap * (c + 2) + warps * kRowLanes * rows + (mins_in_smem ? n + m : 0);
}

template <int C, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
chamfer_kernel(const float* __restrict__ gts, int n, const float* __restrict__ preds, int m,
               int tile_cap, float* scratch, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kPassRows = kRowLanes * R;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tr = lane % kRowLanes;                     // row lane
  const int tc = warp * kColLanes + lane / kRowLanes;  // column lane of the block
  const int step = kGroup * warps * kColLanes;         // columns the block takes in a step
  const size_t f = blockIdx.x;
  const float* x = gts + f * n * C;
  const float* y = preds + f * m * C;

  // shared memory: tile coordinates 0-3 (float4), [coordinates 4 .. C - 1,
  // one row of tile_cap each,] tile norms, tile column minima, the warps'
  // row minima, [the per-point minima]
  static_assert(C >= 4, "the wrapper pads fewer channels to 4");
  float4* tile_pts = reinterpret_cast<float4*>(smem);
  float* tile_ext = smem + 4 * tile_cap;
  float* tile_sq = smem + C * tile_cap;
  float* tile_min = tile_sq + tile_cap;  // the tile's column minima over this pass
  float* row_part = tile_min + tile_cap;
  // per-point minima: rows [0, n), then columns [n, n + m)
  float* mins = scratch != nullptr ? scratch + f * (n + m) : row_part + warps * kPassRows;

  for (int base = 0; base < n; base += kPassRows) {
    // this thread's rows base + tr + 16k, held in registers; rows past n
    // repeat row n - 1 with a +inf norm
    float p[R][C];
    float pp[R];
    float row_min[R];
    {
      int idx[R];
#pragma unroll
      for (int k = 0; k < R; ++k) idx[k] = min(base + tr + kRowLanes * k, n - 1);
      load_points<C, R>(x, idx, p);
    }
    for (int t0 = 0; t0 < m; t0 += tile_cap) {
      const int cnt = min(m - t0, tile_cap);
      const int padded = (cnt + step - 1) / step * step;  // every lane walks as many columns
      __syncthreads();  // the previous tile and row minima are no longer read
      // stage the tile, kStage points a thread at a time; padding columns
      // repeat column cnt - 1 with a +inf norm
      for (int j0 = 0; j0 < padded; j0 += kStage * blockDim.x) {
        int idx[kStage];
        float q[kStage][C];
#pragma unroll
        for (int u = 0; u < kStage; ++u)
          idx[u] = t0 + min(j0 + u * blockDim.x + threadIdx.x, cnt - 1);
        load_points<C, kStage>(y, idx, q);
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int j = j0 + u * blockDim.x + threadIdx.x;
          if (j < padded) {
            tile_pts[j] = make_float4(q[u][0], q[u][1], q[u][2], q[u][3]);
#pragma unroll
            for (int e = 4; e < C; ++e) tile_ext[(e - 4) * tile_cap + j] = q[u][e];
            tile_sq[j] = j < cnt ? sq_norm<C>(q[u]) : inf();
          }
        }
      }
      __syncthreads();
      if (t0 == 0) {  // the rows' norms, once their loads overlapped the tile's
#pragma unroll
        for (int k = 0; k < R; ++k) {
          pp[k] = base + tr + kRowLanes * k < n ? sq_norm<C>(p[k]) : inf();
          row_min[k] = inf();
        }
      }
      // a step: kGroup columns of this column lane against its R rows
      for (int j0 = tc * kGroup; j0 < padded; j0 += step) {
        float cm[kGroup];
#pragma unroll
        for (int s = 0; s < kGroup; ++s) {
          const float4 v = tile_pts[j0 + s];
          float q[C];
          q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
#pragma unroll
          for (int e = 4; e < C; ++e) q[e] = tile_ext[(e - 4) * tile_cap + j0 + s];
          const float qq = tile_sq[j0 + s];
          cm[s] = inf();
#pragma unroll
          for (int k = 0; k < R; ++k) {
            float dot = __fmul_rn(p[k][0], q[0]);
#pragma unroll
            for (int c = 1; c < C; ++c) dot = __fmaf_rn(p[k][c], q[c], dot);
            const float d = __fmaf_rn(-2.f, dot, __fadd_rn(pp[k], qq));
            row_min[k] = fminf(row_min[k], d);
            cm[s] = fminf(cm[s], d);
          }
        }
        const float col_min = group_min(cm, tr);
        if ((tr & 1) == 0) tile_min[j0 + (tr >> 1)] = col_min;
      }
      __syncthreads();
      // fold the tile's column minima into the frame's, each column by
      // one thread
      for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
        float* slot = mins + n + t0 + j;
        *slot = base == 0 ? tile_min[j] : fminf(*slot, tile_min[j]);
      }
    }
    // a row's minimum over the warp's column lanes, then over the warps
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int off = kRowLanes; off < 32; off <<= 1)
        row_min[k] = fminf(row_min[k], __shfl_xor_sync(kFull, row_min[k], off));
    }
    if (lane < kRowLanes) {
#pragma unroll
      for (int k = 0; k < R; ++k) row_part[warp * kPassRows + tr + kRowLanes * k] = row_min[k];
    }
    __syncthreads();
    for (int r = threadIdx.x; r < kPassRows && base + r < n; r += blockDim.x) {
      float v = row_part[r];
      for (int w = 1; w < warps; ++w) v = fminf(v, row_part[w * kPassRows + r]);
      mins[base + r] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float cols = warp_sum(mins + n, m, lane);
    const float rows = warp_sum(mins, n, lane);
    if (lane == 0) out[f] = __fadd_rn(cols, rows);
  }
}

// Any C, at run time: one block a frame; each thread takes points, gt rows
// first and then pred columns, and walks the other cloud from global memory
// for that point's minimum. Every distance is rounded as chamfer_kernel
// rounds it (the dot, the norms and the sum are symmetric in x and y), so
// the minima, and the sums taken as chamfer_kernel takes them, are the
// same bits. scratch: frames x (n + m) floats for the per-point minima.
constexpr int kAnyThreads = 256;

__device__ __forceinline__ float sq_norm_any(const float* __restrict__ p, int c) {
  float s = __fmul_rn(__ldg(p), __ldg(p));
  for (int k = 1; k < c; ++k) s = __fmaf_rn(__ldg(p + k), __ldg(p + k), s);
  return s;
}

__global__ void __launch_bounds__(kAnyThreads)
chamfer_any_kernel(const float* __restrict__ gts, int n, const float* __restrict__ preds, int m,
                   int c, float* __restrict__ scratch, float* __restrict__ out) {
  const size_t f = blockIdx.x;
  const float* x = gts + f * n * c;
  const float* y = preds + f * m * c;
  float* mins = scratch + f * (n + m);
  for (int i = threadIdx.x; i < n + m; i += blockDim.x) {
    const bool row = i < n;
    const float* p = row ? x + static_cast<size_t>(i) * c : y + static_cast<size_t>(i - n) * c;
    const float* other = row ? y : x;
    const int count = row ? m : n;
    const float pp = sq_norm_any(p, c);
    float best = inf();
    for (int j = 0; j < count; ++j) {
      const float* q = other + static_cast<size_t>(j) * c;
      float dot = __fmul_rn(__ldg(p), __ldg(q));
      for (int k = 1; k < c; ++k) dot = __fmaf_rn(__ldg(p + k), __ldg(q + k), dot);
      best = fminf(best, __fmaf_rn(-2.f, dot, __fadd_rn(pp, sq_norm_any(q, c))));
    }
    mins[i] = best;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float cols = warp_sum(mins + n, m, lane);
    const float rows = warp_sum(mins, n, lane);
    if (lane == 0) out[f] = __fadd_rn(cols, rows);
  }
}

template <int C, int R>
cudaError_t launch(const float* gts, const float* preds, float* out, float* scratch, int frames,
                   int n, int m, int warps, int tile_cap, int smem_bytes, cudaStream_t stream) {
  // ask for all of the SM's shared memory, so that it and not the default
  // carveout bounds the blocks an SM holds
  static const cudaError_t carveout = cudaFuncSetAttribute(
      chamfer_kernel<C, R>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return carveout;
  chamfer_kernel<C, R><<<frames, warps * 32, smem_bytes, stream>>>(gts, n, preds, m, tile_cap,
                                                                    scratch, out);
  return cudaGetLastError();
}

// rows per thread: the values ops/chamfer_kernel.py::ROWS_PER_THREAD offers
template <int C>
cudaError_t launch_rows(int rows, const float* gts, const float* preds, float* out,
                        float* scratch, int frames, int n, int m, int warps, int tile_cap,
                        int smem_bytes, cudaStream_t s) {
#define CHAMFER_ROWS(R) \
  case R: return launch<C, R>(gts, preds, out, scratch, frames, n, m, warps, tile_cap, smem_bytes, s);
  switch (rows) {
    CHAMFER_ROWS(1)
    CHAMFER_ROWS(2)
    CHAMFER_ROWS(4)
    CHAMFER_ROWS(6)
    CHAMFER_ROWS(10)
    default: return cudaErrorInvalidValue;
  }
#undef CHAMFER_ROWS
}

}  // namespace

// Plain C entry point for ctypes. gts: (frames, n, c) f32; preds:
// (frames, m, c) f32, both contiguous; out: (frames,) f32, the per-frame
// sum of min-over-gts for each pred point plus min-over-preds for each gt
// point. c: 4, 5 or 8 (the wrapper pads other counts up to 8, zeros in
// both clouds; more go to seq_chamfer_frames_any_f32). The launch
// geometry comes from ops/chamfer_kernel.py::launch_geometry: rows_per_thread (R), warps per
// frame (1, 2, 4 or 8), tile_cap (staged columns, a multiple of 16 x warps,
// at most 1024) and smem_bytes; scratch is null when the per-point minima
// fit in shared memory, else frames x (n + m) floats. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int seq_chamfer_frames_f32(const float* gts, const float* preds, float* out,
                                      float* scratch, int frames, int n, int m, int c,
                                      int rows_per_thread, int warps, int tile_cap,
                                      int smem_bytes, void* stream) {
  const bool warps_ok = warps == 1 || warps == 2 || warps == 4 || warps == 8;
  if (frames < 1 || n < 1 || m < 1 || !warps_ok || tile_cap < 1 || tile_cap > kColTile ||
      tile_cap % (kGroup * kColLanes * warps) != 0 || smem_bytes > kSmemLimit ||
      smem_bytes < 4 * smem_floats(c, rows_per_thread, warps, tile_cap, n, m, scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 4:
      return static_cast<int>(launch_rows<4>(rows_per_thread, gts, preds, out, scratch, frames, n,
                                             m, warps, tile_cap, smem_bytes, s));
    case 5:
      return static_cast<int>(launch_rows<5>(rows_per_thread, gts, preds, out, scratch, frames, n,
                                             m, warps, tile_cap, smem_bytes, s));
    case 8:
      return static_cast<int>(launch_rows<8>(rows_per_thread, gts, preds, out, scratch, frames, n,
                                             m, warps, tile_cap, smem_bytes, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function for any c >= 1, through chamfer_any_kernel: gts
// (frames, n, c), preds (frames, m, c), out (frames,), scratch frames x
// (n + m) floats, all f32, contiguous, on the card. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int seq_chamfer_frames_any_f32(const float* gts, const float* preds, float* out,
                                          float* scratch, int frames, int n, int m, int c,
                                          void* stream) {
  if (frames < 1 || n < 1 || m < 1 || c < 1 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  chamfer_any_kernel<<<frames, kAnyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gts, n, preds, m, c, scratch, out);
  return static_cast<int>(cudaGetLastError());
}
