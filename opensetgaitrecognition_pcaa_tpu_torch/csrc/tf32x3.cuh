// One tensor-core GEMM engine for the PointNet kernels, written by hand for
// Hopper (sm_90a): C = prologue(A) @ B in an exact three-pass TF32 mode
// (3xTF32), with a hook on the A tile and a hook on the output fragments.
//
// A is (rows, K) row-major and B is given K-major, as Bt (N, K) row-major
// (the wrappers transpose the JAX package's (in, out) weights); K and N are
// multiples of 4, so every row is a whole number of 16-byte chunks.
//
// The exact mode. Each operand value x splits into hi = tf32(x) and
// lo = tf32(x - hi), both rounded as cvt.rna does (to nearest, ties away
// from zero); x - hi is exact in f32 and |x - hi - lo| <= 2^-22 |x|. A
// product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, three mma.sync m16n8k8 TF32
// passes into one f32 accumulator, the small terms first. Only a_lo*b_lo
// (about 2^-22 |a||b|) is dropped, so the result keeps about 22 of f32's 24
// mantissa bits, against TF32's 11; ops/tf32x3.py emulates it in plain
// PyTorch for the CPU tests. No single-pass TF32 product exists here.
//
// The split is done in registers, after each fragment's shared-memory
// load, for both operands: one code path for A and B, no pre-split copy of
// the weights (the training step changes them every step), and shared
// memory holds each value once. It costs three ALU instructions per
// fragment value against the three MMAs that use it; ops/mma_probe.py
// measures what that costs the MMA rate (PERF.md, section 6, PR 4). Weights
// pre-split once per call into (hi, lo) pairs were tried and measured
// slower end to end (PERF.md): with twice the weight bytes, a
// stage holds only 16 K values, and the barriers per K double.
//
// Tiling: 128 x 256 output tiles, K steps of 32; 256 threads, 8 warps as
// 2 (rows) x 4 (columns), each warp 64 x 64 outputs = 4 x 8 m16n8 tiles,
// so each split value feeds 3 x 4 or 3 x 8 MMAs. A 128-row tile serves
// each weight byte fetched from L2 to 128 rows (the FFMA kernels it
// replaces used 32 and 64); 256 columns mean a prologue rewrites each A
// value once per 256 output columns. A ring of kStages stages of A and Bt
// tiles in dynamic shared memory is filled by cp.async (zero-filled past
// the edges), kStages - 1 tiles ahead of the MMAs. Inside each k8 step the
// thread that the MMA gives K indices t and t + 4 reads the stored columns
// 2t and 2t + 1 instead, for A and B alike: the same eight products, and
// each fragment pair is one 64-bit shared-memory load. Rows are padded by
// 8 floats so that those loads are free of bank conflicts. Blocks walk the
// output column tiles fastest, so the blocks in flight share their A row
// tiles in L2 and each activation is read from device memory about once.
//
// Hooks:
// - Prologue: `kIdentity` true skips it; otherwise `apply(As, k0, k)`
//   rewrites a landed A stage in shared memory (K columns k0 .. k0 + kBK
//   - 1, those >= k left as zero) between two barriers;
// - Epilogue: `operator()(acc, row0, col0, smem)` is called by every
//   thread with its fragments; acc[i][j][q] holds output row
//   row0 + wm*64 + i*16 + g + 8*(q/2), column col0 + wn*64 + j*8 + 2t +
//   q%2 (g = lane/4, t = lane%4; `frag_row`/`frag_col` compute them). The
//   ring's shared memory is free again and may be used after a
//   __syncthreads.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tf32x3 {

constexpr int kMT = 4;                   // m16 tiles per warp
constexpr int kNT = 8;                   // n8 tiles per warp
constexpr int kWarpsM = 2;               // warps along the rows
constexpr int kWarpsN = 4;               // warps along the columns
constexpr int kWarpRows = 16 * kMT;      // 64
constexpr int kWarpCols = 8 * kNT;       // 64
constexpr int kBM = kWarpsM * kWarpRows;  // rows per output tile: 128
constexpr int kBN = kWarpsN * kWarpCols;  // columns per output tile: 256
constexpr int kBK = 32;                  // K per stage
constexpr int kStages = 3;               // ring depth
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kStride = kBK + 8;         // floats per A or Bt row in shared memory
constexpr int kAStage = kBM * kStride;
constexpr int kBStage = kBN * kStride;
constexpr size_t kSmemBytes = sizeof(float) * kStages * (kAStage + kBStage);

using Acc = float[kMT][kNT][4];

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// x -> (hi, lo) as TF32 bit patterns, both rounded to nearest, ties away.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The fragment coordinates inside the block tile.
__device__ __forceinline__ int frag_row(int i, int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % kWarpsM) * kWarpRows + i * 16 + lane / 4 + 8 * (q / 2);
}
__device__ __forceinline__ int frag_col(int j, int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / kWarpsM) * kWarpCols + j * 8 + 2 * (lane % 4) + (q % 2);
}

// Sum over the 8 lanes that share lane % 4 (the 8 row groups of an m16
// tile), in one fixed order; every lane gets the sum.
__device__ __forceinline__ float sum_row_groups(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

struct Identity {
  static constexpr bool kIdentity = true;
  __device__ void apply(float*, int, int) const {}
};

// Rows [row0, row0 + ROWS) of a K-major (rows, k) matrix, K columns
// [k0, k0 + kBK), into shared memory; zeros past `rows` and past k.
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int k, int row0, int k0) {
#pragma unroll
  for (int q = 0; q < ROWS * kBK / 4 / kThreads; ++q) {
    const int c = threadIdx.x + q * kThreads;
    const int r = c / (kBK / 4);
    const int kc = (c % (kBK / 4)) * 4;
    const bool ok = row0 + r < rows && k0 + kc < k;
    const float* p = ok ? src + static_cast<size_t>(row0 + r) * k + k0 + kc : src;
    cp_async16(dst + r * kStride + kc, p, ok ? 16 : 0);
  }
}

// Stage ktile of A and Bt into ring slot `slot`.
__device__ __forceinline__ void load_stage(float* smem, int slot, const float* __restrict__ a,
                                           const float* __restrict__ bt, int rows, int k, int n,
                                           int row0, int col0, int ktile) {
  float* As = smem + slot * (kAStage + kBStage);
  load_tile<kBM>(As, a, rows, k, row0, ktile * kBK);
  load_tile<kBN>(As + kAStage, bt, n, k, col0, ktile * kBK);
}

// The MMAs of one landed stage; only the k8 steps below k run, so a
// K of 4 costs one k8 step. Fragment K index t reads stored column 2t and
// t + 4 reads 2t + 1, in A and in Bt.
__device__ __forceinline__ void compute_stage(const float* As, const float* Bs, int ksteps,
                                              Acc& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* a_base = As + ((warp % kWarpsM) * kWarpRows + g) * kStride + 2 * t;
  const float* b_base = Bs + ((warp / kWarpsM) * kWarpCols + g) * kStride + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    if (kk < ksteps) {
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* p = a_base + i * 16 * kStride + kk * 8;
        const float2 top = *reinterpret_cast<const float2*>(p);
        const float2 bottom = *reinterpret_cast<const float2*>(p + 8 * kStride);
        split(top.x, ahi[i][0], alo[i][0]);
        split(bottom.x, ahi[i][1], alo[i][1]);
        split(top.y, ahi[i][2], alo[i][2]);
        split(bottom.y, ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(b_base + j * 8 * kStride + kk * 8);
        uint32_t bhi[2], blo[2];
        split(v.x, bhi[0], blo[0]);
        split(v.y, bhi[1], blo[1]);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma(acc[i][j], alo[i], bhi);
          mma(acc[i][j], ahi[i], blo);
          mma(acc[i][j], ahi[i], bhi);
        }
      }
    }
  }
}

// One block per kBM x kBN output tile; blockIdx.x walks the column tiles
// fastest. bt is B transposed: (n, k) row-major. Launch with kThreads
// threads and kSmemBytes of dynamic shared memory (`launch` does both).
template <class Prologue, class Epilogue>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ bt, int rows, int k, int n,
            Prologue pro, Epilogue epi) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int col_tiles = (n + kBN - 1) / kBN;
  const int row0 = (blockIdx.x / col_tiles) * kBM;
  const int col0 = (blockIdx.x % col_tiles) * kBN;
  const int ktiles = (k + kBK - 1) / kBK;

  Acc acc;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(smem, s, a, bt, rows, k, n, row0, col0, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed for every thread; slot kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(smem, next % kStages, a, bt, rows, k, n, row0, col0, next);
    cp_async_commit();
    float* As = smem + (kt % kStages) * (kAStage + kBStage);
    if constexpr (!Prologue::kIdentity) {
      pro.apply(As, kt * kBK, k);
      __syncthreads();
    }
    const int left = k - kt * kBK;
    compute_stage(As, As + kAStage, (left < kBK ? left + 7 : kBK) / 8, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
  epi(acc, row0, col0, smem);
}

template <class Prologue, class Epilogue>
cudaError_t launch(const float* a, const float* bt, int rows, int k, int n, Prologue pro,
                   Epilogue epi, cudaStream_t stream) {
  auto kernel = gemm_kernel<Prologue, Epilogue>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>((rows + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, stream>>>(a, bt, rows, k, n, pro,
                                                                         epi);
  return cudaGetLastError();
}

}  // namespace tf32x3
