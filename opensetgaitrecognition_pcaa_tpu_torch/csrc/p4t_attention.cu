// The P4Transformer blocks' attention, softmax(Q Kᵀ / √dh) V over each crop's
// tokens and heads, and its gradients, on the tensor cores in the exact
// three-pass TF32 mode of tf32x3.cuh (3xTF32), written by hand for Hopper
// (sm_90a): a flash-attention forward and a flash-attention-2 backward that
// never hold the (tokens x tokens) scores in device memory.
//
// No TPU kernel is ported here: the JAX package has no P4Transformer. It
// replaces F.scaled_dot_product_attention's memory-efficient CUTLASS kernels
// (sm80 code on mma.sync, three-pass TF32 too).
//
// What bounds it: the three tensor-core passes, 495 / 3 = 165 TFLOP/s. At
// the published sizes (16 crops of n = 1,125 tokens, 8 heads of dh = 128)
// a layer's forward does 4 n² dh operations a head (83 GFLOP, 0.50 ms at
// that rate) and its backward, as written here, 14 n² dh (the scores and
// dO Vᵀ recomputed once for dK and dV and once for dQ; 290 GFLOP, 1.76 ms);
// the bytes (Q, K, V, O, dO, the gradients: about 0.4 GB) take 0.12 ms.
//
// Layout. qkv is to_qkv's output as it lies, (B, n, 3 H dh) f32: Q, K and V
// of head h at columns h dh, (H + h) dh and (2H + h) dh. The kernels read
// their tiles through 3-D TMA maps (column, token, crop), so the tokens past
// n of a crop read as zeros and nothing is copied. O is (B, n, H dh), ready
// for to_out; the log-sum-exp of each query row's scaled scores (B, H, n);
// the gradient of qkv one (B, n, 3 H dh) tensor, as to_qkv's backward takes
// it. dh is 128.
//
// Design. Every kernel is one shape: a block of 384 threads, two consumer
// warpgroups that each hold 64 "stationary" rows of 128 values in registers
// (raw f32, split into TF32 hi and lo at each use; the dQ kernel keeps them
// split), and a producer
// warpgroup that walks the "moving" tokens in tiles of 32: one thread loads
// the tile's two operands by TMA (4 boxes of 32 tokens x 32 columns each,
// 128-byte swizzle) into a ring of 2 stages, and the 128 threads split each
// value in place into a hi plane and a lo plane (tf32x3::split, the
// rounding of every 3xTF32 kernel of the port), then hand the stage over.
// TF32 wgmma takes K-major operands only, so the products are arranged so
// that no operand is ever transposed in shared memory:
// - `scores`: a 64 x 32 tile X Mᵀ over the 128 columns (m64n32k8): A the
//   stationary rows from registers, B the moving operand's planes, which
//   are K-major as they lie. Each k8 step is three wgmma, a_lo b_hi, a_hi
//   b_lo, a_hi b_hi, the small terms first, as in tf32x3_wgmma.cuh;
// - `write_plane`: a consumer writes such a tile (P, or dS) from its
//   accumulators into a B plane of its own, 64 rows by the 32 tokens, split
//   and swizzled as a TMA would land it;
// - `transposed_product`: Mᵀ W over the tile's 32 tokens (m64n64k8), a
//   transposed result (the moving operand's columns by the 64 stationary
//   rows): A is read from the moving operand's hi and lo planes with
//   64-bit loads at transposed coordinates (fragment row g is column 2g,
//   g + 8 is 2g + 1; K index t is token 2t, t + 4 is 2t + 1: free of bank
//   conflicts under the swizzle, as p4t_linear's weight gradient reads dYᵀ),
//   B is the written plane, whose tokens write_plane lays in that order.
// The three kernels:
// - forward (`p4t_attention_fwd_kernel`): stationary Q (128 queries a block,
//   64 a warpgroup), moving K and V. S = Q Kᵀ, the online softmax in f32 in
//   the base-2 domain (keys past n at -inf), P into the warpgroup's plane,
//   Oᵀ = α Oᵀ + Vᵀ Pᵀ with α read per query column from shared memory.
//   Writes O and the log-sum-exp;
// - `p4t_attention_delta_kernel`: D = rowsum(dO ∘ O), a warp a row;
// - dK and dV (`p4t_attention_dkdv_kernel`): 64 keys a block, stationary K
//   in warpgroup 0 and V in warpgroup 1, moving Q and dO (the stage also
//   carries the tile's log-sum-exp and D). Warpgroup 0: Sᵀ = K Qᵀ, Pᵀ from
//   the saved log-sum-exp, Pᵀ to warpgroup 1 through shared memory, dVᵀ +=
//   dOᵀ P. Warpgroup 1: dPᵀ = V dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − D), dKᵀ += Qᵀ dS;
// - dQ (`p4t_attention_dq_kernel`): 64 queries a block, stationary Q in
//   warpgroup 0 and dO in warpgroup 1, moving K and V. Warpgroup 0: S = Q
//   Kᵀ, P; warpgroup 1: dP = dO Vᵀ, dS = P ∘ (dP − D) into the plane; both:
//   dQᵀ += Kᵀ dSᵀ, 64 of the 128 columns each.
//   A separate dQ kernel keeps the backward free of atomics and of any
//   workspace that grows with the key tiles: every output is one sum in a
//   fixed order, so two calls on the same inputs give the same bits.
// Named barriers order the warpgroups' hand-overs and, in the forward and
// the dK and dV kernel, their turns at the scores (bar.sync / bar.arrive),
// mbarriers the ring. Every kernel's name holds `p4t_attention`; the
// mbarrier, TMA and wgmma primitives are hopper.cuh's.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kDh = 128;                               // the head width the kernels take
constexpr int kRows = 64;                              // stationary rows of a consumer warpgroup
constexpr int kTile = 32;                              // moving tokens a stage
constexpr int kBox = 32;                               // a TMA box: 32 tokens x 32 f32 columns
constexpr int kBoxBytes = kBox * kTile * 4;            // 4 KB
constexpr int kPlaneBytes = (kDh / kBox) * kBoxBytes;  // 16 KB: a tile's 128 columns
constexpr int kOperandBytes = 2 * kPlaneBytes;         // its hi and lo planes
constexpr int kStageBytes = 2 * kOperandBytes;         // two moving operands: 64 KB
constexpr int kStages = 2;
constexpr int kWrittenBytes = kRows * kTile * 4;       // 8 KB: a written plane, 64 rows x 32 tokens
constexpr int kConsumers = 256;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
// shared memory after the 1024-byte alignment: the ring, two written
// planes (hi and lo each), the hand-over of P (64 x 32 f32), the stages'
// token vectors (2 x 32 f32 a stage), the forward's per-row exchange (2 x
// 64 f32), the mbarriers (landed, full, empty a stage)
constexpr int kWrittenOff = kStages * kStageBytes;
constexpr int kPbufOff = kWrittenOff + 2 * 2 * kWrittenBytes;
constexpr int kVecOff = kPbufOff + kRows * kTile * 4;
constexpr int kXchOff = kVecOff + kStages * 2 * kTile * 4;
constexpr int kBarOff = kXchOff + 2 * kRows * 4;
constexpr int kSmemBytes = 1024 + kBarOff + 3 * kStages * 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kDeltaThreads = 256;

static_assert(kSmemBytes <= 232448, "ring and planes fit one block's shared memory");
static_assert(kBox * 4 == hopper::kSwizzleBytes, "a box row is one swizzled row");
static_assert(kTile * 4 == hopper::kSwizzleBytes, "a written plane row is one swizzled row");

// named barriers (0 is __syncthreads'): a warpgroup's own, then the hand-overs
enum NamedBarrier {
  kOwn0 = 1, kOwn1 = 2, kPReady = 3, kPFree = 4, kDsReady = 5, kDsFree = 6, kTurn0 = 7, kTurn1 = 8
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The two consumer warpgroups take turns at `scores`: warpgroup 1 starts a
// tile's once warpgroup 0's is done, warpgroup 0 the next tile's once
// warpgroup 1's is, so that one's softmax and hand-overs run beside the
// other's products rather than at the same time (on the card it took 7% off
// the dK and dV kernel and 4% off the forward).
__device__ __forceinline__ void turn_wait(int wg, int it) {
  if (wg == 1 || it > 0) named_sync(kTurn0 + wg, 256);
}
__device__ __forceinline__ void turn_pass(int wg, int it, int tiles) {
  if (wg == 0 || it + 1 < tiles) named_arrive(kTurn1 - wg, 256);
}

#define P4T_ACC8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 32 f32) += A (64 x 8 TF32, registers) @ B (8 x 32 TF32, K-major in
// shared memory).
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : P4T_ACC8(0), P4T_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d (64 x 64 f32) += A (64 x 8 TF32, registers) @ B (8 x 64 TF32, K-major in
// shared memory).
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : P4T_ACC8(0), P4T_ACC8(8), P4T_ACC8(16), P4T_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

#undef P4T_ACC8

struct Args {
  const float* qkv;    // (B, n, 3 H dh)
  const float* dout;   // (B, n, H dh)
  const float* lse;    // (B, H, n)
  float* o;            // the forward's outputs
  float* lse_out;
  float* delta;        // (B, H, n): D
  float* dqkv;         // (B, n, 3 H dh)
  int n, heads;
  float scale;         // 1 / √dh
  float scale_log2;    // log2(e) / √dh
};

// The shared memory of a block: the ring and its mbarriers, set up once.
struct Smem {
  unsigned char* base;
  uint32_t addr, landed, full, empty;
};

__device__ __forceinline__ Smem setup(unsigned char* raw) {
  Smem m;
  m.base = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
  m.addr = hopper::smem_addr(m.base);
  m.landed = m.addr + kBarOff;
  m.full = m.landed + 8 * kStages;
  m.empty = m.full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(m.landed + 8 * s, 1);
      hopper::mbar_init(m.full + 8 * s, kProducers / 32);  // a producer warp's each
      hopper::mbar_init(m.empty + 8 * s, kConsumers / 32);  // a consumer warp's each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return m;
}

// What the producer brings: for each tile of 32 tokens of crop `batch`, the
// columns col0 .. col0 + 127 of map 0 and col1 .. of map 1, and, where vec0
// is not null, the tile's values of two per-token vectors (vec0, vec1).
struct Moving {
  int col0, col1, batch, tiles, n;
  const float* vec0;
  const float* vec1;
};

// The producer warpgroup: stage it % kStages for tile it. Thread 0 loads
// the two operands into their hi planes, all wait for them, split each value
// in place into hi and lo, and release the stage to the consumers.
__device__ __forceinline__ void stage_in(const CUtensorMap* tm0, const CUtensorMap* tm1,
                                         const Moving& mv, const Smem& m) {
  const int p = threadIdx.x - kConsumers;
  float* vecs = reinterpret_cast<float*>(m.base + kVecOff);
  for (int it = 0; it < mv.tiles; ++it) {
    const int s = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    hopper::mbar_wait(m.empty + 8 * s, phase ^ 1);  // a fresh barrier passes at once
    if (p == 0) {
      const uint32_t st = m.addr + s * kStageBytes, bar = m.landed + 8 * s;
      hopper::mbar_expect_tx(bar, 2 * kPlaneBytes);  // out-of-bounds zeros count too
#pragma unroll
      for (int i = 0; i < kDh / kBox; ++i) {
        hopper::tma_load_3d(st + i * kBoxBytes, tm0, bar, mv.col0 + kBox * i, it * kTile,
                            mv.batch);
        hopper::tma_load_3d(st + kOperandBytes + i * kBoxBytes, tm1, bar, mv.col1 + kBox * i,
                            it * kTile, mv.batch);
      }
    }
    if (mv.vec0 != nullptr && p < 2 * kTile) {
      const int tok = it * kTile + p % kTile;
      vecs[s * 2 * kTile + p] = tok < mv.n ? __ldg((p < kTile ? mv.vec0 : mv.vec1) + tok) : 0.f;
    }
    hopper::mbar_wait(m.landed + 8 * s, phase);
    float4* stage = reinterpret_cast<float4*>(m.base + s * kStageBytes);
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      float4* hi = stage + op * (kOperandBytes / 16);
      float4* lo = hi + kPlaneBytes / 16;
#pragma unroll 4
      for (int i = p; i < kPlaneBytes / 16; i += kProducers) {
        const float4 v = hi[i];
        uint32_t h[4], l[4];
        tf32x3::split(v.x, h[0], l[0]);
        tf32x3::split(v.y, h[1], l[1]);
        tf32x3::split(v.z, h[2], l[2]);
        tf32x3::split(v.w, h[3], l[3]);
        hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                            __uint_as_float(h[3]));
        lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                            __uint_as_float(l[3]));
      }
    }
    fence_async_smem();  // the planes, visible to wgmma
    __syncwarp();
    if (p % 32 == 0) hopper::mbar_arrive(m.full + 8 * s);
  }
}

// A consumer thread's place: warp of its warpgroup, g = lane / 4, t = lane % 4.
struct Lane {
  int wg, warp, lane, g, t;
};
__device__ __forceinline__ Lane lane_of() {
  const int lane = threadIdx.x % 32;
  return {static_cast<int>(threadIdx.x) / 128, static_cast<int>(threadIdx.x % 128) / 32, lane,
          lane / 4, lane % 4};
}

// The warpgroup's stationary rows row0 .. row0 + 63 of a matrix whose row r
// starts at base + r * stride, as the A fragments of `scores`: x[kk] holds
// (row g, column 8kk + t), (g + 8, 8kk + t), (g, 8kk + t + 4), (g + 8, 8kk +
// t + 4) of the warp's 16 rows; rows at or past n read as zeros.
__device__ __forceinline__ void load_rows(float (&x)[kDh / 8][4], const float* base,
                                          long long stride, int row0, int n) {
  const Lane l = lane_of();
  const int r0 = row0 + 16 * l.warp + l.g, r1 = r0 + 8;
  const float* p0 = base + static_cast<long long>(r0) * stride + l.t;
  const float* p1 = base + static_cast<long long>(r1) * stride + l.t;
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    x[kk][0] = r0 < n ? __ldg(p0 + 8 * kk) : 0.f;
    x[kk][1] = r1 < n ? __ldg(p1 + 8 * kk) : 0.f;
    x[kk][2] = r0 < n ? __ldg(p0 + 8 * kk + 4) : 0.f;
    x[kk][3] = r1 < n ? __ldg(p1 + 8 * kk + 4) : 0.f;
  }
}

// acc (the 64 stationary rows by the tile's 32 tokens) = X Mᵀ over the 128
// columns: A the rows x, split here two k8 steps at a time into a double
// buffer, six wgmma a group (a group of three waited on one by one left
// the tensor cores idle most of the time, on the card); B the moving
// operand whose hi plane is at `plane` (lo one plane on), K-major as the
// TMA landed it. acc[4j + q] is row 16 warp + g + 8 (q / 2), token 8j + 2t +
// q % 2.
__device__ __forceinline__ void scores(float (&acc)[16], const float (&x)[kDh / 8][4],
                                       uint32_t plane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  uint32_t hi[2][2][4], lo[2][2][4];
#pragma unroll
  for (int kp = 0; kp < kDh / 16; ++kp) {
    const int b = kp & 1;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32x3::split(x[2 * kp + u][q], hi[b][u][q], lo[b][u][q]);
    hopper::wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kk = 2 * kp + u;
      const uint32_t at = plane + (kk / 4) * kBoxBytes + 32 * (kk % 4);
      const uint64_t dhi = hopper::desc_sw128(at), dlo = hopper::desc_sw128(at + kPlaneBytes);
      mma_n32(acc, lo[b][u], dhi);
      mma_n32(acc, hi[b][u], dlo);
      mma_n32(acc, hi[b][u], dhi);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous group is done: its buffer is free
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// The same from rows split once into hi (xs[0]) and lo (xs[1]): no register
// of the A operand changes, so all 48 wgmma go as one group. It takes 64
// registers more, which only the dQ kernel, with its half-width
// accumulator, has to spare.
__device__ __forceinline__ void split_rows(uint32_t (&xs)[2][kDh / 8][4],
                                           const float (&x)[kDh / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) tf32x3::split(x[kk][q], xs[0][kk][q], xs[1][kk][q]);
}

__device__ __forceinline__ void scores(float (&acc)[16], const uint32_t (&xs)[2][kDh / 8][4],
                                       uint32_t plane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    const uint32_t at = plane + (kk / 4) * kBoxBytes + 32 * (kk % 4);
    const uint64_t dhi = hopper::desc_sw128(at), dlo = hopper::desc_sw128(at + kPlaneBytes);
    mma_n32(acc, xs[1][kk], dhi);
    mma_n32(acc, xs[0][kk], dlo);
    mma_n32(acc, xs[0][kk], dhi);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// v (a `scores` tile) into the written plane at w (hi) and w + kWrittenBytes
// (lo): row r of the tile is row r of the plane; in each k8 step of its
// tokens, position t holds token 2t and position t + 4 token 2t + 1, the
// order transposed_product reads A in. 128-byte swizzle, as a TMA lands a
// box.
__device__ __forceinline__ void write_plane(const float (&v)[16], unsigned char* w) {
  const Lane l = lane_of();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * l.warp + l.g + 8 * (q / 2);
      const int off = row * 128 + (((2 * j + q % 2) ^ (row % 8)) << 4) + 4 * l.t;
      uint32_t h, lo;
      tf32x3::split(v[4 * j + q], h, lo);
      *reinterpret_cast<uint32_t*>(w + off) = h;
      *reinterpret_cast<uint32_t*>(w + kWrittenBytes + off) = lo;
    }
  }
}

// acc[m] = acc[m] * col_scale[column] + Mᵀ W over the tile's 32 tokens, for
// columns 64 (m0 + m) .. + 63 of the moving operand (M = 64) by the written
// plane's 64 rows (N = 64); col_scale null: 1. A from the operand's hi and
// lo planes (`plane`, generic address) at transposed coordinates, already
// split; B the written plane at `w`. acc[m][4j + q] is column 64 (m0 + m) +
// 16 warp + 2g + q / 2, plane row 8j + 2t + q % 2.
// Two-level sums: the tile's product is summed from zero in the tensor
// cores, then added to acc by an f32 FMA, which rounds to nearest. The
// tensor cores' own f32 accumulation truncates at every wgmma; carried over
// the 1,125 tokens of a crop it left the output and the gradients 5 to 9
// times plain f32's error, against 1.7 to 2.7 times with these sums (the
// library's kernels: 0.8 to 1.4 times), at the cell's shape on the card.
template <int MT>
__device__ __forceinline__ void transposed_product(float (&acc)[MT][32],
                                                   const unsigned char* plane, int m0,
                                                   uint32_t w, const float* col_scale) {
  const Lane l = lane_of();
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = 64 * (m0 + m) + 16 * l.warp;
    const int c = (r % kBox) / 4 + l.g / 2;
    uint32_t off[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * l.t + u;
      off[u] = (r / kBox) * kBoxBytes + k * 128 + ((c ^ k) << 4) + (l.g % 2) * 8;
    }
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTile / 8; ++kk) {
      const int b = kk & 1;
      const unsigned char* a = plane + kk * 8 * 128;  // tokens 8kk ..: the swizzle's rows 0 .. 7
      const float2 h0 = *reinterpret_cast<const float2*>(a + off[0]);
      const float2 h1 = *reinterpret_cast<const float2*>(a + off[1]);
      const float2 l0 = *reinterpret_cast<const float2*>(a + kPlaneBytes + off[0]);
      const float2 l1 = *reinterpret_cast<const float2*>(a + kPlaneBytes + off[1]);
      hi[b][0] = __float_as_uint(h0.x);  // column 2g, token 2t
      hi[b][1] = __float_as_uint(h0.y);  // column 2g + 1, token 2t
      hi[b][2] = __float_as_uint(h1.x);  // column 2g, token 2t + 1
      hi[b][3] = __float_as_uint(h1.y);
      lo[b][0] = __float_as_uint(l0.x);
      lo[b][1] = __float_as_uint(l0.y);
      lo[b][2] = __float_as_uint(l1.x);
      lo[b][3] = __float_as_uint(l1.y);
      hopper::wgmma_fence();
      const uint64_t dhi = hopper::desc_sw128(w + 32 * kk);
      const uint64_t dlo = hopper::desc_sw128(w + kWrittenBytes + 32 * kk);
      mma_n64(part, lo[b], dhi);
      mma_n64(part, hi[b], dlo);
      mma_n64(part, hi[b], dhi);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous step's group is done: its buffer is free
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(part[i])::"memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = col_scale != nullptr
                           ? *reinterpret_cast<const float2*>(col_scale + 8 * j + 2 * l.t)
                           : make_float2(1.f, 1.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[m][4 * j + q] = fmaf(acc[m][4 * j + q], q % 2 ? f.y : f.x, part[4 * j + q]);
      }
    }
  }
}

// A transposed_product result into dst, row r of the written plane to
// dst[(row0 + r) * stride + ..] (rows at or past n skipped), column c to
// column c, times `scale`.
template <int MT>
__device__ __forceinline__ void store_transposed(const float (&acc)[MT][32], float* dst,
                                                 long long stride, int row0, int n, int m0,
                                                 float scale) {
  const Lane l = lane_of();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int col = 64 * (m0 + m) + 16 * l.warp + 2 * l.g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = row0 + 8 * j + 2 * l.t + u;
        if (row < n) {
          *reinterpret_cast<float2*>(dst + row * stride + col) =
              make_float2(acc[m][4 * j + u] * scale, acc[m][4 * j + 2 + u] * scale);
        }
      }
    }
  }
}

// acc[m] of transposed_product, each column c (a plane row) times f[c]: the
// forward's 1 / l at the end.
__device__ __forceinline__ void scale_columns(float (&acc)[2][32], const float* f) {
  const Lane l = lane_of();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(f + 8 * j + 2 * l.t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][4 * j] *= c.x;
      acc[m][4 * j + 2] *= c.x;
      acc[m][4 * j + 1] *= c.y;
      acc[m][4 * j + 3] *= c.y;
    }
  }
}

__device__ __forceinline__ void release(const Smem& m, int s) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(m.empty + 8 * s);
}

// ---- the forward -------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
p4t_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_qkv, const Args args) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = setup(smem_raw);
  const int n = args.n, bh = blockIdx.y, b = bh / args.heads, h = bh % args.heads;
  const int inner = args.heads * kDh, tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const Moving mv{inner + h * kDh, 2 * inner + h * kDh, b, tiles, n, nullptr, nullptr};
    stage_in(&tm_qkv, &tm_qkv, mv, sm);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const Lane l = lane_of();
  const int row0 = blockIdx.x * 2 * kRows + l.wg * kRows;
  const long long crop = static_cast<long long>(b) * n;
  float x[kDh / 8][4];
  load_rows(x, args.qkv + crop * 3 * inner + h * kDh, 3 * inner, row0, n);

  unsigned char* w = sm.base + kWrittenOff + l.wg * 2 * kWrittenBytes;
  const uint32_t w_addr = sm.addr + kWrittenOff + l.wg * 2 * kWrittenBytes;
  float* xch = reinterpret_cast<float*>(sm.base + kXchOff) + l.wg * kRows;
  const int own = kOwn0 + l.wg;
  float o[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[m][i] = 0.f;
  float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.f, 0.f};  // rows g, g + 8

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
    float p[16];
    turn_wait(l.wg, it);
    scores(p, x, sm.addr + s * kStageBytes);  // Q Kᵀ
    turn_pass(l.wg, it, tiles);
    // the online softmax, base 2: x = s log2(e) / √dh, keys past n at -inf
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = it * kTile + 8 * j + 2 * l.t + q % 2;
        p[4 * j + q] = key < n ? p[4 * j + q] * args.scale_log2 : -INFINITY;
        tile_max[q / 2] = fmaxf(tile_max[q / 2], p[4 * j + q]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float next = fmaxf(run_max[r], tile_max[r]);
      alpha[r] = exp2f(run_max[r] - next);
      run_max[r] = next;
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        p[4 * j + q] = exp2f(p[4 * j + q] - run_max[q / 2]);
        part[q / 2] += p[4 * j + q];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) run_sum[r] = run_sum[r] * alpha[r] + part[r];
    named_sync(own, 128);  // the warpgroup's last product is done with its plane and xch
    write_plane(p, w);
    if (l.t == 0) {
      xch[16 * l.warp + l.g] = alpha[0];
      xch[16 * l.warp + l.g + 8] = alpha[1];
    }
    fence_async_smem();
    named_sync(own, 128);
    // Oᵀ = α Oᵀ + Vᵀ Pᵀ; Oᵀ's column 8j + 2t + u is query row 8j + 2t + u
    transposed_product<2>(o, sm.base + s * kStageBytes + kOperandBytes, 0, w_addr, xch);
    release(sm, s);
  }

  float total[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    total[r] = run_sum[r] + __shfl_xor_sync(0xffffffffu, run_sum[r], 1);
    total[r] += __shfl_xor_sync(0xffffffffu, total[r], 2);
  }
  named_sync(own, 128);
  if (l.t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * l.warp + l.g + 8 * r;
      xch[row] = 1.f / total[r];
      if (row0 + row < n) {
        args.lse_out[static_cast<long long>(bh) * n + row0 + row] =
            (run_max[r] + log2f(total[r])) * kLn2;
      }
    }
  }
  named_sync(own, 128);
  scale_columns(o, xch);
  store_transposed<2>(o, args.o + crop * inner + h * kDh, inner, row0, n, 0, 1.f);
}

// ---- the backward ------------------------------------------------------

// D[b, h, i] = Σ dO[b, i, h, :] O[b, i, h, :]: a warp a (token, head), four
// values a lane, a fixed butterfly.
__global__ void __launch_bounds__(kDeltaThreads)
p4t_attention_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                           float* __restrict__ delta, int batch, int n, int heads) {
  const long long row = (blockIdx.x * static_cast<long long>(kDeltaThreads) + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(batch) * n * heads) return;  // whole warps
  const long long token = row / heads;
  const int h = static_cast<int>(row % heads);
  const long long at = row * kDh + lane * 4;  // (token, head) rows are (B n H, dh)
  const float4 a = *reinterpret_cast<const float4*>(out + at);
  const float4 d = *reinterpret_cast<const float4*>(dout + at);
  float v = a.x * d.x;
  v = fmaf(a.y, d.y, v);
  v = fmaf(a.z, d.z, v);
  v = fmaf(a.w, d.w, v);
#pragma unroll
  for (int k = 16; k > 0; k /= 2) v += __shfl_xor_sync(0xffffffffu, v, k);
  if (lane == 0) {
    const long long b = token / n, i = token % n;
    delta[(b * heads + h) * n + i] = v;
  }
}

// dK and dV of 64 keys a block (the file's comment).
__global__ void __launch_bounds__(kThreads, 1)
p4t_attention_dkdv_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                          const __grid_constant__ CUtensorMap tm_dout, const Args args) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = setup(smem_raw);
  const int n = args.n, bh = blockIdx.y, b = bh / args.heads, h = bh % args.heads;
  const int inner = args.heads * kDh, tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const long long at = static_cast<long long>(bh) * n;
    const Moving mv{h * kDh, h * kDh, b, tiles, n, args.lse + at, args.delta + at};
    stage_in(&tm_qkv, &tm_dout, mv, sm);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const Lane l = lane_of();
  const int row0 = blockIdx.x * kRows;
  const long long crop = static_cast<long long>(b) * n;
  float* qkv_grad = args.dqkv + crop * 3 * inner;
  float x[kDh / 8][4];  // warpgroup 0: K, warpgroup 1: V
  load_rows(x, args.qkv + crop * 3 * inner + (1 + l.wg) * inner + h * kDh, 3 * inner, row0, n);

  unsigned char* w = sm.base + kWrittenOff + l.wg * 2 * kWrittenBytes;
  const uint32_t w_addr = sm.addr + kWrittenOff + l.wg * 2 * kWrittenBytes;
  float4* pbuf = reinterpret_cast<float4*>(sm.base + kPbufOff) + threadIdx.x % 128;
  const int own = kOwn0 + l.wg;
  float acc[2][32];  // warpgroup 0: dVᵀ, warpgroup 1: dKᵀ
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
    const float* vecs = reinterpret_cast<const float*>(sm.base + kVecOff) + s * 2 * kTile;
    float v[16];
    turn_wait(l.wg, it);
    scores(v, x, sm.addr + s * kStageBytes + l.wg * kOperandBytes);  // K Qᵀ, or V dOᵀ
    turn_pass(l.wg, it, tiles);
    // the tile's values of the thread's columns 8j + 2t and 8j + 2t + 1:
    // warpgroup 0 the log-sum-exp, warpgroup 1 D
    float2 cols[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cols[j] = *reinterpret_cast<const float2*>(vecs + l.wg * kTile + 8 * j + 2 * l.t);
    }
    if (l.wg == 0) {
      // Pᵀ = exp(Sᵀ / √dh − lse), queries past n at 0
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 8 * j + 2 * l.t + q % 2;
          const float lse2 = (q % 2 ? cols[j].y : cols[j].x) * kLog2e;  // base 2
          v[4 * j + q] = it * kTile + col < n ? exp2f(v[4 * j + q] * args.scale_log2 - lse2) : 0.f;
        }
      if (it > 0) named_sync(kPFree, 256);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pbuf[128 * i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
      named_arrive(kPReady, 256);
    } else {
      // dSᵀ = Pᵀ ∘ (dPᵀ − D)
      named_sync(kPReady, 256);
      float p[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = pbuf[128 * i];
        p[4 * i] = f.x;
        p[4 * i + 1] = f.y;
        p[4 * i + 2] = f.z;
        p[4 * i + 3] = f.w;
      }
      if (it + 1 < tiles) named_arrive(kPFree, 256);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[4 * j + q] = p[4 * j + q] * (v[4 * j + q] - (q % 2 ? cols[j].y : cols[j].x));
        }
    }
    named_sync(own, 128);  // the warpgroup's last product is done with its plane
    write_plane(v, w);
    fence_async_smem();
    named_sync(own, 128);
    // dVᵀ += dOᵀ P (warpgroup 0), dKᵀ += Qᵀ dS (warpgroup 1)
    transposed_product<2>(acc, sm.base + s * kStageBytes + (1 - l.wg) * kOperandBytes, 0,
                          w_addr, nullptr);
    release(sm, s);
  }
  // warpgroup 0: dV into V's columns; warpgroup 1: dK (times 1 / √dh) into K's
  store_transposed<2>(acc, qkv_grad + (2 - l.wg) * inner + h * kDh, 3 * inner, row0, n, 0,
                      l.wg == 0 ? 1.f : args.scale);
}

// dQ of 64 queries a block (the file's comment).
__global__ void __launch_bounds__(kThreads, 1)
p4t_attention_dq_kernel(const __grid_constant__ CUtensorMap tm_qkv, const Args args) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = setup(smem_raw);
  const int n = args.n, bh = blockIdx.y, b = bh / args.heads, h = bh % args.heads;
  const int inner = args.heads * kDh, tiles = (n + kTile - 1) / kTile;
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    const Moving mv{inner + h * kDh, 2 * inner + h * kDh, b, tiles, n, nullptr, nullptr};
    stage_in(&tm_qkv, &tm_qkv, mv, sm);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const Lane l = lane_of();
  const int row0 = blockIdx.x * kRows;
  const long long crop = static_cast<long long>(b) * n;
  uint32_t xs[2][kDh / 8][4];  // warpgroup 0: Q, warpgroup 1: dO; hi and lo
  {
    float x[kDh / 8][4];
    if (l.wg == 0) {
      load_rows(x, args.qkv + crop * 3 * inner + h * kDh, 3 * inner, row0, n);
    } else {
      load_rows(x, args.dout + crop * inner + h * kDh, inner, row0, n);
    }
    split_rows(xs, x);
  }
  // rows g and g + 8: warpgroup 0 the log-sum-exp in base 2, warpgroup 1 D
  float rowv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * l.warp + l.g + 8 * r;
    const float* src = l.wg == 0 ? args.lse : args.delta;
    rowv[r] = row < n ? __ldg(src + static_cast<long long>(bh) * n + row) : 0.f;
    if (l.wg == 0) rowv[r] *= kLog2e;
  }

  unsigned char* w = sm.base + kWrittenOff;
  const uint32_t w_addr = sm.addr + kWrittenOff;
  float4* pbuf = reinterpret_cast<float4*>(sm.base + kPbufOff) + threadIdx.x % 128;
  float dq[1][32];  // columns 64 wg .. + 63 of dQᵀ
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[0][i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    hopper::mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
    float v[16];
    scores(v, xs, sm.addr + s * kStageBytes + l.wg * kOperandBytes);  // Q Kᵀ, or dO Vᵀ
    if (l.wg == 0) {
      // P = exp(S / √dh − lse), keys past n at 0
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int key = it * kTile + 8 * j + 2 * l.t + q % 2;
          v[4 * j + q] = key < n ? exp2f(v[4 * j + q] * args.scale_log2 - rowv[q / 2]) : 0.f;
        }
      if (it > 0) named_sync(kPFree, 256);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pbuf[128 * i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
      named_arrive(kPReady, 256);
    } else {
      // dS = P ∘ (dP − D) into the plane
      named_sync(kPReady, 256);
      float p[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = pbuf[128 * i];
        p[4 * i] = f.x;
        p[4 * i + 1] = f.y;
        p[4 * i + 2] = f.z;
        p[4 * i + 3] = f.w;
      }
      if (it + 1 < tiles) named_arrive(kPFree, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = p[i] * (v[i] - rowv[(i % 4) / 2]);
      if (it > 0) named_sync(kDsFree, 256);  // both warpgroups' last products are done with it
      write_plane(v, w);
      fence_async_smem();
    }
    named_sync(kDsReady, 256);
    transposed_product<1>(dq, sm.base + s * kStageBytes, l.wg, w_addr, nullptr);  // dQᵀ += Kᵀ dSᵀ
    if (l.wg == 0 && it + 1 < tiles) named_arrive(kDsFree, 256);
    release(sm, s);
  }
  store_transposed<1>(dq, args.dqkv + crop * 3 * inner + h * kDh, 3 * inner, row0, n, l.wg,
                      args.scale);
}

bool shape_ok(int batch, int n, int heads, int dh) {
  return dh == kDh && batch >= 1 && n >= 1 && heads >= 1 &&
         static_cast<long long>(batch) * heads <= 65535 &&
         static_cast<long long>(batch) * n < (1LL << 31);
}

cudaError_t launch_setup() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(p4t_attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(p4t_attention_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(p4t_attention_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  done = err == cudaSuccess;
  return err;
}

Args args_of(const float* qkv, int n, int heads) {
  Args a{};
  a.qkv = qkv;
  a.n = n;
  a.heads = heads;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(kDh)));
  a.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(kDh)));
  return a;
}

}  // namespace

// Plain C entry points for ctypes. All arrays f32, contiguous, on the card,
// 16-byte aligned; each returns the cudaError_t of its launches (0 on
// success).
//
// p4t_attention_forward: o (B, n, H dh) and lse (B, H, n) from qkv (B, n, 3
// H dh); one launch.
extern "C" int p4t_attention_forward(const float* qkv, float* o, float* lse, int batch, int n,
                                     int heads, int dh, void* stream) {
  if (!shape_ok(batch, n, heads, dh)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  if (!hopper::make_map_3d(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), qkv,
                           3 * heads * kDh, n, batch, kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = launch_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = args_of(qkv, n, heads);
  a.o = o;
  a.lse_out = lse;
  const dim3 grid((n + 2 * kRows - 1) / (2 * kRows), batch * heads);
  p4t_attention_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm, a);
  return static_cast<int>(cudaGetLastError());
}

// p4t_attention_backward: dqkv (B, n, 3 H dh) from qkv, the forward's o and
// lse, and dout (B, n, H dh); delta (B, H, n) is scratch (D). Three
// launches: D, then dK and dV, then dQ.
extern "C" int p4t_attention_backward(const float* qkv, const float* o, const float* lse,
                                      const float* dout, float* delta, float* dqkv, int batch,
                                      int n, int heads, int dh, void* stream) {
  if (!shape_ok(batch, n, heads, dh)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_qkv, tm_dout;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!hopper::make_map_3d(&tm_qkv, kF32, sizeof(float), qkv, 3 * heads * kDh, n, batch, kTile) ||
      !hopper::make_map_3d(&tm_dout, kF32, sizeof(float), dout, heads * kDh, n, batch, kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = launch_setup();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * n * heads;
  p4t_attention_delta_kernel<<<static_cast<unsigned>((rows * 32 + kDeltaThreads - 1) /
                                                     kDeltaThreads),
                               kDeltaThreads, 0, s>>>(o, dout, delta, batch, n, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = args_of(qkv, n, heads);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dqkv = dqkv;
  const dim3 grid((n + kRows - 1) / kRows, batch * heads);
  p4t_attention_dkdv_kernel<<<grid, kThreads, kSmemBytes, s>>>(tm_qkv, tm_dout, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  p4t_attention_dq_kernel<<<grid, kThreads, kSmemBytes, s>>>(tm_qkv, a);
  return static_cast<int>(cudaGetLastError());
}
