// The P4Transformer blocks' dense products (Block.to_qkv, to_out, ff1,
// ff2): Y = X W^T (+ b) and its two gradients, dX = dY W and dW = dY^T X
// (with db = the column sums of dY), on the tensor cores in the exact
// three-pass TF32 mode of tf32x3.cuh (3xTF32), written by hand for Hopper
// (sm_90a).
//
// No TPU kernel is ported here: the JAX package has no P4Transformer, and
// XLA ran its dense layers. It replaces cuBLAS's f32 GEMMs, which run on
// the CUDA cores (67 TFLOP/s) because the port keeps single-pass TF32 off.
//
// What bounds it: the three tensor-core passes, 495 / 3 = 165 TFLOP/s. At
// the published sizes (18,000 tokens a step; D 1024, QKV 3072, MLP 2048)
// one block's forward and backward do 0.906 TFLOP of dense products, 5.5 ms
// at that rate; the operands and outputs (about 1.3 GB a block) take 0.4
// ms at 3.35 TB/s.
//
// Design. X is (rows, in) row-major, rows = B x tokens; W is nn.Linear's
// (out, in); in and out multiples of 4, any rows.
// - Forward and input gradient: the persistent TMA + wgmma engine of
//   tf32x3_wgmma.cuh as it is, with this file's epilogue `p4t_linear_out`
//   (the bias added in the epilogue). Its B operand is K-major TF32 hi/lo
//   planes, which the engine's split writes once a call: W itself for
//   the forward (B^T = W, (out, in)), W^T for the input gradient (B^T = W^T,
//   (in, out)). The planes are not kept from the forward for the backward:
//   five blocks' planes would hold 336 MB beside the activations.
// - Weight gradient: K is the token axis, and both operands, dY (rows, out)
//   and X (rows, in), are token-major, where TF32 wgmma takes K-major
//   operands only. p4t_linear_wgrad_kernel is persistent like the engine,
//   on 128 x 128 output tiles, 32 tokens a stage, a ring of 3 stages, with
//   two consumer warpgroups (one m64 tile each) and two producer
//   warpgroups (odd and even stages), and brings both operands K-major
//   without a transposed copy in device memory:
//   - A = dY^T from registers: the TMA lands the stage's dY rows as 32 x 32
//     boxes with the 128-byte swizzle, and each consumer thread reads its
//     fragments as 64-bit pairs of neighbouring output rows. Fragment row g
//     of a warp's 16 is output row 2g, row g + 8 is 2g + 1, and fragment K
//     index t is token 2t, t + 4 is token 2t + 1: with those two
//     permutations the reads are free of bank conflicts under the swizzle;
//   - B = X: the TMA lands the stage's X rows in a staging slot, and the
//     producer warpgroup's 128 threads (each one column of X) split each
//     value into TF32 hi and lo and write both planes K-major, with the
//     swizzle and with the same token permutation, into the stage, then
//     release it to the consumers (fence.proxy.async, one arrival a warp).
//     A stage's dY boxes are loaded once the stage is free, its X tile two
//     of the group's stages ahead, so no load waits on the consumers. Two
//     groups, because one group's split, not the tensor cores, set the pace
//     (on the card, with one group: taking the producer's loads out took
//     17% off the kernel's time, a third of the products 4%; the second
//     group took 10% off);
//   - two-level sums: the tensor cores' f32 accumulation drops low bits
//     toward zero at every wgmma, so over the 18,000 tokens of a weight's
//     gradient the sums shrank by about 6e-5 of their size (a gradient norm
//     read 6e-5 off plain f32's, on every seed). A consumer's wgmma of 64
//     tokens start from zero, and those sums go into a second register
//     accumulator by an f32 add, which rounds to nearest; the two consumer
//     warpgroups add 32 tokens apart, so that one's wait for its last
//     group overlaps the other's products (the producers give up registers
//     to 56, the consumers take 200);
//   - split K: an output tile's tokens are cut into `splits` slices of
//     whole stages (the wrapper picks 1-4 so that tiles x slices fill the
//     132 SMs), each slice one work item. Slice 0 writes dW, the others a
//     partial each, and p4t_linear_reduce_kernel adds them to dW in slice
//     order. db: the consumers of the items of column tile 0 sum the dY
//     values they load (a stage's sum, then the running sum, then the four
//     lanes of a row by a fixed butterfly), a partial a slice, reduced in
//     slice order by the same kernel.
// No atomics: every output is a fixed-order sum, so two calls on the same
// inputs give the same bits. Every kernel's name holds `p4t_linear` (the
// engine's gemm_kernel through its epilogue's type, its split_kernel
// through p4t_linear_tag), so a trace finds them all. The mbarrier, TMA
// and wgmma primitives are hopper.cuh's, the wgmma shape the engine's.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3_wgmma.cuh"

namespace {

namespace tw = tf32x3_wgmma;
using tw::Acc;
using tw::kBK;
using tw::kBN;
using tw::kConsumers;
using tw::kMT;

constexpr int kColSteps = kBN / 8;  // n8 column steps of a tile
constexpr int kReduceThreads = 256;

// y[r][c] = acc + bias[c] (no bias: acc) for r < rows, c < n.
struct p4t_linear_out {
  const float* bias;
  float* y;
  int rows, n;
  __device__ void operator()(Acc& acc, int row0, int col0) const {
#pragma unroll
    for (int j = 0; j < kColSteps; ++j) {
      const int c = col0 + tw::frag_col(j, 0);
      if (c >= n) continue;  // n % 4 == 0: both columns of the pair are in or out
      const float b0 = bias != nullptr ? __ldg(bias + c) : 0.f;
      const float b1 = bias != nullptr ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + tw::frag_row(m, 2 * h);
          if (r < rows) {
            *reinterpret_cast<float2*>(y + static_cast<size_t>(r) * n + c) =
                make_float2(acc[m][4 * j + 2 * h] + b0, acc[m][4 * j + 2 * h + 1] + b1);
          }
        }
      }
    }
  }
};

// The tag that names this file's splits: tw::split_kernel<p4t_linear_tag, ...>.
struct p4t_linear_tag {};

// ---- the weight gradient ---------------------------------------------------

constexpr int kTileM = 128;                         // output rows a tile: 2 x m64
constexpr int kBox = 32;                            // a TMA box: 32 x 32 f32, 128-byte swizzle
constexpr int kBoxBytes = kBox * kBox * 4;          // 4 KB
constexpr int kABytes = kTileM * kBK * 4;           // 16 KB: 4 boxes of dY
constexpr int kBBytes = kBN * kBK * 4;              // 16 KB: a plane, or the staged X tile
constexpr int kStageBytes = kABytes + 2 * kBBytes;  // 48 KB
constexpr int kStages = 3;
constexpr int kGroups = 2;                          // producer warpgroups: odd and even stages
constexpr int kProducers = 128;                     // threads of a producer warpgroup
constexpr int kSlots = 2;                           // staging slots of X a producer warpgroup
constexpr int kWgradThreads = kConsumers + kGroups * kProducers;
constexpr int kWgradSmem = 1024 + kStages * kStageBytes + kGroups * kSlots * kBBytes +
                           8 * (2 * kStages + kGroups * kSlots);
static_assert(kWgradSmem <= 232448, "ring and staging fit one block's shared memory");
static_assert(kProducers == kBN, "a producer thread a column of X");
static_assert(kConsumers == 2 * 128 && kTileM == 2 * 64, "a consumer warpgroup an m64 tile");

// The work items: (slice, output tile), column tiles fastest, slice
// slowest; item i goes to block i % gridDim.x, each block's in order.
struct Work {
  int m_tiles, n_tiles, splits, k_tiles;
  __device__ __forceinline__ int items() const { return m_tiles * n_tiles * splits; }
  __device__ __forceinline__ int slice(int i) const { return i / (m_tiles * n_tiles); }
  __device__ __forceinline__ int m0(int i) const {
    return (i % (m_tiles * n_tiles)) / n_tiles * kTileM;
  }
  __device__ __forceinline__ int n0(int i) const { return i % n_tiles * kBN; }
  // the slice's stages [kb, ke) of the k_tiles token stages
  __device__ __forceinline__ int kb(int i) const {
    return static_cast<int>(static_cast<long long>(slice(i)) * k_tiles / splits);
  }
  __device__ __forceinline__ int ke(int i) const {
    return static_cast<int>(static_cast<long long>(slice(i) + 1) * k_tiles / splits);
  }
};

struct WgradArgs {
  Work work;
  int out, in;
  float* dw;          // (out, in): slice 0's sums, then the reduced gradient
  float* partial;     // (splits - 1, out, in): slices 1 ..
  float* db_partial;  // (splits, out), or null: no bias
};

// The producer's cursor over the block's (item, stage) pairs, in order.
struct Cursor {
  int item, kt, ke;
  __device__ __forceinline__ void skip_empty(const Work& w) {
    while (item < w.items() && kt >= ke) {
      item += gridDim.x;
      if (item < w.items()) {
        kt = w.kb(item);
        ke = w.ke(item);
      }
    }
  }
  __device__ __forceinline__ bool valid(const Work& w) const { return item < w.items(); }
  __device__ __forceinline__ void advance(const Work& w) {
    ++kt;
    skip_empty(w);
  }
};

// The leader's loads of the block's `j`-th stage (item `item`, token stage
// `kt`): the dY boxes into the ring's stage (`full`), X's into a staging
// slot (`staged`).
__device__ __forceinline__ void load_dy(const CUtensorMap* tm_dy, uint32_t stage, uint32_t bar,
                                        int m0, int kt) {
  hopper::mbar_expect_tx(bar, kABytes);  // out-of-bounds zeros count too
#pragma unroll
  for (int b = 0; b < kTileM / kBox; ++b) {
    hopper::tma_load(stage + b * kBoxBytes, tm_dy, bar, m0 + b * kBox, kt * kBK);
  }
}
__device__ __forceinline__ void load_x(const CUtensorMap* tm_x, uint32_t slot, uint32_t bar,
                                       int n0, int kt) {
  hopper::mbar_expect_tx(bar, kBBytes);
#pragma unroll
  for (int b = 0; b < kBN / kBox; ++b) {
    hopper::tma_load(slot + b * kBoxBytes, tm_x, bar, n0 + b * kBox, kt * kBK);
  }
}

// Producer thread p: column p of the staged X tile (32 tokens, 4 swizzled
// boxes) into row p of the stage's hi and lo planes, K-major with the
// 128-byte swizzle. Plane chunk 2kk holds tokens 8kk + 0, 2, 4, 6 and chunk
// 2kk + 1 tokens 8kk + 1, 3, 5, 7: K index t of a k8 step is token 2t, t + 4
// is 2t + 1, as the consumers read A. Plain loads and stores, so that the
// compiler overlaps a k8 step's eight loads (the waits and fences around
// them are asm with memory clobbers).
__device__ __forceinline__ void split_column(const float* staged_tile, float* planes, int p) {
  const float* col = staged_tile + (p / kBox) * (kBox * kBox) + p % 4;
  const int chunk = (p % kBox) / 4;
  float* row_hi = planes + p * kBK;
  float* row_lo = row_hi + kBBytes / 4;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    float v[8];  // a k8 step's tokens, loaded together
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = 8 * kk + u;
      v[u] = col[k * kBox + ((chunk ^ (k % 8)) << 2)];
    }
    uint32_t h[2][4], l[2][4];  // [token parity][position in the chunk]
#pragma unroll
    for (int u = 0; u < 8; ++u) tf32x3::split(v[u], h[u % 2][u / 2], l[u % 2][u / 2]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = ((2 * kk + c) ^ (p % 8)) << 2;
      *reinterpret_cast<uint4*>(row_hi + off) = make_uint4(h[c][0], h[c][1], h[c][2], h[c][3]);
      *reinterpret_cast<uint4*>(row_lo + off) = make_uint4(l[c][0], l[c][1], l[c][2], l[c][3]);
    }
  }
}

// Producer warpgroup q (0 or 1) takes the block's stages it with it % 2 ==
// q, so that two stages are split at once. For each: wait for the ring's
// stage to be free, the leader (thread 0 of the group) loads its dY boxes,
// all wait for its X tile and split it into the stage's planes, then
// arrive; once every thread is done with the staging slot the leader loads
// the X tile of the group's stage kSlots ahead into it. No load waits for
// the consumers but the dY boxes, which the stage's own wait covers.
__device__ __forceinline__ void wgrad_produce(const CUtensorMap* tm_dy, const CUtensorMap* tm_x,
                                              unsigned char* smem, uint32_t ring, uint32_t slots,
                                              uint32_t full, uint32_t empty, uint32_t staged,
                                              const Work& w) {
  const int q = (threadIdx.x - kConsumers) / kProducers, p = (threadIdx.x - kConsumers) % kProducers;
  const bool leader = p == 0;
  const uint32_t my_slots = slots + q * kSlots * kBBytes, my_staged = staged + 8 * q * kSlots;
  Cursor next{static_cast<int>(blockIdx.x), 0, 0};  // the block's stages in order
  if (next.valid(w)) {
    next.kt = w.kb(next.item);
    next.ke = w.ke(next.item);
  }
  next.skip_empty(w);
  if (q == 1) next.advance(w);  // the group's first stage, then every other
  if (leader) {
    for (int j = 0; j < kSlots && next.valid(w); ++j, next.advance(w), next.advance(w)) {
      load_x(tm_x, my_slots + j * kBBytes, my_staged + 8 * j, w.n0(next.item), next.kt);
    }
  }
  __syncwarp();
  int it = 0, mine = 0;  // the block's stages, the group's
  for (int i = blockIdx.x; i < w.items(); i += gridDim.x) {
    for (int kt = w.kb(i); kt < w.ke(i); ++kt, ++it) {
      if (it % kGroups != q) continue;
      const int s = it % kStages, slot = mine % kSlots;
      hopper::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);  // a fresh barrier passes at once
      if (leader) load_dy(tm_dy, ring + s * kStageBytes, full + 8 * s, w.m0(i), kt);
      __syncwarp();
      hopper::mbar_wait(my_staged + 8 * slot, (mine / kSlots) & 1);
      split_column(reinterpret_cast<const float*>(smem + (my_slots - ring) + slot * kBBytes),
                   reinterpret_cast<float*>(smem + s * kStageBytes + kABytes), p);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
      __syncwarp();
      if (p % 32 == 0) hopper::mbar_arrive(full + 8 * s);
      // every thread of the group is done with the slot: refill it
      asm volatile("barrier.sync %0, %1;" ::"r"(1 + q), "n"(kProducers) : "memory");
      if (leader && next.valid(w)) {
        load_x(tm_x, my_slots + slot * kBBytes, my_staged + 8 * slot, w.n0(next.item), next.kt);
        next.advance(w);
        next.advance(w);
      }
      __syncwarp();
      ++mine;
    }
  }
}

// dW = dY^T X over the block's items (the file's comment). Launch with
// kWgradThreads threads and kWgradSmem bytes of dynamic shared memory.
__global__ void __launch_bounds__(kWgradThreads, 1)
p4t_linear_wgrad_kernel(const __grid_constant__ CUtensorMap tm_dy,
                        const __grid_constant__ CUtensorMap tm_x, const WgradArgs args) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hopper::smem_addr(smem);
  const uint32_t slots = ring + kStages * kStageBytes;
  const uint32_t full = slots + kGroups * kSlots * kBBytes;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t staged = empty + 8 * kStages;
  const Work& w = args.work;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the dY bytes' arrival + a warp's each; one arrival per consumer warp
      hopper::mbar_init(full + 8 * s, 1 + kProducers / 32);
      hopper::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    for (int s = 0; s < kGroups * kSlots; ++s) hopper::mbar_init(staged + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;" ::: "memory");
    wgrad_produce(&tm_dy, &tm_x, smem, ring, slots, full, empty, staged, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;" ::: "memory");
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // A fragments: the warp's 16 output rows lie in dY box (wg * 64 + warp *
  // 16) / 32 at column offset 0 or 16; the pair (2g, 2g + 1) at token 2t
  // (fragment K index t) and at 2t + 1 (t + 4). Chunk q of box row k sits
  // at q ^ (k % 8); per k8 step the rows move by 8.
  uint32_t a_off[2];
  {
    const int r = wg * 64 + warp * 16;
    const int q = (r % kBox) / 4 + g / 2;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * t + u;
      a_off[u] = (r / kBox) * kBoxBytes + k * (kBox * 4) + ((q ^ k) << 4) + (g % 2) * 8;
    }
  }

  // Two-level sums: the wgmma of two stages (64 tokens) into `acc` from
  // zero, then `acc` into `total` by an f32 add (round to nearest), in
  // token order. The tensor cores' own f32 accumulation drops low bits
  // toward zero at every wgmma, an error that grows with the length of the
  // sum and biases it toward zero; 64 tokens keep it at their scale. The
  // two warpgroups add a stage apart, so that while one waits for its last
  // group the other's keep the tensor cores busy.
  float acc[64], total[64];
  uint32_t hi[2][2][4], lo[2][2][4];  // a double buffer of two k8 steps' split fragments
  float db_sum[2];                    // this thread's dY sums of rows 2g and 2g + 1
  const int add_at = wg;              // the stage, of 2, at whose start acc goes into total
  int it = 0;
  for (int i = blockIdx.x; i < w.items(); i += gridDim.x) {
    db_sum[0] = db_sum[1] = 0.f;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = total[e] = 0.f;
    int pending = -1;    // a stage whose groups may still run, -1 if none
    bool dirty = false;  // acc holds sums not yet in total
    for (int kt = w.kb(i); kt < w.ke(i); ++kt, ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(full + 8 * s, (it / kStages) & 1);
      const unsigned char* stage = smem + s * kStageBytes;
      const uint32_t Bhi = ring + s * kStageBytes + kABytes, Blo = Bhi + kBBytes;
      float stage_sum[2] = {0.f, 0.f};
      // a group of wgmma a pair of k8 steps, two groups a stage
#pragma unroll
      for (int kp = 0; kp < kBK / 16; ++kp) {
        const int b = kp;  // the pairs alternate buffers, also across stages and items
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const unsigned char* a = stage + (2 * kp + u) * 8 * (kBox * 4);
          const float2 v0 = *reinterpret_cast<const float2*>(a + a_off[0]);
          const float2 v1 = *reinterpret_cast<const float2*>(a + a_off[1]);
          tf32x3::split(v0.x, hi[b][u][0], lo[b][u][0]);  // row g, K index t
          tf32x3::split(v0.y, hi[b][u][1], lo[b][u][1]);  // row g + 8, K index t
          tf32x3::split(v1.x, hi[b][u][2], lo[b][u][2]);  // row g, K index t + 4
          tf32x3::split(v1.y, hi[b][u][3], lo[b][u][3]);  // row g + 8, K index t + 4
          stage_sum[0] += v0.x + v1.x;
          stage_sum[1] += v0.y + v1.y;
        }
        if (dirty && kp == 0 && it % 2 == add_at) {
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(acc[e])::"memory");
#pragma unroll
          for (int e = 0; e < 64; ++e) {
            total[e] += acc[e];
            acc[e] = 0.f;
          }
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kk = 2 * kp + u;
          const uint64_t dhi = hopper::desc_sw128(Bhi + 32 * kk);
          const uint64_t dlo = hopper::desc_sw128(Blo + 32 * kk);
          tw::wgmma_rs(acc, lo[b][u], dhi);
          tw::wgmma_rs(acc, hi[b][u], dlo);
          tw::wgmma_rs(acc, hi[b][u], dhi);
        }
        hopper::wgmma_commit();
        dirty = true;
        // the previous group is done and its fragment buffer free; at the
        // second group, so are the previous stage's groups
        hopper::wgmma_wait<1>();
        if (kp == 1 && pending >= 0) {
          if (lane == 0) hopper::mbar_arrive(empty + 8 * pending);
          pending = -1;
        }
      }
      pending = s;
      db_sum[0] += stage_sum[0];
      db_sum[1] += stage_sum[1];
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(acc[e])::"memory");
    if (pending >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * pending);
#pragma unroll
    for (int e = 0; e < 64; ++e) total[e] += acc[e];

    // the epilogue: fragment row g is output row 2g, row g + 8 is 2g + 1
    const int sl = w.slice(i), n0 = w.n0(i);
    const int row = w.m0(i) + wg * 64 + warp * 16 + 2 * g;
    float* dst = sl == 0 ? args.dw : args.partial + static_cast<size_t>(sl - 1) * args.out * args.in;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + h >= args.out) continue;
#pragma unroll
      for (int j = 0; j < kColSteps; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < args.in) {
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(row + h) * args.in + c) =
              make_float2(total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
        }
      }
    }
    if (args.db_partial != nullptr && n0 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = db_sum[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && row + h < args.out) {
          args.db_partial[static_cast<size_t>(sl) * args.out + row + h] = v;
        }
      }
    }
  }
}

// dW += partial[0] + partial[1] + ..., in slice order, four floats a thread
// (nothing to add where splits is 1); db[o] = db_partial[0][o] +
// db_partial[1][o] + ... where db is not null.
__global__ void __launch_bounds__(kReduceThreads)
p4t_linear_reduce_kernel(float* __restrict__ dw, const float* __restrict__ partial, int splits,
                         long long n4, const float* __restrict__ db_partial,
                         float* __restrict__ db, int out) {
  const long long i = blockIdx.x * static_cast<long long>(kReduceThreads) + threadIdx.x;
  if (i < n4 && splits > 1) {
    float4 v = reinterpret_cast<float4*>(dw)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 p = reinterpret_cast<const float4*>(partial)[(s - 1) * n4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    reinterpret_cast<float4*>(dw)[i] = v;
  }
  if (db != nullptr && i < out) {
    float v = db_partial[i];
    for (int s = 1; s < splits; ++s) v += db_partial[static_cast<size_t>(s) * out + i];
    db[i] = v;
  }
}

bool widths_ok(int k, int n) { return k >= 4 && k % 4 == 0 && n >= 4 && n % 4 == 0; }

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 0;
    }
  }
  return sms;
}

}  // namespace

// Plain C entry points for ctypes. All arrays f32, contiguous, on the card,
// 16-byte aligned; each returns the cudaError_t of its launches (0 on
// success).
//
// p4t_linear_split: W (out, in) into planes = hi then lo, out * in floats
// each: W's layout where transpose is 0, W^T's (in, out) where it is 1.
extern "C" int p4t_linear_split(const float* w, int out, int in, int transpose, float* planes,
                                void* stream) {
  if (!widths_ok(in, out)) return static_cast<int>(cudaErrorInvalidValue);
  float* lo = planes + static_cast<size_t>(out) * in;
  tw::SplitArgs args{};
  // the engine's planes are (n, k): W as it lies (k = in) for the forward,
  // read as (k, n) = (out, in) and transposed for the input gradient
  args.p[0] = transpose ? tw::SplitPlane{w, planes, lo, out, in}
                        : tw::SplitPlane{w, planes, lo, in, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(transpose ? tw::split_planes<p4t_linear_tag, true>(args, 1, s)
                                    : tw::split_planes<p4t_linear_tag, false>(args, 1, s));
}

// p4t_linear_gemm: y (rows, n) = a (rows, k) @ B (+ bias (n,), or null),
// with planes = B^T's hi then lo, (n, k) each, as p4t_linear_split writes
// them.
extern "C" int p4t_linear_gemm(const float* a, const float* planes, const float* bias, float* y,
                               int rows, int k, int n, void* stream) {
  if (rows < 1 || !widths_ok(k, n)) return static_cast<int>(cudaErrorInvalidValue);
  const float* lo = planes + static_cast<size_t>(n) * k;
  return static_cast<int>(tw::launch(a, planes, lo, rows, k, n, p4t_linear_out{bias, y, rows, n},
                                     static_cast<cudaStream_t>(stream)));
}

// p4t_linear_wgrad: dw (out, in) = dy (rows, out)^T @ x (rows, in) in
// `splits` token slices, and db (out,) = dy's column sums where db is not
// null; then the slices reduced in order (a second launch where splits > 1
// or db is not null). Scratch: partial of (splits - 1) * out * in floats,
// db_partial of splits * out (unused without db).
extern "C" int p4t_linear_wgrad(const float* dy, const float* x, int rows, int out, int in,
                                int splits, float* dw, float* partial, float* db_partial,
                                float* db, void* stream) {
  const int k_tiles = (rows + kBK - 1) / kBK;
  if (rows < 1 || !widths_ok(in, out) || splits < 1 || splits > k_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap tm_dy, tm_x;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!hopper::make_map(&tm_dy, kF32, sizeof(float), dy, out, rows, kBox) ||
      !hopper::make_map(&tm_x, kF32, sizeof(float), x, in, rows, kBox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WgradArgs args;
  args.work = {(out + kTileM - 1) / kTileM, (in + kBN - 1) / kBN, splits, k_tiles};
  args.out = out;
  args.in = in;
  args.dw = dw;
  args.partial = partial;
  args.db_partial = db == nullptr ? nullptr : db_partial;
  const long long items =
      static_cast<long long>(args.work.m_tiles) * args.work.n_tiles * args.work.splits;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(p4t_linear_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgradSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  p4t_linear_wgrad_kernel<<<blocks, kWgradThreads, kWgradSmem, s>>>(tm_dy, tm_x, args);
  err = cudaGetLastError();
  if (err != cudaSuccess || (splits == 1 && db == nullptr)) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(out) * in / 4;
  const long long n = splits > 1 && n4 > out ? n4 : out;
  p4t_linear_reduce_kernel<<<static_cast<unsigned>((n + kReduceThreads - 1) / kReduceThreads),
                             kReduceThreads, 0, s>>>(dw, partial, splits, n4, db_partial, db,
                                                     out);
  return static_cast<int>(cudaGetLastError());
}
