// K4's bf16 kernels with the scores in device memory, on Hopper's tensor
// cores (sm_90a): the forward and the backward of the flash policy
// (attention_kernels.cuh's contract: causal triangle and segment ids,
// -0.7 * FLT_MAX added to a masked logit, no dropout) in bf16 on wgmma, fed
// by TMA, at every head dim that is a multiple of 64.
// flash_attention.cu and flash_attention_bwd.cu launch them for bf16
// (kokoro_flash_attention_{fwd,bwd}_scores, dtype 1), and the wrappers of
// ops/flash_attention.py take them for bf16 from the head dim
// BF16_SCORES_FROM on.  They replace the same TPU kernels as the rest of K4:
// the library Pallas flash attention behind
// kokoro_tpu/models/blocks.py:139 _flash_attention (forward
// _flash_attention_kernel, pl.pallas_call flash_attention.py:758; backward
// _flash_attention_bwd_dkv :1121 and _flash_attention_bwd_dq :1456).
//
// The schedule is attention_scores.cuh's, as in attention_scores_tf32.cuh: a
// scores kernel S = Q K^T over the whole head dim into an f32 workspace, the
// row pass (attention_scores.cuh's rows_kernel: m, l, lse, P~ in bf16), and
// products over keys or queries by 128-column strips of the head dim; the
// backward's row deltas, its scores kernel (S, then P, then dP = dO V^T, then
// dS), and dQ, dK, dV.  Every product is a plain wgmma.m64n128k16 with both
// operands in shared memory:
//
//   * a CTA is one producer warpgroup (one thread issues every TMA load into
//     a ring of full / empty mbarriers) and two consumer warpgroups of 64
//     rows, so one CTA holds a whole 128 x 128 tile;
//   * the contraction streams in chunks of 64 bf16: 128 bytes, one row of the
//     128-byte swizzle; a stage is an A and a B of 16 KB each;
//   * for 16-bit types wgmma reads either operand K-major or MN-major (its
//     transpose bits).  The products over the head dim (S = Q K^T, dP =
//     dO V^T, the delta's dO O^T) take both operands K-major as stored, a
//     128-row box each.  The products over keys or queries take the head-dim
//     operand (V, K, Q, dO) as B MN-major, two 64 x 64 boxes of its rows;
//     their A is the workspace, K-major for the rows that are queries (O =
//     P~ V, dQ = dS K: a 128-row box) and MN-major for the rows that are keys
//     (dK = dS^T Q, dV = P^T dO: two 64 x 64 boxes, one a warpgroup), so the
//     backward writes no transposed workspace;
//   * a consumer issues a chunk's four products, then waits for the previous
//     chunk's (wgmma's group count, one group in flight) and releases that
//     chunk's stage: the tensor cores always hold the next chunk's work.
//     The accumulator sums in place across chunks (bf16's tolerance leaves
//     room for the tensor cores' own accumulation; the f32 path joins each
//     chunk in f32).
//
// The backward's scores kernel takes S, then P = exp(s - lse) in f32 over
// S's registers (written to the P workspace in bf16), then dP into a second
// accumulator through the same ring, then dS = (dP - delta) P scale: two
// 64 x 128 f32 accumulators, 128 registers a consumer thread, within the 168
// ptxas allocates at the launch bound (it allocates against the launch
// bound, not setmaxnreg's 240).  Each row's delta is the diagonal of dO O^T over the
// query tile by the very products, chunk order and in-place accumulation of
// dP (the same consume), so a row whose one visible key gives O = that key's
// V row (P~ = 1) has dP - delta = 0 exactly, hence dS = 0 and its dQ row 0,
// as in the plain version.  No atomics: every output element is summed by one
// thread in a fixed order, two calls are bitwise equal.
//
// Workspaces (the wrapper allocates them): the forward's S (B H, Mq, Nk) f32,
// P~ (B H, Mq, Nk) bf16 and l (B H, Tq); the backward's delta (B H, Tq), P and
// dS (B H, Mq, Nk) bf16, Mq, Nk = Tq, Tk rounded up to 128.  A scheduled tile
// is written whole (zeros past Tq and Tk).  Rows of Q, K, V, O, dO past T
// and head-dim columns past Dh are TMA's zero fill.
//
// What bounds them on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 4 Dh operations
// a visible (query, key) pair forward, 10 Dh backward (12 Dh here, S
// recomputed and the delta's products); at the long path's B=12, T=1408, H=1
// and Dh 1536 that is 0.074 ms forward and 0.185 ms backward against 0.03 ms
// of bytes.  A 128 x 128 tile's chunk brings 32 KB for 4.2 MFLOP, so the
// products ask 7.7 TB/s of L2 across 132 SMs at the peak: six stages keep
// the loads ahead.  The workspace traffic (S written and read, P~ written and
// read; the backward's P and dS) is not in the bound and is flat in Dh: at
// small head dims it sets the share.

#pragma once

#include <cuda.h>

#include "attention_scores.cuh"
#include "attention_tc.cuh"

namespace kokoro_attn {
namespace scores_tc {

using scores::Args;
using bf16 = __nv_bfloat16;

constexpr int kTile = 128;      // a CTA's tile: 128 x 128
constexpr int kChunk = 64;      // bf16 of the contraction a stage: 128 bytes
constexpr int kSteps = 4;       // k-steps of 16 a chunk
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kConsumers = 2;   // consumer warpgroups of 64 rows
constexpr int kThreads = (1 + kConsumers) * kWG;
constexpr int kBoxBytes = kTile * kChunk * 2;   // a 128 x 64 bf16 operand: 16 KB
constexpr int kHalfBytes = kBoxBytes / 2;       // a 64 x 64 box: 8 KB
constexpr int kStageBytes = 2 * kBoxBytes;      // A and B
constexpr int kStages = 6;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

static_assert(kChunk * 2 == 128, "a chunk is one row of the 128-byte swizzle");
static_assert(kTile == scores::kTile && kTile == scores::kStrip,
              "attention_scores.cuh's schedule: tiles, strips");
static_assert(kChunk == 16 * kSteps, "wgmma's bf16 k-step is 16");

__host__ __device__ constexpr int smem_bytes() { return 1024 + kStages * kStageBytes + 2 * kStages * 8; }
static_assert(smem_bytes() <= 232448, "a CTA's shared memory");

// -- the ring -------------------------------------------------------------------

// The shared memory of a CTA from its 1024-byte aligned base: kStages stages
// (A, B), the full and the empty barriers
struct Ring {
  uint8_t* base;
  static constexpr int kBars = kStages * kStageBytes;
  __device__ __forceinline__ uint8_t* a(int s) const { return base + s * kStageBytes; }
  __device__ __forceinline__ uint8_t* b(int s) const { return base + s * kStageBytes + kBoxBytes; }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kBars) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(base + kBars) + kStages + s;
  }
  // the full barriers take the producer's arrival with its bytes; the
  // empty ones an arrival of each consumer warp once its products have read
  // the stage
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(full(s), 1);
      tc::mbar_init(empty(s), kConsumers * 4);
    }
    tc::mbar_fence_init();
  }
};

__device__ __forceinline__ Ring carve(uint8_t* raw) { return Ring{tc::align1024(raw)}; }

// a box of a 3-D tensor map (columns, rows, heads) into shared memory
__device__ __forceinline__ void tma3(uint8_t* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(tc::smem_u32(bar))
      : "memory");
}

// the producer: ring chunks c0 .. c1 - 1, chunk c into stage c % kStages
// once its consumers released it; load(c, A, B, bar) issues the chunk's
// boxes (kStageBytes)
template <typename Load>
__device__ __forceinline__ void produce(const Ring& r, int c0, int c1, Load load) {
  for (int c = c0; c < c1; ++c) {
    const int s = c % kStages;
    if (c >= kStages) tc::mbar_wait(r.empty(s), ((c / kStages) - 1) & 1);
    tc::mbar_expect_tx(r.full(s), kStageBytes);
    load(c, r.a(s), r.b(s), r.full(s));
  }
}

// -- the products ---------------------------------------------------------------

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), both in shared memory:
// TA / TB 0 K-major, 1 MN-major (the transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

// How a product's stage holds its operands
enum Layout {
  kHeadDim,     // over the head dim: A and B 128-row boxes, K-major (S, dP, the delta)
  kOverKeys,    // rows queries: A a 128-row box K-major, B two 64 x 64 boxes MN-major (O, dQ)
  kOverQueries  // rows keys: A two 64 x 64 boxes MN-major (one a warpgroup), B as kOverKeys (dK, dV)
};

// a chunk's four products of warpgroup wg (its 64 rows of the tile)
template <Layout L>
__device__ __forceinline__ void chunk_products(float (&acc)[64], const uint8_t* a, const uint8_t* b,
                                               int wg) {
  const uint8_t* aw = a + wg * kHalfBytes;  // 64 rows of a K-major box, or the warpgroup's box
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if constexpr (L == kHeadDim) {
      wgmma<0, 0>(acc, tc::sw128_desc(aw + ks * 32, 16), tc::sw128_desc(b + ks * 32, 16));
    } else if constexpr (L == kOverKeys) {
      wgmma<0, 1>(acc, tc::sw128_desc(aw + ks * 32, 16),
                  tc::sw128_desc(b + ks * 16 * 128, kHalfBytes));
    } else {
      wgmma<1, 1>(acc, tc::sw128_desc(aw + ks * 16 * 128, kHalfBytes),
                  tc::sw128_desc(b + ks * 16 * 128, kHalfBytes));
    }
  }
}

// acc += the product of ring chunks c0 .. c0 + n - 1: a chunk's products
// issued once its stage landed, then the previous chunk's awaited and its
// stage released (an arrival a warp).  Ends with every chunk's stage
// released and the products done.
template <Layout L>
__device__ __forceinline__ void consume(float (&acc)[64], const Ring& r, int c0, int n, int wg,
                                        int lane) {
  for (int i = 0; i < n; ++i) {
    const int c = c0 + i, s = c % kStages;
    tc::mbar_wait(r.full(s), (c / kStages) & 1);
    tc::fence_regs(acc);
    tc::wgmma_fence();
    chunk_products<L>(acc, r.a(s), r.b(s), wg);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    tc::fence_regs(acc);
    if (i > 0 && lane == 0) tc::mbar_arrive(r.empty((c - 1) % kStages));
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  if (n > 0 && lane == 0) tc::mbar_arrive(r.empty((c0 + n - 1) % kStages));
}

// The consumer's thread: its warpgroup (0, 1), its lane, its fragment row m
// (and m + 8) of the CTA's 128 and its column t
struct Lane {
  int wg, lane, t, m;
};
__device__ __forceinline__ Lane lane_of() {
  Lane l;
  const int ct = (int)threadIdx.x - kWG;
  l.wg = tc::warpgroup_index() - 1;
  l.lane = ct & 31;
  l.t = ct & 3;
  l.m = 16 * (ct >> 5) + ((ct & 31) >> 2);  // 64 a warpgroup, 16 a warp
  return l;
}

// accumulator element 4 j + 2 i + e of a 64 x 128 product: row
// 16 warp + g + 8 i of the warpgroup, column 8 j + 2 t + e
__device__ __forceinline__ int acc_row(const Lane& ln, int i) { return ln.m + 8 * i; }
__device__ __forceinline__ int acc_col(const Lane& ln, int j, int e) { return 8 * j + 2 * ln.t + e; }

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// -- kernels ----------------------------------------------------------------------

// S = scale Q K^T + mask, one 128 x 128 tile, into the f32 workspace
__global__ void __launch_bounds__(kThreads, 1)
scores_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  Args a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = carve(smem_raw);
  const int bh = blockIdx.z, b = bh / a.H, n = a.Dh / kChunk;
  int qi, kj;
  scores::score_tile((int)blockIdx.x, a.Nk / kTile, a.causal != 0, qi, kj);
  const int m0 = qi * kTile, n0 = kj * kTile;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(r, 0, n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        tma3(A, &tq, c * kChunk, m0, bh, bar);
        tma3(B, &tk, c * kChunk, n0, bh, bar);
      });
    return;
  }
  tc::regs_inc<kConsumerRegs>();
  const Lane ln = lane_of();
  float acc[64];
  zero(acc);
  consume<kHeadDim>(acc, r, 0, n, ln.wg, ln.lane);
  float* s = a.s + (size_t)bh * a.Mq * a.Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + acc_row(ln, i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + acc_col(ln, j, 0);
      scores::store2(s + (size_t)row * a.Nk + col, scores::logit(a, b, row, col, acc[4 * j + 2 * i]),
                     scores::logit(a, b, row, col + 1, acc[4 * j + 2 * i + 1]));
    }
  }
}

// each row's delta: dO O^T over the query tile's own rows, its diagonal, by
// dP's products (consume<kHeadDim>)
__global__ void __launch_bounds__(kThreads, 1)
delta_kernel(const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap to,
             Args a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = carve(smem_raw);
  const int bh = blockIdx.z, n = a.Dh / kChunk, q0 = (int)blockIdx.x * kTile;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(r, 0, n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        tma3(A, &tdo, c * kChunk, q0, bh, bar);
        tma3(B, &to, c * kChunk, q0, bh, bar);
      });
    return;
  }
  tc::regs_inc<kConsumerRegs>();
  const Lane ln = lane_of();
  float acc[64];
  zero(acc);
  consume<kHeadDim>(acc, r, 0, n, ln.wg, ln.lane);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = acc_row(ln, i);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (acc_col(ln, j, e) == row && q0 + row < a.Tq)
          a.delta[(size_t)bh * a.Tq + q0 + row] = acc[4 * j + 2 * i + e];
  }
}

// the backward's tile: S, then P = exp(s - lse) over S's registers (into
// the P workspace in bf16), then dP, then dS = (dP - delta) P scale (into
// the dS workspace in bf16)
__global__ void __launch_bounds__(kThreads, 1)
scores_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tv,
                  Args a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = carve(smem_raw);
  const int bh = blockIdx.z, b = bh / a.H, n = a.Dh / kChunk;
  int qi, kj;
  scores::score_tile((int)blockIdx.x, a.Nk / kTile, a.causal != 0, qi, kj);
  const int m0 = qi * kTile, n0 = kj * kTile;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      // S's chunks, then dP's
      produce(r, 0, n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        tma3(A, &tq, c * kChunk, m0, bh, bar);
        tma3(B, &tk, c * kChunk, n0, bh, bar);
      });
      produce(r, n, 2 * n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        tma3(A, &tdo, (c - n) * kChunk, m0, bh, bar);
        tma3(B, &tv, (c - n) * kChunk, n0, bh, bar);
      });
    }
    return;
  }
  tc::regs_inc<kConsumerRegs>();
  const Lane ln = lane_of();
  float p[64];
  zero(p);
  consume<kHeadDim>(p, r, 0, n, ln.wg, ln.lane);
  bf16* P = static_cast<bf16*>(a.p) + (size_t)bh * a.Mq * a.Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + acc_row(ln, i);
    const bool in_row = row < a.Tq;
    const float lse = in_row ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + acc_col(ln, j, e), at = 4 * j + 2 * i + e;
        // lse = +inf on a row with no visible key: p = 0
        p[at] = in_row && col < a.Tk ? expf(scores::logit(a, b, row, col, p[at]) - lse) : 0.f;
      }
      scores::store2(P + (size_t)row * a.Nk + n0 + acc_col(ln, j, 0), p[4 * j + 2 * i],
                     p[4 * j + 2 * i + 1]);
    }
  }
  float dp[64];
  zero(dp);
  consume<kHeadDim>(dp, r, n, n, ln.wg, ln.lane);
  bf16* dS = static_cast<bf16*>(a.ds) + (size_t)bh * a.Mq * a.Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + acc_row(ln, i);
    const bool in_row = row < a.Tq;
    const float di = in_row ? a.delta[(size_t)bh * a.Tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + acc_col(ln, j, e), at = 4 * j + 2 * i + e;
        ds[e] = in_row && col < a.Tk ? (dp[at] - di) * p[at] * a.scale : 0.f;
      }
      scores::store2(dS + (size_t)row * a.Nk + n0 + acc_col(ln, j, 0), ds[0], ds[1]);
    }
  }
}

// out = X Y over the row tile's contraction, a 128-column strip of the head
// dim.  OVER_QUERIES false: rows are queries (O = P~ V / l, dQ = dS K; X
// read K-major, 128-row boxes); true: rows are keys (dK = dS^T Q, dV =
// P^T dO; X read MN-major, 64 x 64 boxes).  X is (B H, Mq, Nk); Y is
// (B H, T, Dh) over the contraction's rows, MN-major.
template <bool OVER_QUERIES>
__global__ void __launch_bounds__(kThreads, 1)
apply_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
             bf16* out, const float* l, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring r = carve(smem_raw);
  const int bh = blockIdx.z;
  const int To = OVER_QUERIES ? a.Tk : a.Tq;
  // under causal the last query tiles (and the first key tiles) take the
  // longest contractions: they start first
  const int it = !OVER_QUERIES && a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int r0 = it * kTile, d0 = (int)blockIdx.y * kTile;
  int k0, k1;
  scores::apply_range(r0, kTile, a.Tq, a.Tk, a.causal != 0, OVER_QUERIES, k0, k1, kChunk);
  const int n = (k1 - k0) / kChunk;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(r, 0, n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        const int kc = k0 + c * kChunk;
        if constexpr (OVER_QUERIES) {
          tma3(A, &tx, r0, kc, bh, bar);
          tma3(A + kHalfBytes, &tx, r0 + 64, kc, bh, bar);
        } else {
          tma3(A, &tx, kc, r0, bh, bar);
        }
        tma3(B, &ty, d0, kc, bh, bar);
        tma3(B + kHalfBytes, &ty, d0 + 64, kc, bh, bar);
      });
    return;
  }
  tc::regs_inc<kConsumerRegs>();
  const Lane ln = lane_of();
  float acc[64];
  zero(acc);
  consume<OVER_QUERIES ? kOverQueries : kOverKeys>(acc, r, 0, n, ln.wg, ln.lane);
  bf16* o = out + (size_t)bh * To * a.Dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + acc_row(ln, i);
    if (row >= To) continue;
    const float div = l != nullptr ? l[(size_t)bh * a.Tq + row] : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = d0 + acc_col(ln, j, 0);
      if (col >= a.Dh) continue;
      float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (l != nullptr) {
        v0 /= div;
        v1 /= div;
      }
      scores::store2(o + (size_t)row * a.Dh + col, v0, v1);
    }
  }
}

// -- launches -----------------------------------------------------------------------

// a bf16 (B H, rows, cols) tensor as a 3-D map of boxes of box_rows x 64
// with the 128-byte swizzle; rows past `rows` and columns past `cols` read
// as zero
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int heads,
                            int box_rows) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kSmem = smem_bytes();

inline cudaError_t set_attributes() {
  cudaError_t err = scores::allow_smem(scores_fwd_kernel, kSmem);
  if (err == cudaSuccess) err = scores::allow_smem(delta_kernel, kSmem);
  if (err == cudaSuccess) err = scores::allow_smem(scores_bwd_kernel, kSmem);
  if (err == cudaSuccess) err = scores::allow_smem(apply_kernel<false>, kSmem);
  if (err == cudaSuccess) err = scores::allow_smem(apply_kernel<true>, kSmem);
  return err;
}

// Once a library, with internal linkage (attention_scores.cuh says why)
namespace {
inline cudaError_t attributes_once() {
  static const cudaError_t err = set_attributes();
  return err;
}
}  // namespace

// the launch's counts (ops/flash_scores.py::grid mirrors them): one CTA a
// score tile, 128-row tiles of the products, 128-column strips
inline scores::Grid grid_of(int Tq, int Tk, int Dh, bool causal) {
  return scores::Grid{scores::score_tiles(scores::tiles_of(Tq), scores::tiles_of(Tk), causal), 1,
                      scores::tiles_of(Tq), scores::tiles_of(Tk), (Dh + kTile - 1) / kTile};
}

// forward: scores, rows (attention_scores.cuh's row pass in bf16), O; a.s,
// a.p, a.l the workspaces
inline cudaError_t launch_fwd(const Args& a, void* o, int BH, cudaStream_t st) {
  cudaError_t err = attributes_once();
  CUtensorMap mq, mk, mv, mp;
  if (err == cudaSuccess) err = make_map(&mq, a.q, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.Dh, a.Tk, BH, 64);
  if (err == cudaSuccess) err = make_map(&mp, a.p, a.Nk, a.Mq, BH, kTile);
  if (err != cudaSuccess) return err;
  const scores::Grid gr = grid_of(a.Tq, a.Tk, a.Dh, a.causal != 0);
  scores_fwd_kernel<<<dim3(gr.score_tiles, 1, BH), kThreads, kSmem, st>>>(mq, mk, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned row_blocks =
      (unsigned)(((long long)BH * a.Tq + scores::kWarps - 1) / scores::kWarps);
  scores::rows_kernel<bf16><<<row_blocks, scores::kThreads, 0, st>>>(a, BH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<false><<<dim3(gr.query_rows, gr.strips, BH), kThreads, kSmem, st>>>(
      mp, mv, static_cast<bf16*>(o), a.l, a);
  return cudaGetLastError();
}

// backward: delta, scores (P, dS), dQ, dK, dV; a.p (P) and a.ds (dS) the
// workspaces
inline cudaError_t launch_bwd(const Args& a, void* dq, void* dk, void* dv, int BH,
                              cudaStream_t st) {
  cudaError_t err = attributes_once();
  CUtensorMap mq, mk, mdo, mv, mo, yq, yk, ydo, xds, xds_t, xp_t;
  if (err == cudaSuccess) err = make_map(&mq, a.q, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mdo, a.dout, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mo, a.o, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&yq, a.q, a.Dh, a.Tq, BH, 64);
  if (err == cudaSuccess) err = make_map(&yk, a.k, a.Dh, a.Tk, BH, 64);
  if (err == cudaSuccess) err = make_map(&ydo, a.dout, a.Dh, a.Tq, BH, 64);
  if (err == cudaSuccess) err = make_map(&xds, a.ds, a.Nk, a.Mq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&xds_t, a.ds, a.Nk, a.Mq, BH, 64);
  if (err == cudaSuccess) err = make_map(&xp_t, a.p, a.Nk, a.Mq, BH, 64);
  if (err != cudaSuccess) return err;
  const scores::Grid gr = grid_of(a.Tq, a.Tk, a.Dh, a.causal != 0);
  delta_kernel<<<dim3(scores::tiles_of(a.Tq), 1, BH), kThreads, kSmem, st>>>(mdo, mo, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scores_bwd_kernel<<<dim3(gr.score_tiles, 1, BH), kThreads, kSmem, st>>>(mq, mk, mdo, mv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 q_grid(gr.query_rows, gr.strips, BH), k_grid(gr.key_rows, gr.strips, BH);
  apply_kernel<false><<<q_grid, kThreads, kSmem, st>>>(xds, yk, static_cast<bf16*>(dq), nullptr,
                                                       a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<true><<<k_grid, kThreads, kSmem, st>>>(xds_t, yq, static_cast<bf16*>(dk), nullptr,
                                                      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<true><<<k_grid, kThreads, kSmem, st>>>(xp_t, ydo, static_cast<bf16*>(dv), nullptr,
                                                      a);
  return cudaGetLastError();
}

}  // namespace scores_tc
}  // namespace kokoro_attn
