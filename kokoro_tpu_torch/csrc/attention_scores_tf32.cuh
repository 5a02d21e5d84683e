// K4's f32 kernels with the scores in device memory, on Hopper's tensor
// cores (sm_90a): the forward and the backward of the flash policy
// (attention_kernels.cuh's contract: causal triangle and segment ids,
// -0.7 * FLT_MAX added to a masked logit, no dropout) in 3xTF32 on wgmma,
// fed by TMA, at every head dim that is a multiple of 64.
// flash_attention.cu and flash_attention_bwd.cu launch them for f32
// (kokoro_flash_attention_{fwd,bwd}_scores, dtype 0), and the wrappers of
// ops/flash_attention.py take them for f32 from the head dim
// F32_SCORES_FROM on.  They replace the same TPU kernels as the rest of K4:
// the library Pallas flash attention behind
// kokoro_tpu/models/blocks.py:139 _flash_attention (forward
// _flash_attention_kernel, pl.pallas_call flash_attention.py:758; backward
// _flash_attention_bwd_dkv :1121 and _flash_attention_bwd_dq :1456).
//
// The schedule is attention_scores.cuh's (its f32 row pass stays as it
// is; bf16 has its own products, attention_scores_tc.cuh): a scores kernel S = Q K^T over the whole head dim
// into an f32 workspace, the row pass (m, l, lse, P~ over S in place), and
// products over keys or queries by 128-column strips of the head dim; the
// backward's row deltas, its scores kernel (S, then dP = dO V^T, then P and
// dS), and dQ, dK, dV.  What changes is every product:
//
//   * 3xTF32 on wgmma.m64n128k8: a CTA is one producer warpgroup (one thread
//     issues every TMA load into a ring of full / empty mbarriers) and two
//     consumer warpgroups of 64 rows, so one CTA holds a whole 128 x 128
//     tile (the mma.sync kernels took two CTAs of 64 rows in f32);
//   * the contraction streams in chunks of 32 f32: 128 bytes, one row of the
//     128-byte swizzle, a TMA box of 128 rows x 32 f32 (16 KB);
//   * TF32 wgmma reads a shared-memory operand only K-major (it has no
//     transpose bits for 32-bit types).  The operand each product has K-major
//     in memory is its B, read from shared memory: K, V or O (the scores
//     products, over the head dim) and the workspaces S / P~, dS, dS^T, P^T
//     (the products over keys or queries, rows the contraction).  The other
//     operand, A, comes from registers: Q or dO (the scores products) or the
//     head-dim operand V, K, Q, dO (rows the contraction, MN-major), gathered
//     from the shared tile.  So the products over keys or queries are taken
//     transposed, out^T = Y^T X^T (O^T = V^T P~^T, dQ^T = K^T dS^T,
//     dK^T = Q^T dS, dV^T = dO^T P), and stored transposed: a CTA is a
//     128-column strip of the head dim (64 columns a warpgroup) x 128 rows;
//   * the split, once a CTA: after a stage lands, the 256 consumer threads
//     split its B tile (each element by one thread) into big, written over
//     the raw tile, and small, written beside it; each warpgroup splits the
//     A values it gathers in registers (each read by one thread).  big =
//     tf32(x) rounded to nearest (split_t, attention_tf32_wide.cuh), small =
//     x - big truncated to TF32 (split), so that a split of big + small gives
//     big and small back, whatever the tensor cores do with low bits;
//   * three products a k-step, big.small, small.big, big.big, in the order of
//     attention_tf32.cuh's mma3; each chunk (4 k-steps, 12 products) into a
//     fresh accumulator joined to the sum by an f32 add (the tensor cores'
//     own accumulation truncates: PERF.md);
//   * the CTA splits chunk c + 1's B while chunk c's products run; then each
//     warpgroup waits for them, adds them, releases chunk c's stage (an
//     arrival a warp) and gathers chunk c + 1's A (one register set: two
//     left ptxas too few registers to keep the products asynchronous).
//
// The backward's scores kernel takes S (Q K^T), then P = exp(s - lse),
// written transposed (P^T, dV's B) and parked in shared memory (each thread
// its own values), then dP = dO V^T through the same ring, then dS = (dP -
// delta) P scale, written as dS (dQ's B) and dS^T (dK's B); both products'
// accumulators never live at once.  Each row's delta is the diagonal of
// dO O^T over the query tile, by the very split and products of dP: a row
// whose one visible key gives O = that key's V row as split splits it
// (the forward's P~ = 1) has dP - delta = 0 exactly, hence dS = 0 and its dQ
// row 0, as in the plain version.  The forward's scores and the backward's S
// are the same products in the same order, so the backward's P gives the
// forward's weights back (a row's one visible key gets weight 1).  No
// atomics: every output element is summed by one thread in a fixed order,
// two calls are bitwise equal, and nothing reads
// torch.backends.cuda.matmul.allow_tf32.
//
// Workspaces (the wrapper allocates them): the forward's S (B H, Mq, Nk)
// f32, P~ over it in place, and l (B H, Tq); the backward's delta (B H, Tq),
// P^T (B H, Nk, Mq), dS (B H, Mq, Nk) and dS^T (B H, Nk, Mq), Mq, Nk = Tq,
// Tk rounded up to 128.  A scheduled tile is written whole (zeros past Tq
// and Tk).  Rows of Q, K, V, O, dO past T and head-dim columns past Dh are
// TMA's zero fill.
//
// What bounds them on an H100 (165 TFLOP/s of 3xTF32 work: 495 TF32 / 3;
// 3.35 TB/s): 4 Dh operations a visible (query, key) pair forward, 10 Dh
// backward (12 Dh here, S recomputed and the delta's products); at the long
// path's B=12, T=1408 and Dh 1536 that is 0.443 ms forward and 1.108 ms
// backward against 0.03-0.1 ms of bytes.  Shared memory reads set the pace
// of a tensor-core product in f32 (an m64n128k8 reads 4 KB of B for 64
// clocks of tensor work): A from registers halves them, and the split writes
// each B element once a CTA.  Shared memory: 4 stages of 48 KB (A raw, B big,
// B small), the backward's scores kernel 3 stages and 64 KB of parked P.

#pragma once

#include <cuda.h>

#include "attention_scores.cuh"
#include "attention_tc.cuh"
#include "attention_tf32_wide.cuh"

namespace kokoro_attn {
namespace scores_tf32 {

using scores::Args;

constexpr int kTile = 128;      // a CTA's tile: 128 x 128
constexpr int kChunk = 32;      // f32 of the contraction a stage: 128 bytes
constexpr int kSteps = 4;       // k-steps of 8 a chunk
constexpr int kWG = 128;        // threads of a warpgroup
constexpr int kConsumers = 2;   // consumer warpgroups of 64 rows
constexpr int kThreads = (1 + kConsumers) * kWG;
constexpr int kBoxBytes = kTile * kChunk * 4;   // a 128 x 32 f32 tile: 16 KB
constexpr int kStageBytes = 3 * kBoxBytes;      // A raw, B (big in place), B small
constexpr int kFwdStages = 4;   // the scores, delta and product kernels
constexpr int kBwdStages = 3;   // the backward's scores kernel, beside its parked P
constexpr int kParkBytes = kConsumers * kWG * 64 * 4;  // each consumer thread's 64 P values
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kSplitBarrier = 1;  // the consumers' named barrier (0 is __syncthreads)

static_assert(kChunk * 4 == 128, "a chunk is one row of the 128-byte swizzle");
static_assert(kTile == scores::kTile && kChunk == scores::kChunk && kTile == scores::kStrip,
              "attention_scores.cuh's schedule: tiles, chunks, strips");
static_assert(kChunk == 8 * kSteps, "wgmma's f32 k-step is 8");

template <int STAGES, bool PARK>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STAGES * kStageBytes + (PARK ? kParkBytes : 0) + 2 * STAGES * 8;
}
static_assert(smem_bytes<kFwdStages, false>() <= 232448, "a CTA's shared memory");
static_assert(smem_bytes<kBwdStages, true>() <= 232448, "a CTA's shared memory");

// -- the ring -------------------------------------------------------------------

// The shared memory of a CTA from its 1024-byte aligned base: STAGES stages
// (A raw, B, B small), the parked P (PARK), the full and the empty
// barriers.  One pointer, the rest compile-time offsets: the consumers'
// product loop has few registers to spare.
template <int STAGES, bool PARK>
struct Ring {
  uint8_t* base;
  static constexpr int kPark = STAGES * kStageBytes;
  static constexpr int kBars = kPark + (PARK ? kParkBytes : 0);
  __device__ __forceinline__ uint8_t* a(int s) const { return base + s * kStageBytes; }
  __device__ __forceinline__ uint8_t* b(int s) const { return base + s * kStageBytes + kBoxBytes; }
  __device__ __forceinline__ float* park() const { return reinterpret_cast<float*>(base + kPark); }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kBars) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(base + kBars) + STAGES + s;
  }
  // the full barriers take the producer's arrival with its bytes; the
  // empty ones an arrival of each consumer warp once its products have read
  // the stage
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(full(s), 1);
      tc::mbar_init(empty(s), kConsumers * 4);
    }
    tc::mbar_fence_init();
  }
};

template <int STAGES, bool PARK>
__device__ __forceinline__ Ring<STAGES, PARK> carve(uint8_t* raw) {
  return Ring<STAGES, PARK>{tc::align1024(raw)};
}

// a box of a 3-D tensor map (columns, rows, heads) into shared memory
__device__ __forceinline__ void tma3(uint8_t* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(tc::smem_u32(bar))
      : "memory");
}

// the producer: ring chunks c0 .. c1 - 1, chunk c into stage c % STAGES
// once its consumers released it; load(c, A, B, bar) issues the chunk's
// boxes (2 kBoxBytes)
template <typename R, typename Load>
__device__ __forceinline__ void produce(const R& r, int c0, int c1, Load load) {
  constexpr int STAGES = R::kPark / kStageBytes;
  for (int c = c0; c < c1; ++c) {
    const int s = c % STAGES;
    if (c >= STAGES) tc::mbar_wait(r.empty(s), ((c / STAGES) - 1) & 1);
    tc::mbar_expect_tx(r.full(s), 2 * kBoxBytes);
    load(c, r.a(s), r.b(s), r.full(s));
  }
}

// -- the products ---------------------------------------------------------------

// D (64 x 128, f32) = A (64 x 8, TF32 registers) B^T (B: 128 x 8, shared
// memory, K-major), plus D when `accumulate`
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// x = big + small as the tensor cores read them: big = tf32(x) rounded to
// nearest, ties away (split_t's), small = x - big truncated to TF32 here, so
// that the bits a product reads do not depend on what the tensor cores do
// with an operand's low 13 bits, and a split of big + small gives big and
// small back
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  tf32::wide::split_t(x, big, small);
  small &= 0xffffe000u;
}

// k-step ks of a stage's B (128 rows of 32 f32, 128-byte swizzle, K-major)
__device__ __forceinline__ uint64_t b_desc(const uint8_t* tile, int ks) {
  return tc::sw128_desc(tile + ks * 32, 16);
}

// A's element (m, k) of a stage: A_T false, a 128 x 32 box (row m, the
// contraction k along the row, 128-byte swizzle); A_T true, four 32 x 32
// boxes of Y (row k of the contraction, head-dim column m)
template <bool A_T>
__device__ __forceinline__ float a_at(const float* A, int m, int k) {
  if constexpr (!A_T) {
    return A[m * kChunk + ((((k >> 2) ^ (m & 7)) << 2) | (k & 3))];
  } else {
    const int d = m & 31;
    return A[(m >> 5) * 1024 + k * kChunk + ((((d >> 2) ^ (k & 7)) << 2) | (d & 3))];
  }
}

// this thread's A fragments of a chunk, split: rows m, m + 8, columns
// 8 ks + t, 8 ks + t + 4 (wgmma's TF32 A layout, as mma.sync's m16n8k8)
template <bool A_T>
__device__ __forceinline__ void gather_a(const uint8_t* stage, int m, int t,
                                         uint32_t (&fb)[kSteps][4], uint32_t (&fs)[kSteps][4]) {
  const float* A = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const int k = 8 * ks + t;
    split(a_at<A_T>(A, m, k), fb[ks][0], fs[ks][0]);
    split(a_at<A_T>(A, m + 8, k), fb[ks][1], fs[ks][1]);
    split(a_at<A_T>(A, m, k + 4), fb[ks][2], fs[ks][2]);
    split(a_at<A_T>(A, m + 8, k + 4), fb[ks][3], fs[ks][3]);
  }
}

// the stage's B split by the 256 consumer threads (ct): big over the raw
// tile, small into the stage's third box; then fenced for wgmma's reads
__device__ __forceinline__ void split_b(uint8_t* b, int ct) {
  float4* big = reinterpret_cast<float4*>(b);
  float4* small = reinterpret_cast<float4*>(b + kBoxBytes);
#pragma unroll
  for (int i = 0; i < kBoxBytes / 16 / (kConsumers * kWG); ++i) {
    const int idx = ct + i * kConsumers * kWG;
    const float4 x = big[idx];
    uint32_t hb[4], hs[4];
    split(x.x, hb[0], hs[0]);
    split(x.y, hb[1], hs[1]);
    split(x.z, hb[2], hs[2]);
    split(x.w, hb[3], hs[3]);
    big[idx] = make_float4(__uint_as_float(hb[0]), __uint_as_float(hb[1]), __uint_as_float(hb[2]),
                           __uint_as_float(hb[3]));
    small[idx] = make_float4(__uint_as_float(hs[0]), __uint_as_float(hs[1]),
                             __uint_as_float(hs[2]), __uint_as_float(hs[3]));
  }
  tc::fence_async_smem();
}

// a chunk's 12 products into part (the first overwrites it)
__device__ __forceinline__ void issue(float (&part)[64], const uint32_t (&fb)[kSteps][4],
                                      const uint32_t (&fs)[kSteps][4], const uint8_t* b) {
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    wgmma_tf32(part, fb[ks], b_desc(b + kBoxBytes, ks), ks > 0);
    wgmma_tf32(part, fs[ks], b_desc(b, ks), 1);
    wgmma_tf32(part, fb[ks], b_desc(b, ks), 1);
  }
  tc::wgmma_commit();
}

// The consumer's thread: its index among the 256, its fragment row m (and
// m + 8) of the CTA's 128 and its column t
struct Lane {
  int ct, t, m;
};
__device__ __forceinline__ Lane lane_of() {
  Lane l;
  l.ct = (int)threadIdx.x - kWG;
  l.t = l.ct & 3;
  l.m = 16 * (l.ct >> 5) + ((l.ct & 31) >> 2);  // 64 a warpgroup, 16 a warp
  return l;
}

// acc += the product of ring chunks c0 .. c0 + n - 1.  A chunk: its stage
// landed and its B split (while the previous chunk's products run), then
// the previous chunk's products awaited, added and their stage released,
// then this chunk's A gathered and its products issued.  The wait is
// unconditional (part is zero before the first chunk), so that ptxas sees
// no path on which an accumulator or an A register is written under a
// running product.  Ends with every chunk's stage released.
template <bool A_T, typename R>
__device__ __forceinline__ void consume(float (&acc)[64], const R& r, int c0, int n,
                                        const Lane& ln) {
  constexpr int STAGES = R::kPark / kStageBytes;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  uint32_t fb[kSteps][4], fs[kSteps][4];
  for (int i = 0; i < n; ++i) {
    const int c = c0 + i, s = c % STAGES;
    tc::mbar_wait(r.full(s), (c / STAGES) & 1);
    split_b(r.b(s), ln.ct);
    tc::pair_sync(kSplitBarrier);
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
    tc::fence_operand(fb);
    tc::fence_operand(fs);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
    if (i > 0 && (ln.ct & 31) == 0) tc::mbar_arrive(r.empty((c - 1) % STAGES));
    gather_a<A_T>(r.a(s), ln.m, ln.t, fb, fs);
    issue(part, fb, fs, r.b(s));
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(part);
  tc::fence_operand(fb);
  tc::fence_operand(fs);
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] += part[e];
  if (n > 0 && (ln.ct & 31) == 0) tc::mbar_arrive(r.empty((c0 + n - 1) % STAGES));
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
  const auto r = carve<kFwdStages, false>(smem_raw);
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
  consume<false>(acc, r, 0, n, ln);
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

// each row's delta: dO O^T over the query tile's own rows, its diagonal
__global__ void __launch_bounds__(kThreads, 1)
delta_kernel(const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap to,
             Args a) {
  extern __shared__ uint8_t smem_raw[];
  const auto r = carve<kFwdStages, false>(smem_raw);
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
  consume<false>(acc, r, 0, n, ln);
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

// the backward's first epilogue: P = exp(s - lse) of the tile's S in acc,
// written transposed into P^T and parked in shared memory (each thread its
// own 64 values, 256 apart)
__device__ __forceinline__ void weights_epilogue(const float (&acc)[64], const Args& a, float* park,
                                                 const Lane& ln, int bh, int m0, int n0) {
  const int b = bh / a.H;
  float* PT = static_cast<float*>(a.p) + (size_t)bh * a.Nk * a.Mq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + acc_row(ln, i);
    const bool in_row = row < a.Tq;
    const float lse = in_row ? a.lse[(size_t)bh * a.Tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + acc_col(ln, j, e), at = 4 * j + 2 * i + e;
        // lse = +inf on a row with no visible key: p = 0
        const float p = in_row && col < a.Tk ? expf(scores::logit(a, b, row, col, acc[at]) - lse)
                                             : 0.f;
        PT[(size_t)col * a.Mq + row] = p;
        park[at * kConsumers * kWG + ln.ct] = p;
      }
  }
}

// the second: dS = (dP - delta) P scale from the tile's dP in acc and the
// parked P, written as dS and dS^T
__device__ __forceinline__ void ds_epilogue(const float (&acc)[64], const Args& a, const float* park,
                                            float* ds_t, const Lane& ln, int bh, int m0, int n0) {
  float* dS = static_cast<float*>(a.ds) + (size_t)bh * a.Mq * a.Nk;
  float* dST = ds_t + (size_t)bh * a.Nk * a.Mq;
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
        const float p = park[at * kConsumers * kWG + ln.ct];
        ds[e] = in_row && col < a.Tk ? (acc[at] - di) * p * a.scale : 0.f;
        dST[(size_t)col * a.Mq + row] = ds[e];
      }
      scores::store2(dS + (size_t)row * a.Nk + n0 + acc_col(ln, j, 0), ds[0], ds[1]);
    }
  }
}

// the backward's tile: S, then P = exp(s - lse) (P^T into its workspace,
// parked in shared memory), then dP, then dS = (dP - delta) P scale (dS and
// dS^T into theirs)
__global__ void __launch_bounds__(kThreads, 1)
scores_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tv,
                  float* ds_t, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const auto r = carve<kBwdStages, true>(smem_raw);
  const int bh = blockIdx.z, n = a.Dh / kChunk;
  int qi, kj;
  scores::score_tile((int)blockIdx.x, a.Nk / kTile, a.causal != 0, qi, kj);
  const int m0 = qi * kTile, n0 = kj * kTile;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      // S's chunks, then dP's (two loops: the producer has 24 registers)
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
  float acc[64];
  // one instance of the product loop for both passes (S, then dP), each
  // pass's epilogue after it
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    zero(acc);
    consume<false>(acc, r, pass * n, n, ln);
    if (pass == 0)
      weights_epilogue(acc, a, r.park(), ln, bh, m0, n0);
    else
      ds_epilogue(acc, a, r.park(), ds_t, ln, bh, m0, n0);
  }
}

// out = X Y, taken transposed: out^T (a 128-column strip of the head dim x
// 128 rows) = Y^T X^T over the row tile's contraction.  OVER_QUERIES false:
// rows are queries (O = P~ V / l, dQ = dS K; X (B H, Mq, Nk)); true: rows
// are keys (dK = dS^T Q, dV = P^T dO; X the transposed workspaces (B H, Nk,
// Mq)).  Y is (B H, T, Dh) over the contraction's rows.
template <bool OVER_QUERIES>
__global__ void __launch_bounds__(kThreads, 1)
apply_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
             float* out, const float* l, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const auto r = carve<kFwdStages, false>(smem_raw);
  const int bh = blockIdx.z;
  const int To = OVER_QUERIES ? a.Tk : a.Tq;
  // under causal the last query tiles (and the first key tiles) take the
  // longest contractions: they start first
  const int it = !OVER_QUERIES && a.causal ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int r0 = it * kTile, d0 = (int)blockIdx.y * kTile;
  int k0, k1;
  scores::apply_range(r0, kTile, a.Tq, a.Tk, a.causal != 0, OVER_QUERIES, k0, k1);
  const int n = (k1 - k0) / kChunk;
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  if (tc::warpgroup_index() == 0) {
    tc::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce(r, 0, n, [&](int c, uint8_t* A, uint8_t* B, uint64_t* bar) {
        const int kc = k0 + c * kChunk;
#pragma unroll
        for (int x = 0; x < kTile / 32; ++x) tma3(A + x * 4096, &ty, d0 + 32 * x, kc, bh, bar);
        tma3(B, &tx, kc, r0, bh, bar);
      });
    return;
  }
  tc::regs_inc<kConsumerRegs>();
  const Lane ln = lane_of();
  float acc[64];
  zero(acc);
  consume<true>(acc, r, 0, n, ln);
  float* o = out + (size_t)bh * To * a.Dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = d0 + acc_row(ln, i);
    if (d >= a.Dh) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + acc_col(ln, j, e);
        if (row >= To) continue;
        float v = acc[4 * j + 2 * i + e];
        if (l != nullptr) v /= l[(size_t)bh * a.Tq + row];
        o[(size_t)row * a.Dh + d] = v;
      }
  }
}

// -- launches -----------------------------------------------------------------------

// an f32 (B H, rows, cols) tensor as a 3-D map of boxes of box_rows x 32
// with the 128-byte swizzle; rows past `rows` and columns past `cols` read
// as zero
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols, int rows, int heads,
                            int box_rows) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kFwdSmem = smem_bytes<kFwdStages, false>();
constexpr int kBwdSmem = smem_bytes<kBwdStages, true>();

inline cudaError_t set_attributes() {
  cudaError_t err = scores::allow_smem(scores_fwd_kernel, kFwdSmem);
  if (err == cudaSuccess) err = scores::allow_smem(delta_kernel, kFwdSmem);
  if (err == cudaSuccess) err = scores::allow_smem(scores_bwd_kernel, kBwdSmem);
  if (err == cudaSuccess) err = scores::allow_smem(apply_kernel<false>, kFwdSmem);
  if (err == cudaSuccess) err = scores::allow_smem(apply_kernel<true>, kFwdSmem);
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

// forward: scores, rows (attention_scores.cuh's f32 row pass), O; a.s, a.p
// (= a.s), a.l the workspaces
inline cudaError_t launch_fwd(const Args& a, void* o, int BH, cudaStream_t st) {
  cudaError_t err = attributes_once();
  CUtensorMap mq, mk, mv, mp;
  if (err == cudaSuccess) err = make_map(&mq, a.q, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.Dh, a.Tk, BH, 32);
  if (err == cudaSuccess) err = make_map(&mp, a.p, a.Nk, a.Mq, BH, kTile);
  if (err != cudaSuccess) return err;
  const scores::Grid gr = grid_of(a.Tq, a.Tk, a.Dh, a.causal != 0);
  scores_fwd_kernel<<<dim3(gr.score_tiles, 1, BH), kThreads, kFwdSmem, st>>>(mq, mk, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned row_blocks =
      (unsigned)(((long long)BH * a.Tq + scores::kWarps - 1) / scores::kWarps);
  scores::rows_kernel<float><<<row_blocks, scores::kThreads, 0, st>>>(a, BH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<false><<<dim3(gr.query_rows, gr.strips, BH), kThreads, kFwdSmem, st>>>(
      mp, mv, static_cast<float*>(o), a.l, a);
  return cudaGetLastError();
}

// backward: delta, scores (P^T, dS, dS^T), dQ, dK, dV; a.p (P^T), a.ds
// (dS) and ds_t (dS^T) the workspaces
inline cudaError_t launch_bwd(const Args& a, void* ds_t, void* dq, void* dk, void* dv, int BH,
                              cudaStream_t st) {
  cudaError_t err = attributes_once();
  CUtensorMap mq, mk, mdo, mv, mo, yq, yk, ydo, xds, xdst, xpt;
  if (err == cudaSuccess) err = make_map(&mq, a.q, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mdo, a.dout, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.Dh, a.Tk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&mo, a.o, a.Dh, a.Tq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&yq, a.q, a.Dh, a.Tq, BH, 32);
  if (err == cudaSuccess) err = make_map(&yk, a.k, a.Dh, a.Tk, BH, 32);
  if (err == cudaSuccess) err = make_map(&ydo, a.dout, a.Dh, a.Tq, BH, 32);
  if (err == cudaSuccess) err = make_map(&xds, a.ds, a.Nk, a.Mq, BH, kTile);
  if (err == cudaSuccess) err = make_map(&xdst, ds_t, a.Mq, a.Nk, BH, kTile);
  if (err == cudaSuccess) err = make_map(&xpt, a.p, a.Mq, a.Nk, BH, kTile);
  if (err != cudaSuccess) return err;
  const scores::Grid gr = grid_of(a.Tq, a.Tk, a.Dh, a.causal != 0);
  delta_kernel<<<dim3(scores::tiles_of(a.Tq), 1, BH), kThreads, kFwdSmem, st>>>(mdo, mo, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scores_bwd_kernel<<<dim3(gr.score_tiles, 1, BH), kThreads, kBwdSmem, st>>>(
      mq, mk, mdo, mv, static_cast<float*>(ds_t), a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 q_grid(gr.query_rows, gr.strips, BH), k_grid(gr.key_rows, gr.strips, BH);
  apply_kernel<false><<<q_grid, kThreads, kFwdSmem, st>>>(xds, yk, static_cast<float*>(dq),
                                                           nullptr, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<true><<<k_grid, kThreads, kFwdSmem, st>>>(xdst, yq, static_cast<float*>(dk),
                                                          nullptr, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<true><<<k_grid, kThreads, kFwdSmem, st>>>(xpt, ydo, static_cast<float*>(dv),
                                                          nullptr, a);
  return cudaGetLastError();
}

}  // namespace scores_tf32
}  // namespace kokoro_attn
